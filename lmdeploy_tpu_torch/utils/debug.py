"""Golden-file activation debugging — record/replay tensor comparison.

Port of ``lmdeploy_tpu/utils/debug.py`` (reference:
src/turbomind/models/llama/llama_utils.cu:59-121 CmpWrite/CmpRead under
TM_DEBUG_LEVEL: run A dumps per-tensor files, run B prints L1 diffs
against them, validating refactors against a known-good build).

Usage: set LMDEPLOY_TPU_DEBUG=dump (record) or =cmp (compare) and
LMDEPLOY_TPU_DEBUG_DIR (default ./tmp_cmp) before this module is
imported; instrument code with ``dbg('name', tensor)``.  The file format
is the JAX package's: ``{name}.{n}.npy`` in f32, ``n`` counting the calls
of each name since the last :func:`reset`, so either package's ``cmp``
reads the other's ``dump``.

With the mode on, ``dbg`` copies the tensor to the host, which
synchronises with the device.  With it off, ``dbg`` returns before it
touches the tensor: no launch, no copy, no sync."""
from __future__ import annotations

import os
import os.path as osp

import numpy as np

_MODE = os.environ.get('LMDEPLOY_TPU_DEBUG', '')
_DIR = os.environ.get('LMDEPLOY_TPU_DEBUG_DIR', './tmp_cmp')
_counters = {}


def enabled() -> bool:
    return _MODE in ('dump', 'cmp')


def _path(name: str) -> str:
    n = _counters.get(name, 0)
    _counters[name] = n + 1
    return osp.join(_DIR, f'{name}.{n}.npy')


def _dump(name, arr: np.ndarray) -> None:
    os.makedirs(_DIR, exist_ok=True)
    np.save(_path(str(name)), np.asarray(arr, np.float32))


def _cmp(name, arr: np.ndarray) -> None:
    p = _path(str(name))
    if not osp.exists(p):
        print(f'[cmp] {name}: no golden file {p}')
        return
    want = np.load(p)
    got = np.asarray(arr, np.float32)
    if want.shape != got.shape:
        print(f'[cmp] {name}: shape {got.shape} != golden {want.shape}')
        return
    l1 = np.abs(got - want).mean()
    rel = l1 / (np.abs(want).mean() + 1e-12)
    flag = 'OK ' if rel < 1e-3 else 'DIFF'
    print(f'[cmp] {flag} {name}: L1 {l1:.3e} rel {rel:.3e}')


def dbg(name: str, tensor) -> None:
    """Record or compare ``tensor`` under ``name``; a no-op when
    LMDEPLOY_TPU_DEBUG is unset."""
    if not enabled():
        return
    fn = _dump if _MODE == 'dump' else _cmp
    fn(name, tensor.detach().float().cpu().numpy())


def reset() -> None:
    """Reset per-name counters (call between steps when comparing)."""
    _counters.clear()


__all__ = ['dbg', 'enabled', 'reset']
