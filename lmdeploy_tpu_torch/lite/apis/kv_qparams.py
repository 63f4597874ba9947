"""Export static KV-cache qparams from calibration stats into a
workspace.

Port of ``lmdeploy_tpu/lite/apis/kv_qparams.py``, per layer and per head
(``--per-head``: int4 only, ``[L, KH]`` qparams reduced over the head
dimension only).  numpy only; the stats come through
``lite/quantization/calibration.py::load_stats``.

Formula, as the reference's ``past_kv_scale`` with the zero point kept in
the quantised domain (the cache computes ``q = x / scale + zp``):
- symmetric: ``scale = absmax / qmax``, ``zp = 0``;
- asymmetric: ``scale = (max - min) / (2^bits - 1)``,
  ``zp = -((max + min) / 2) / scale``;
with qmax 127 (int8) or 7 (int4).  The workspace's ``config.json`` gets
``kv_scales`` (four [L] or [L][KH] lists) and the engine's
``quant_policy`` / ``kv_dtype``.
"""
from __future__ import annotations

import json
import os.path as osp
from typing import Dict

import numpy as np

from ..quantization.calibration import load_stats

Stats = Dict[int, Dict[str, np.ndarray]]


def qparams_from_stats(keys: Stats, values: Stats, kv_bits: int = 8,
                       kv_sym: bool = False, per_head: bool = False):
    """f32 arrays (k_scale, k_zp, v_scale, v_zp) from per-layer stats
    ``{'min', 'max', 'absmax'}``: [L], each layer's stats reduced to its
    envelope, or with ``per_head`` [L, KH], [KH, Dh] stats reduced over
    Dh."""
    if kv_bits not in (4, 8):
        raise ValueError(f'kv_bits must be 4 or 8, got {kv_bits} (the '
                         'cache pools store int8 or nibble-packed int4)')
    if per_head and kv_bits != 4:
        raise ValueError('per-head kv qparams require kv_bits=4 '
                         '(int8 attention kernels take per-layer scalars)')
    nl = len(keys)
    shape = (nl, keys[0]['absmax'].shape[0]) if per_head else (nl,)
    out = [np.zeros(shape, np.float32) for _ in range(4)]
    k_scale, k_zp, v_scale, v_zp = out
    qmax = 2 ** (kv_bits - 1) - 1       # 127 / 7
    span = 2 ** kv_bits - 1             # 255 / 15
    axis = 1 if per_head else None
    for i in range(nl):
        if kv_sym:
            k_scale[i] = np.max(keys[i]['absmax'], axis=axis) / qmax
            v_scale[i] = np.max(values[i]['absmax'], axis=axis) / qmax
        else:
            kmin = np.min(keys[i]['min'], axis=axis)
            kmax = np.max(keys[i]['max'], axis=axis)
            vmin = np.min(values[i]['min'], axis=axis)
            vmax = np.max(values[i]['max'], axis=axis)
            k_scale[i] = (kmax - kmin) / span
            v_scale[i] = (vmax - vmin) / span
            k_zp[i] = -((kmax + kmin) / 2) / np.maximum(k_scale[i], 1e-12)
            v_zp[i] = -((vmax + vmin) / 2) / np.maximum(v_scale[i], 1e-12)
    return k_scale, k_zp, v_scale, v_zp


def kv_qparams(work_dir: str, dst: str, kv_bits: int = 8,
               kv_sym: bool = False, stats_path: str = '',
               per_head: bool = False) -> None:
    """Write the qparams of ``work_dir``'s calibration stats into the
    workspace ``dst`` (its config.json)."""
    stats_path = stats_path or osp.join(work_dir, 'calib_stats.npz')
    _, keys, values = load_stats(stats_path)
    k_scale, k_zp, v_scale, v_zp = qparams_from_stats(
        keys, values, kv_bits, kv_sym, per_head)
    for i in range(len(k_scale)):
        print(f'layer {i}: k_scale={np.mean(k_scale[i]):.6f} '
              f'k_zp={np.mean(k_zp[i]):.3f} '
              f'v_scale={np.mean(v_scale[i]):.6f} '
              f'v_zp={np.mean(v_zp[i]):.3f}'
              + (' (per-head)' if per_head else ''))
    cfg_path = osp.join(dst, 'config.json')
    with open(cfg_path) as f:
        payload = json.load(f)
    payload['kv_scales'] = [k_scale.tolist(), k_zp.tolist(),
                            v_scale.tolist(), v_zp.tolist()]
    engine = payload.setdefault('engine', {})
    engine['quant_policy'] = 8 if kv_bits == 4 else 4
    engine['kv_dtype'] = 'int4' if kv_bits == 4 else 'int8'
    with open(cfg_path, 'w') as f:
        json.dump(payload, f, indent=2)
    print(f'kv qparams -> {cfg_path}')


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser('lmdeploy_tpu_torch.lite kv_qparams')
    ap.add_argument('work_dir')
    ap.add_argument('dst', help='workspace dir to update')
    ap.add_argument('--kv-bits', type=int, default=8)
    ap.add_argument('--kv-sym', action='store_true')
    ap.add_argument('--per-head', action='store_true',
                    help='per-head [L, KH] qparams (int4 only)')
    args = ap.parse_args(argv)
    kv_qparams(args.work_dir, args.dst, args.kv_bits, args.kv_sym,
               per_head=args.per_head)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
