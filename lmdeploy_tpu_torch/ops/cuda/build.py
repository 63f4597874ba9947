"""Build and load the port's hand-written CUDA kernels.

The sources live in ``lmdeploy_tpu_torch/csrc/*.cu``, each with a plain C
interface.  At first use they are compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` per source, all
started together, then linked into one shared library under
``lmdeploy_tpu_torch/csrc/build/`` (named by a hash of the sources, the
header they share and the flags, so an unchanged tree reuses it) and
loaded with ``ctypes``.  There is no fallback: a missing ``nvcc`` or a
failed build raises.

``ptxas -v`` output (registers, shared memory, spills per kernel) is kept
in :data:`BUILD_LOG` for the build that this process ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parents[2] / 'csrc'
BUILD_DIR = CSRC / 'build'
SOURCES = ('w4a16_gemm.cu', 'paged_decode_attention.cu',
           'paged_prefill_attention.cu')
HEADERS = ('sm90.cuh',)
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

BUILD_LOG: List[str] = []

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    'lmd_w4a16_gemm': (_P,) * 6 + (_I,) * 5 + (_P,),
    'lmd_w4a16_wgmma_rows': (_I,),
    'lmd_tmap_encode_ns': (_I,),
    'lmd_paged_decode_attention': (_I,) + (_P,) * 15 + (_I,) * 10
                                  + (_F, _P),
    'lmd_paged_decode_want': (_I, _I, _I, _I),
    'lmd_paged_prefill_attention': (_I,) + (_P,) * 10 + (_I,) * 12
                                   + (_F, _P),
    'lmd_paged_prefill_capacity': (_I, _I, _I),
}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else the
    one on PATH; raises when there is none."""
    for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
                 '/usr/local/cuda/bin/nvcc', shutil.which('nvcc') or ''):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels of '
                       'lmdeploy_tpu_torch need the CUDA toolkit')


def _digest() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, so_path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f'{os.getpid()}'
    objs = [BUILD_DIR / f'{Path(n).stem}.{tag}.o' for n in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, '-c', str(CSRC / n),
                               '-o', str(o)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for n, o in zip(SOURCES, objs)]
    failed = []
    for name, p in zip(SOURCES, procs):
        out, _ = p.communicate()
        BUILD_LOG.append(f'== nvcc {name} (rc {p.returncode})\n{out}')
        if p.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f'nvcc failed for {failed}:\n'
                           + '\n'.join(BUILD_LOG))
    tmp = so_path.with_suffix(f'.{tag}.tmp')
    link = subprocess.run([nvcc, '-shared', '-o', str(tmp),
                           *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    BUILD_LOG.append(f'== link (rc {link.returncode})\n{link.stdout}')
    if link.returncode != 0:
        raise RuntimeError(f'linking the kernels failed:\n{link.stdout}')
    os.replace(tmp, so_path)
    for o in objs:
        o.unlink()


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so_path = BUILD_DIR / f'liblmdeploy_kernels_{_digest()}.so'
        if not so_path.exists():
            _compile(find_nvcc(), so_path)
        lib = ctypes.CDLL(str(so_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f'{name}: CUDA error {rc}')


__all__ = ['load', 'check', 'find_nvcc', 'BUILD_LOG', 'BUILD_DIR',
           'SOURCES']
