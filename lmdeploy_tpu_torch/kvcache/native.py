"""ctypes binding of the native C++ cache manager
(``lmdeploy_tpu_torch/csrc/cache_manager.cpp``), the host-runtime
component the reference implements as LlamaCacheManager.cc.

Port of ``lmdeploy_tpu/kvcache/native.py``, with the same C ABI.
:class:`NativeSequenceManager` has the surface of
``kvcache/manager.py::SequenceManager`` (prefix caching included), so the
engine is agnostic of the store.

The library is built at first use with ``g++ -O2 -fPIC -std=c++17
-shared`` into ``lmdeploy_tpu_torch/csrc/build/`` (named by a hash of the
source and flags, so an unchanged tree reuses it; written to a temporary
name and renamed, so concurrent builds do not collide).  Unlike the JAX
package, which switches to the Python manager when its build fails, a
failed build raises with the compiler's message.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from .manager import NoFreePages  # one exception type across stores

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
SOURCE = CSRC / 'cache_manager.cpp'
BUILD_DIR = CSRC / 'build'
CXX_FLAGS = ('-O2', '-fPIC', '-std=c++17', '-shared')

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_c = ctypes
_SIGNATURES = {
    'cm_create': ([_c.c_int32] * 3, _c.c_void_p),
    'cm_destroy': ([_c.c_void_p], None),
    'cm_free_pages': ([_c.c_void_p], _c.c_int32),
    'cm_contains': ([_c.c_void_p, _c.c_int64], _c.c_int32),
    'cm_create_seq': ([_c.c_void_p, _c.c_int64], None),
    'cm_erase': ([_c.c_void_p, _c.c_int64], _c.c_int32),
    'cm_grow': ([_c.c_void_p, _c.c_int64, _c.c_int32], _c.c_int32),
    'cm_get_pages': ([_c.c_void_p, _c.c_int64, _c.c_void_p, _c.c_int32],
                     _c.c_int32),
    'cm_set_active': ([_c.c_void_p, _c.c_int64, _c.c_int32], None),
    'cm_set_tokens': ([_c.c_void_p, _c.c_int64, _c.c_void_p, _c.c_int32],
                      _c.c_int32),
    'cm_append_token': ([_c.c_void_p, _c.c_int64, _c.c_int32], _c.c_int32),
    'cm_get_tokens': ([_c.c_void_p, _c.c_int64, _c.c_void_p, _c.c_int32],
                      _c.c_int32),
    'cm_truncate_tokens': ([_c.c_void_p, _c.c_int64, _c.c_int32],
                           _c.c_int32),
    'cm_cache_len': ([_c.c_void_p, _c.c_int64], _c.c_int32),
    'cm_set_cache_len': ([_c.c_void_p, _c.c_int64, _c.c_int32], None),
    'cm_set_rng': ([_c.c_void_p, _c.c_int64, _c.c_uint32, _c.c_uint32],
                   None),
    'cm_get_rng': ([_c.c_void_p, _c.c_int64, _c.c_void_p], _c.c_int32),
    'cm_set_prefix_cache': ([_c.c_void_p, _c.c_int32], None),
    'cm_match_prefix': ([_c.c_void_p, _c.c_int64, _c.c_void_p, _c.c_int32],
                        _c.c_int32),
    'cm_publish': ([_c.c_void_p, _c.c_int64], None),
    'cm_prepare_rewrite': ([_c.c_void_p, _c.c_int64, _c.c_int32],
                           _c.c_int32),
    'cm_flush_prefix': ([_c.c_void_p], None),
    'cm_prefix_stats': ([_c.c_void_p, _c.c_void_p, _c.c_void_p], None),
    'cm_shared_pages': ([_c.c_void_p, _c.c_int64], _c.c_int32),
}


def library_path() -> Path:
    """Where the built library for this source and these flags lives."""
    h = hashlib.sha256(' '.join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f'libcache_manager_{h.hexdigest()[:16]}.so'


def build() -> Path:
    """Compile the library (when it is not built yet) and return its path;
    a failed compile raises RuntimeError with g++'s output."""
    so_path = library_path()
    if so_path.exists():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(f'.{os.getpid()}.tmp')
    res = subprocess.run(['g++', *CXX_FLAGS, '-o', str(tmp), str(SOURCE)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f'building the native cache manager failed '
                           f'(g++ rc {res.returncode}):\n{res.stdout}')
    os.replace(tmp, so_path)
    return so_path


def load() -> ctypes.CDLL:
    """The library with its C ABI declared, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


class NativeSequence:
    """Proxy with the Python Sequence's attribute surface (token_ids,
    pages, cache_len, rng_key, active, shared_pages) over the native
    store."""

    __slots__ = ('_mgr', 'seq_id')

    def __init__(self, mgr: 'NativeSequenceManager', seq_id: int):
        self._mgr = mgr
        self.seq_id = seq_id

    @property
    def token_ids(self) -> '_TokenList':
        return _TokenList(self._mgr, self.seq_id)

    @token_ids.setter
    def token_ids(self, ids):
        arr = np.asarray(list(ids), np.int32)
        self._mgr._lib.cm_set_tokens(self._mgr._h, self.seq_id, _ptr(arr),
                                     len(arr))

    @property
    def pages(self) -> List[int]:
        lib, h = self._mgr._lib, self._mgr._h
        n = lib.cm_get_pages(h, self.seq_id, None, 0)
        if n <= 0:
            return []
        out = np.empty((n,), np.int32)
        lib.cm_get_pages(h, self.seq_id, _ptr(out), n)
        return out.tolist()

    @property
    def cache_len(self) -> int:
        return max(0, self._mgr._lib.cm_cache_len(self._mgr._h, self.seq_id))

    @cache_len.setter
    def cache_len(self, v: int):
        self._mgr._lib.cm_set_cache_len(self._mgr._h, self.seq_id, int(v))

    @property
    def rng_key(self) -> Optional[np.ndarray]:
        out = np.empty((2,), np.uint32)
        ok = self._mgr._lib.cm_get_rng(self._mgr._h, self.seq_id, _ptr(out))
        return out if ok else None

    @rng_key.setter
    def rng_key(self, key):
        a, b = (int(x) for x in np.asarray(key, np.uint32).ravel()[:2])
        self._mgr._lib.cm_set_rng(self._mgr._h, self.seq_id, a, b)

    @property
    def active(self) -> bool:
        return False  # the engine only sets it

    @active.setter
    def active(self, v: bool):
        self._mgr._lib.cm_set_active(self._mgr._h, self.seq_id, int(v))

    @property
    def history_len(self) -> int:
        return max(0, self._mgr._lib.cm_get_tokens(self._mgr._h, self.seq_id,
                                                   None, 0))

    @property
    def shared_pages(self) -> int:
        return max(0, self._mgr._lib.cm_shared_pages(self._mgr._h,
                                                     self.seq_id))


class _TokenList:
    """List-like view of the native token history (what the engine uses:
    len, slicing, append, iteration, +, ==)."""

    __slots__ = ('_mgr', '_id')

    def __init__(self, mgr: 'NativeSequenceManager', seq_id: int):
        self._mgr = mgr
        self._id = seq_id

    def _all(self) -> List[int]:
        lib, h = self._mgr._lib, self._mgr._h
        n = lib.cm_get_tokens(h, self._id, None, 0)
        if n <= 0:
            return []
        out = np.empty((n,), np.int32)
        lib.cm_get_tokens(h, self._id, _ptr(out), n)
        return out.tolist()

    def __len__(self):
        return max(0, self._mgr._lib.cm_get_tokens(self._mgr._h, self._id,
                                                   None, 0))

    def __getitem__(self, idx):
        return self._all()[idx]

    def __iter__(self):
        return iter(self._all())

    def __add__(self, other):
        return self._all() + list(other)

    def __radd__(self, other):
        return list(other) + self._all()

    def __eq__(self, other):
        return self._all() == list(other)

    def append(self, tok: int):
        self._mgr._lib.cm_append_token(self._mgr._h, self._id, int(tok))


class NativeSequenceManager:
    """``kvcache/manager.py::SequenceManager`` over the C++ store."""

    def __init__(self, num_pages: int, page_size: int,
                 max_entries: int = 0, enable_prefix_cache: bool = True):
        self._lib = load()
        self._h = self._lib.cm_create(num_pages, page_size, max_entries)
        self.page_size = page_size
        self.num_pages = num_pages
        self.enable_prefix_cache = enable_prefix_cache
        if not enable_prefix_cache:
            self._lib.cm_set_prefix_cache(self._h, 0)

    def __del__(self):
        if getattr(self, '_h', None) is not None:
            self._lib.cm_destroy(self._h)
            self._h = None

    @property
    def free_count(self) -> int:
        return self._lib.cm_free_pages(self._h)

    def __contains__(self, seq_id: int) -> bool:
        return bool(self._lib.cm_contains(self._h, int(seq_id)))

    def get(self, seq_id: int) -> Optional[NativeSequence]:
        return NativeSequence(self, int(seq_id)) if seq_id in self else None

    def create(self, seq_id: int) -> NativeSequence:
        self._lib.cm_create_seq(self._h, int(seq_id))
        return NativeSequence(self, int(seq_id))

    def fetch(self, seq_id: int) -> Optional[NativeSequence]:
        return self.get(seq_id)

    def erase(self, seq_id: int) -> None:
        self._lib.cm_erase(self._h, int(seq_id))

    def grow(self, seq: NativeSequence, new_total_tokens: int) -> List[int]:
        if self._lib.cm_grow(self._h, seq.seq_id, int(new_total_tokens)) < 0:
            raise NoFreePages(f'cannot grow seq {seq.seq_id} to '
                              f'{new_total_tokens} tokens')
        return seq.pages

    def release(self, seq: NativeSequence) -> None:
        self._lib.cm_set_active(self._h, seq.seq_id, 0)

    def truncate(self, seq: NativeSequence, n: int) -> None:
        self._lib.cm_truncate_tokens(self._h, seq.seq_id, int(n))

    def match_prefix(self, seq: NativeSequence, all_ids) -> int:
        arr = np.asarray(list(all_ids), np.int32)
        return max(0, self._lib.cm_match_prefix(self._h, seq.seq_id,
                                                _ptr(arr), len(arr)))

    def publish(self, seq: NativeSequence) -> None:
        self._lib.cm_publish(self._h, seq.seq_id)

    def prepare_rewrite(self, seq: NativeSequence,
                        new_cache_len: int) -> int:
        r = self._lib.cm_prepare_rewrite(self._h, seq.seq_id,
                                         int(new_cache_len))
        if r < 0:
            raise NoFreePages(f'cannot privatize seq {seq.seq_id}')
        return r

    def flush_prefix(self) -> None:
        self._lib.cm_flush_prefix(self._h)

    def _prefix_stats(self):
        hits, lookups = ctypes.c_int64(0), ctypes.c_int64(0)
        self._lib.cm_prefix_stats(self._h, ctypes.byref(hits),
                                  ctypes.byref(lookups))
        return hits.value, lookups.value

    @property
    def prefix_hits(self) -> int:
        return self._prefix_stats()[0]

    @property
    def prefix_lookups(self) -> int:
        return self._prefix_stats()[1]


__all__ = ['NativeSequenceManager', 'NativeSequence', 'NoFreePages',
           'build', 'load', 'library_path']
