"""Calibration observers.

Copy of ``lmdeploy_tpu/lite/quantization/observer.py`` (numpy only; the
port imports nothing of the JAX package).  Reference:
lmdeploy/lite/quantization/activation/observer.py — ActivationObserver
records per-channel max/min/absmax/absmean of linear inputs;
KVCacheObserver records per-(head, dim) extrema of past K/V.  Stats are
plain numpy here (exported to .npz, consumed by the quantisers of
``lite/apis``)."""
from __future__ import annotations

from typing import Dict

import numpy as np


class ActivationObserver:
    """Per-channel stats of a [*, dim] activation stream."""

    def __init__(self, dim: int):
        self.dim = dim
        self.max = np.full((dim,), -np.inf, np.float32)
        self.min = np.full((dim,), np.inf, np.float32)
        self.absmax = np.zeros((dim,), np.float32)
        self.absmean = np.zeros((dim,), np.float32)
        self.mean = np.zeros((dim,), np.float32)
        self.batches = 0

    def observe(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32).reshape(-1, self.dim)
        self.max = np.maximum(self.max, x.max(0))
        self.min = np.minimum(self.min, x.min(0))
        ax = np.abs(x)
        self.absmax = np.maximum(self.absmax, ax.max(0))
        n = self.batches
        self.mean = (self.mean * n + x.mean(0)) / (n + 1)
        self.absmean = (self.absmean * n + ax.mean(0)) / (n + 1)
        self.batches = n + 1

    def stats(self) -> Dict[str, np.ndarray]:
        return {'max': self.max, 'min': self.min, 'absmax': self.absmax,
                'absmean': self.absmean, 'mean': self.mean}


class KVCacheObserver:
    """Per-(head, dim) extrema of cached K or V ([B, heads, S, dim] or
    [B, S, heads, dim] input layouts)."""

    def __init__(self, num_head: int, head_dim: int):
        self.num_head = num_head
        self.head_dim = head_dim
        self.max = np.full((num_head, head_dim), -np.inf, np.float32)
        self.min = np.full((num_head, head_dim), np.inf, np.float32)
        self.absmax = np.zeros((num_head, head_dim), np.float32)

    def observe(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32)
        assert x.ndim == 4
        if x.shape[1] == self.num_head and x.shape[3] == self.head_dim:
            x = np.moveaxis(x, 1, 2)        # -> [B, S, heads, dim]
        assert x.shape[2] == self.num_head and x.shape[3] == self.head_dim
        flat = x.reshape(-1, self.num_head, self.head_dim)
        self.max = np.maximum(self.max, flat.max(0))
        self.min = np.minimum(self.min, flat.min(0))
        self.absmax = np.maximum(self.absmax, np.abs(flat).max(0))

    def stats(self) -> Dict[str, np.ndarray]:
        return {'max': self.max, 'min': self.min, 'absmax': self.absmax}


__all__ = ['ActivationObserver', 'KVCacheObserver']
