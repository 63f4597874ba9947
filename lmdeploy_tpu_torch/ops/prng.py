"""Counter-based random numbers: the parts of ``jax.random`` the JAX package
uses, as threefry2x32 in plain PyTorch integer ops.

The JAX package keeps one threefry key per batch slot as plain data (two
uint32 words), splits it every step and draws from the split-off half
(``lmdeploy_tpu/ops/sampling.py``, ``ops/speculative.py``).  Keys as data
are what let the engine save and restore a slot's key at the exact
sub-step it stopped.  This module is the port's own copy of that scheme,
bit for bit the ``jax_threefry_partitionable`` variant (the default from
JAX 0.5):

- ``split(key)[i] = threefry2x32(key, (0, i))``;
- ``random_bits(key, shape)[j] = x0 ^ x1`` with ``(x0, x1) =
  threefry2x32(key, (hi(j), lo(j)))`` over the row-major index j;
- ``uniform`` keeps the top 23 bits as the mantissa of a float in [1, 2)
  and subtracts 1;
- ``categorical`` is Gumbel-max, ``argmax(logits + gumbel)`` with
  ``gumbel = -log(-log(uniform(tiny, 1)))``.

Keys are int32 [..., 2] tensors (the bits of the uint32 words, as the
engine's state and readback hold them); every function is vectorised over
the leading key dimensions.  The uint32 arithmetic runs in int64 with a
32-bit mask: torch has no unsigned 32-bit add or shift on every device.
The integer results equal ``jax.random``'s exactly; ``log`` may differ from
XLA's in the last bit, which moves a ``categorical`` draw only where the
two largest perturbed logits tie to within that bit.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _u32(words: torch.Tensor) -> torch.Tensor:
    """int32 (or int64) words -> int64 values in [0, 2^32)."""
    return words.to(torch.int64) & _MASK


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block function (20 rounds), elementwise over
    broadcastable int64 tensors holding uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) & _MASK) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key_from_seed(seed: int) -> np.ndarray:
    """Key data of ``jax.random.PRNGKey(seed)`` as the JAX engine builds
    it on the host: uint32 ``[seed >> 32, seed & 0xFFFFFFFF]``."""
    seed = int(seed)
    return np.array([seed >> 32 & _MASK, seed & _MASK], np.uint32)


def _hash_counts(keys: torch.Tensor, shape: Sequence[int]):
    """threefry2x32 of every key over the 64-bit row-major counter of
    ``shape``: two int64 tensors [*keys.shape[:-1], *shape]."""
    lead = keys.shape[:-1]
    n = int(np.prod(shape)) if len(shape) else 1
    count = torch.arange(n, dtype=torch.int64, device=keys.device)
    count = count.reshape(tuple(shape))
    k = _u32(keys).reshape(lead + (1,) * len(shape) + (2,))
    return threefry2x32(k[..., 0], k[..., 1], count >> 32, count & _MASK)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of each key: int32 [..., 2] -> [..., num, 2]."""
    y0, y1 = _hash_counts(keys, (num,))
    return _as_int32(torch.stack([y0, y1], dim=-1))


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element, as int64 in [0, 2^32): [..., *shape]."""
    y0, y1 = _hash_counts(keys, shape)
    return y0 ^ y1


def uniform(keys: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` (f32) per key: [..., *shape]."""
    bits = (random_bits(keys, shape) >> 9) | 0x3F800000
    floats = _as_int32(bits).view(torch.float32) - 1.0
    # JAX's f32 operations: floats * (maxval - minval) + minval, then the
    # larger of that and minval
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    return torch.clamp(floats * float(span) + float(lo), min=float(lo))


def gumbel(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (f32, low-range mode) per key."""
    return -torch.log(-torch.log(uniform(keys, shape, _TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis, one key per leading
    row: keys [B, 2], logits f32 [B, ..., C] -> int64 [B, ...]."""
    g = gumbel(keys, tuple(logits.shape[1:]))
    return torch.argmax(g + logits.float(), dim=-1)


__all__ = ['threefry2x32', 'key_from_seed', 'split', 'random_bits',
           'uniform', 'gumbel', 'categorical']
