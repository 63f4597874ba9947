"""Launch and plain-version counters of the port's kernels.

Keys are the kernel's name, and for the attention kernels its KV width
too: ``paged_decode_attention_write[int8]``.  A wrapper adds one to
:data:`LAUNCHES` where it launches its kernel and to :data:`PLAIN_CALLS`
where its plain version runs, and nowhere else.
"""
from __future__ import annotations

import collections

from ...kvcache.paged import KV_WIDTHS

LAUNCHES: collections.Counter = collections.Counter()
PLAIN_CALLS: collections.Counter = collections.Counter()


def variant(name: str, kv_bits: int) -> str:
    """``name[bf16|int8|int4]`` (kv_bits 0 is any unquantised pool)."""
    return f'{name}[{KV_WIDTHS[kv_bits].name}]'


__all__ = ['LAUNCHES', 'PLAIN_CALLS', 'variant']
