"""Paged KV cache — device pool and its plain update / gather functions.

Port of ``lmdeploy_tpu/kvcache/paged.py`` for the bf16 pool and the
STATIC-qparam quantised pools: int8 (``quant_policy`` 4, the reference's
KV-INT8 scheme, docs/en/kv_int8.md: per-layer scale and zero point from
calibration) and nibble-packed int4 (``quant_policy`` 8 with calibrated
per-layer qparams; uint8 pool whose last dim is Dh/2).  Dynamic
per-token int4 and per-head int4 qparams are ROADMAP.md Queue 1 item 5.
All KV lives in one pool ``[L, P, page_size, KH, Dh]`` addressed through a
per-slot page table; the host allocator is ``kvcache/manager.py``.

Quantisation: ``q = clip(round(x_f32 / scale + zp))`` (true f32 division,
round half to even) into [-128, 127], or [-8, 7] for int4; dequant
``(q - zp) * scale``.  The int4 pack is HALF-SPLIT: byte j holds feature
j in its low nibble and feature j + Dh/2 in its high nibble.

Unlike the JAX package, whose arrays are immutable (XLA aliases the
pool functionally), the port updates the pool IN PLACE: :func:`write_kv`
and the decode kernels write straight into ``cache.k`` / ``cache.v``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch


class KVWidth(NamedTuple):
    """One KV pool width: its name in counters and configs, the pool's
    dtype and the bytes each K or V feature takes there."""
    name: str
    dtype: torch.dtype
    elem_bytes: float


# by kv_bits; 0 is the unquantised pool (bf16, or f32 in tests)
KV_WIDTHS = {0: KVWidth('bf16', torch.bfloat16, 2.0),
             8: KVWidth('int8', torch.int8, 1.0),
             4: KVWidth('int4', torch.uint8, 0.5)}


def kv_bits_named(name: str) -> int:
    """kv_bits of the width ``name`` ('int8' or 'int4'; any other name is
    the unquantised pool, 0)."""
    return next((b for b, w in KV_WIDTHS.items() if w.name == name), 0)


def kv_bits_of(pool: torch.Tensor) -> int:
    """0 (unquantised pool), 8 (int8) or 4 (nibble-packed uint8)."""
    return next((b for b, w in KV_WIDTHS.items()
                 if b and w.dtype == pool.dtype), 0)


@dataclasses.dataclass
class KVCache:
    """Device KV pool. k/v: [L, P, page_size, KH, Dh] (bf16, f32 or int8),
    or [L, P, page_size, KH, Dh/2] uint8 for nibble-packed int4.

    qparams: f32 [L, 4] static per-layer rows (k_scale, k_zp, v_scale,
    v_zp), zp in the quantised domain, on the pool's device: the attention
    kernels read one row per layer.  Ones/zeros for an unquantised pool,
    where they are not read."""
    k: torch.Tensor
    v: torch.Tensor
    qparams: torch.Tensor

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.quant_bits != 0

    @property
    def quant_bits(self) -> int:
        """0 (unquantised), 8 (int8) or 4 (nibble-packed uint8 pool)."""
        return kv_bits_of(self.k)

    @property
    def k_scale(self) -> torch.Tensor:
        return self.qparams[:, 0]

    @property
    def k_zp(self) -> torch.Tensor:
        return self.qparams[:, 1]

    @property
    def v_scale(self) -> torch.Tensor:
        return self.qparams[:, 2]

    @property
    def v_zp(self) -> torch.Tensor:
        return self.qparams[:, 3]


def init_cache(num_layers: int, num_pages: int, page_size: int,
               kv_heads: int, head_dim: int, dtype=torch.bfloat16,
               device='cuda', *,
               kv_scales: Optional[Sequence] = None) -> KVCache:
    """Allocate a zeroed pool.  ``dtype=torch.uint8`` is the nibble-packed
    int4 pool (last dim Dh/2).  ``kv_scales``: four per-layer sequences
    (k_scale, k_zp, v_scale, v_zp); None gives scale 1 and zero point 0,
    as the JAX package does.  Per-head [L, KH] qparams raise."""
    if dtype == torch.uint8:               # nibble-packed int4: 2 per byte
        if head_dim % 2:
            raise ValueError(f'int4 KV needs even head_dim, got {head_dim}')
        head_dim //= 2
    shape = (num_layers, num_pages, page_size, kv_heads, head_dim)
    if kv_scales is None:
        kv_scales = ([1.0] * num_layers, [0.0] * num_layers,
                     [1.0] * num_layers, [0.0] * num_layers)
    scales = [torch.as_tensor(x, dtype=torch.float32) for x in kv_scales]
    if any(s.shape != (num_layers,) for s in scales):
        raise NotImplementedError(
            f'kv_scales of shapes {[tuple(s.shape) for s in scales]}: only '
            f'static per-layer [{num_layers}] qparams are ported; per-head '
            'int4 qparams are ROADMAP.md Queue 1 item 5')
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   qparams=torch.stack(scales, dim=1).to(device))


def quantize_kv(x: torch.Tensor, scale, zp, bits: int = 8) -> torch.Tensor:
    """f -> q-domain int8 with static per-layer scale/zp (scalars or 0-d
    tensors); bits=4 clips to the int4 range of the packed pool.  The
    qparams become f32 tensors on x's device: PyTorch divides a CUDA
    tensor by a host scalar as a multiply by its reciprocal, which is not
    the kernels' f32 division."""
    scale, zp = (torch.as_tensor(p, dtype=torch.float32, device=x.device)
                 for p in (scale, zp))
    q = torch.round(x.float() / scale + zp)
    lo, hi = (-8, 7) if bits == 4 else (-128, 127)
    return torch.clamp(q, lo, hi).to(torch.int8)


def dequantize_kv(q: torch.Tensor, scale, zp,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return ((q.float() - zp) * scale).to(dtype)


def pack_kv_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 q-domain values in [-8, 7], [..., Dh] -> uint8 [..., Dh/2],
    half-split (low nibble feature j, high nibble feature j + Dh/2)."""
    u = q.to(torch.int16) & 0xF
    dh2 = u.shape[-1] // 2
    return (u[..., :dh2] | (u[..., dh2:] << 4)).to(torch.uint8)


def unpack_kv_int4(p: torch.Tensor) -> torch.Tensor:
    """uint8 [..., Dh/2] -> sign-extended int8 [..., Dh] (half-split)."""
    p = p.to(torch.int16)
    lo = ((p & 0xF) ^ 8) - 8
    hi = ((p >> 4) ^ 8) - 8
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def quantize_pack(x: torch.Tensor, scale, zp, kv_bits: int,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """Rows [..., Dh] -> the pool's dtype: cast (kv_bits 0), int8, or
    int4 packed to [..., Dh/2] uint8."""
    if kv_bits == 0:
        return x.to(out_dtype)
    q = quantize_kv(x, scale, zp, bits=kv_bits)
    return pack_kv_int4(q) if kv_bits == 4 else q


def write_kv(cache_k: torch.Tensor, cache_v: torch.Tensor, layer: int,
             k_new: torch.Tensor, v_new: torch.Tensor,
             positions: torch.Tensor, page_table: torch.Tensor,
             valid: torch.Tensor, qparams=None) -> None:
    """Scatter new tokens' K/V [B, T, KH, Dh] into layer ``layer`` of the
    pool, in place, at page ``page_table[b, pos // page]`` slot
    ``pos % page``.  Tokens with ``valid == False`` or an unmapped (-1)
    page are dropped, as the JAX scatter's ``mode='drop'`` does.
    ``qparams`` = this layer's (k_scale, k_zp, v_scale, v_zp), four
    scalars or an f32 [4] row of ``KVCache.qparams``, quantises the rows
    for an int8 / int4 pool.

    No row is selected by a boolean mask (that would wait for the device
    to count the rows): every row is written, a dropped row with the same
    bytes as a kept one, at the same place, so the duplicate writes
    agree; with no row kept, each row writes back what its place holds."""
    page_size = cache_k.shape[2]
    maxp = page_table.shape[1]
    pos = positions.long()
    page_of = torch.clamp(pos // page_size, max=maxp - 1)
    phys = torch.gather(page_table.long(), 1, page_of).reshape(-1)
    keep = (valid.bool() & (pos // page_size < maxp)).reshape(-1) \
        & (phys >= 0)
    pos = pos.reshape(-1)
    bits = kv_bits_of(cache_k)
    if bits and qparams is None:
        raise ValueError('write_kv: a quantised pool needs qparams')
    ks, kz, vs, vz = qparams if bits else (None,) * 4
    # the first kept row, as a 1-element index (a 0-d one reads the host)
    first = torch.argmax(keep.to(torch.int8)).reshape(1)
    any_keep = keep[first]
    redirect = ~keep & any_keep
    page = torch.where(redirect, phys[first], torch.clamp(phys, min=0))
    slot = torch.where(redirect, pos[first], pos) % page_size
    for pool, new, scale, zp in ((cache_k, k_new, ks, kz),
                                 (cache_v, v_new, vs, vz)):
        rows = quantize_pack(new.reshape((-1,) + new.shape[2:]), scale, zp,
                             bits, pool.dtype)
        rows = torch.where(keep[:, None, None], rows,
                           torch.where(any_keep, rows[first],
                                       pool[layer, page, slot]))
        pool[layer, page, slot] = rows


def gather_kv_layer(cache_k_l: torch.Tensor, cache_v_l: torch.Tensor,
                    page_table: torch.Tensor, qparams=None,
                    dtype=torch.bfloat16
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot contiguous K/V [B, max_pages*page, KH, Dh] from one layer's
    pages (the plain path; the kernels read pages in place).  An int4 pool
    is unpacked; with ``qparams`` the values are dequantised to ``dtype``.
    Unmapped pages read page 0 and must be masked by the caller via
    kv_len."""
    b, max_pages = page_table.shape
    page_size = cache_k_l.shape[1]
    idx = torch.clamp(page_table.long(), min=0)
    k = cache_k_l[idx]            # [B, max_pages, page, KH, Dh]
    v = cache_v_l[idx]
    if kv_bits_of(cache_k_l) == 4:         # nibble-packed int4 pool
        k = unpack_kv_int4(k)
        v = unpack_kv_int4(v)
    kh, dh = k.shape[-2], k.shape[-1]
    k = k.reshape(b, max_pages * page_size, kh, dh)
    v = v.reshape(b, max_pages * page_size, kh, dh)
    if qparams is not None:
        ks, kz, vs, vz = qparams
        k = dequantize_kv(k, ks, kz, dtype)
        v = dequantize_kv(v, vs, vz, dtype)
    return k, v


__all__ = ['KVWidth', 'KV_WIDTHS', 'KVCache', 'init_cache', 'kv_bits_named',
           'kv_bits_of', 'write_kv',
           'gather_kv_layer', 'quantize_kv', 'dequantize_kv', 'pack_kv_int4', 'unpack_kv_int4',
           'quantize_pack']
