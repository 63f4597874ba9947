"""Paged KV cache — device pool and its plain update / gather functions.

Port of ``lmdeploy_tpu/kvcache/paged.py``: the bf16 pool, int8
(``quant_policy`` 4, the reference's KV-INT8 scheme, docs/en/kv_int8.md:
per-layer scale and zero point from calibration) and nibble-packed int4
(``quant_policy`` 8; uint8 pool whose last dim is Dh/2) with three qparam
schemes:

- static per-layer qparams from calibration (int8 and int4);
- static per-HEAD ``[L, KH]`` qparams (int4 only, ``kv_qparams
  --per-head``);
- DYNAMIC per-token-head-group qparams (int4 without calibration, the JAX
  package's default int4 KV): each written token's K (and V) vector splits
  into G contiguous feature groups (``LMDEPLOY_TPU_KV_DYN_GROUPS``, default
  2 -> 64 features per group at Dh = 128, aligned with the half-split
  pack), each with its own asymmetric (scale, min) computed at append
  time: ``q = clip(round((x - min) / scale), 0, 15)``, ``x ~= q * scale +
  min``.

All KV lives in one pool ``[L, P, page_size, KH, Dh]`` addressed through a
per-slot page table; the host allocator is ``kvcache/manager.py`` (or
``kvcache/native.py``).

Static quantisation: ``q = clip(round(x_f32 / scale + zp))`` (true f32
division, round half to even) into [-128, 127], or [-8, 7] for int4;
dequant ``(q - zp) * scale``.  The int4 pack is HALF-SPLIT: byte j holds
feature j in its low nibble and feature j + Dh/2 in its high nibble.

Unlike the JAX package, whose arrays are immutable (XLA aliases the
pool functionally), the port updates the pool IN PLACE: :func:`write_kv`,
:func:`write_kv_dynamic` and the decode kernels write straight into
``cache.k`` / ``cache.v`` (and ``cache.dyn``).
"""
from __future__ import annotations

import dataclasses
import os
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

    qparams: f32 static rows (k_scale, k_zp, v_scale, v_zp), zp in the
    quantised domain, on the pool's device: [L, 4] per layer (the
    attention kernels read one row per layer), or [L, 4, KH] per head (an
    int4 pool; ``qparams[layer]`` unpacks into four [KH] vectors).  Ones /
    zeros for an unquantised or a dynamic pool, where they are not read.

    dyn: the dynamic int4 pool's qparams, f32 [L, P, page_size, KH, 4, G]
    (k_scale, k_min, v_scale, v_min per feature group), written beside
    each token, or None.  The JAX package keeps four [L, P, page, KH, G]
    arrays; here they are one, so that a store or a gather moves a
    token-head's qparams as one row (one scatter and one gather per layer
    instead of four, and the row a future decode kernel would read)."""
    k: torch.Tensor
    v: torch.Tensor
    qparams: torch.Tensor
    dyn: Optional[torch.Tensor] = None

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
    def dynamic_scales(self) -> bool:
        """Per-token-head-group dynamic int4 qparams."""
        return self.dyn is not None

    @property
    def dyn_groups(self) -> int:
        """Feature groups per head vector of the dynamic pool (0: none)."""
        return self.dyn.shape[-1] if self.dyn is not None else 0

    @property
    def per_head(self) -> bool:
        """Static per-head [L, KH] qparams."""
        return self.qparams.dim() == 3

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


def kv_dyn_groups(head_dim: int) -> int:
    """Feature groups per head vector for dynamic int4 qparams
    (``LMDEPLOY_TPU_KV_DYN_GROUPS``, default 2), clamped to a divisor of
    Dh/2 so that groups stay aligned with the half-split pack."""
    g = max(1, int(os.environ.get('LMDEPLOY_TPU_KV_DYN_GROUPS', '2')))
    while (head_dim // 2) % g:
        g -= 1
    return g


def init_cache(num_layers: int, num_pages: int, page_size: int,
               kv_heads: int, head_dim: int, dtype=torch.bfloat16,
               device='cuda', *,
               kv_scales: Optional[Sequence] = None,
               dynamic_scales: bool = False) -> KVCache:
    """Allocate a zeroed pool.  ``dtype=torch.uint8`` is the nibble-packed
    int4 pool (last dim Dh/2).  ``kv_scales``: four sequences (k_scale,
    k_zp, v_scale, v_zp) of [L] per-layer or [L, KH] per-head values
    (per-head: int4 only); None gives scale 1 and zero point 0, as the JAX
    package does.  ``dynamic_scales`` adds the dynamic int4 qparam pool
    (scales 1, minima 0 until written)."""
    if dtype == torch.uint8:               # nibble-packed int4: 2 per byte
        if head_dim % 2:
            raise ValueError(f'int4 KV needs even head_dim, got {head_dim}')
        head_dim //= 2
    shape = (num_layers, num_pages, page_size, kv_heads, head_dim)
    if kv_scales is None:
        kv_scales = ([1.0] * num_layers, [0.0] * num_layers,
                     [1.0] * num_layers, [0.0] * num_layers)
    scales = [torch.as_tensor(x, dtype=torch.float32).cpu() for x in kv_scales]
    if any(s.shape != scales[0].shape for s in scales) or scales[0].shape \
            not in ((num_layers,), (num_layers, kv_heads)):
        raise ValueError(
            f'kv_scales of shapes {[tuple(s.shape) for s in scales]}: want '
            f'four [{num_layers}] per-layer or [{num_layers}, {kv_heads}] '
            'per-head arrays')
    if scales[0].dim() == 2 and dtype != torch.uint8:
        raise ValueError('per-head kv qparams need an int4 pool (the int8 '
                         'attention kernels take per-layer qparams)')
    dyn = None
    if dynamic_scales:
        if dtype != torch.uint8:
            raise ValueError('dynamic kv qparams need an int4 pool')
        g = kv_dyn_groups(head_dim * 2)
        dyn = torch.zeros(shape[:-1] + (4, g), dtype=torch.float32,
                          device=device)
        dyn[..., 0::2, :] = 1.0            # scales 1, minima 0
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   qparams=torch.stack(scales, dim=1).to(device), dyn=dyn)


def _per_head(p, x: torch.Tensor):
    """A per-layer qparam (scalar or 0-d) as it is; a per-head one ([KH],
    one layer's slice of a [L, KH] export) as [KH, 1], to broadcast
    against x's trailing [KH, Dh].  A vector whose length is not x's
    KV-head count (an unsliced [L] array, say) raises."""
    if getattr(p, 'ndim', 0) >= 1:
        if p.shape[-1] != x.shape[-2]:
            raise ValueError(
                f'per-head kv qparams {tuple(p.shape)} do not match KV heads '
                f'{x.shape[-2]}; per-layer [L] arrays must be sliced to '
                'scalars first')
        return torch.as_tensor(p)[..., :, None]
    return p


def quantize_kv(x: torch.Tensor, scale, zp, bits: int = 8) -> torch.Tensor:
    """f -> q-domain int8 with static scale/zp (per layer: scalars or 0-d
    tensors; per head: [KH]); bits=4 clips to the int4 range of the packed
    pool.  The qparams become f32 tensors on x's device: PyTorch divides a
    CUDA tensor by a host scalar as a multiply by its reciprocal, which is
    not the kernels' f32 division."""
    scale, zp = (_per_head(torch.as_tensor(p, dtype=torch.float32,
                                           device=x.device), x)
                 for p in (scale, zp))
    q = torch.round(x.float() / scale + zp)
    lo, hi = (-8, 7) if bits == 4 else (-128, 127)
    return torch.clamp(q, lo, hi).to(torch.int8)


def dequantize_kv(q: torch.Tensor, scale, zp,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return ((q.float() - _per_head(zp, q)) * _per_head(scale, q)).to(dtype)


def pack_kv_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 q-domain values in [-8, 7] (or uint8 0..15), [..., Dh] ->
    uint8 [..., Dh/2], half-split (low nibble feature j, high nibble
    feature j + Dh/2)."""
    u = q.to(torch.int16) & 0xF
    dh2 = u.shape[-1] // 2
    return (u[..., :dh2] | (u[..., dh2:] << 4)).to(torch.uint8)


def unpack_kv_int4(p: torch.Tensor) -> torch.Tensor:
    """uint8 [..., Dh/2] -> sign-extended int8 [..., Dh] (half-split)."""
    p = p.to(torch.int16)
    lo = ((p & 0xF) ^ 8) - 8
    hi = ((p >> 4) ^ 8) - 8
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def unpack_kv_uint4(p: torch.Tensor) -> torch.Tensor:
    """uint8 [..., Dh/2] -> UNSIGNED int8 values 0..15, [..., Dh] (the
    dynamic scheme's codes; half-split)."""
    return torch.cat([p & 0xF, p >> 4], dim=-1).to(torch.int8)


def quantize_kv_dynamic(x: torch.Tensor, groups: Optional[int] = None):
    """Asymmetric per-token-head-group int4: each [..., Dh] vector splits
    into ``groups`` contiguous feature groups, each quantised against its
    own (scale, min).  Returns (packed uint8 [..., Dh/2], scale [..., G],
    min [..., G]), f32 qparams, with x ~= q * scale + min per group."""
    dh = x.shape[-1]
    g = kv_dyn_groups(dh) if groups is None else groups
    xf = x.float().reshape(*x.shape[:-1], g, dh // g)
    mn = xf.amin(dim=-1)
    mx = xf.amax(dim=-1)
    # a device tensor: true f32 division (see quantize_kv)
    fifteen = torch.tensor(15.0, dtype=torch.float32, device=x.device)
    s = torch.clamp((mx - mn) / fifteen, min=1e-8)
    q = torch.clamp(torch.round((xf - mn[..., None]) / s[..., None]), 0, 15)
    return pack_kv_int4(q.reshape(x.shape)), s, mn


def quantize_pack(x: torch.Tensor, scale, zp, kv_bits: int,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """Rows [..., Dh] -> the pool's dtype: cast (kv_bits 0), int8, or
    int4 packed to [..., Dh/2] uint8."""
    if kv_bits == 0:
        return x.to(out_dtype)
    q = quantize_kv(x, scale, zp, bits=kv_bits)
    return pack_kv_int4(q) if kv_bits == 4 else q


def _scatter_rows(layer: int, positions: torch.Tensor,
                  page_table: torch.Tensor, valid: torch.Tensor,
                  writes) -> None:
    """Write ``rows`` [B*T, ...] into layer ``layer`` of each ``pool`` of
    ``writes`` ((pool, rows) pairs, pools [L, P, page, ...]), in place, at
    page ``page_table[b, pos // page]`` slot ``pos % page``.  Rows with
    ``valid == False`` or an unmapped (-1) page are dropped, as the JAX
    scatter's ``mode='drop'`` does.

    No row is selected by a boolean mask (that would wait for the device
    to count the rows): every row is written, a dropped row with the same
    bytes as a kept one, at the same place, so the duplicate writes
    agree; with no row kept, each row writes back what its place holds."""
    page_size = writes[0][0].shape[2]
    maxp = page_table.shape[1]
    pos = positions.long()
    page_of = torch.clamp(pos // page_size, max=maxp - 1)
    phys = torch.gather(page_table.long(), 1, page_of).reshape(-1)
    keep = (valid.bool() & (pos // page_size < maxp)).reshape(-1) \
        & (phys >= 0)
    pos = pos.reshape(-1)
    # the first kept row, as a 1-element index (a 0-d one reads the host)
    first = torch.argmax(keep.to(torch.int8)).reshape(1)
    any_keep = keep[first]
    redirect = ~keep & any_keep
    page = torch.where(redirect, phys[first], torch.clamp(phys, min=0))
    slot = torch.where(redirect, pos[first], pos) % page_size
    for pool, rows in writes:
        lead = (-1,) + (1,) * (rows.dim() - 1)
        rows = torch.where(keep.view(lead), rows,
                           torch.where(any_keep.view(lead), rows[first],
                                       pool[layer, page, slot]))
        pool[layer, page, slot] = rows


def write_kv(cache_k: torch.Tensor, cache_v: torch.Tensor, layer: int,
             k_new: torch.Tensor, v_new: torch.Tensor,
             positions: torch.Tensor, page_table: torch.Tensor,
             valid: torch.Tensor, qparams=None) -> None:
    """Scatter new tokens' K/V [B, T, KH, Dh] into layer ``layer`` of the
    pool, in place (see :func:`_scatter_rows` for the addressing and the
    dropped tokens).  ``qparams`` = this layer's (k_scale, k_zp, v_scale,
    v_zp): four scalars, an f32 [4] row of ``KVCache.qparams``, or its
    per-head [4, KH] slice; it quantises the rows for an int8 / int4
    pool."""
    bits = kv_bits_of(cache_k)
    if bits and qparams is None:
        raise ValueError('write_kv: a quantised pool needs qparams')
    ks, kz, vs, vz = qparams if bits else (None,) * 4
    _scatter_rows(layer, positions, page_table, valid, [
        (pool, quantize_pack(new.reshape((-1,) + new.shape[2:]), scale, zp,
                             bits, pool.dtype))
        for pool, new, scale, zp in ((cache_k, k_new, ks, kz),
                                     (cache_v, v_new, vs, vz))])


def write_kv_dynamic(cache_k: torch.Tensor, cache_v: torch.Tensor,
                     dyn: torch.Tensor, layer: int, k_new: torch.Tensor,
                     v_new: torch.Tensor, positions: torch.Tensor,
                     page_table: torch.Tensor, valid: torch.Tensor) -> None:
    """Dynamic-int4 :func:`write_kv`: each token-head vector is quantised
    against its own per-group (scale, min), which land in ``dyn`` [L, P,
    page, KH, 4, G] at the same (page, slot) as the codes.  The group
    count comes from the pool, not the environment."""
    kq, ks, kz = quantize_kv_dynamic(k_new, dyn.shape[-1])
    vq, vs, vz = quantize_kv_dynamic(v_new, dyn.shape[-1])
    qp = torch.stack([ks, kz, vs, vz], dim=-2)       # [B, T, KH, 4, G]
    _scatter_rows(layer, positions, page_table, valid, [
        (cache_k, kq.reshape((-1,) + kq.shape[2:])),
        (cache_v, vq.reshape((-1,) + vq.shape[2:])),
        (dyn, qp.reshape((-1,) + qp.shape[2:]))])


def gather_kv_layer(cache_k_l: torch.Tensor, cache_v_l: torch.Tensor,
                    page_table: torch.Tensor, qparams=None,
                    dtype=torch.bfloat16
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot contiguous K/V [B, max_pages*page, KH, Dh] from one layer's
    pages (the plain path; the kernels read pages in place).  An int4 pool
    is unpacked; with ``qparams`` (per-layer scalars or per-head [KH]) the
    values are dequantised to ``dtype``.  Unmapped pages read page 0 and
    must be masked by the caller via kv_len."""
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


def gather_kv_layer_dynamic(cache_k_l: torch.Tensor, cache_v_l: torch.Tensor,
                            dyn_l: torch.Tensor, page_table: torch.Tensor,
                            dtype=torch.bfloat16
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic-int4 :func:`gather_kv_layer`: one layer's codes and its
    qparams ``dyn_l`` [P, page, KH, 4, G] through the same page
    indirection, ``x = q * scale + min`` per feature group in f32, then
    ``dtype``."""
    b, max_pages = page_table.shape
    page_size = cache_k_l.shape[1]
    idx = torch.clamp(page_table.long(), min=0)
    qp = dyn_l[idx][..., None]               # [B, mp, page, KH, 4, G, 1]
    out = []
    for pool, j in ((cache_k_l, 0), (cache_v_l, 2)):
        q = unpack_kv_uint4(pool[idx])       # [B, mp, page, KH, Dh]
        kh, dh = q.shape[-2], q.shape[-1]
        g = qp.shape[-2]
        x = q.float().reshape(*q.shape[:-1], g, dh // g) * qp[..., j, :, :] \
            + qp[..., j + 1, :, :]
        out.append(x.to(dtype).reshape(b, max_pages * page_size, kh, dh))
    return out[0], out[1]


__all__ = ['KVWidth', 'KV_WIDTHS', 'KVCache', 'init_cache', 'kv_bits_named',
           'kv_bits_of', 'kv_dyn_groups', 'write_kv', 'write_kv_dynamic',
           'gather_kv_layer', 'gather_kv_layer_dynamic', 'quantize_kv',
           'quantize_kv_dynamic', 'dequantize_kv', 'pack_kv_int4',
           'unpack_kv_int4', 'unpack_kv_uint4', 'quantize_pack']
