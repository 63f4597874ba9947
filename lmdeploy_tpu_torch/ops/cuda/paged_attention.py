"""Paged decode attention: the three kernels' wrappers and their plain
versions.

Replaces, from ``lmdeploy_tpu/ops/pallas/paged_attention.py``:

- ``paged_decode_attention`` (``_decode_kernel``): attend over the paged
  context; the caller has written this step's K/V (:func:`write_kv`);
- ``paged_decode_attention_write`` (``_decode_write_kernel`` +
  ``_online_attend``): store this step's K/V at ``context_len - 1``, then
  attend;
- ``paged_decode_attention_rope_write`` (``_decode_rope_write_kernel`` +
  ``_rope_full``): rotate-half rope of q and k_new from full-width tables
  (:func:`rope_full_tables`), a per-slot q scale (logn), then store and
  attend;

with ``lmdeploy_tpu_torch/csrc/paged_decode_attention.cu`` (CUDA C++ for
sm_90a, one kernel template over mode and KV width).  Each runs at three
KV widths: a bf16 pool, an int8 pool and a nibble-packed int4 pool
([..., Dh/2] uint8, half-split), the last two with static per-layer
``qparams4`` = (k_scale, k_zp, v_scale, v_zp).

The pool is updated IN PLACE (the JAX kernels alias it functionally).
Page-table entries are clamped at 0, as in the JAX kernels.  Masked slots
(valid == 0) never write; the kernel returns zeros for them in the
storing modes and the plain versions attend them: either way the output
is discarded upstream.  The current token is attended in its stored
(quantised) form.

Bound on an H100 SXM (3.35 TB/s): the context's KV bytes, 2*ctx*KH*Dh
per slot times 2 (bf16), 1 (int8) or 0.5 (int4) bytes.  The kernel splits
the context over a grid (KH, B, S) whose S comes from the page table's
width and the card's resident blocks (:func:`decode_want`,
:func:`decode_splits`; each slot cuts its own context on the device),
walks 64-token tiles in shared memory with one max and rescale per tile,
and merges the splits in the same launch: the last split of a (slot, kv
head) to finish takes the merge, through an int32 ticket counter that
this module keeps per device and leaves at zero after every launch.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.  The plain versions quantise new rows with
``kvcache/paged.py::quantize_pack`` and read pages with
``gather_kv_layer(qparams)``, the same functions ``write_kv`` and the JAX
package's XLA path use (the counterparts of the Pallas ``_quant_pack`` and
``dequant_tile``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ...kvcache.paged import (KV_WIDTHS, gather_kv_layer, kv_bits_of,
                               quantize_pack)
from ..attention import gqa_attention
from . import build
from .counts import LAUNCHES, PLAIN_CALLS, variant

_MODES = {'paged_decode_attention': 0, 'paged_decode_attention_write': 1,
          'paged_decode_attention_rope_write': 2}


def as_qparams4(qparams4, kv_bits: int, device) -> Optional[torch.Tensor]:
    """qparams4 (host floats or a tensor) as f32 [4] on ``device``; None
    for an unquantised pool."""
    if not kv_bits:
        return None
    if qparams4 is None:
        raise ValueError('a quantised KV pool needs qparams4')
    return torch.as_tensor(qparams4, dtype=torch.float32, device=device)


def gather_plain(k_cache, v_cache, layer: int, page_table, qp):
    """The plain versions' K/V: one layer's pages per slot, unpacked and
    dequantised in f32 for a quantised pool (``gather_kv_layer``)."""
    return gather_kv_layer(k_cache[layer], v_cache[layer], page_table,
                           None if qp is None else qp.unbind(),
                           dtype=torch.float32)


def _store_plain(k_new, v_new, k_cache, v_cache, layer, page_table,
                 context_len, valid, qp, kv_bits) -> None:
    """Each valid slot's row at position ctx-1 (page entry clamped at 0),
    quantised and packed as the pool's width requires."""
    page_size = k_cache.shape[2]
    maxp = page_table.shape[1]
    pos = context_len.long() - 1
    rows = torch.nonzero(valid.bool() & (pos >= 0)
                         & (pos // page_size < maxp)).flatten()
    if not rows.numel():
        return
    p = pos[rows]
    phys = torch.clamp(page_table.long()[rows, p // page_size], min=0)
    ks, kz, vs, vz = qp if kv_bits else (None,) * 4
    k_cache[layer, phys, p % page_size] = quantize_pack(
        k_new[rows].float(), ks, kz, kv_bits, k_cache.dtype)
    v_cache[layer, phys, p % page_size] = quantize_pack(
        v_new[rows].float(), vs, vz, kv_bits, v_cache.dtype)


def _attend_plain(q, k_cache, v_cache, layer, page_table, context_len, qp,
                  scale=None) -> torch.Tensor:
    kk, vv = gather_plain(k_cache, v_cache, layer, page_table, qp)
    pos = context_len.long() - 1
    return gqa_attention(q[:, None], kk, vv, pos[:, None], context_len,
                         scale)[:, 0]


def paged_decode_attention_plain(q, k_cache, v_cache, layer: int,
                                 page_table, context_len,
                                 qparams4=None) -> torch.Tensor:
    """Plain version of kernel 4: gather, dequantise, attend."""
    kv_bits = kv_bits_of(k_cache)
    PLAIN_CALLS[variant('paged_decode_attention', kv_bits)] += 1
    qp = as_qparams4(qparams4, kv_bits, q.device)
    return _attend_plain(q, k_cache, v_cache, layer, page_table,
                         context_len, qp)


def paged_decode_attention_write_plain(q, k_new, v_new, k_cache, v_cache,
                                       layer: int, page_table, context_len,
                                       valid, qparams4=None) -> torch.Tensor:
    """Plain version of kernel 2: store the new rows, gather, attend."""
    kv_bits = kv_bits_of(k_cache)
    PLAIN_CALLS[variant('paged_decode_attention_write', kv_bits)] += 1
    qp = as_qparams4(qparams4, kv_bits, q.device)
    _store_plain(k_new, v_new, k_cache, v_cache, layer, page_table,
                 context_len, valid, qp, kv_bits)
    return _attend_plain(q, k_cache, v_cache, layer, page_table,
                         context_len, qp)


def rope_full_tables(cos: torch.Tensor, sin: torch.Tensor, dh: int):
    """[B, half] rope tables -> the full-width f32 [B, Dh] form kernel 5
    reads: cos_f = (cos|cos|1...), sin_f = (-sin|sin|0...); the sign is
    folded in and a partial-rotary tail passes through."""
    b, half = cos.shape
    tail = dh - 2 * half
    cos_f = torch.cat([cos, cos], dim=-1).float()
    sin_f = torch.cat([-sin, sin], dim=-1).float()
    if tail:
        cos_f = torch.cat([cos_f, cos_f.new_ones((b, tail))], dim=-1)
        sin_f = torch.cat([sin_f, sin_f.new_zeros((b, tail))], dim=-1)
    return cos_f.contiguous(), sin_f.contiguous()


def rope_full(x: torch.Tensor, cos_f: torch.Tensor, sin_f: torch.Tensor,
              half: int) -> torch.Tensor:
    """Rotate-half rope on [B, heads, Dh] rows with [B, Dh] full-width
    tables: ``x * cos_f + rothalf(x) * sin_f`` in f32."""
    x = x.float()
    rh = torch.cat([x[..., half:2 * half], x[..., :half],
                    x[..., 2 * half:]], dim=-1)
    return x * cos_f[:, None] + rh * sin_f[:, None]


def paged_decode_attention_rope_write_plain(
        q, k_new, v_new, cos_f, sin_f, qscale, k_cache, v_cache,
        layer: int, page_table, context_len, valid, qparams4=None, *,
        half: int) -> torch.Tensor:
    """Plain version of kernel 5: rope q and k_new, store, attend with q
    scaled by ``Dh^-0.5 * qscale[b]``."""
    kv_bits = kv_bits_of(k_cache)
    PLAIN_CALLS[variant('paged_decode_attention_rope_write', kv_bits)] += 1
    qp = as_qparams4(qparams4, kv_bits, q.device)
    k_rot = rope_full(k_new, cos_f, sin_f, half)
    _store_plain(k_rot, v_new, k_cache, v_cache, layer, page_table,
                 context_len, valid, qp, kv_bits)
    dh = q.shape[-1]
    q_rot = rope_full(q, cos_f, sin_f, half) * (
        dh ** -0.5 * qscale.float())[:, None, None]
    return _attend_plain(q_rot, k_cache, v_cache, layer, page_table,
                         context_len, qp, scale=1.0).to(q.dtype)


# Splits per slot: None takes the most that keep every block resident
# (decode_want); an int fixes them, for measurements.
SPLITS_WANTED = None
_TILE = 64
_counters: dict = {}
_outgrown: list = []     # counters a CUDA graph may still hold
_wants: dict = {}


def decode_want(name: str, kv_bits: int, g: int, pairs: int) -> int:
    """The most splits per slot for which all ``pairs`` (B * KH) x splits
    blocks of this kernel variant fit on the card at once: SMs x resident
    blocks per SM (the CUDA occupancy calculator, registers and shared
    memory) over ``pairs``, at least 1.  Cached per variant."""
    key = (name, kv_bits, g, pairs, torch.cuda.current_device())
    want = _wants.get(key)
    if want is None:
        want = build.load().lmd_paged_decode_want(_MODES[name], kv_bits, g,
                                                   pairs)
        build.check(min(want, 0), f'{name}: occupancy')
        _wants[key] = want
    return want


def decode_splits(max_pages: int, page_size: int, want: int) -> int:
    """Splits of the decode kernel's grid (KH, B, splits) for a page table
    of ``max_pages`` pages: ``want`` (each slot cuts its own context into
    at most that many splits of whole 64-token tiles, on the device), at
    most one per tile of the table, and enough that no split spans more
    than 126 pages.  Host values only: the contexts are not read."""
    width = max(max_pages * page_size, 1)
    cap = max(_TILE, (126 * page_size) // _TILE * _TILE)
    return max(-(-width // cap), min(want, -(-width // _TILE)))


def _counter(device, n: int) -> torch.Tensor:
    """The ticket counters of ``device`` (int32, at least ``n``), zeroed
    once when allocated; every launch leaves them at zero.  Never freed:
    a captured CUDA graph keeps their address."""
    c = _counters.get(device)
    if c is None or c.numel() < n:
        if c is not None:
            _outgrown.append(c)
        c = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _counters[device] = c
    return c


def _launch(name: str, q, k_new, v_new, cos_f, sin_f, qscale, k_cache,
            v_cache, layer: int, page_table, context_len, valid, qparams4,
            half: int = 0) -> torch.Tensor:
    """Check the operands and launch mode ``name`` of the decode kernel."""
    b, h, dh = q.shape
    kv_bits = kv_bits_of(k_cache)
    n_layers, _, page_size, kh, dp = k_cache.shape
    pool_dtype = KV_WIDTHS[kv_bits].dtype
    if (v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype
            or dp != (dh // 2 if kv_bits == 4 else dh)
            or page_table.shape[0] != b or context_len.numel() != b
            or not 0 <= layer < n_layers
            or any(t is not None and t.shape != (b, kh, dh)
                   for t in (k_new, v_new))
            or any(t is not None and t.numel() != b for t in (valid,
                                                              qscale))
            or any(t is not None and t.shape != (b, dh)
                   for t in (cos_f, sin_f))):
        raise ValueError(f'{name}: inconsistent shapes q{tuple(q.shape)} '
                         f'pool{tuple(k_cache.shape)} page_table'
                         f'{tuple(page_table.shape)} layer {layer}')
    bf = [t for t in (q, k_new, v_new) if t is not None]
    if any(t.dtype != torch.bfloat16 for t in bf) or \
            k_cache.dtype != pool_dtype:
        raise ValueError(f'{name}: bf16 q and K/V, and a bf16, int8 or '
                         f'uint8 (int4) pool only; got pool {k_cache.dtype}')
    if not all(t.is_contiguous() for t in bf + [k_cache, v_cache]):
        raise ValueError(f'{name}: contiguous operands only')
    if dh != 128 or h % kh or (h // kh) not in (1, 2, 4, 8) or \
            not 0 <= 2 * half <= dh:
        raise ValueError(f'{name}: unsupported H={h} KH={kh} Dh={dh} '
                         f'half={half}')
    qp = as_qparams4(qparams4, kv_bits, q.device)
    if qp is not None and (qp.numel() != 4 or not qp.is_contiguous()):
        raise ValueError(f'{name}: qparams4 must be 4 contiguous floats')

    def i32(t):
        return None if t is None else t.to(torch.int32).contiguous()

    def f32(t):
        return None if t is None else t.to(torch.float32).contiguous()
    ops = dict(page_table=i32(page_table), ctx=i32(context_len),
               valid=i32(valid), cos_f=f32(cos_f), sin_f=f32(sin_f),
               qscale=f32(qscale))
    max_pages = page_table.shape[1]
    want = SPLITS_WANTED or decode_want(name, kv_bits, h // kh, b * kh)
    splits = decode_splits(max_pages, page_size, want)
    part = counter = None
    if splits > 1:
        part = torch.empty(b * kh * splits * h // kh * (dh + 2),
                           dtype=torch.float32, device=q.device)
        counter = _counter(q.device, b * kh)

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    out = torch.empty_like(q)
    rc = build.load().lmd_paged_decode_attention(
        _MODES[name], ptr(q), ptr(k_new), ptr(v_new), ptr(ops['cos_f']),
        ptr(ops['sin_f']), ptr(ops['qscale']), k_cache[layer].data_ptr(),
        v_cache[layer].data_ptr(), ptr(ops['page_table']), ptr(ops['ctx']),
        ptr(ops['valid']), ptr(qp), out.data_ptr(), ptr(part), ptr(counter),
        b, h, kh, dh, page_size, max_pages, kv_bits, half, want, splits,
        dh ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, name)
    LAUNCHES[variant(name, kv_bits)] += 1
    return out


def paged_decode_attention(q, k_cache, v_cache, layer: int, page_table,
                           context_len, qparams4=None) -> torch.Tensor:
    """Kernel 4: decode attention over layer ``layer`` of the pool, whose
    current-token K/V the caller has already written.

    q: [B, KH*G, Dh] rope'd queries, kv-major; pool [L, P, page, KH, Dh]
    (bf16 / int8) or [L, P, page, KH, Dh/2] uint8 (int4); page_table int32
    [B, max_pages] (-1 unmapped); context_len int32 [B] INCLUDING this
    token; qparams4 f32 [4] of this layer for a quantised pool (host floats
    or a device tensor).  Returns [B, KH*G, Dh] in q.dtype."""
    if q.device.type == 'cpu':
        return paged_decode_attention_plain(q, k_cache, v_cache, layer,
                                            page_table, context_len,
                                            qparams4)
    return _launch('paged_decode_attention', q, None, None, None, None,
                   None, k_cache, v_cache, layer, page_table, context_len,
                   None, qparams4)


def paged_decode_attention_write(q, k_new, v_new, k_cache, v_cache,
                                 layer: int, page_table, context_len,
                                 valid, qparams4=None) -> torch.Tensor:
    """Kernel 2: append k_new/v_new [B, KH, Dh] at position context_len-1
    of layer ``layer`` (in place, quantised for an int8/int4 pool), then
    attend as :func:`paged_decode_attention`; valid [B] gates the store."""
    if q.device.type == 'cpu':
        return paged_decode_attention_write_plain(
            q, k_new, v_new, k_cache, v_cache, layer, page_table,
            context_len, valid, qparams4)
    return _launch('paged_decode_attention_write', q, k_new, v_new, None,
                   None, None, k_cache, v_cache, layer, page_table,
                   context_len, valid, qparams4)


def paged_decode_attention_rope_write(q, k_new, v_new, cos_f, sin_f,
                                      qscale, k_cache, v_cache, layer: int,
                                      page_table, context_len, valid,
                                      qparams4=None, *,
                                      half: int) -> torch.Tensor:
    """Kernel 5: as :func:`paged_decode_attention_write` with q and k_new
    UNROTATED: rope from cos_f/sin_f f32 [B, Dh] (:func:`rope_full_tables`)
    with ``half = rotary_dim // 2``, and q scaled by qscale f32 [B] (logn;
    ones when unused)."""
    if q.device.type == 'cpu':
        return paged_decode_attention_rope_write_plain(
            q, k_new, v_new, cos_f, sin_f, qscale, k_cache, v_cache, layer,
            page_table, context_len, valid, qparams4, half=half)
    return _launch('paged_decode_attention_rope_write', q, k_new, v_new,
                   cos_f, sin_f, qscale, k_cache, v_cache, layer,
                   page_table, context_len, valid, qparams4, half)


__all__ = ['paged_decode_attention', 'paged_decode_attention_plain',
           'paged_decode_attention_write',
           'paged_decode_attention_write_plain',
           'paged_decode_attention_rope_write',
           'paged_decode_attention_rope_write_plain', 'rope_full_tables',
           'rope_full', 'as_qparams4', 'gather_plain', 'decode_splits',
           'decode_want']
