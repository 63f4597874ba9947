"""Paged prefill (chunked context) attention: the kernel's wrapper, its
plain version, its route rule and its launch counters.

Replaces ``lmdeploy_tpu/ops/pallas/prefill_attention.py::
paged_prefill_attention_batched`` (``_prefill_kernel``) with
``lmdeploy_tpu_torch/csrc/paged_prefill_attention.cu`` (CUDA C++ for
sm_90a), at three KV widths: bf16, int8 and nibble-packed int4.  Causal
attention of chunk rows at positions ``start_pos[b] + t`` over the paged
history plus the chunk (whose K/V the caller already wrote), mask
``kv_pos <= q_pos and kv_pos < context_end[b]``, fp32 online softmax.
Padding rows (``context_end == start_pos``) are garbage on both sides and
are discarded upstream: the kernel writes zeros there, the JAX kernel the
mean of V over the first mapped page.  The TPU's 8-sublane verify q block
and VMEM limit are not ported; T need not be padded to a block.

The kernel has three routes; :func:`prefill_route` picks one from shapes
only (B, T, G, page size, KV width), never from the context values, so a
dispatch stays free of host syncs:

- ``split`` (T <= 8, T*G <= 64, B <= 256: the speculative verify's k+1
  rows and any short chunk).  Bound by the slot's K/V bytes (bs1,
  Llama-2-7B, ctx 512: 8.4 MB a layer, 2.5 us at 3.35 TB/s).  All T*G
  rows of a kv head share one block; the grid is (KH, W) with W workers
  per kv head (the card's resident blocks over KH, :func:`split_workers`),
  and every block derives the same plan from the contexts on the device
  (:func:`split_plan`): each live slot's context in 64-token tiles, about
  W splits in all, so a bs1 request among padding slots uses every
  worker.  Splits merge by log-sum-exp in split order (the last to finish
  merges, through a self-resetting ticket per slot and kv head), so two
  calls give the same bits.
- ``wgmma`` (the chunks: every shape ``split`` does not take, at a page
  size that divides 64 or is a multiple of it).  Bound by bytes and operations together (512-token bf16 chunk
  from 0: 16.8 MB, 5.0 us; 2.1 GFLOP, 2.2 us at 989 TF/s).  A
  warp-specialised block: one producer lane keeps TMA loads of 64-token
  K/V tiles in a 3-stage mbarrier ring (one tensor map per pool, cached
  on the host), one consumer warpgroup on 64 query rows runs
  ``S = Q K^T`` (wgmma m64n64k16) and ``O += P V`` (m64n128k16, V through
  a transposed-B descriptor) with the online softmax in registers; int8 /
  int4 tiles arrive raw and the consumers stage their codes as bf16
  (exact) before the same products.  It does not split the context: on
  an H100 every split count measured slower than one at chip_smoke.py's
  chunk shapes.
- ``mma`` (the rest: shapes ``split`` does not take at a page size that
  neither divides 64 nor is a multiple of it, which TMA's box plan does
  not take).  FlashAttention-2 on mma.sync m16n8k16: 16-row warps, 64-token
  KV tiles through a cp.async ring (int codes through registers), Q held
  in registers, P fed from registers to P V.  Route ``split`` runs this
  body.

Quantised pools are staged as their integer codes (exact in bf16) and the
static per-layer ``qparams4`` are applied in f32 to the scores and the
output.  The one rounding the JAX kernel does not make is that of P for
the tensor cores: P enters P V as two bf16 terms (``bf16(p)`` and
``bf16(p - bf16(p))``), ~2^-17 relative per weight; P in one bf16 term
(2^-9) moves some bf16 outputs of rows with few keys by one ulp, 2^-6 at
|x| in [2, 4), past the 1e-2 gate (``tests/test_torch_prefill_numerics.py``
emulates both; ``chip_smoke.py --phases probe,build,breakdown`` times
the one-term form on the card).

Every launch counts under ``paged_prefill_attention[<width>]`` and under
``paged_prefill_attention[<width>]:<route>``.  On a CPU tensor the wrapper
runs :func:`paged_prefill_attention_plain`; on a CUDA tensor it launches
the kernel or raises.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ...kvcache.paged import KV_WIDTHS, kv_bits_of
from ..attention import gqa_attention
from . import build
from .counts import LAUNCHES, PLAIN_CALLS, variant
from .paged_attention import as_qparams4, gather_plain

NAME = 'paged_prefill_attention'
ROUTES = ('split', 'wgmma', 'mma')
_ROUTE_IDS = {'mma': 0, 'split': 1, 'wgmma': 2}
TILE = 64
SPLIT_MAX_T = 8        # route split: the verify's k+1 rows and short chunks
SPLIT_MAX_ROWS = 64    # T*G rows of one block
SPLIT_MAX_SLOTS = 256  # the device plan's per-slot counts in shared memory

# Measurement and test override: True sends every call to route mma (the
# body kernel 3 had before its routes), whatever prefill_route says.
FORCE_MMA = False

_capacity: dict = {}
_counters: dict = {}
_outgrown: list = []     # counters a CUDA graph may still hold


def prefill_route(b: int, t: int, h: int, kh: int, page_size: int,
                  kv_bits: int) -> str:
    """The route a call of these shapes takes (see the module note)."""
    g = h // kh
    if t <= SPLIT_MAX_T and t * g <= SPLIT_MAX_ROWS and \
            b <= SPLIT_MAX_SLOTS:
        return 'split'
    if page_size % TILE == 0 or TILE % page_size == 0:
        return 'wgmma'
    return 'mma'


def split_plan(context_end, start_pos, workers: int, kv_cap: int
               ) -> Tuple[int, List[Tuple[int, int, int, int, int]]]:
    """Route split's plan, as every block computes it on the device:
    ``(per, items)``, items ``(slot, split, n_splits, first tile, end
    tile)`` in item order; item i goes to worker ``i % workers``.  A live
    slot (``context_end > start_pos``) covers ``[0, min(context_end,
    kv_cap))`` in 64-token tiles, ``per`` tiles a split, ``per`` chosen so
    that all live slots' splits number about ``workers``; padding slots
    have none (the kernel zeroes their rows)."""
    tiles = [-(-min(int(e), kv_cap) // TILE) if int(e) > int(s) else 0
             for e, s in zip(context_end, start_pos)]
    per = max(1, -(-sum(tiles) // workers))
    items = []
    for b, n_t in enumerate(tiles):
        n = -(-n_t // per)
        items += [(b, s, n, s * per, min((s + 1) * per, n_t))
                  for s in range(n)]
    return per, items


def split_workers(kh: int, b: int, table_tiles: int, capacity: int) -> int:
    """Workers per kv head of route split's grid: the card's resident
    blocks over KH, at most one per tile the batch's table can hold."""
    return max(1, min(capacity // kh, b * table_tiles))


def split_capacity(kv_bits: int, rows: int) -> int:
    """Route split's blocks at this width and T*G the card holds at once
    (SMs x resident blocks per SM, the occupancy calculator); cached per
    variant and device."""
    key = (kv_bits, rows, torch.cuda.current_device())
    cap = _capacity.get(key)
    if cap is None:
        cap = build.load().lmd_paged_prefill_capacity(_ROUTE_IDS['split'],
                                                      kv_bits, rows)
        build.check(min(cap, 0), f'{NAME}: occupancy')
        _capacity[key] = cap
    return cap


def _counter(device, n: int) -> torch.Tensor:
    """The ticket counters of ``device`` (int32, at least ``n``), zeroed
    once when allocated; every launch leaves them at zero.  Never freed:
    a captured CUDA graph keeps their address."""
    c = _counters.get(device)
    if c is None or c.numel() < n:
        if c is not None:
            _outgrown.append(c)
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[device] = c
    return c


def paged_prefill_attention_plain(q, k_cache, v_cache, layer: int,
                                  page_tables, start_pos, context_end,
                                  qparams4=None) -> torch.Tensor:
    """Plain PyTorch version: gather the slot's pages, dequantise, masked
    softmax."""
    kv_bits = kv_bits_of(k_cache)
    PLAIN_CALLS[variant(NAME, kv_bits)] += 1
    qp = as_qparams4(qparams4, kv_bits, q.device)
    t = q.shape[1]
    kk, vv = gather_plain(k_cache, v_cache, layer, page_tables, qp)
    q_pos = start_pos.long()[:, None] + torch.arange(t, device=q.device)
    return gqa_attention(q, kk, vv, q_pos, context_end)


def paged_prefill_attention(q, k_cache, v_cache, layer: int, page_tables,
                            start_pos, context_end,
                            qparams4=None) -> torch.Tensor:
    """q: [B, T, KH*G, Dh] rope'd chunk queries; pool [L, P, page, KH, Dh]
    (bf16 / int8) or [L, P, page, KH, Dh/2] uint8 (int4) with the chunk's
    K/V written; page_tables int32 [B, max_pages]; start_pos / context_end
    int32 [B]; qparams4 f32 [4] of this layer for a quantised pool.
    Returns [B, T, KH*G, Dh]."""
    if q.device.type == 'cpu':
        return paged_prefill_attention_plain(q, k_cache, v_cache, layer,
                                             page_tables, start_pos,
                                             context_end, qparams4)
    return _launch(q, k_cache, v_cache, layer, page_tables, start_pos,
                   context_end, qparams4)


def _launch(q, k_cache, v_cache, layer: int, page_tables, start_pos,
            context_end, qparams4) -> torch.Tensor:
    """Check the operands, pick the route and launch the kernel."""
    b, t, h, dh = q.shape
    kv_bits = kv_bits_of(k_cache)
    n_layers, n_pages, page_size, kh, dp = k_cache.shape
    pool_dtype = KV_WIDTHS[kv_bits].dtype
    if (v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype
            or dp != (dh // 2 if kv_bits == 4 else dh)
            or page_tables.shape[0] != b or start_pos.numel() != b
            or context_end.numel() != b or not 0 <= layer < n_layers):
        raise ValueError(f'{NAME}: inconsistent shapes q{tuple(q.shape)} '
                         f'pool{tuple(k_cache.shape)} page_tables'
                         f'{tuple(page_tables.shape)} layer {layer}')
    if q.dtype != torch.bfloat16 or k_cache.dtype != pool_dtype:
        raise ValueError(f'{NAME}: bf16 q and a bf16, int8 or uint8 (int4) '
                         f'pool only; got pool {k_cache.dtype}')
    if not all(x.is_contiguous() for x in (q, k_cache, v_cache)):
        raise ValueError(f'{NAME}: contiguous operands only')
    if dh != 128 or h % kh or 64 % (h // kh):
        raise ValueError(f'{NAME}: unsupported H={h} KH={kh} Dh={dh}')
    qp = as_qparams4(qparams4, kv_bits, q.device)
    if qp is not None and (qp.numel() != 4 or not qp.is_contiguous()):
        raise ValueError(f'{NAME}: qparams4 must be 4 contiguous floats')
    pt = page_tables.to(torch.int32).contiguous()
    sp = start_pos.to(torch.int32).contiguous()
    ce = context_end.to(torch.int32).contiguous()
    max_pages = pt.shape[1]
    route = 'mma' if FORCE_MMA else prefill_route(b, t, h, kh, page_size,
                                                   kv_bits)
    rows = t * (h // kh)
    table_tiles = max(1, -(-max_pages * page_size // TILE))
    part = counter = None
    splits = 1
    if route == 'split':
        splits = split_workers(kh, b, table_tiles,
                               split_capacity(kv_bits, rows))
        if splits > 1:
            part = torch.empty(kh * (b + splits) * rows * (dh + 2),
                               dtype=torch.float32, device=q.device)
            counter = _counter(q.device, b * kh)

    def ptr(x):
        return 0 if x is None else x.data_ptr()
    out = torch.empty_like(q)
    rc = build.load().lmd_paged_prefill_attention(
        _ROUTE_IDS[route], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), pt.data_ptr(), sp.data_ptr(), ce.data_ptr(),
        ptr(qp), out.data_ptr(), ptr(part), ptr(counter), b, t, h, kh, dh,
        n_layers, n_pages, layer, page_size, max_pages, kv_bits, splits,
        dh ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, NAME)
    name = variant(NAME, kv_bits)
    LAUNCHES[name] += 1
    LAUNCHES[f'{name}:{route}'] += 1
    return out


__all__ = ['paged_prefill_attention', 'paged_prefill_attention_plain',
           'prefill_route', 'split_plan', 'split_workers', 'ROUTES']
