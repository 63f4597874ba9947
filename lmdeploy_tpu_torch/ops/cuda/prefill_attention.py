"""Paged prefill (chunked context) attention: the kernel's wrapper, its
plain version and its launch counter.

Replaces ``lmdeploy_tpu/ops/pallas/prefill_attention.py::
paged_prefill_attention_batched`` (``_prefill_kernel``) with
``lmdeploy_tpu_torch/csrc/paged_prefill_attention.cu`` (CUDA C++ for
sm_90a, grid (B, ceil(T/QB), KH), QB = 64/G query tokens per block), at
three KV widths: bf16, int8 and nibble-packed int4, the last two
dequantised with static per-layer ``qparams4`` as the KV tile is loaded.
The TPU's 8-sublane verify q block and VMEM limit are not ported; T need
not be padded to a block.

Causal attention of chunk rows at positions ``start_pos[b] + t`` over the
paged history plus the chunk (whose K/V the caller already wrote), mask
``kv_pos <= q_pos and kv_pos < context_end[b]``, fp32 online softmax.
Padding rows (``context_end == start_pos``) are garbage on both sides and
are discarded upstream: the kernel writes zeros there, the JAX kernel the
mean of V over the first mapped page.

Bound on an H100 SXM (3.35 TB/s): the bytes of q, out and the visible KV
(Llama-2-7B, 512-token chunk from 0, bf16 pool: ~16.8 MB per layer ~ 5
us; ~2.1 GFLOP).  This first kernel is SIMT fp32.

On a CPU tensor the wrapper runs :func:`paged_prefill_attention_plain`;
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ...kvcache.paged import KV_WIDTHS, kv_bits_of
from ..attention import gqa_attention
from . import build
from .counts import LAUNCHES, PLAIN_CALLS, variant
from .paged_attention import as_qparams4, gather_plain

NAME = 'paged_prefill_attention'


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
    """Check the operands and launch the kernel."""
    b, t, h, dh = q.shape
    kv_bits = kv_bits_of(k_cache)
    n_layers, _, page_size, kh, dp = k_cache.shape
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
    out = torch.empty_like(q)
    rc = build.load().lmd_paged_prefill_attention(
        q.data_ptr(), k_cache[layer].data_ptr(), v_cache[layer].data_ptr(),
        pt.data_ptr(), sp.data_ptr(), ce.data_ptr(),
        0 if qp is None else qp.data_ptr(), out.data_ptr(),
        b, t, h, kh, dh, page_size, pt.shape[1], kv_bits, dh ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, NAME)
    LAUNCHES[variant(NAME, kv_bits)] += 1
    return out


__all__ = ['paged_prefill_attention', 'paged_prefill_attention_plain']
