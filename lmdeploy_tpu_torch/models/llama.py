"""Llama-family transformer in PyTorch — the port's engine core.

Port of ``lmdeploy_tpu/models/llama.py``: one step function for prefill
([B, T] chunks) and decode ([B, 1] steps); both append K/V into the paged
pool and attend over it.  The JAX ``lax.scan`` over stacked layer weights
becomes a Python loop over the same stacked ``[L, ...]`` tensors.  Per
layer:

  rms_norm -> W4A16 wqkv -> rope -> attention -> W4A16 wo (+ residual)
  -> rms_norm -> W4A16 w1, w3 -> silu * up -> W4A16 w2 (+ residual)

Attention is the hand-written kernels' path, at every KV width of the
pool (bf16, int8, nibble-packed int4 with static per-layer qparams).
Decode (T == 1) takes one of three routes, chosen by the JAX package's
two switches with its defaults:

- ``LMDEPLOY_TPU_FUSED_ATTN`` (default 1): the fused KV-append + paged
  attention kernel;
- ``LMDEPLOY_TPU_FUSED_ATTN=0``: :func:`write_kv`, then the attend-only
  kernel;
- ``LMDEPLOY_TPU_FUSED_ROPE=1`` (default 0, with fused attention): rope,
  append and attend in one kernel.

Chunks (T > 1) scatter their K/V (:func:`write_kv`) and run the paged
prefill kernel.  The pool is updated in place.  The lm_head is a plain
``torch.matmul``, as the JAX package leaves it to XLA.

An int4 pool with dynamic or per-head qparams takes the JAX package's
gather route for such pools on every device, the card included (its
kernels read static per-layer qparams only): every decode, prefill and
verify step stores its K/V (:func:`write_kv_dynamic`, or :func:`write_kv`
with per-head qparams), gathers and dequantises the layer's pages
(:func:`gather_kv_layer_dynamic` / :func:`gather_kv_layer`) and runs
``ops/attention.py::gqa_attention``.

:func:`forward_layers` takes an optional calibration ``hook`` (see there).

Profiler ranges (``utils/profiler.py::span``, opened only while torch's
profiler records on the calling thread): ``llama.embed``, ``llama.rope``
(the step's rope tables), per layer ``llama.attn`` (norm, wqkv, rope,
attention with the KV write, wo and its residual add) and ``llama.ffn``
(norm, w1 / w3, the activation, w2 and its residual add), then
``llama.lm_head`` (final norm, lm_head, the vocab gather).

Golden-file debugging (``utils/debug.py``, ``LMDEPLOY_TPU_DEBUG=dump|cmp``)
records ``layer_out`` (the residual stream after each layer's FFN add, in
layer order) and ``logits`` (after the vocab gather), where the JAX
package's forward records them, so the ``n`` of ``{name}.{n}.npy`` names
the same tensor in both packages for forwards of identical
:class:`StepBatch` shapes.  With several ranks each rank records its own
activations (a stage its own layers) into the one shared directory, each
with its own counters, so ranks overwrite one another's files: record one
rank's run.  With the mode off the hooks return at once (no launch, no
host sync).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import ModelConfig
from ..kvcache.paged import (KVCache, gather_kv_layer,
                             gather_kv_layer_dynamic, write_kv,
                             write_kv_dynamic)
from ..ops.attention import gqa_attention
from ..ops.cuda.paged_attention import (paged_decode_attention,
                                        paged_decode_attention_rope_write,
                                        paged_decode_attention_write,
                                        rope_full_tables)
from ..ops.cuda.prefill_attention import paged_prefill_attention
from ..ops.linear import (PackedInt4Weight, QuantizedWeight, linear,
                          pack_quantized, packed_int4_enabled,
                          quant_matmul_packed, quantize_weight_int4)
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope_qk, rope_tables
from ..utils.debug import dbg
from ..utils.profiler import span


def fused_attn_enabled() -> bool:
    """Decode through the fused append + attend kernel (the JAX package's
    ``LMDEPLOY_TPU_FUSED_ATTN``, default on)."""
    return os.environ.get('LMDEPLOY_TPU_FUSED_ATTN', '1') == '1'


def fused_rope_enabled() -> bool:
    """Rope inside the fused decode kernel (the JAX package's
    ``LMDEPLOY_TPU_FUSED_ROPE``, default off)."""
    return os.environ.get('LMDEPLOY_TPU_FUSED_ROPE', '0') == '1'


@dataclasses.dataclass
class StepBatch:
    """Inputs of one engine step (prefill chunk or decode step)."""
    ids: torch.Tensor          # int [B, T]
    positions: torch.Tensor    # int [B, T] absolute positions
    valid: torch.Tensor        # bool [B, T]
    context_len: torch.Tensor  # int [B] total ctx len incl. this step
    page_table: torch.Tensor   # int32 [B, max_pages]


def vocab_padded(cfg: ModelConfig, tp: int = 1) -> int:
    """Vocab padded to a multiple of 128*tp (the JAX package's layout)."""
    m = 128 * tp
    return (cfg.vocab_size + m - 1) // m * m


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device='cuda') -> Dict[str, Any]:
    """Random-init dense parameters, normal(0, 0.02), drawn from
    ``generator`` (which must live on ``device``)."""
    d, dh = cfg.hidden_size, cfg.size_per_head
    h, kh, inter, nl = (cfg.head_num, cfg.kv_head_num, cfg.inter_size,
                        cfg.num_layer)
    vp = vocab_padded(cfg)

    def w(*shape):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * 0.02).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers: Dict[str, Any] = {
        'attn_norm': ones(nl, d), 'ffn_norm': ones(nl, d),
        'wqkv': w(nl, d, (h + 2 * kh) * dh), 'wo': w(nl, h * dh, d),
        'w1': w(nl, d, inter), 'w3': w(nl, d, inter), 'w2': w(nl, inter, d),
    }
    if cfg.attn_bias:
        layers['bqkv'] = torch.zeros((nl, (h + 2 * kh) * dh), dtype=dtype,
                                     device=device)
        if not cfg.qkv_bias_only:
            layers['bo'] = torch.zeros((nl, d), dtype=dtype, device=device)
    params = {'tok_embedding': w(vp, d), 'norm': ones(d), 'layers': layers}
    if not cfg.tie_word_embeddings:
        params['lm_head'] = w(d, vp)
    return params


def random_packed_params(cfg: ModelConfig, seed: int,
                         device='cuda') -> Dict[str, Any]:
    """Random W4A16 parameters drawn directly as nibble-packed bytes from
    a seeded generator on ``device``: group ``cfg.group_size`` (128 when
    unset), constant scale 0.002 and zero point 8, bf16 normal(0, 0.02)
    embedding and lm_head, as the JAX bench draws its weights
    (``bench.py::random_int4_params``).  Nothing is downloaded."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d, g = cfg.hidden_size, cfg.group_size or 128
    dh, h, kh, inter, nl = (cfg.size_per_head, cfg.head_num, cfg.kv_head_num,
                            cfg.inter_size, cfg.num_layer)
    bf = torch.bfloat16

    def qw(k, n):
        return PackedInt4Weight(
            packed=torch.randint(0, 256, (nl, k // 2, n), generator=gen,
                                 dtype=torch.uint8, device=device),
            scales=torch.full((nl, k // g, 1, n), 0.002, dtype=bf,
                              device=device),
            sz=torch.full((nl, k // g, n), 0.002 * 8.0, dtype=bf,
                          device=device))

    def normal(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02
                ).to(bf)

    vp = vocab_padded(cfg)
    return {
        'tok_embedding': normal(vp, d),
        'norm': torch.ones((d,), dtype=bf, device=device),
        'lm_head': normal(d, vp),
        'layers': {
            'attn_norm': torch.ones((nl, d), dtype=bf, device=device),
            'ffn_norm': torch.ones((nl, d), dtype=bf, device=device),
            'wqkv': qw(d, (h + 2 * kh) * dh), 'wo': qw(h * dh, d),
            'w1': qw(d, inter), 'w3': qw(d, inter), 'w2': qw(inter, d),
        },
    }


def quantize_params(params: Dict[str, Any], cfg: ModelConfig,
                    group_size: int = 128) -> Dict[str, Any]:
    """The five projection families -> stacked W4A16 QuantizedWeight
    (norms, biases, embedding and lm_head stay dense)."""
    layers = dict(params['layers'])
    for name in ('wqkv', 'wo', 'w1', 'w3', 'w2'):
        stacked = layers[name]
        dev = stacked.device
        qws = [quantize_weight_int4(stacked[i].float().cpu().numpy(),
                                    group_size)
               for i in range(stacked.shape[0])]
        layers[name] = QuantizedWeight(
            qvals=torch.stack([q.qvals for q in qws]).to(dev),
            scales=torch.stack([q.scales for q in qws]).to(dev),
            zeros=torch.stack([q.zeros for q in qws]).to(dev))
    out = dict(params)
    out['layers'] = layers
    return out


def packable(w) -> bool:
    """Whether a QuantizedWeight can take nibble-packed residency (even K
    and group count; N a multiple of 16 for the kernel's vector loads)."""
    g = w.scales.shape[-2]
    return w.k % 2 == 0 and g % 2 == 0 and w.n % 16 == 0


def pack_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Stacked QuantizedWeight layers -> PackedInt4Weight where packable
    (a tree with nothing to pack comes back as it is)."""
    layers = params.get('layers', {})
    packed = {name: pack_quantized(w) for name, w in layers.items()
              if isinstance(w, QuantizedWeight) and packable(w)}
    if not packed:
        return params
    return dict(params, layers=dict(layers, **packed))


def _split_qkv(qkv: torch.Tensor, cfg: ModelConfig, tp: int = 1):
    """[B, T, (H + 2KH)/tp * Dh] -> q [B,T,H/tp,Dh], k/v [B,T,KH/tp,Dh]."""
    b, t, _ = qkv.shape
    h, kh, dh = cfg.head_num // tp, cfg.kv_head_num // tp, cfg.size_per_head
    qkv = qkv.reshape(b, t, h + 2 * kh, dh)
    return (qkv[:, :, :h].contiguous(), qkv[:, :, h:h + kh].contiguous(),
            qkv[:, :, h + kh:].contiguous())


def embed_tokens(params: Dict[str, Any], ids: torch.Tensor) -> torch.Tensor:
    """[B, T] -> [B, T, D] embedding lookup."""
    with span('llama.embed'):
        return params['tok_embedding'][ids.long()]


def _layer_linear(x: torch.Tensor, w, layer: int,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One projection of layer ``layer``; output in x.dtype."""
    if isinstance(w, PackedInt4Weight):
        lead = x.shape[:-1]
        out = quant_matmul_packed(x.reshape(-1, x.shape[-1]), w, layer)
        out = out.reshape(*lead, -1).to(x.dtype)
        return out if bias is None else out + bias.to(out.dtype)
    if isinstance(w, QuantizedWeight):
        # byte-per-int4: ops/linear.py's group, dequant or W4A8 product, as
        # the JAX package serves this form with XLA.  On the card only when
        # the user chose it (LMDEPLOY_TPU_PACKED_INT4=0); with packed
        # residency a weight left in this form is one the kernel cannot take
        if x.device.type != 'cpu' and packed_int4_enabled():
            raise NotImplementedError(
                f'byte-per-int4 W4A16 weight K={w.k} N={w.n} with '
                f'{w.scales.shape[-2]} groups on the card: packed residency '
                'serves W4A16 only nibble-packed (packable: N % 16 == 0 and '
                'an even group count); LMDEPLOY_TPU_PACKED_INT4=0 serves '
                'the byte form')
        w = QuantizedWeight(qvals=w.qvals[layer], scales=w.scales[layer],
                            zeros=w.zeros[layer])
    else:
        w = w[layer]
    return linear(x, w, bias)


def forward_layers(params: Dict[str, Any], cache: KVCache, batch: StepBatch,
                   h: torch.Tensor, cfg: ModelConfig,
                   hook: Optional[Callable[[int, str, torch.Tensor], None]]
                   = None, group=None) -> torch.Tensor:
    """The layer loop on an embedded activation [B, T, D]; returns the
    final hidden state.  The pool is updated in place.

    ``group``: the tensor-parallel process group (None: one rank).  Each
    rank holds its ``parallel/tp.py::shard_params`` block and KV heads
    ``kv_head_num / tp`` of the pool; the outputs of wo and w2 are summed
    over the group in the activation dtype before any bias, where the JAX
    package calls ``psum``.

    ``hook(layer, name, x)``, when given, sees each projection's input
    (``'attn_in'``: the attention norm's output, the input of wqkv;
    ``'attn_out'``: the attention output before wo; ``'ffn_in'``: the FFN
    norm's output, the input of w1 and w3; ``'ffn_act'``: silu(gate) * up,
    the input of w2) and the post-rope K (``'k'``) and the V (``'v'``)
    that the layer stores, [B, T, KH, Dh].  With a hook, rope runs outside
    the decode kernel so that the hook sees it applied."""
    b, t = batch.ids.shape
    dh = cfg.size_per_head
    tp = 1 if group is None else dist.get_world_size(group)
    # static qparams on the device: per-layer [L, 4] rows (the kernels read
    # a row) or per-head [L, 4, KH]
    qp = cache.qparams if cache.quantized else None
    # dynamic or per-head int4 qparams: the gather route (no kernel reads
    # them), as in the JAX package
    gather = cache.dynamic_scales or cache.per_head
    fused_attn = fused_attn_enabled() and not gather
    fused_rope = (t == 1 and fused_attn and fused_rope_enabled()
                  and hook is None)
    with span('llama.rope'):
        tables = rope_tables(
            batch.positions, batch.context_len,
            rotary_dim=cfg.rotary_embedding, base=cfg.rope_theta,
            max_position_embeddings=cfg.max_position_embeddings,
            use_dynamic_ntk=cfg.use_dynamic_ntk,
            use_logn_attn=cfg.use_logn_attn,
            rope_scaling_type=cfg.rope_scaling_type,
            rope_scaling_factor=cfg.rope_scaling_factor,
            rope_original_max=cfg.rope_original_max_position,
            rope_low_freq_factor=cfg.rope_low_freq_factor,
            rope_high_freq_factor=cfg.rope_high_freq_factor)
        if fused_rope:
            cos_f, sin_f = rope_full_tables(tables[0][:, 0],
                                            tables[1][:, 0], dh)
            qscale = (tables[2][:, 0].float() if tables[2] is not None
                      else torch.ones((b,), dtype=torch.float32,
                                      device=h.device))
    lw = params['layers']
    # the layers this rank holds: all of them, or a pipeline stage's
    # (parallel/pp.py); layer indices into the weights and the pool are
    # local to the stage
    for li in range(lw['attn_norm'].shape[0]):
        with span('llama.attn'):
            bqkv = lw['bqkv'][li] if 'bqkv' in lw else None
            x = rms_norm(h, lw['attn_norm'][li], cfg.norm_eps)
            if hook is not None:
                hook(li, 'attn_in', x)
            q, k, v = _split_qkv(_layer_linear(x, lw['wqkv'], li, bqkv),
                                 cfg, tp)
            qp_l = None if qp is None else qp[li]
            if not fused_rope:
                q, k = apply_rope_qk(q, k, tables)
                if hook is not None:
                    hook(li, 'k', k)
                    hook(li, 'v', v)
            if fused_rope:
                # q and k arrive unrotated: rope, append and attend, one
                # kernel
                o = paged_decode_attention_rope_write(
                    q[:, 0], k[:, 0], v[:, 0], cos_f, sin_f, qscale,
                    cache.k, cache.v, li, batch.page_table,
                    batch.context_len, batch.valid[:, 0], qp_l,
                    half=cfg.rotary_embedding // 2)
                o = o[:, None]
            elif t == 1 and fused_attn:
                o = paged_decode_attention_write(
                    q[:, 0], k[:, 0].contiguous(), v[:, 0].contiguous(),
                    cache.k, cache.v, li, batch.page_table,
                    batch.context_len, batch.valid[:, 0], qp_l)[:, None]
            elif gather:
                if cache.dynamic_scales:
                    write_kv_dynamic(cache.k, cache.v, cache.dyn, li, k, v,
                                     batch.positions, batch.page_table,
                                     batch.valid)
                    kk, vv = gather_kv_layer_dynamic(
                        cache.k[li], cache.v[li], cache.dyn[li],
                        batch.page_table, dtype=q.dtype)
                else:
                    write_kv(cache.k, cache.v, li, k, v, batch.positions,
                             batch.page_table, batch.valid, qp_l)
                    kk, vv = gather_kv_layer(cache.k[li], cache.v[li],
                                             batch.page_table,
                                             qp_l.unbind(), dtype=q.dtype)
                o = gqa_attention(q, kk, vv, batch.positions,
                                  batch.context_len)
            else:
                write_kv(cache.k, cache.v, li, k, v, batch.positions,
                         batch.page_table, batch.valid, qp_l)
                if t == 1:
                    o = paged_decode_attention(
                        q[:, 0], cache.k, cache.v, li, batch.page_table,
                        batch.context_len, qp_l)[:, None]
                else:
                    o = paged_prefill_attention(q, cache.k, cache.v, li,
                                                batch.page_table,
                                                batch.positions[:, 0],
                                                batch.context_len, qp_l)
            o = o.reshape(b, t, -1)
            if hook is not None:
                hook(li, 'attn_out', o)
            o = _layer_linear(o, lw['wo'], li)
            if group is not None:
                dist.all_reduce(o, group=group)
            if 'bo' in lw:
                o = o + lw['bo'][li]
            h = h + o
        with span('llama.ffn'):
            x = rms_norm(h, lw['ffn_norm'][li], cfg.norm_eps)
            if hook is not None:
                hook(li, 'ffn_in', x)
            gate = _layer_linear(x, lw['w1'], li)
            up = _layer_linear(x, lw['w3'], li)
            act = F.silu(gate.float()).to(up.dtype) * up
            if hook is not None:
                hook(li, 'ffn_act', act)
            f = _layer_linear(act, lw['w2'], li)
            if group is not None:
                dist.all_reduce(f, group=group)
            h = h + f
        dbg('layer_out', h)
    return h


def _gather_logits(logits: torch.Tensor, group) -> torch.Tensor:
    """The vocab shards' logits, concatenated on every rank (reference:
    LlamaV2.cc:360): each rank places its block in a zeroed full-vocab
    buffer and the group sums them, exactly (x + 0 = x), over the one
    collective that NCCL and gloo both take on CUDA tensors."""
    tp, rank = dist.get_world_size(group), dist.get_rank(group)
    v = logits.shape[-1]
    full = logits.new_zeros((*logits.shape[:-1], v * tp))
    full[..., rank * v:(rank + 1) * v] = logits
    dist.all_reduce(full, group=group)
    return full


def lm_head_logits(params: Dict[str, Any], h_out: torch.Tensor,
                   batch: StepBatch, cfg: ModelConfig, *,
                   return_all_logits: bool = False,
                   logits_count: Optional[int] = None,
                   group=None) -> torch.Tensor:
    """Final norm + lm_head -> f32 logits: [B, V] at each row's last valid
    token, or [B, T, V] with ``return_all_logits``.  Under a ``group`` the
    lm_head is each rank's vocab block, in the group's rank order, and the
    logits are gathered: the tp group, or under pp the vocab group of
    every stage's tp ranks (``parallel/pp.py``)."""
    with span('llama.lm_head'):
        h_out = rms_norm(h_out, params['norm'], cfg.norm_eps)
        if return_all_logits and logits_count is not None:
            h_out = h_out[:, :logits_count]
        if not return_all_logits:
            last = torch.clamp(batch.valid.sum(dim=1) - 1, min=0)
            h_out = h_out[torch.arange(h_out.shape[0], device=h_out.device),
                          last]
        lm_head = params.get('lm_head')
        if lm_head is None:
            lm_head = params['tok_embedding'].T
        lead = h_out.shape[:-1]
        h2 = h_out.reshape(-1, h_out.shape[-1]).to(lm_head.dtype)
        if h2.is_cuda and h2.dtype != torch.float32:
            # bf16 product, f32 output (the JAX preferred_element_type)
            logits = torch.mm(h2, lm_head, out_dtype=torch.float32)
        else:
            # the CPU has no bf16 GEMM with an f32 output: the same bf16
            # values multiplied in f32 (each product exact), f32 logits
            logits = torch.mm(h2.float(), lm_head.float())
        logits = logits.reshape(*lead, -1)
        if group is not None:
            logits = _gather_logits(logits, group)
        dbg('logits', logits)
    return logits


def forward(params: Dict[str, Any], cache: KVCache, batch: StepBatch,
            cfg: ModelConfig, *, return_all_logits: bool = False,
            logits_count: Optional[int] = None, group=None):
    """One step: embed -> layers -> final norm -> lm_head.

    Returns (logits, cache): logits [B, V] (last valid position per row) or
    [B, T, V]; ``cache`` is the same pool object, updated in place.
    ``group``: the tensor-parallel process group (:func:`forward_layers`);
    the logits are full-vocab on every rank."""
    h = embed_tokens(params, batch.ids)
    h = forward_layers(params, cache, batch, h, cfg, group=group)
    logits = lm_head_logits(params, h, batch, cfg,
                            return_all_logits=return_all_logits,
                            logits_count=logits_count, group=group)
    return logits, cache


def mask_vocab_padding(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """-1e30 on padded vocab columns before sampling."""
    v = logits.shape[-1]
    if v == vocab_size:
        return logits
    pad = torch.arange(v, device=logits.device) >= vocab_size
    return logits.masked_fill(pad, -1e30)


__all__ = ['StepBatch', 'fused_attn_enabled', 'fused_rope_enabled',
           'vocab_padded', 'init_params', 'random_packed_params',
           'quantize_params',
           'packable', 'pack_params', 'embed_tokens', 'forward_layers',
           'lm_head_logits', 'forward', 'mask_vocab_padding']
