"""The plain reference: the published Llama-family forward in float32.

Plain PyTorch, imports nothing of the program.  It reads the weight bytes
that the harness's maker drew (``weights.py``) and dequantises them
itself: a W4A16 weight is nibble-packed [K/2, N] (row k < K/2 in the low
nibble, row K/2 + k in the high one), with per-group bf16 scales s and
s * z, and w = q * s - s * z.  Whatever the program derives from those
bytes (Qwen-14B's w2 padded to an even group count, the packed layout of
each kernel) is not read: the reference works from the raw bytes at the
published shapes.

Per layer, as the published models compute it (HF Llama / InternLM /
Qwen): RMSNorm, the qkv projection (+ Qwen's qkv bias), rotary embedding
(rotate-half pairing; Qwen's dynamic NTK base and logn query scaling past
``max_position_embeddings``, from the whole sequence as one forward does),
causal softmax attention at Dh^-0.5, the output projection, RMSNorm,
silu(x W1) * (x W3) W2, residual adds; a final RMSNorm and the lm_head.
Everything is float32 with TF32 off.

With ``kv``, K and V are stored through static per-layer qparams, as a
quantised pool stores them: q = clip(round(x / scale + zp)) into
[-128, 127] (8 bits) or [-8, 7] (4 bits), read back as (q - zp) * scale.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

PROJ = ('wqkv', 'wo', 'w1', 'w3', 'w2')


def highest_precision() -> None:
    """Float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')


def unpack(packed: torch.Tensor) -> torch.Tensor:
    """[K/2, N] nibble-packed bytes -> [K, N] values 0..15."""
    return torch.cat([packed & 0xF, packed >> 4], dim=-2)


def dequant(w: Dict[str, torch.Tensor], layer: int) -> torch.Tensor:
    """Layer ``layer`` of a W4A16 weight as float32 [K, N]."""
    q = unpack(w['packed'][layer]).float()
    k, n = q.shape
    s = w['scales'][layer].float()
    sz = w['sz'][layer].float()
    g = s.shape[0]
    return (q.view(g, k // g, n) * s[:, None] - sz[:, None]).view(k, n)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def kv_round(x: torch.Tensor, scale: float, zp: float, bits: int):
    """x through a static-qparam pool of ``bits``; returns (x', clipped
    count)."""
    lo, hi = (-128, 127) if bits == 8 else (-8, 7)
    q = torch.round(x / scale + zp)
    clipped = int(((q < lo) | (q > hi)).sum())
    return (torch.clamp(q, lo, hi) - zp) * scale, clipped


def rope(x: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """Rotate-half rotary embedding of x [T, heads, Dh] at positions pos."""
    dh = x.shape[-1]
    inv = base ** (-torch.arange(0, dh, 2, dtype=torch.float64,
                                 device=x.device) / dh)
    ang = pos.double()[:, None] * inv[None]
    cos = torch.cat([ang.cos(), ang.cos()], -1).float()[:, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1).float()[:, None]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def rope_base(model: dict, t: int) -> float:
    """The rotary base of a forward over t tokens (Qwen's dynamic NTK past
    max_position_embeddings)."""
    base = float(model['rope_theta'])
    lmax = model['max_position_embeddings']
    if model.get('use_dynamic_ntk') and t > lmax:
        alpha = max(2 ** math.ceil(math.log2(t / lmax) + 1) - 1, 1)
        dh = model['rotary_embedding']
        base *= alpha ** (dh / (dh - 2))
    return base


def attention(q, k, v, model: dict, block: int = 8) -> torch.Tensor:
    """Causal softmax attention of one sequence, q [T, H, Dh], k / v
    [T, KH, Dh]; heads in blocks so that the scores fit."""
    t, h, dh = q.shape
    rep = h // k.shape[1]
    if rep > 1:
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for h0 in range(0, h, block):
        qb = q[:, h0:h0 + block].transpose(0, 1)          # [hb, T, Dh]
        kb = k[:, h0:h0 + block].transpose(0, 1)
        vb = v[:, h0:h0 + block].transpose(0, 1)
        s = (qb @ kb.transpose(1, 2)) * dh ** -0.5
        s = s.masked_fill(~mask, float('-inf')).softmax(-1)
        out[:, h0:h0 + block] = (s @ vb).transpose(0, 1)
    return out


def forward(raw: Dict, model: dict, seqs: Sequence[torch.Tensor],
            want: Sequence[torch.Tensor], *, kv: Optional[dict] = None,
            stats: Optional[dict] = None
            ) -> List[torch.Tensor]:
    """Float32 logits [len(want[i]), vocab] of sequence i (ids [T_i]) at
    its positions ``want[i]`` (row p predicts token p + 1).  The layers
    run one at a time over all sequences, so that one layer's float32
    weights and the sequences' activations are what is held.

    ``kv``: ``{"bits": 8 | 4, "k_scale", "k_zp", "v_scale", "v_zp"}``
    (lists over layers) rounds K and V through a pool of those qparams;
    ``stats``, when given, gets the count and share of clipped codes."""
    highest_precision()
    h_num, kh_num = model['head_num'], model['kv_head_num']
    dh = model['size_per_head']
    eps = model['norm_eps']
    lmax = model['max_position_embeddings']
    lens = [int(s.numel()) for s in seqs]
    hs = torch.cat([raw['embed'][s.long()] for s in seqs]).float()
    dev = hs.device
    clipped = total = 0

    for li in range(model['num_layer']):
        w = {name: dequant(raw[name], li) for name in PROJ}
        x = rms_norm(hs, raw['attn_norm'][li], eps)
        qkv = x @ w['wqkv']
        if 'bqkv' in raw:
            qkv = qkv + raw['bqkv'][li].float()
        q, k, v = qkv.split([h_num * dh, kh_num * dh, kh_num * dh], -1)
        outs, at = [], 0
        for t in lens:
            qs = q[at:at + t].reshape(t, h_num, dh)
            ks = k[at:at + t].reshape(t, kh_num, dh)
            vs = v[at:at + t].reshape(t, kh_num, dh)
            pos = torch.arange(t, device=dev)
            base = rope_base(model, t)
            qs, ks = rope(qs, pos, base), rope(ks, pos, base)
            if model.get('use_logn_attn') and t > lmax:
                scale = torch.where(pos + 1 > lmax,
                                    torch.log((pos + 1).double())
                                    / math.log(lmax),
                                    torch.ones((), dtype=torch.float64,
                                               device=dev))
                qs = qs * scale.float()[:, None, None]
            if kv is not None:
                ks, ck = kv_round(ks, kv['k_scale'][li], kv['k_zp'][li],
                                  kv['bits'])
                vs, cv = kv_round(vs, kv['v_scale'][li], kv['v_zp'][li],
                                  kv['bits'])
                clipped += ck + cv
                total += 2 * ks.numel()
            outs.append(attention(qs, ks, vs, model).reshape(t, -1))
            at += t
        o = torch.cat(outs) @ w['wo']
        if 'bo' in raw:
            o = o + raw['bo'][li].float()
        hs = hs + o
        x = rms_norm(hs, raw['ffn_norm'][li], eps)
        act = torch.nn.functional.silu(x @ w['w1']) * (x @ w['w3'])
        hs = hs + act @ w['w2']
        del w
    if stats is not None and kv is not None:
        stats['kv_clipped'] = clipped
        stats['kv_clipped_share'] = clipped / max(total, 1)
    lm_head = raw['lm_head'].float()[:, :model['vocab_size']]
    out, at = [], 0
    for t, pos in zip(lens, want):
        x = rms_norm(hs[at:at + t][pos.long()], raw['norm'], eps)
        out.append(x @ lm_head)
        at += t
    return out


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """By how much each token's logit lies below the row's best."""
    return logits.max(-1).values - logits.gather(
        -1, tokens.long()[:, None])[:, 0]


__all__ = ['forward', 'gaps', 'dequant', 'unpack', 'highest_precision']
