"""Rotary position embedding with dynamic-NTK base scaling, logn attention
scaling and the HF linear / dynamic / yarn / llama3 presets.

Port of ``lmdeploy_tpu/ops/rope.py`` in plain PyTorch (the JAX package
leaves rope to XLA; it is position-only elementwise math).  Same formulas,
all in float32:

- dynamic NTK:  alpha = max(2^ceil(log2(L/Lmax)+1) - 1, 1) when L >= Lmax,
  base' = base * alpha^(dim/(dim-2))
- logn scaling: q *= log2(L)/log2(Lmax) when L > Lmax

Convention: HF "rotate_half" pairing (x[..., :d/2] with x[..., d/2:]).
"""
from __future__ import annotations

import math

import torch


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _const(x: float, device) -> torch.Tensor:
    """A 0-d f32 constant made on ``device`` by a fill, not copied from
    the host, so that a CUDA graph can capture the step that makes it."""
    return torch.full((), x, dtype=torch.float32, device=device)


def ntk_rope_base(context_len, max_position_embeddings: int,
                  rotary_dim: int, base: float) -> torch.Tensor:
    """Per-sequence dynamic-NTK rope base (qwen power-of-two form)."""
    ctx = _f32(context_len)
    ratio = torch.clamp(ctx / max_position_embeddings, min=1e-9)
    alpha = torch.clamp(torch.exp2(torch.ceil(torch.log2(ratio) + 1.0)) - 1.0,
                        min=1.0)
    scaled = base * torch.pow(alpha, rotary_dim / (rotary_dim - 2.0))
    return torch.where(ctx < max_position_embeddings,
                       _const(base, ctx.device), scaled)


def logn_scaling(context_len, max_position_embeddings: int) -> torch.Tensor:
    """log_2(L)/log_2(Lmax) for L > Lmax else 1."""
    ctx = _f32(context_len)
    scale = (torch.log2(torch.clamp(ctx, min=2.0))
             / torch.log2(_const(max_position_embeddings, ctx.device)))
    return torch.where(ctx <= max_position_embeddings,
                       torch.ones_like(scale), scale)


def rope_cos_sin(positions: torch.Tensor, rotary_dim: int, base,
                 inv_freq=None):
    """cos/sin tables, shape positions.shape + (rotary_dim//2,), float32.

    ``base`` broadcasts against ``positions`` (per-sequence NTK bases);
    ignored when ``inv_freq`` [rotary_dim//2] is given."""
    dev = positions.device
    if inv_freq is None:
        half = rotary_dim // 2
        exponent = torch.arange(half, dtype=torch.float32,
                                device=dev) * (2.0 / rotary_dim)
        base = base.to(dev, torch.float32) if torch.is_tensor(base) \
            else _const(base, dev)
        inv_freq = torch.pow(base[..., None], -exponent)
    angle = positions.float()[..., None] * inv_freq.to(dev)
    return torch.cos(angle), torch.sin(angle)


def hf_dynamic_ntk_base(context_len, original_max: int, rotary_dim: int,
                        base: float, factor: float) -> torch.Tensor:
    """HF-style dynamic-NTK base: base * (f*L/Lmax - (f-1)) ** (d/(d-2))
    for L > Lmax (transformers _compute_dynamic_ntk_parameters)."""
    ctx = _f32(context_len)
    grow = factor * ctx / original_max - (factor - 1.0)
    scaled = base * torch.pow(torch.clamp(grow, min=1.0),
                              rotary_dim / (rotary_dim - 2.0))
    return torch.where(ctx <= original_max, _const(base, ctx.device), scaled)


def yarn_inv_freq(rotary_dim: int, base: float, factor: float,
                  original_max: int, beta_fast: float = 32.0,
                  beta_slow: float = 1.0):
    """YaRN / NTK-by-parts frequencies + attention factor
    (transformers _compute_yarn_parameters).  Returns
    (inv_freq [rotary_dim//2] float32, attention_factor float)."""
    half = rotary_dim // 2
    exponent = torch.arange(half, dtype=torch.float32) * (2.0 / rotary_dim)
    inv_freq_extrap = torch.pow(_f32(base), -exponent)
    inv_freq_interp = inv_freq_extrap / factor

    def correction_dim(num_rotations: float) -> float:
        return (rotary_dim * math.log(
            original_max / (num_rotations * 2 * math.pi))
            / (2 * math.log(base)))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), rotary_dim - 1)
    ramp = ((torch.arange(half, dtype=torch.float32) - low)
            / max(high - low, 0.001))
    ramp = torch.clamp(ramp, 0.0, 1.0)
    extrap_w = 1.0 - ramp
    inv_freq = (inv_freq_interp * (1.0 - extrap_w)
                + inv_freq_extrap * extrap_w)
    return inv_freq, float(0.1 * math.log(factor) + 1.0)


def llama3_inv_freq(rotary_dim: int, base: float, factor: float,
                    original_max: int, low_freq_factor: float = 1.0,
                    high_freq_factor: float = 4.0) -> torch.Tensor:
    """Llama-3.1 frequency rescale (transformers
    _compute_llama3_parameters); position-independent."""
    half = rotary_dim // 2
    exponent = torch.arange(half, dtype=torch.float32) * (2.0 / rotary_dim)
    inv_freq = torch.pow(_f32(base), -exponent)
    wavelen = (2.0 * math.pi) / inv_freq
    low_wl = original_max / low_freq_factor
    high_wl = original_max / high_freq_factor
    out = torch.where(wavelen > low_wl, inv_freq / factor, inv_freq)
    smooth = ((original_max / wavelen - low_freq_factor)
              / (high_freq_factor - low_freq_factor))
    smoothed = (1.0 - smooth) / factor * inv_freq + smooth * inv_freq
    medium = (wavelen >= high_wl) & (wavelen <= low_wl)
    return torch.where(medium, smoothed, out)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half rope on x [..., heads, head_dim] with cos/sin
    [..., rotary_dim//2] (broadcast over heads); a partial-rotary tail
    passes through."""
    half = cos.shape[-1]
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:2 * half].float()
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                        dim=-1).to(x.dtype)
    if x.shape[-1] > 2 * half:
        rotated = torch.cat([rotated, x[..., 2 * half:]], dim=-1)
    return rotated


def rope_tables(positions, context_len, *, rotary_dim: int, base: float,
                max_position_embeddings: int, use_dynamic_ntk: bool = False,
                use_logn_attn: bool = False, rope_scaling_type: str = '',
                rope_scaling_factor: float = 1.0,
                rope_original_max: int = 0,
                rope_low_freq_factor: float = 1.0,
                rope_high_freq_factor: float = 4.0):
    """(cos, sin, logn_scale_or_None) for one step; position-only and
    layer-invariant, so the caller builds them once per step.

    positions: int [B, T]; context_len: int [B] (history + new tokens).
    """
    dev = positions.device
    orig_max = rope_original_max or max_position_embeddings
    factor = rope_scaling_factor
    inv_freq = None
    table_scale = None
    b = positions.shape[0]
    if rope_scaling_type == 'linear':
        positions = positions.float() / _const(factor, dev)
        eff_base = torch.full((b, 1), base, dtype=torch.float32, device=dev)
    elif rope_scaling_type == 'dynamic':
        eff_base = hf_dynamic_ntk_base(context_len, orig_max, rotary_dim,
                                       base, factor)[:, None]
    elif rope_scaling_type == 'yarn':
        inv_freq, table_scale = yarn_inv_freq(rotary_dim, base, factor,
                                              orig_max)
        eff_base = None
    elif rope_scaling_type == 'llama3':
        inv_freq = llama3_inv_freq(rotary_dim, base, factor, orig_max,
                                   rope_low_freq_factor,
                                   rope_high_freq_factor)
        eff_base = None
    elif use_dynamic_ntk:
        eff_base = ntk_rope_base(context_len, max_position_embeddings,
                                 rotary_dim, base)[:, None]
    else:
        eff_base = torch.full((b, 1), base, dtype=torch.float32, device=dev)
    cos, sin = rope_cos_sin(positions, rotary_dim, eff_base,
                            inv_freq=inv_freq)
    if table_scale is not None:
        cos = cos * table_scale
        sin = sin * table_scale
    scale = None
    if use_logn_attn:
        scale = logn_scaling(positions.float() + 1.0,
                             max_position_embeddings)
    return cos, sin, scale


def apply_rope_qk(q, k, tables):
    """Rotate q [B,T,Hq,D] and k [B,T,Hk,D] with :func:`rope_tables`
    (+ the optional logn q-scale)."""
    cos, sin, scale = tables
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if scale is not None:
        q = (q.float() * scale[..., None, None]).to(q.dtype)
    return q, k


__all__ = ['ntk_rope_base', 'hf_dynamic_ntk_base', 'yarn_inv_freq',
           'llama3_inv_freq', 'logn_scaling', 'rope_cos_sin', 'apply_rope',
           'rope_tables', 'apply_rope_qk']
