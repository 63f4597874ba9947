"""AWQ activation-aware weight smoothing (state-dict level).

Copy of ``lmdeploy_tpu/lite/quantization/awq.py`` (numpy only, the same
arithmetic, so both packages smooth a checkpoint to the same bytes).

Algorithm of the AWQ paper as shipped by the reference
(lmdeploy/lite/quantization/awq.py: smooth_ln_fcs:52, smooth_fc_fcs:91,
NORM_FCS_MAP:7, FC_FCS_MAP:24): per-channel scales
``s = clamp(act_absmax^a / w_scale^(1-a), 1e-4)`` normalized by
``sqrt(max*min)``, divided into the producer (norm weight or previous
linear's rows) and multiplied into the consumers' input columns — an
exact reparameterization before quantization.

Implemented over the raw HF state_dict (numpy) instead of nn.Module
surgery: the smoothed dict feeds convert.hf straight into the
workspace, no intermediate quantized-HF checkpoint needed.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

# module-relative names per decoder-layer class (HF conventions)
NORM_FCS_MAP = {
    'llama': {
        'input_layernorm':
            ['self_attn.q_proj', 'self_attn.k_proj', 'self_attn.v_proj'],
        'post_attention_layernorm': ['mlp.gate_proj', 'mlp.up_proj'],
    },
    'internlm': {
        'input_layernorm':
            ['self_attn.q_proj', 'self_attn.k_proj', 'self_attn.v_proj'],
        'post_attention_layernorm': ['mlp.gate_proj', 'mlp.up_proj'],
    },
    'qwen': {
        'ln_1': ['attn.c_attn'],
        'ln_2': ['mlp.w1', 'mlp.w2'],
    },
}

FC_FCS_MAP = {
    'llama': {
        'self_attn.v_proj': ['self_attn.o_proj'],
        'mlp.up_proj': ['mlp.down_proj'],
    },
    'internlm': {
        'self_attn.v_proj': ['self_attn.o_proj'],
        'mlp.up_proj': ['mlp.down_proj'],
    },
    'qwen': {
        'attn.c_attn': ['attn.c_proj'],
        'mlp.w1': ['mlp.c_proj'],
    },
}


def weight_scale(w: np.ndarray, group_size: int = -1) -> np.ndarray:
    """Mean over output rows of per-group-normalized |w| -> [in]."""
    w = np.abs(np.asarray(w, np.float32))          # HF layout [out, in]
    if group_size > 0:
        flat = w.reshape(-1, group_size)
        flat = flat / np.maximum(flat.max(1, keepdims=True), 1e-12)
        w = flat.reshape(w.shape)
    else:
        w = w / np.maximum(w.max(1, keepdims=True), 1e-12)
    return w.mean(0)


def _awq_scales(act_absmax: np.ndarray, fc_weights: List[np.ndarray],
                group_size: int, alpha: float) -> np.ndarray:
    w = np.concatenate(fc_weights, axis=0)
    ws = weight_scale(w, group_size)
    s = np.clip(act_absmax ** alpha / np.maximum(ws, 1e-12) ** (1 - alpha),
                1e-4, None)
    return s / np.sqrt(np.maximum(s.max() * s.min(), 1e-12))


def smooth_ln_fcs(sd: Dict[str, np.ndarray], ln_name: str,
                  fc_names: List[str], act_absmax: np.ndarray,
                  group_size: int = -1, alpha: float = 0.5) -> np.ndarray:
    """Fold scales: norm weight (and bias) / s; consumer columns * s."""
    s = _awq_scales(act_absmax, [sd[f'{n}.weight'] for n in fc_names],
                    group_size, alpha)
    sd[f'{ln_name}.weight'] = sd[f'{ln_name}.weight'] / s
    if f'{ln_name}.bias' in sd:
        sd[f'{ln_name}.bias'] = sd[f'{ln_name}.bias'] / s
    for n in fc_names:
        sd[f'{n}.weight'] = sd[f'{n}.weight'] * s[None, :]
    return s


def smooth_fc_fcs(sd: Dict[str, np.ndarray], pre_fc_name: str,
                  fc_names: List[str], act_absmax: np.ndarray,
                  group_size: int = -1, alpha: float = 0.5):
    """Fold scales between a producer linear and its consumers.

    Skipped for GQA (producer out-dim < consumer in-dim, reference
    smooth_fc_fcs:110); for fused QKV producers (qwen c_attn) only the V
    third scales (reference :125-131)."""
    pre_w = sd[f'{pre_fc_name}.weight']
    size_pre = pre_w.shape[0]
    size_a = act_absmax.shape[0]
    if size_pre < size_a and size_a % size_pre == 0:
        return None  # GQA: v rows fewer than o columns
    s = _awq_scales(act_absmax, [sd[f'{n}.weight'] for n in fc_names],
                    group_size, alpha)
    bias_name = f'{pre_fc_name}.bias'
    if size_pre > size_a and size_pre % size_a == 0 \
            and size_pre // size_a == 3:
        w = pre_w.copy()
        w[-size_a:] = w[-size_a:] / s[:, None]
        sd[f'{pre_fc_name}.weight'] = w
        if bias_name in sd:
            b = sd[bias_name].copy()
            b[-size_a:] = b[-size_a:] / s
            sd[bias_name] = b
    else:
        sd[f'{pre_fc_name}.weight'] = pre_w / s[:, None]
        if bias_name in sd:
            sd[bias_name] = sd[bias_name] / s
    for n in fc_names:
        sd[f'{n}.weight'] = sd[f'{n}.weight'] * s[None, :]
    return s


def _family(model_name: str) -> str:
    name = model_name.lower()
    for fam in ('qwen', 'internlm'):
        if fam in name:
            return fam
    return 'llama'


def smooth_state_dict(sd: Dict[str, np.ndarray], model_name: str,
                      act_stats: Dict[str, np.ndarray], num_layers: int,
                      group_size: int = -1, alpha: float = 0.5,
                      layer_prefix: str = 'model.layers') -> None:
    """Apply AWQ smoothing to every decoder layer in place.

    act_stats maps full linear names -> input-activation absmax [in_dim]
    (from lite.apis.calibrate)."""
    fam = _family(model_name)
    for i in range(num_layers):
        p = f'{layer_prefix}.{i}'
        for ln, fcs in NORM_FCS_MAP[fam].items():
            a = act_stats[f'{p}.{fcs[0]}']
            smooth_ln_fcs(sd, f'{p}.{ln}', [f'{p}.{n}' for n in fcs], a,
                          group_size, alpha)
        for fc, fcs in FC_FCS_MAP[fam].items():
            a = act_stats[f'{p}.{fcs[0]}']
            smooth_fc_fcs(sd, f'{p}.{fc}', [f'{p}.{n}' for n in fcs], a,
                          group_size, alpha)


__all__ = ['NORM_FCS_MAP', 'FC_FCS_MAP', 'weight_scale', 'smooth_ln_fcs',
           'smooth_fc_fcs', 'smooth_state_dict']
