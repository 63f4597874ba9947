"""HF checkpoint -> the port's parameter tree.

Port of ``lmdeploy_tpu/convert/hf.py``: HF tensors map straight into the
stacked-layer tree of ``models/llama.py`` (``[L, ...]`` per family, HF
``[out, in]`` Linear weights transposed to ``[in, out]``, q/k/v fused
column-wise into ``wqkv``).  The arithmetic runs in numpy float32, as the
JAX converter's does, and the result is cast to the requested torch dtype
once at the end, so both packages give the same bits.

Handles: llama/llama2/vicuna/codellama (q/k/v/o + gate/up/down),
internlm (qkv/o bias), baichuan (fused W_pack), baichuan2 (normalized
lm_head), qwen (fused c_attn + qkv-only bias, dynamic NTK, logn, the
intermediate size halved).

``*.safetensors`` files (one or sharded) are read with
:func:`convert.workspace.read_safetensors`; ``pytorch_model*.bin`` with
``torch.load(..., weights_only=True)``.
"""
from __future__ import annotations

import glob
import json
import os.path as osp
from typing import Any, Dict

import numpy as np
import torch

from ..config import ModelConfig
from ..models.llama import vocab_padded
from .workspace import read_safetensors


def config_from_hf(hf_cfg: dict, model_name: str = '') -> ModelConfig:
    """Derive ModelConfig from an HF config.json dict."""
    arch = (hf_cfg.get('architectures') or [''])[0].lower()
    get = hf_cfg.get
    head_num = get('num_attention_heads', 32)
    hidden = get('hidden_size', head_num * 128)
    size_per_head = hidden // head_num
    cfg = ModelConfig(
        model_name=model_name or arch or 'llama',
        head_num=head_num,
        kv_head_num=get('num_key_value_heads', head_num) or head_num,
        size_per_head=size_per_head,
        inter_size=get('intermediate_size', 4 * hidden),
        num_layer=get('num_hidden_layers', 32),
        vocab_size=get('vocab_size', 32000),
        norm_eps=get('rms_norm_eps', 1e-6),
        rotary_embedding=size_per_head,
        rope_theta=get('rope_theta', 10000.0),
        max_position_embeddings=get('max_position_embeddings', 2048),
        start_id=get('bos_token_id', 1) or 1,
        end_id=get('eos_token_id', 2) or 2,
        tie_word_embeddings=get('tie_word_embeddings', False),
    )
    if 'qwen' in arch:
        cfg.attn_bias = True
        cfg.qkv_bias_only = True
        cfg.use_dynamic_ntk = bool(get('use_dynamic_ntk', False))
        cfg.use_logn_attn = bool(get('use_logn_attn', False))
        cfg.norm_eps = get('layer_norm_epsilon', cfg.norm_eps)
        cfg.kv_head_num = cfg.head_num
        cfg.inter_size = get('intermediate_size', cfg.inter_size) // 2
        cfg.session_len = get('seq_length', 8192)
    if 'internlm' in arch:
        cfg.attn_bias = bool(get('bias', True))
    scaling = get('rope_scaling') or {}
    if scaling:
        # HF rope_scaling: {"type"|"rope_type": linear|dynamic|yarn|llama3,
        # "factor": f, ["original_max_position_embeddings": n]}
        stype = scaling.get('type') or scaling.get('rope_type') or ''
        if stype in ('linear', 'dynamic', 'yarn', 'llama3'):
            cfg.rope_scaling_type = stype
            cfg.rope_scaling_factor = float(scaling.get('factor', 1.0))
            cfg.rope_original_max_position = int(
                scaling.get('original_max_position_embeddings', 0))
            cfg.rope_low_freq_factor = float(
                scaling.get('low_freq_factor', 1.0))
            cfg.rope_high_freq_factor = float(
                scaling.get('high_freq_factor', 4.0))
            # linear/yarn/llama3 extend the usable context by `factor`
            # beyond the trained length; dynamic grows on the fly
            if stype in ('linear', 'yarn', 'llama3'):
                orig = (cfg.rope_original_max_position
                        or cfg.max_position_embeddings)
                cfg.session_len = max(cfg.session_len,
                                      int(orig * cfg.rope_scaling_factor))
        else:
            # refusing beats serving silently-wrong long-context output
            raise ValueError(
                f'unsupported rope_scaling type {stype!r} (supported: '
                f'linear, dynamic, yarn, llama3); converting anyway would '
                f'run the model with UNSCALED rope')
    cfg.session_len = max(cfg.session_len, cfg.max_position_embeddings)
    return cfg


def _f32(t) -> np.ndarray:
    """torch tensor (bf16 included) / numpy -> float32 numpy."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        t = t.numpy()
    return np.asarray(t, np.float32)


def _torch(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def convert_hf_llama(state_dict: Dict[str, Any], cfg: ModelConfig,
                     dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Map an HF llama-family state_dict (torch tensors or numpy arrays)
    to the stacked-layer tree of CPU tensors at ``dtype``.

    HF Linear weights are [out, in]; the tree's layout is [in, out], so
    every projection transposes.  qkv are fused column-wise:
    wqkv = concat(q.T, k.T, v.T) -> [D, (H+2KH)*Dh].
    """
    sd = state_dict
    d = cfg.hidden_size

    def get(name):
        return _f32(sd[name])

    def maybe(name):
        return _f32(sd[name]) if name in sd else None

    is_qwen = 'qwen' in cfg.model_name.lower()
    is_baichuan = 'baichuan' in cfg.model_name.lower()

    wqkv, bqkv, wo, bo = [], [], [], []
    w1, w3, w2, attn_norm, ffn_norm = [], [], [], [], []
    for i in range(cfg.num_layer):
        if is_qwen:
            p = f'transformer.h.{i}'
            wqkv.append(get(f'{p}.attn.c_attn.weight').T)   # [D, 3D]
            bqkv.append(get(f'{p}.attn.c_attn.bias'))
            wo.append(get(f'{p}.attn.c_proj.weight').T)
            w1.append(get(f'{p}.mlp.w2.weight').T)          # qwen: w2=gate
            w3.append(get(f'{p}.mlp.w1.weight').T)          # qwen: w1=up
            w2.append(get(f'{p}.mlp.c_proj.weight').T)
            attn_norm.append(get(f'{p}.ln_1.weight'))
            ffn_norm.append(get(f'{p}.ln_2.weight'))
            continue
        p = f'model.layers.{i}'
        if is_baichuan:
            wqkv.append(get(f'{p}.self_attn.W_pack.weight').T)
        else:
            q = get(f'{p}.self_attn.q_proj.weight').T
            k = get(f'{p}.self_attn.k_proj.weight').T
            v = get(f'{p}.self_attn.v_proj.weight').T
            wqkv.append(np.concatenate([q, k, v], axis=1))
            if cfg.attn_bias:
                bqkv.append(np.concatenate([
                    get(f'{p}.self_attn.{n}_proj.bias') for n in 'qkv']))
        wo.append(get(f'{p}.self_attn.o_proj.weight').T)
        if cfg.attn_bias and not cfg.qkv_bias_only:
            ob = maybe(f'{p}.self_attn.o_proj.bias')
            bo.append(ob if ob is not None else np.zeros((d,), np.float32))
        w1.append(get(f'{p}.mlp.gate_proj.weight').T)
        w3.append(get(f'{p}.mlp.up_proj.weight').T)
        w2.append(get(f'{p}.mlp.down_proj.weight').T)
        attn_norm.append(get(f'{p}.input_layernorm.weight'))
        ffn_norm.append(get(f'{p}.post_attention_layernorm.weight'))

    if is_qwen:
        emb = get('transformer.wte.weight')
        final_norm = get('transformer.ln_f.weight')
    else:
        emb = get('model.embed_tokens.weight')
        final_norm = get('model.norm.weight')
    head = maybe('lm_head.weight')

    vp = vocab_padded(cfg)
    if emb.shape[0] < vp:
        emb = np.pad(emb, ((0, vp - emb.shape[0]), (0, 0)))

    layers = {name: _torch(np.stack(arrs), dtype) for name, arrs in (
        ('attn_norm', attn_norm), ('ffn_norm', ffn_norm), ('wqkv', wqkv),
        ('wo', wo), ('w1', w1), ('w3', w3), ('w2', w2))}
    if bqkv:
        layers['bqkv'] = _torch(np.stack(bqkv), dtype)
    if bo:
        layers['bo'] = _torch(np.stack(bo), dtype)
    params = {'tok_embedding': _torch(emb, dtype),
              'norm': _torch(final_norm, dtype), 'layers': layers}
    if head is not None and not cfg.tie_word_embeddings:
        head = head.T  # [D, V]
        if 'baichuan2' in cfg.model_name.lower():
            # Baichuan2 normalizes the lm_head (reference deploy.py:535-539)
            head = head / np.maximum(
                np.linalg.norm(head, axis=0, keepdims=True), 1e-12)
        if head.shape[1] < vp:
            head = np.pad(head, ((0, 0), (0, vp - head.shape[1])))
        params['lm_head'] = _torch(head, dtype)
    return params


def read_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """Every tensor of an HF directory: its ``*.safetensors`` files (one
    or sharded), else its ``pytorch_model*.bin`` files.  Raises
    FileNotFoundError when it holds neither."""
    sd: Dict[str, torch.Tensor] = {}
    st_files = sorted(glob.glob(osp.join(model_dir, '*.safetensors')))
    if st_files:
        for fpath in st_files:
            sd.update(read_safetensors(fpath))
    else:
        for fpath in sorted(glob.glob(osp.join(model_dir,
                                               'pytorch_model*.bin'))):
            sd.update(torch.load(fpath, map_location='cpu',
                                 weights_only=True))
    if not sd:
        raise FileNotFoundError(f'no weights found in {model_dir}')
    return sd


def load_hf_dir(model_dir: str, dtype: torch.dtype = torch.float32):
    """Load config + weights from an HF model directory and return
    (ModelConfig, params).  Original meta-llama checkpoint directories
    (params.json + consolidated.*.pth) dispatch to :mod:`convert.meta`."""
    from .meta import is_meta_llama, load_meta_dir
    if is_meta_llama(model_dir):
        return load_meta_dir(model_dir, dtype)
    with open(osp.join(model_dir, 'config.json')) as f:
        hf_cfg = json.load(f)
    cfg = config_from_hf(hf_cfg, osp.basename(model_dir.rstrip('/')))
    return cfg, convert_hf_llama(read_state_dict(model_dir), cfg, dtype)


__all__ = ['config_from_hf', 'convert_hf_llama', 'read_state_dict',
           'load_hf_dir']
