"""Original meta-llama checkpoint (``consolidated.*.pth``) ingestion.

Port of ``lmdeploy_tpu/convert/meta.py`` (reference:
lmdeploy/serve/turbomind/deploy.py:263 ``deploy_llama``): reads
``params.json`` + the model-parallel ``consolidated.NN.pth`` shards,
merges them along each tensor family's split dim, and re-permutes q/k
rows from Meta's interleaved rope-pair layout to the HF rotate-half
convention the port computes rope in.  The merged tensors are renamed
into an HF-style state_dict and go through
:func:`convert.hf.convert_hf_llama`, so both ingestion paths share one
mapping.
"""
from __future__ import annotations

import glob
import json
import os.path as osp
from typing import Any, Dict

import numpy as np
import torch

from ..config import ModelConfig

# concat dim of each Meta tensor family across consolidated.* shards
# (column-parallel weights shard their OUT dim = torch dim 0; row-parallel
# shard the IN dim = torch dim 1; embeddings shard the feature dim)
_SHARD_DIM = {
    'attention.wq.weight': 0,
    'attention.wk.weight': 0,
    'attention.wv.weight': 0,
    'attention.wo.weight': 1,
    'feed_forward.w1.weight': 0,
    'feed_forward.w2.weight': 1,
    'feed_forward.w3.weight': 0,
    'tok_embeddings.weight': 1,
    'output.weight': 0,
}
_REPLICATED = ('attention_norm.weight', 'ffn_norm.weight', 'norm.weight')


def is_meta_llama(path: str) -> bool:
    return (osp.exists(osp.join(path, 'params.json'))
            and bool(glob.glob(osp.join(path, 'consolidated.*.pth'))))


def _unpermute_rope(w: np.ndarray, n_heads: int) -> np.ndarray:
    """Meta interleaved rope pairs -> HF half-split convention.

    Meta stores each head's rows as (re0, im0, re1, im1, ...); HF's
    rotate-half expects (re0, re1, ..., im0, im1, ...).  ``w``:
    [n_heads*dh, in]."""
    out, inner = w.shape
    dh = out // n_heads
    return (w.reshape(n_heads, dh // 2, 2, inner)
             .transpose(0, 2, 1, 3)
             .reshape(out, inner))


def _merge_shards(shards, key: str) -> np.ndarray:
    parts = [np.asarray(sd[key].float().numpy()
                        if isinstance(sd[key], torch.Tensor) else sd[key],
                        np.float32) for sd in shards]
    base = key.split('.', 2)[-1] if key.startswith('layers.') else key
    if base in _REPLICATED or key in _REPLICATED:
        return parts[0]
    dim = _SHARD_DIM.get(base if base in _SHARD_DIM else key)
    if dim is None:
        raise KeyError(f'unknown meta checkpoint tensor {key}')
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=dim)


def load_meta_dir(model_dir: str, dtype: torch.dtype = torch.float32):
    """Load a meta-llama original checkpoint directory.  Returns
    ``(ModelConfig, params)`` as :func:`convert.hf.load_hf_dir` does."""
    from .hf import convert_hf_llama

    with open(osp.join(model_dir, 'params.json')) as f:
        meta = json.load(f)
    files = sorted(glob.glob(osp.join(model_dir, 'consolidated.*.pth')))
    shards = [torch.load(f, map_location='cpu', weights_only=True)
              for f in files]

    n_heads = meta['n_heads']
    n_kv = meta.get('n_kv_heads', n_heads)
    nl = meta['n_layers']
    dh = meta['dim'] // n_heads

    sd: Dict[str, Any] = {}
    for i in range(nl):
        p, hp = f'layers.{i}', f'model.layers.{i}'
        sd[f'{hp}.self_attn.q_proj.weight'] = _unpermute_rope(
            _merge_shards(shards, f'{p}.attention.wq.weight'), n_heads)
        sd[f'{hp}.self_attn.k_proj.weight'] = _unpermute_rope(
            _merge_shards(shards, f'{p}.attention.wk.weight'), n_kv)
        for hf_name, meta_name in (
                ('self_attn.v_proj', 'attention.wv'),
                ('self_attn.o_proj', 'attention.wo'),
                ('mlp.gate_proj', 'feed_forward.w1'),
                ('mlp.down_proj', 'feed_forward.w2'),
                ('mlp.up_proj', 'feed_forward.w3'),
                ('input_layernorm', 'attention_norm'),
                ('post_attention_layernorm', 'ffn_norm')):
            sd[f'{hp}.{hf_name}.weight'] = _merge_shards(
                shards, f'{p}.{meta_name}.weight')
    sd['model.embed_tokens.weight'] = _merge_shards(
        shards, 'tok_embeddings.weight')
    sd['model.norm.weight'] = _merge_shards(shards, 'norm.weight')
    sd['lm_head.weight'] = _merge_shards(shards, 'output.weight')

    vocab = sd['model.embed_tokens.weight'].shape[0]  # params.json may say -1
    inter = sd['model.layers.0.mlp.gate_proj.weight'].shape[0]
    cfg = ModelConfig(
        model_name=osp.basename(model_dir.rstrip('/')) or 'llama',
        head_num=n_heads, kv_head_num=n_kv, size_per_head=dh,
        inter_size=inter, num_layer=nl, vocab_size=vocab,
        norm_eps=meta.get('norm_eps', 1e-6), rotary_embedding=dh,
        rope_theta=meta.get('rope_theta', 10000.0),
        max_position_embeddings=meta.get('max_seq_len', 2048))
    return cfg, convert_hf_llama(sd, cfg, dtype)


__all__ = ['is_meta_llama', 'load_meta_dir']
