"""AWQ-quantized HF checkpoint import.

Port of ``lmdeploy_tpu/convert/awq.py`` (reference:
lmdeploy/serve/turbomind/deploy.py ``deploy_awq``, :554-783): AWQ's
qweight / qzeros / scales are repacked into the port's
:class:`~lmdeploy_tpu_torch.ops.linear.QuantizedWeight` (one int4 value
per byte) and written as a W4A16 workspace, which packs them to the
workspace's column-pair bytes.

AWQ GEMM tensor formats (from the llm-awq project):
  qweight: int32 [K, N/8]  — 8 uint4 values per int32 along N, order
           [0, 2, 4, 6, 1, 3, 5, 7]
  qzeros:  int32 [K/g, N/8] — same packing
  scales:  fp16  [K/g, N]
Dequant: w[k, n] = (qweight[k, n] - qzeros[k//g, n]) * scales[k//g, n].
"""
from __future__ import annotations

import json
import os.path as osp
import shutil

import numpy as np
import torch

from ..ops.linear import QuantizedWeight

AWQ_ORDER = np.array([0, 2, 4, 6, 1, 3, 5, 7])
AWQ_INV = np.argsort(AWQ_ORDER)  # position of logical nibble i in packed word
TOKENIZER_FILES = ('tokenizer.json', 'tokenizer.model',
                   'tokenizer_config.json', 'special_tokens_map.json')


def unpack_awq_int32(packed: np.ndarray) -> np.ndarray:
    """int32 [..., W] -> uint4-as-uint8 [..., W*8] in logical N order."""
    u = np.asarray(packed).astype(np.uint32)
    nibbles = np.stack([(u >> (4 * i)) & 0xF for i in range(8)], axis=-1)
    # nibble slot i holds logical element AWQ_ORDER[i]; invert
    nibbles = nibbles[..., AWQ_INV]
    return nibbles.reshape(*u.shape[:-1], u.shape[-1] * 8).astype(np.uint8)


def awq_to_quantized_weight(qweight: np.ndarray, qzeros: np.ndarray,
                            scales: np.ndarray) -> QuantizedWeight:
    """AWQ GEMM tensors -> QuantizedWeight (byte-per-value layout); the
    fp16 scales and the zero points become bf16."""
    return QuantizedWeight(
        qvals=torch.from_numpy(unpack_awq_int32(qweight)),
        scales=torch.from_numpy(np.asarray(scales, np.float32)).to(
            torch.bfloat16),
        zeros=torch.from_numpy(unpack_awq_int32(qzeros).astype(
            np.float32)).to(torch.bfloat16))


def copy_tokenizer_files(src: str, dst: str) -> None:
    """Carry a checkpoint's tokenizer files over to its workspace."""
    for fname in TOKENIZER_FILES:
        src_f = osp.join(src, fname)
        if osp.exists(src_f):
            shutil.copy(src_f, osp.join(dst, fname))


def convert_awq(model_path: str, dst: str, model_name: str = '',
                group_size: int = 128) -> None:
    """AWQ HF dir (qweight/qzeros/scales linears) -> W4A16 workspace."""
    from ..models.llama import vocab_padded
    from .hf import config_from_hf, read_state_dict
    from .workspace import save_workspace

    with open(osp.join(model_path, 'config.json')) as f:
        hf_cfg = json.load(f)
    cfg = config_from_hf(hf_cfg, model_name or
                         osp.basename(model_path.rstrip('/')))
    cfg.weight_type = 'int4'
    cfg.group_size = group_size
    sd = read_state_dict(model_path)

    def arr(name) -> np.ndarray:
        t = sd[name]
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def f32(name) -> np.ndarray:
        return np.asarray(arr(name), np.float32)

    def bf16(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            torch.bfloat16)

    def qlinear(prefix) -> QuantizedWeight:
        return awq_to_quantized_weight(arr(f'{prefix}.qweight'),
                                       arr(f'{prefix}.qzeros'),
                                       arr(f'{prefix}.scales'))

    def combine(fn, qws) -> QuantizedWeight:
        """Concatenate (fuse q, k, v) or stack (layers) quantized weights."""
        return QuantizedWeight(*(fn([getattr(q, part) for q in qws])
                                 for part in ('qvals', 'scales', 'zeros')))

    wqkv, wo, w1, w3, w2, an, fn_, bqkv = [], [], [], [], [], [], [], []
    for i in range(cfg.num_layer):
        p = f'model.layers.{i}'
        wqkv.append(combine(lambda ts: torch.cat(ts, dim=-1), [
            qlinear(f'{p}.self_attn.{n}_proj') for n in 'qkv']))
        wo.append(qlinear(f'{p}.self_attn.o_proj'))
        w1.append(qlinear(f'{p}.mlp.gate_proj'))
        w3.append(qlinear(f'{p}.mlp.up_proj'))
        w2.append(qlinear(f'{p}.mlp.down_proj'))
        an.append(f32(f'{p}.input_layernorm.weight'))
        fn_.append(f32(f'{p}.post_attention_layernorm.weight'))
        if f'{p}.self_attn.q_proj.bias' in sd:
            cfg.attn_bias = True
            bqkv.append(np.concatenate([
                f32(f'{p}.self_attn.{n}_proj.bias') for n in 'qkv']))

    vp = vocab_padded(cfg)
    emb = f32('model.embed_tokens.weight')
    if emb.shape[0] < vp:
        emb = np.pad(emb, ((0, vp - emb.shape[0]), (0, 0)))
    head = f32('lm_head.weight').T
    if head.shape[1] < vp:
        head = np.pad(head, ((0, 0), (0, vp - head.shape[1])))

    layers = {'attn_norm': bf16(np.stack(an)),
              'ffn_norm': bf16(np.stack(fn_))}
    for name, qws in (('wqkv', wqkv), ('wo', wo), ('w1', w1), ('w3', w3),
                      ('w2', w2)):
        layers[name] = combine(torch.stack, qws)
    if bqkv:
        layers['bqkv'] = bf16(np.stack(bqkv))
    params = {'tok_embedding': bf16(emb),
              'norm': bf16(f32('model.norm.weight')),
              'lm_head': bf16(head), 'layers': layers}
    save_workspace(dst, cfg, params)
    copy_tokenizer_files(model_path, dst)


__all__ = ['unpack_awq_int32', 'awq_to_quantized_weight', 'convert_awq',
           'copy_tokenizer_files']
