"""Workspace converter — offline checkpoint preparation.

Port of ``lmdeploy_tpu/convert/converter.py`` (reference:
lmdeploy/serve/turbomind/deploy.py).  A workspace is a directory of one
flat ``weights.safetensors`` (bf16 dense tensors, column-pair packed
int4) plus ``config.json``; both packages read and write it
(:mod:`convert.workspace`).

    python -m lmdeploy_tpu_torch.convert.converter <hf_dir> <dst> [--quantize]
    python -m lmdeploy_tpu_torch.convert.converter <awq_dir> <dst> \
        --model-format awq
    python -m lmdeploy_tpu_torch.convert.converter --random tiny <dst>

Supports:
- hf:   fp16/bf16/f32 HF llama-family dirs (or meta-llama dirs) -> bf16
- awq:  AWQ-quantized HF dirs (qweight/qzeros/scales) -> W4A16
- quantize: min/max int4 quantization of an fp checkpoint on the way
- random: a random-weight workspace from a preset (tests, benchmarks)

Conversion runs on the CPU; it needs no GPU.
"""
from __future__ import annotations

import torch

from ..config import ModelConfig
from ..models.llama import init_params, quantize_params
from .awq import copy_tokenizer_files
from .workspace import is_workspace, load_workspace, save_workspace

PRESETS = {
    'tiny': dict(head_num=4, kv_head_num=2, size_per_head=32, inter_size=256,
                 num_layer=2, vocab_size=512, rotary_embedding=32,
                 max_position_embeddings=512, session_len=512),
    'llama2-7b': dict(head_num=32, kv_head_num=32, size_per_head=128,
                      inter_size=11008, num_layer=32, vocab_size=32000,
                      rotary_embedding=128, max_position_embeddings=4096,
                      session_len=4096),
    'llama2-13b': dict(head_num=40, kv_head_num=40, size_per_head=128,
                       inter_size=13824, num_layer=40, vocab_size=32000,
                       rotary_embedding=128, max_position_embeddings=4096,
                       session_len=4096),
    'internlm-7b': dict(head_num=32, kv_head_num=32, size_per_head=128,
                        inter_size=11008, num_layer=32, vocab_size=103168,
                        rotary_embedding=128, attn_bias=True,
                        max_position_embeddings=2048, session_len=2048),
    'llama2-70b': dict(head_num=64, kv_head_num=8, size_per_head=128,
                       inter_size=28672, num_layer=80, vocab_size=32000,
                       rotary_embedding=128, max_position_embeddings=4096,
                       session_len=4096),
    'qwen-7b': dict(head_num=32, kv_head_num=32, size_per_head=128,
                    inter_size=11008, num_layer=32, vocab_size=151936,
                    rotary_embedding=128, max_position_embeddings=8192,
                    session_len=8192, attn_bias=True, qkv_bias_only=True,
                    use_dynamic_ntk=True, use_logn_attn=True),
}


def convert_hf(model_path: str, dst: str, model_name: str = '',
               quantize: bool = False, group_size: int = 128) -> None:
    """HF (or meta-llama) dir -> workspace, optionally min/max
    W4A16-quantized; tokenizer files are carried over."""
    from .hf import load_hf_dir
    cfg, params = load_hf_dir(model_path, torch.float32)
    if model_name:
        cfg.model_name = model_name
    if quantize:
        params = quantize_params(params, cfg, group_size)
        cfg.weight_type = 'int4'
        cfg.group_size = group_size
    else:
        cfg.weight_type = 'bf16'
    save_workspace(dst, cfg, params)
    copy_tokenizer_files(model_path, dst)


def make_random_workspace(dst: str, preset: str = 'tiny',
                          weight_type: str = 'bf16', seed: int = 0,
                          group_size: int = 128,
                          model_name: str = '') -> ModelConfig:
    """Random-weight workspace for tests and benchmarks: normal(0, 0.02)
    bf16 weights drawn on the CPU from a ``torch.Generator`` seeded by
    ``seed`` (the shapes, dtypes and config of the JAX converter's; not
    its values)."""
    cfg = ModelConfig(model_name=model_name or preset, **PRESETS[preset])
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         torch.bfloat16, 'cpu')
    if weight_type == 'int4':
        params = quantize_params(params, cfg, group_size)
        cfg.weight_type = 'int4'
        cfg.group_size = group_size
    save_workspace(dst, cfg, params)
    return cfg


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser('lmdeploy_tpu_torch.convert')
    ap.add_argument('model_path', nargs='?', help='HF model dir')
    ap.add_argument('dst', help='output workspace dir')
    ap.add_argument('--model-name', default='')
    ap.add_argument('--model-format', choices=['hf', 'awq'], default='hf')
    ap.add_argument('--quantize', action='store_true',
                    help='min/max W4A16 quantization during conversion')
    ap.add_argument('--group-size', type=int, default=128)
    ap.add_argument('--random', default='',
                    help=f'fabricate random weights: {sorted(PRESETS)}')
    ap.add_argument('--weight-type', choices=['bf16', 'int4'], default='bf16')
    args = ap.parse_args(argv)
    if args.random:
        cfg = make_random_workspace(args.dst, args.random, args.weight_type,
                                    group_size=args.group_size,
                                    model_name=args.model_name)
        print(f'random {args.random} ({cfg.weight_type}) -> {args.dst}')
        return
    if args.model_format == 'awq':
        from .awq import convert_awq
        convert_awq(args.model_path, args.dst, args.model_name,
                    args.group_size)
    else:
        convert_hf(args.model_path, args.dst, args.model_name,
                   quantize=args.quantize, group_size=args.group_size)
    print(f'{args.model_path} -> {args.dst}')


__all__ = ['PRESETS', 'convert_hf', 'make_random_workspace', 'main',
           'save_workspace', 'load_workspace', 'is_workspace']

if __name__ == '__main__':
    main()
