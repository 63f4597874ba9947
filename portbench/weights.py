"""Seeded random weights in the program's parameter layout, drawn on the
device.

The maker draws a whole family at a time (one call per tensor of all
layers) from one ``torch.Generator`` on the device, in the dtypes the
program serves:

- each W4A16 projection [L, K, N] at group G: random bytes as the
  nibble-packed [L, K/2, N] codes (row k < K/2 in the low nibble, K/2 + k
  in the high one), bf16 scales s = s0 (0.5 + u) per group and column,
  integer zero points z on 4..11 per group and column, given as the bf16
  product s * z, as a checkpoint's AWQ groups vary;
  s0 = 1 / (5.15 sqrt(K)) keeps a product's output near unit variance
  ((q - z) has a mean square of about 26.5);
- bf16 embedding, normal(0, 0.02), and lm_head, normal(0, LOGIT_STD /
  sqrt(hidden)) (vocabulary padded to a multiple of 128 rows, as the
  program lays it out): logits spread by about LOGIT_STD = 4, so that a
  top-p 0.8 nucleus holds tens to hundreds of tokens, as on a trained
  model, and not the tens of thousands that flat logits give (0.02 gives
  about 1.4: 42k of Qwen's 152k tokens); RMSNorm weights 1 + 0.1
  normal(0, 1); Qwen's qkv bias normal(0, 0.1).

The same tensors go to the engine (wrapped in its weight type by
``serve.py``) and, drawn again from the same seed once the engine is
gone, to the reference.

``kv_qparams`` makes a quantised pool's static per-layer qparams from the
seed: a scale that spans about +-8 standard deviations of K and V
(estimated from the maker's distributions: about 1.05), so that no code
saturates, and a zero point on [-2, 2].
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from reference import PROJ

KV_STD = 1.05          # estimated standard deviation of K and V entries
LOGIT_STD = 4.0        # the spread of the logits the lm_head draws


def vocab_padded(vocab: int) -> int:
    return -(-vocab // 128) * 128


def shapes(model: dict) -> Dict[str, Tuple[int, int]]:
    """(K, N) of the five projections at the published widths."""
    d = model['head_num'] * model['size_per_head']
    kvd = model['kv_head_num'] * model['size_per_head']
    inter = model['inter_size']
    return {'wqkv': (d, d + 2 * kvd), 'wo': (d, d), 'w1': (d, inter),
            'w3': (d, inter), 'w2': (inter, d)}


def make(model: dict, seed: int, device,
         logit_std: float = LOGIT_STD) -> Dict:
    """The model's weights from ``seed`` on ``device``, the lm_head's
    logits spread by about ``logit_std``."""
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    bf = torch.bfloat16
    nl, group = model['num_layer'], model['group_size']
    d = model['head_num'] * model['size_per_head']
    vp = vocab_padded(model['vocab_size'])

    def normal(*shape, std=1.0, mean=0.0):
        x = torch.randn(shape, generator=gen, device=device)
        return (x * std + mean).to(bf)

    raw: Dict = {'embed': normal(vp, d, std=0.02),
                 'lm_head': normal(d, vp, std=logit_std / math.sqrt(d)),
                 'norm': normal(d, std=0.1, mean=1.0),
                 'attn_norm': normal(nl, d, std=0.1, mean=1.0),
                 'ffn_norm': normal(nl, d, std=0.1, mean=1.0)}
    for name in PROJ:
        k, n = shapes(model)[name]
        g = k // group
        s0 = 1.0 / (5.15 * math.sqrt(k))
        packed = torch.randint(0, 256, (nl, k // 2, n), generator=gen,
                               dtype=torch.uint8, device=device)
        scales = ((torch.rand((nl, g, n), generator=gen, device=device)
                   + 0.5) * s0).to(bf)
        zeros = torch.randint(4, 12, (nl, g, n), generator=gen,
                              dtype=torch.uint8, device=device)
        sz = (scales.float() * zeros.float()).to(bf)
        del zeros
        raw[name] = {'packed': packed, 'scales': scales, 'sz': sz}
    if model.get('attn_bias'):
        n = shapes(model)['wqkv'][1]
        raw['bqkv'] = normal(nl, n, std=0.1)
        if not model.get('qkv_bias_only'):
            raw['bo'] = normal(nl, d, std=0.1)
    return raw


def kv_qparams(num_layer: int, seed: int, bits: int) -> dict:
    """Static per-layer qparams of a ``bits`` pool (8 or 4) from the seed:
    lists ``k_scale``, ``k_zp``, ``v_scale``, ``v_zp`` over layers; the
    4-bit ones span the same range as the 8-bit ones."""
    gen = torch.Generator().manual_seed(seed % 2 ** 63 ^ 0x5EED)
    u = torch.rand((4, num_layer), generator=gen, dtype=torch.float64)
    scale8 = 8.0 * KV_STD / 127.0 * (0.95 + 0.1 * u[0::2])
    zp8 = 4.0 * u[1::2] - 2.0
    if bits == 8:
        scale, zp = scale8, zp8
    elif bits == 4:
        scale, zp = scale8 * 255.0 / 15.0, zp8 * 15.0 / 255.0
    else:
        raise ValueError(f'no {bits}-bit pool')
    # float32 values, as the pool keeps them
    scale, zp = scale.float().double(), zp.float().double()
    return {'bits': bits,
            'k_scale': scale[0].tolist(), 'k_zp': zp[0].tolist(),
            'v_scale': scale[1].tolist(), 'v_zp': zp[1].tolist()}


__all__ = ['make', 'kv_qparams', 'shapes', 'vocab_padded', 'KV_STD',
           'LOGIT_STD']
