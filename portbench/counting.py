"""Operations, bytes and least times of the work the benchmark measures.

Every count is reckoned from shapes and lengths the harness knows (the
model's configuration file, the arguments of each dispatch), never read
from the program.  Peaks are those of NVIDIA's H100 SXM data sheet (dense,
no sparsity), at the card's full power limit of 700 W:

- 989e12 FLOP/s in bf16 on the tensor cores;
- 3.35e12 bytes/s of HBM3.

A least time is max(bytes / PEAK_BYTES_S, flops / PEAK_FLOPS); a roofline
share is the sum of least times over the sum of measured times.  Bytes
count each input read once and each output written once.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

PEAK_FLOPS = 989e12        # bf16 dense, H100 SXM
PEAK_BYTES_S = 3.35e12     # HBM3, H100 SXM


def least_s(flops: float, nbytes: float) -> float:
    """The least time of work of ``flops`` operations over ``nbytes``."""
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS)


# -- the model's shapes -------------------------------------------------------

def projections(model: dict, padded: bool = True) -> List[Tuple[str, int, int]]:
    """(name, K, N) of one layer's five W4A16 products.  ``padded``: the
    shapes kernel 1 is handed, with inter rounded up to an even number of
    quantisation groups (an odd count cannot half-split: Qwen-14B's 107
    groups of 128 become 108); else the published shapes."""
    d = model['head_num'] * model['size_per_head']
    kvd = model['kv_head_num'] * model['size_per_head']
    inter = model['inter_size']
    if padded:
        q = 2 * model['group_size']
        inter = -(-inter // q) * q
    return [('wqkv', d, d + 2 * kvd), ('wo', d, d), ('w1', d, inter),
            ('w3', d, inter), ('w2', inter, d)]


def gemm_flops_bytes(m: int, k: int, n: int, group: int) -> Tuple[float, float]:
    """Kernel 1 on an [M, K] bf16 x and a nibble-packed [K, N] weight with
    one bf16 scale per group and column: 2MKN operations; the packed
    weight, its scales, x and the f32 [M, N] output."""
    flops = 2.0 * m * k * n
    nbytes = k * n / 2 + (k // group) * n * 2 + m * k * 2 + m * n * 4
    return flops, nbytes


def layer_gemm_least_s(model: dict, m: int) -> float:
    """Kernel 1's least time over one layer's five products at M rows."""
    if m <= 0:
        return 0.0
    g = model['group_size']
    return sum(least_s(*gemm_flops_bytes(m, k, n, g))
               for _, k, n in projections(model))


def kv_bytes_per_token(model: dict, kv_bits: int) -> float:
    """Bytes of one token's K and V in one layer of the pool (kv_bits 0:
    bf16)."""
    elem = {0: 2.0, 8: 1.0, 4: 0.5}[kv_bits]
    return 2 * model['kv_head_num'] * model['size_per_head'] * elem


def decode_attn_flops_bytes(model: dict, contexts: Iterable[int],
                            kv_bits: int) -> Tuple[float, float]:
    """Kernel 2 in one layer of one decode step over live slots whose
    contexts (tokens attended, the new one included) are ``contexts``:
    QK and PV, 4 H Dh per token attended; K and V of every token read,
    the new token's written, q read and o written in bf16."""
    h, dh = model['head_num'], model['size_per_head']
    ctx = list(contexts)
    flops = 4.0 * h * dh * sum(ctx)
    nbytes = kv_bytes_per_token(model, kv_bits) * (sum(ctx) + len(ctx)) \
        + len(ctx) * h * dh * 2 * 2
    return flops, nbytes


def prefill_attn_flops_bytes(model: dict, rows: Sequence[Tuple[int, int]],
                             kv_bits: int) -> Tuple[float, float]:
    """Kernel 3 in one layer of one prefill pass over rows (start, length):
    causal QK and PV (token i of a chunk that starts at s attends s + i + 1
    tokens); K and V of history and chunk read, q read and o written in
    bf16."""
    h, dh = model['head_num'], model['size_per_head']
    flops = nbytes = 0.0
    for s, n in rows:
        if n <= 0:
            continue
        flops += 4.0 * h * dh * (n * s + n * (n + 1) / 2)
        nbytes += kv_bytes_per_token(model, kv_bits) * (s + n) \
            + n * h * dh * 2 * 2
    return flops, nbytes


# -- the published model ------------------------------------------------------

def published_params(model: dict) -> Dict[str, int]:
    """Parameters of the published model in products per token: the
    layers' five projections at their published shapes, and the lm_head."""
    layers = model['num_layer'] * sum(k * n for _, k, n in
                                      projections(model, padded=False))
    lm_head = model['head_num'] * model['size_per_head'] \
        * model['vocab_size']
    return {'layers': layers, 'lm_head': lm_head}


def model_flops(model: dict, contexts: Iterable[int], logits: int) -> float:
    """Operations of the published model for tokens at the given contexts
    (tokens each attends, itself included), ``logits`` of which project
    onto the vocabulary: 2 x parameters a token, plus attention."""
    p = published_params(model)
    ctx = list(contexts)
    attn = 4.0 * model['num_layer'] * model['head_num'] \
        * model['size_per_head'] * sum(ctx)
    return 2.0 * p['layers'] * len(ctx) + 2.0 * p['lm_head'] * logits + attn


def decode_contexts(live: Sequence[Tuple[int, int]], steps: int) -> List[int]:
    """Contexts attended in a dispatch of ``steps`` decode steps by slots
    (context_len at issue, tokens still allowed): a slot at context c
    attends c + j + 1 tokens at step j while it still runs."""
    out = []
    for c, left in live:
        out.extend(c + j + 1 for j in range(min(steps, left)))
    return out


def prefill_contexts(rows: Sequence[Tuple[int, int]]) -> List[int]:
    """Contexts attended by every token of a pass's rows (start, length)."""
    return [s + i + 1 for s, n in rows for i in range(n)]


__all__ = ['PEAK_FLOPS', 'PEAK_BYTES_S', 'least_s', 'projections',
           'gemm_flops_bytes', 'layer_gemm_least_s', 'kv_bytes_per_token',
           'decode_attn_flops_bytes', 'prefill_attn_flops_bytes',
           'published_params', 'model_flops', 'decode_contexts',
           'prefill_contexts']
