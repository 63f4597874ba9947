"""The tensor-core prefill kernel's arithmetic against the JAX kernel.

``lmdeploy_tpu_torch/csrc/paged_prefill_attention.cu`` runs on the card
only.  This file emulates its arithmetic in PyTorch on the CPU and holds
it against ``paged_prefill_attention_batched`` of the JAX package (Pallas
in interpret mode) on identical numpy inputs:

- 16-row q tiles (rows ``t * G + g`` of one KV head) walking 64-token KV
  tiles with an f32 online softmax in base 2 (``Dh^-0.5 * log2 e`` applied
  to the f32 scores, not to q);
- P entering P V as two bf16 terms, ``hi = bf16(p)`` and
  ``lo = bf16(p - hi)``: the one rounding the JAX kernel does not make
  (P once in bf16 would carry 2^-9 relative error per weight);
- int8 / int4 pools staged as their integer codes, with the qparams
  applied in f32 outside the products: ``S = k_s (Q C_k^T)`` (the key
  zero point adds ``-k_s k_zp rowsum(Q)``, one constant per row, which
  softmax cancels) and ``O = v_s (P C_v / l - v_zp)``.

Both outputs are rounded to bf16, the kernel's output type, and compared
on valid rows within 1e-2, the gate ``chip_smoke.py`` and the card tests
hold the kernel to; padding rows must be finite.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lmdeploy_tpu.ops.pallas.prefill_attention import \
    paged_prefill_attention_batched as jax_prefill

torch.set_num_threads(1)

DH, TILE, ROWS = 128, 64, 16
QPARAMS = {8: (0.021, 1.5, 0.017, -2.0), 4: (0.31, 0.5, 0.27, -0.5)}


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _codes(pool, kv_bits):
    """A pool layer's values as the kernel stages them in bf16: bf16 values
    (kv_bits 0), int8 codes, or int4 codes (n ^ 8) - 8 of the half-split
    nibbles (low nibble of byte j is feature j, high is j + Dh/2)."""
    if kv_bits == 4:
        n = torch.cat([pool & 0xF, pool >> 4], dim=-1).to(torch.int32)
        return ((n ^ 8) - 8).float()
    return pool.float()


def emulate_kernel(q, kc, vc, layer, pt, starts, ends, qp, kv_bits):
    """The kernel's arithmetic, tile by tile, in f32; returns f32
    [B, T, H, Dh] (padding row tiles are zeros, as the kernel writes)."""
    b_n, t_n, h, _ = q.shape
    kh_n = kc.shape[-2]
    g = h // kh_n
    page = kc.shape[2]
    sl2 = DH ** -0.5 * math.log2(math.e)
    out = torch.zeros(b_n, t_n, h, DH)
    for b in range(b_n):
        start, end = int(starts[b]), int(ends[b])
        n_kv = -(-end // TILE) * TILE
        pos = torch.arange(n_kv)
        phys = pt[b, (pos // page).clamp(max=pt.shape[1] - 1)].clamp(min=0)
        ok_tok = (pos < end)[:, None]
        for kh in range(kh_n):
            ck = _codes(kc[layer, phys, pos % page, kh], kv_bits) * ok_tok
            cv = _codes(vc[layer, phys, pos % page, kh], kv_bits) * ok_tok
            qr = _bf16(q[b, :, kh * g:(kh + 1) * g].reshape(t_n * g, DH))
            for r0 in range(0, t_n * g, ROWS):
                rows = torch.arange(r0, min(r0 + ROWS, t_n * g))
                if r0 // g >= end - start:
                    continue                        # padding: zeros
                qt = qr[rows]
                q_pos = start + rows // g
                k_s, _, v_s, v_z = qp
                mul = k_s * sl2
                m = torch.full((len(rows),), -math.inf)
                l = torch.zeros(len(rows))
                o = torch.zeros(len(rows), DH)
                last = min(int(q_pos[-1]), end - 1)
                for kv0 in range(0, last // TILE * TILE + 1, TILE):
                    kv = torch.arange(kv0, kv0 + TILE)
                    s = (qt @ ck[kv0:kv0 + TILE].T) * mul
                    vis = (kv[None] <= q_pos[:, None]) & (kv[None] < end)
                    s = torch.where(vis, s, torch.tensor(-math.inf))
                    m_new = torch.maximum(m, s.max(-1).values)
                    base = torch.where(torch.isinf(m_new),
                                       torch.zeros_like(m_new), m_new)
                    alpha = torch.exp2(m - base)
                    p = torch.exp2(s - base[:, None])
                    hi = _bf16(p)
                    lo = _bf16(p - hi)
                    l = l * alpha + p.sum(-1)
                    o = o * alpha[:, None] + (hi + lo) @ cv[kv0:kv0 + TILE]
                    m = m_new
                res = o / l.clamp(min=1e-20)[:, None]
                if kv_bits:
                    res = (res - v_z) * v_s
                out[b, rows // g, kh * g + rows % g] = res
    return out


def _case(rng, kv_bits, kh, g, page, t):
    """A chunk from 0, a 40-token chunk over 100 tokens of history (padded
    to t), and a padding row (context_end == start_pos)."""
    starts = np.array([0, 100, 9], np.int32)
    lens = np.array([t, 40, 0], np.int32)
    ends = starts + lens
    maxp = -(-int(ends.max()) // page) + 1
    p = 3 * maxp + 2
    shape = (2, p, page, kh, DH)
    if kv_bits == 0:
        kc, vc = (torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(torch.bfloat16).float() for _ in range(2))
    elif kv_bits == 8:
        kc, vc = (torch.from_numpy(rng.integers(-128, 128, shape).astype(
            np.int8)) for _ in range(2))
    else:
        kc, vc = (torch.from_numpy(rng.integers(
            0, 256, shape[:-1] + (DH // 2,)).astype(np.uint8))
            for _ in range(2))
    pt = np.full((3, maxp), -1, np.int32)
    free = list(rng.permutation(p))
    for i in range(3):
        need = max(1, -(-int(ends[i]) // page))
        pt[i, :need] = [free.pop() for _ in range(need)]
    q = torch.from_numpy(rng.normal(size=(3, t, kh * g, DH)).astype(
        np.float32)).to(torch.bfloat16).float()
    return q, kc, vc, pt, starts, ends, lens


@pytest.mark.parametrize('page', [16, 64])
@pytest.mark.parametrize('g', [1, 4])
@pytest.mark.parametrize('kv_bits', [0, 8, 4])
def test_prefill_kernel_arithmetic_matches_pallas(kv_bits, g, page):
    rng = np.random.default_rng(200 + kv_bits + 10 * g + page)
    t = 64
    q, kc, vc, pt, starts, ends, lens = _case(rng, kv_bits, 2, g, page, t)
    qp = QPARAMS.get(kv_bits, (1.0, 0.0, 1.0, 0.0))
    want = jax_prefill(jnp.asarray(q.numpy()), jnp.asarray(kc.numpy()),
                       jnp.asarray(vc.numpy()), jnp.int32(1),
                       jnp.asarray(pt), jnp.asarray(starts),
                       jnp.asarray(ends), jnp.asarray(qp, jnp.float32),
                       quantized=bool(kv_bits), interpret=True, q_block=t)
    got = emulate_kernel(q, kc, vc, 1, torch.from_numpy(pt), starts, ends,
                         qp, kv_bits)
    assert torch.isfinite(got).all()
    want = _bf16(torch.from_numpy(np.array(want, np.float32)))
    got = _bf16(got)
    for i, n in enumerate(lens):
        if n:
            err = (got[i, :n] - want[i, :n]).abs().max().item()
            assert err <= 1e-2, (i, err)
