"""The split decode-attention kernel's arithmetic, and the wgmma GEMM's
fold order, against the JAX kernels.

``lmdeploy_tpu_torch/csrc/paged_decode_attention.cu`` runs on the card
only.  This file emulates its arithmetic in PyTorch on the CPU and holds it
against the JAX package's three decode kernels (Pallas in interpret mode,
as tests/test_pallas.py runs them) on identical numpy inputs:

- each slot cuts its context into at most ``want`` splits of whole 64-token
  tiles (none spanning more than 126 pages), as the kernel does on the
  device; a split walks its 64-token tiles with an f32 online softmax in
  base 2: q times ``Dh^-0.5`` (mode 2: rope first, times qscale) times
  k_scale times log2(e), one max and one rescale per tile;
- int8 / int4 pools enter the sums as integer codes (int4: ``(n ^ 8) - 8``
  of the half-split nibbles) with the qparams outside them: the key zero
  point drops out (a constant per score row, which softmax cancels) and
  the output is ``v_scale (P C_v / l - v_zp)``;
- several splits merge by log-sum-exp; one split writes ``acc / l``;
- masked slots (valid == 0) of the storing modes come out as zeros.

The store itself (rope, quantise, pack) is the port's plain version, which
the card tests hold bit for bit against the kernel.  Both outputs are
rounded to bf16, the kernel's output type, and compared on valid rows
within 1e-2 abs, the gate ``chip_smoke.py`` and the card tests hold the
kernel to.

The GEMM's wgmma kernel folds one f32 partial per group into its sum in
the order low group gb, high group G/2 + gb; that order is emulated and,
with the plain version, held against ``packed_int4_matmul`` (interpret) at
the prefill shapes M = 128 and 512.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lmdeploy_tpu.ops.pallas import paged_attention as jpa
from lmdeploy_tpu.ops.pallas.quant_matmul import \
    packed_int4_matmul as jax_packed_matmul
from lmdeploy_tpu_torch.ops.cuda import paged_attention as tpa
from lmdeploy_tpu_torch.ops.cuda.quant_matmul import (unpack_nibbles,
                                                      w4a16_gemm_plain)

torch.set_num_threads(1)

DH, TILE = 128, 64
LOG2E = 1.4426950408889634
QPARAMS = {0: (1.0, 0.0, 1.0, 0.0), 8: (0.021, 1.5, 0.017, -2.0),
           4: (0.31, 0.5, 0.27, -0.5)}
MODES = ('attend', 'write', 'rope_write')
# contexts straddling tile, page and split edges, then a masked slot
CTXS = (1, 63, 64, 65, 511, 2048, 100)
MASKED = 6


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _codes(rows, kv_bits):
    """Pool rows [..., Dh(/2)] as the kernel sums them: bf16 values, int8
    codes, or int4 codes of the half-split nibbles."""
    if kv_bits == 4:
        n = torch.cat([rows & 0xF, rows >> 4], dim=-1).to(torch.int32)
        return ((n ^ 8) - 8).float()
    return rows.float()


def split_plan(n_tok, want, splits, page):
    """(tokens per split, live splits) of one slot, as the kernel cuts it."""
    cap = (126 * page) // TILE * TILE
    n = min(want, -(-n_tok // TILE))
    n = max(1, min(max(n, -(-n_tok // cap)), splits))
    tps = -(-(-(-n_tok // n)) // TILE) * TILE
    return tps, -(-n_tok // tps)


def emulate_kernel(q_eff, kc, vc, layer, pt, ctx, attend, qp, kv_bits,
                   want, splits):
    """The kernel's attention over the (already stored) pool, in f32.
    q_eff: f32 [B, H, Dh], already times k_scale * log2(e); attend [B]
    bool: slots that attend (others give zeros).  Returns f32 [B, H, Dh]."""
    b_n, h, _ = q_eff.shape
    page, kh_n = kc.shape[2], kc.shape[3]
    g = h // kh_n
    _, _, v_s, v_z = qp
    out = torch.zeros(b_n, h, DH)
    for b in range(b_n):
        n_tok = min(int(ctx[b]), pt.shape[1] * page)
        if not attend[b] or n_tok == 0:
            continue
        tps, n_live = split_plan(n_tok, want, splits, page)
        pos = torch.arange(n_tok)
        phys = pt[b, pos // page].clamp(min=0)
        for kh in range(kh_n):
            ck = _codes(kc[layer, phys, pos % page, kh], kv_bits)
            cv = _codes(vc[layer, phys, pos % page, kh], kv_bits)
            qg = q_eff[b, kh * g:(kh + 1) * g]
            parts = []
            for s in range(n_live):
                t0, t1 = s * tps, min((s + 1) * tps, n_tok)
                m = torch.full((g,), -math.inf)
                l = torch.zeros(g)
                acc = torch.zeros(g, DH)
                for k0 in range(t0, t1, TILE):
                    k1 = min(k0 + TILE, t1)
                    sc = qg @ ck[k0:k1].T                  # [G, n], base 2
                    m_new = torch.maximum(m, sc.max(-1).values)
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(sc - m_new[:, None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + p @ cv[k0:k1]
                    m = m_new
                parts.append((m, l, acc))
            if n_live == 1:
                m, l, acc = parts[0]
                o = acc / l.clamp(min=1e-20)[:, None]
            else:
                mx = torch.stack([m for m, _, _ in parts]).max(0).values
                w = [torch.exp2(m - mx) for m, _, _ in parts]
                lsum = sum(l * wi for (_, l, _), wi in zip(parts, w))
                o = sum(acc * wi[:, None] for (_, _, acc), wi in
                        zip(parts, w)) / lsum.clamp(min=1e-20)[:, None]
            if kv_bits:
                o = (o - v_z) * v_s
            out[b, kh * g:(kh + 1) * g] = o
    return out


def _pool(rng, shape, kv_bits):
    if kv_bits == 0:
        return _bf16(torch.from_numpy(rng.normal(size=shape).astype(
            np.float32))).numpy()
    if kv_bits == 8:
        return rng.integers(-128, 128, shape).astype(np.int8)
    return rng.integers(0, 256, shape[:-1] + (shape[-1] // 2,)).astype(
        np.uint8)


def _case(rng, kv_bits, g, page, kh=2):
    """CTXS slots over a table 2048 tokens wide, scattered disjoint pages;
    q, k_new, v_new rounded to bf16 (the kernel's input type)."""
    b = len(CTXS)
    maxp = 2048 // page
    p = sum(-(-c // page) for c in CTXS) + 4
    kc = _pool(rng, (2, p, page, kh, DH), kv_bits)
    vc = _pool(rng, (2, p, page, kh, DH), kv_bits)
    pt = np.full((b, maxp), -1, np.int32)
    free = list(rng.permutation(p))
    for i, c in enumerate(CTXS):
        pt[i, :-(-c // page)] = [free.pop() for _ in range(-(-c // page))]
    bf = [_bf16(torch.from_numpy(rng.normal(size=s).astype(np.float32)
                                 * scale)).numpy()
          for s, scale in (((b, kh * g, DH), 1.0), ((b, kh, DH), 2.0),
                           ((b, kh, DH), 2.0))]
    return (*bf, kc, vc, pt, np.array(CTXS, np.int32))


def _rope(half, ctx):
    inv = 10000.0 ** (-np.arange(half, dtype=np.float32) * 2 / (2 * half))
    ang = (ctx - 1).astype(np.float32)[:, None] * inv
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _run_jax(mode, q, kn, vn, kc, vc, pt, ctx, valid, qp, qscale, kv_bits):
    """The JAX kernel's output for ``mode`` (interpret mode)."""
    common = dict(quantized=kv_bits != 0, interpret=True)
    if mode == 'attend':
        return jpa.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(1),
            jnp.asarray(pt), jnp.asarray(ctx), jnp.asarray(qp), **common)
    if mode == 'write':
        return jpa.paged_decode_attention_write(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
            jnp.asarray(vc), jnp.int32(1), jnp.asarray(pt), jnp.asarray(ctx),
            jnp.asarray(valid), jnp.asarray(qp), **common)[2]
    cos_f, sin_f = jpa.rope_full_tables(*map(jnp.asarray, _rope(64, ctx)),
                                        DH)
    return jpa.paged_decode_attention_rope_write(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), cos_f, sin_f,
        jnp.asarray(qscale), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(1),
        jnp.asarray(pt), jnp.asarray(ctx), jnp.asarray(valid),
        jnp.asarray(qp), half=64, **common)[2]


def _emulate(mode, q, kn, vn, kc, vc, pt, ctx, valid, qp, qscale, kv_bits,
             want):
    """Store with the port's plain version, then the kernel's attention."""
    t = [torch.from_numpy(np.array(a)) for a in (q, kn, vn, kc, vc, pt, ctx,
                                                 valid, qscale)]
    tq, tkn, tvn, tk, tv, tpt, tctx, tvalid, tqs = t
    tqp = torch.tensor(qp) if kv_bits else None
    scale = DH ** -0.5
    if mode == 'attend':
        q_rot = tq * scale
    elif mode == 'write':
        tpa.paged_decode_attention_write_plain(tq, tkn, tvn, tk, tv, 1, tpt,
                                               tctx, tvalid, tqp)
        q_rot = tq * scale
    else:
        cos_f, sin_f = tpa.rope_full_tables(
            *map(torch.from_numpy, _rope(64, ctx)), DH)
        tpa.paged_decode_attention_rope_write_plain(
            tq, tkn, tvn, cos_f, sin_f, tqs, tk, tv, 1, tpt, tctx, tvalid,
            tqp, half=64)
        q_rot = tpa.rope_full(tq, cos_f, sin_f, 64) * (
            scale * tqs)[:, None, None]
    if kv_bits == 0:                 # the kernel's pool is bf16
        tk, tv = _bf16(tk), _bf16(tv)
    q_eff = q_rot * (qp[0] * LOG2E)
    attend = (torch.ones(len(ctx), dtype=torch.bool) if mode == 'attend'
              else tvalid.bool())
    splits = tpa.decode_splits(tpt.shape[1], tk.shape[2], want)
    return emulate_kernel(q_eff, tk, tv, 1, tpt, tctx, attend, qp, kv_bits,
                          want, splits)


@pytest.mark.parametrize('page', [16, 64])
@pytest.mark.parametrize('g', [1, 4])
@pytest.mark.parametrize('kv_bits', [0, 8, 4])
@pytest.mark.parametrize('mode', MODES)
def test_split_decode_arithmetic_matches_pallas(mode, kv_bits, g, page):
    """Contexts 1, 63, 64, 65, 511 and 2048 (tile, page and split edges)
    and a masked slot; up to 8 splits a slot (several live splits that
    merge) and 1 (the direct path)."""
    rng = np.random.default_rng(500 + 10 * kv_bits + g + page)
    q, kn, vn, kc, vc, pt, ctx = _case(rng, kv_bits, g, page)
    valid = np.ones(len(ctx), np.int32)
    valid[MASKED] = 0
    qp = QPARAMS[kv_bits]
    qscale = np.linspace(0.9, 1.2, len(ctx)).astype(np.float32)
    want = _bf16(torch.from_numpy(np.array(_run_jax(
        mode, q, kn, vn, kc, vc, pt, ctx, valid, np.float32(qp), qscale,
        kv_bits), np.float32)))
    ok = (np.ones(len(ctx), bool) if mode == 'attend'
          else valid.astype(bool))
    for splits_wanted in (8, 1):
        got = _emulate(mode, q, kn, vn, kc.copy(), vc.copy(), pt, ctx, valid,
                       qp, qscale, kv_bits, splits_wanted)
        assert torch.isfinite(got).all()
        if mode != 'attend':
            assert (got[MASKED] == 0).all()
        err = (_bf16(got) - want)[torch.from_numpy(ok)].abs().max().item()
        assert err <= 1e-2, (splits_wanted, err)


def test_split_plan_covers_each_context_once():
    """Every slot's live splits cover [0, n_tok) in whole tiles, no split
    spans more than 126 pages, and the grid holds them all."""
    for page in (1, 16, 64):
        for want in (1, 3, 8, 40):
            splits = tpa.decode_splits(2048 // page, page, want)
            for n_tok in (1, 63, 64, 65, 511, 2047, 2048):
                tps, live = split_plan(n_tok, want, splits, page)
                assert tps % TILE == 0 and live <= splits
                assert (live - 1) * tps < n_tok <= live * tps
                assert tps <= max(TILE, 126 * page // TILE * TILE)


def emulate_wgmma(x, packed, scales, layer):
    """The wgmma kernel's sum: per group an exact f32 partial of bf16 x
    and the nibbles, folded with its scales in the order low group gb,
    then high group G/2 + gb."""
    m, k = x.shape
    n = packed.shape[-1]
    s = scales[layer].reshape(-1, n).float()
    g_half = s.shape[0] // 2
    q = unpack_nibbles(packed[layer]).float()            # [K, N]
    xb = _bf16(x)
    acc = torch.zeros(m, n)
    for gb in range(g_half):
        for g in (gb, g_half + gb):
            rows = slice(g * 128, (g + 1) * 128)
            acc = acc + (xb[:, rows] @ q[rows]) * s[g]
    return acc


@pytest.mark.parametrize('m', [128, 512])
def test_wgmma_fold_and_plain_gemm_match_pallas(m):
    """At the prefill regime's shapes the plain GEMM and the emulated fold
    order agree with packed_int4_matmul (interpret) within the tolerance
    the card holds the kernel to, 1e-3 max|y| + 1e-3."""
    rng = np.random.default_rng(600 + m)
    k, n = 768, 256                        # 3 low and 3 high groups
    x = rng.normal(size=(m, k)).astype(np.float32)
    packed = rng.integers(0, 256, size=(2, k // 2, n), dtype=np.uint8)
    scales = _bf16(torch.from_numpy(rng.uniform(
        0.01, 0.1, size=(2, k // 128, 1, n)).astype(np.float32))).numpy()
    want = torch.from_numpy(np.array(jax_packed_matmul(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales, jnp.bfloat16),
        1, interpret=True), np.float32))
    args = (torch.from_numpy(x), torch.from_numpy(packed),
            torch.from_numpy(scales).to(torch.bfloat16), 1)
    tol = 1e-3 * want.abs().max().item() + 1e-3
    for got in (w4a16_gemm_plain(*args), emulate_wgmma(*args)):
        assert (got - want).abs().max().item() <= tol
