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

Route split (T <= 8: the speculative verify) runs the same tile body with
all T*G rows of a kv head in one block and each slot's context cut into
splits of whole 64-token tiles by the plan every block computes on the
device (``prefill_attention.split_plan``); each split's ``(m, l, O)``
merges by log-sum-exp in split order.  Route wgmma runs the same
arithmetic on 64-row blocks (rows are independent, so the emulation does
not change with the block's height).

Both outputs are rounded to bf16, the kernel's output type, and compared
on valid rows within 1e-2, the gate ``chip_smoke.py`` and the card tests
hold the kernel to; padding rows must be finite.  The route rule and the
split plan are pure functions of shapes and contexts, tested here too.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lmdeploy_tpu.ops.pallas.prefill_attention import \
    paged_prefill_attention_batched as jax_prefill
from lmdeploy_tpu_torch.ops.cuda.prefill_attention import (prefill_route,
                                                          split_plan,
                                                          split_workers)

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
                q_pos = start + rows // g
                last = min(int(q_pos[-1]), end - 1)
                m, l, o = _walk(qr[rows], q_pos, ck, cv, end, qp[0] * sl2,
                                range(last // TILE + 1))
                out[b, rows // g, kh * g + rows % g] = _finish(
                    o / l.clamp(min=1e-20)[:, None], qp, kv_bits)
    return out


def _walk(qt, q_pos, ck, cv, end, mul, tiles):
    """One block's f32 online softmax in base 2 over 64-token KV ``tiles``
    (codes ck / cv of the slot's tokens, zero past ``end``): returns the
    rows' (m, l, O); an empty walk leaves m = -inf, l = 0, O = 0."""
    m = torch.full((len(qt),), -math.inf)
    l = torch.zeros(len(qt))
    o = torch.zeros(len(qt), DH)
    for tile in tiles:
        kv0 = tile * TILE
        kv = torch.arange(kv0, kv0 + TILE)
        s = (qt @ ck[kv0:kv0 + TILE].T) * mul
        vis = (kv[None] <= q_pos[:, None]) & (kv[None] < end)
        s = torch.where(vis, s, torch.tensor(-math.inf))
        m_new = torch.maximum(m, s.max(-1).values)
        base = torch.where(torch.isinf(m_new), torch.zeros_like(m_new),
                           m_new)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s - base[:, None])
        hi = _bf16(p)
        lo = _bf16(p - hi)
        l = l * alpha + p.sum(-1)
        o = o * alpha[:, None] + (hi + lo) @ cv[kv0:kv0 + TILE]
        m = m_new
    return m, l, o


def _finish(o, qp, kv_bits):
    """O / l of the codes to values: v_s (O / l - v_zp) for an int pool."""
    _, _, v_s, v_z = qp
    return (o - v_z) * v_s if kv_bits else o


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


def emulate_split(q, kc, vc, layer, pt, starts, ends, qp, kv_bits, workers):
    """Route split's arithmetic: every slot's splits from ``split_plan``
    (whole 64-token tiles; the rows' tiles up to their last position), a
    walk each, then the log-sum-exp merge of the splits' (m, l, O) in
    split order; a slot of one split divides directly.  Padding slots are
    zeros.  Returns f32 [B, T, H, Dh]."""
    b_n, t_n, h, _ = q.shape
    kh_n = kc.shape[-2]
    g = h // kh_n
    page = kc.shape[2]
    kv_cap = pt.shape[1] * page
    sl2 = DH ** -0.5 * math.log2(math.e)
    _, items = split_plan(ends, starts, workers, kv_cap)
    out = torch.zeros(b_n, t_n, h, DH)
    rows = torch.arange(t_n * g)
    for b in range(b_n):
        mine = [it for it in items if it[0] == b]
        if not mine:
            continue
        start, end = int(starts[b]), min(int(ends[b]), kv_cap)
        pos = torch.arange(-(-end // TILE) * TILE)
        phys = pt[b, (pos // page).clamp(max=pt.shape[1] - 1)].clamp(min=0)
        ok_tok = (pos < end)[:, None]
        q_pos = start + rows // g
        need = min(int(q_pos[-1]), end - 1) // TILE + 1
        for kh in range(kh_n):
            ck = _codes(kc[layer, phys, pos % page, kh], kv_bits) * ok_tok
            cv = _codes(vc[layer, phys, pos % page, kh], kv_bits) * ok_tok
            qt = _bf16(q[b, :, kh * g:(kh + 1) * g].reshape(t_n * g, DH))
            parts = [_walk(qt, q_pos, ck, cv, end, qp[0] * sl2,
                           range(tl, min(th, need)))
                     for _, _, _, tl, th in mine]
            if len(parts) == 1:
                m, l, o = parts[0]
                res = o / l.clamp(min=1e-20)[:, None]
            else:
                mx = torch.stack([m for m, _, _ in parts]).max(0).values
                base = torch.where(torch.isinf(mx), torch.zeros_like(mx), mx)
                w = [torch.exp2(m - base) for m, _, _ in parts]
                lsum = sum(l * wi for (_, l, _), wi in zip(parts, w))
                res = sum(o * wi[:, None] for (_, _, o), wi in
                          zip(parts, w)) / lsum.clamp(min=1e-20)[:, None]
            out[b, rows // g, kh * g + rows % g] = _finish(res, qp, kv_bits)
    return out


def _verify_case(rng, kv_bits, kh, g, page, t):
    """T-row chunks over 0, 58, 250 and 460 tokens of history (1 to 8
    tiles: tile and page edges, several splits), then a padding row
    (context_end == start_pos) with a stale context."""
    starts = np.array([0, 58, 250, 460, 300], np.int32)
    lens = np.array([t, t, t, t, 0], np.int32)
    ends = starts + lens
    b = len(starts)
    maxp = -(-int(ends.max()) // page) + 1
    p = b * maxp + 2
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
    pt = np.full((b, maxp), -1, np.int32)
    free = list(rng.permutation(p))
    for i in range(b):
        need = max(1, -(-int(ends[i]) // page))
        pt[i, :need] = [free.pop() for _ in range(need)]
    q = torch.from_numpy(rng.normal(size=(b, t, kh * g, DH)).astype(
        np.float32)).to(torch.bfloat16).float()
    return q, kc, vc, pt, starts, ends, lens


@pytest.mark.parametrize('page', [16, 64])
@pytest.mark.parametrize('g', [1, 4, 8])
@pytest.mark.parametrize('kv_bits', [0, 8, 4])
def test_split_route_arithmetic_matches_pallas(kv_bits, g, page):
    """Route split at the verify's T = 5 (T = 8 at G = 8: 64 rows in one
    block) with 1, 4 and 16 workers: slots of 1 to 8 splits, merged, and
    a padding row (zeros, finite), within 1e-2 of Pallas on valid rows."""
    t = 8 if g == 8 else 5
    rng = np.random.default_rng(300 + kv_bits + 10 * g + page)
    q, kc, vc, pt, starts, ends, lens = _verify_case(rng, kv_bits, 2, g,
                                                     page, t)
    qp = QPARAMS.get(kv_bits, (1.0, 0.0, 1.0, 0.0))
    want = jax_prefill(jnp.asarray(q.numpy()), jnp.asarray(kc.numpy()),
                       jnp.asarray(vc.numpy()), jnp.int32(1),
                       jnp.asarray(pt), jnp.asarray(starts),
                       jnp.asarray(ends), jnp.asarray(qp, jnp.float32),
                       quantized=bool(kv_bits), interpret=True, q_block=t)
    want = _bf16(torch.from_numpy(np.array(want, np.float32)))
    kv_cap = pt.shape[1] * page
    for workers in (1, 4, 16):
        _, items = split_plan(ends, starts, workers, kv_cap)
        splits = [n for b, s, n, _, _ in items if s == 0]
        assert max(splits) == {1: 1, 4: 2, 16: 8}[workers], splits
        got = emulate_split(q, kc, vc, 1, torch.from_numpy(pt), starts,
                            ends, qp, kv_bits, workers)
        assert torch.isfinite(got).all() and (got[-1] == 0).all()
        got = _bf16(got)
        for i, n in enumerate(lens):
            if n:
                err = (got[i, :n] - want[i, :n]).abs().max().item()
                assert err <= 1e-2, (workers, i, err)


def test_split_plan_covers_each_context_once():
    """Every live slot's splits cover its tiles [0, ceil(min(end, cap) /
    64)) once, in order and in whole tiles; padding slots have none; a
    slot has at most ``workers`` splits and all items number at most
    ``workers`` + live slots (the kernel's scratch)."""
    rng = np.random.default_rng(7)
    for _ in range(200):
        b = int(rng.integers(1, 12))
        starts = rng.integers(0, 3000, b)
        ends = starts + rng.integers(0, 9, b) * (rng.random(b) < 0.8)
        workers = int(rng.integers(1, 70))
        kv_cap = int(rng.choice([64, 1024, 4096]))
        per, items = split_plan(ends, starts, workers, kv_cap)
        live = [i for i in range(b) if ends[i] > starts[i]]
        assert len(items) <= workers + len(live)
        for i in range(b):
            mine = [it for it in items if it[0] == i]
            if i not in live:
                assert not mine
                continue
            tiles = -(-min(int(ends[i]), kv_cap) // 64)
            assert [s for _, s, _, _, _ in mine] == list(range(len(mine)))
            assert all(n == len(mine) <= workers for _, _, n, _, _ in mine)
            assert mine[0][3] == 0 and mine[-1][4] == tiles
            assert all(a[4] == c[3] for a, c in zip(mine, mine[1:]))
            assert all(0 < th - tl <= per for _, _, _, tl, th in mine)


# (B, T, H, KH, page, kv_bits) -> route: the engine's shapes (phase 5 of
# chip_smoke.py: 8 slots, Llama-2-7B heads, page 64; the prefill buckets
# 64 and 512; the k = 4 verify), a tp = 2 rank's heads, chip_smoke.py's
# kernel cases and the T = 8 / 9 boundary at G = 8
ROUTE_CASES = [
    ((8, 5, 32, 32, 64, 0), 'split'),      # verify round, 8 slots
    ((1, 5, 32, 32, 64, 0), 'split'),      # bs1 verify
    ((8, 5, 32, 32, 64, 8), 'split'),
    ((8, 5, 32, 32, 64, 4), 'split'),
    ((8, 5, 16, 16, 64, 0), 'split'),      # tp = 2 rank
    ((1, 512, 32, 32, 64, 0), 'wgmma'),    # 512 bucket
    ((1, 64, 32, 32, 64, 0), 'wgmma'),     # 64 bucket
    ((2, 64, 32, 32, 64, 0), 'wgmma'),     # a chunk and a padding row
    ((1, 512, 16, 16, 64, 0), 'wgmma'),    # tp = 2 rank
    ((1, 512, 32, 32, 64, 8), 'wgmma'),    # int8 / int4 chunks
    ((1, 64, 32, 32, 64, 4), 'wgmma'),
    ((3, 8, 32, 4, 16, 0), 'split'),       # T = 8, G = 8: 64 rows
    ((3, 9, 32, 4, 16, 0), 'wgmma'),
    ((3, 9, 32, 4, 16, 8), 'wgmma'),
    ((3, 8, 64, 4, 64, 0), 'wgmma'),       # T G = 128 rows: no split
    ((3, 64, 32, 32, 48, 0), 'mma'),       # page 48: no TMA box plan
    ((3, 64, 32, 32, 32, 8), 'wgmma'),     # page 32: two boxes a tile
    ((300, 64, 32, 32, 128, 4), 'wgmma'),
    ((300, 5, 32, 32, 64, 0), 'wgmma'),    # more slots than the plan holds
]


@pytest.mark.parametrize('shape,route', ROUTE_CASES)
def test_prefill_route_from_shapes(shape, route):
    assert prefill_route(*shape) == route


def test_split_workers_fill_the_card():
    """bs1 at Llama-2-7B heads: 264 resident blocks (132 SMs x 2) give 8
    workers a kv head, a tp = 2 rank's 16 heads 16, G = 8 (KH = 4) 66; a
    narrow table caps them at its tiles."""
    assert split_workers(32, 8, 32, 264) == 8
    assert split_workers(16, 8, 32, 264) == 16
    assert split_workers(4, 1, 32, 264) == 32
    assert split_workers(4, 8, 32, 264) == 66
    assert split_workers(32, 1, 2, 264) == 2
    assert split_workers(64, 1, 32, 32) == 1


def test_breakdown_variants_edit_the_kernel_source():
    """chip_smoke.py's opt-in breakdown phase times text-edited copies of
    kernel 3's source: every edit still matches the source (a stale one
    raises), each variant differs from it, and one_term drops exactly the
    lo term of P V."""
    import chip_smoke
    from lmdeploy_tpu_torch.ops.cuda import build
    src = (build.CSRC / 'paged_prefill_attention.cu').read_text()
    variants = chip_smoke.breakdown_variants(src)
    assert variants.pop('full') == src
    assert sorted(variants) == ['loads_only', 'no_merge', 'no_products',
                                'one_term']
    for text in variants.values():
        assert text != src
    assert src.replace('      wgmma_pv(o, pl[k2], dv);\n', '') == \
        variants['one_term']
    with pytest.raises(RuntimeError, match='does not match'):
        chip_smoke.breakdown_variants(src.replace('pl[k2]', 'lo[k2]'))
