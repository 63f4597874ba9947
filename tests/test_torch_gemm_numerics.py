"""The W4A16 GEMM's wgmma routes: their summation order, their route rule
and their split plan, against the JAX kernel.

``lmdeploy_tpu_torch/csrc/w4a16_gemm.cu`` runs on the card only.  This
file emulates, in f32 on the CPU, the order in which its wgmma regime sums
(``w4a16_wgmma``):

- per half group gb, one exact partial per group (bf16 x times the
  nibbles; the products are exact in f32) folded into the running sum
  with that group's scales, low group gb first, then high group G/2 + gb;
- route ``tiles`` walks every half group in order into one sum;
- route ``splitk`` cuts the half groups into S splits
  (``quant_matmul.split_range``), each folded as above from zero, and the
  S partials are added in split index order.

Each emulation is held to ``packed_int4_matmul`` (Pallas in interpret
mode, as the JAX package's own tests run it on the CPU) and to the port's
plain version on identical numpy inputs, within 1e-3 max|y| + 1e-3, the
tolerance ``chip_smoke.py`` and the card tests hold the kernel to.  The
route rule (``gemm_route``: at every group that is a multiple of 16 and
every M, the decode steps' M <= 8 too, one of the wgmma kernel's two
routes) and the split plan (``splitk_splits``, ``split_range``) are pure
functions of shapes, tested here at the main path's shapes.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lmdeploy_tpu.ops.pallas.quant_matmul import \
    packed_int4_matmul as jax_packed_matmul
from lmdeploy_tpu_torch.ops.cuda.quant_matmul import (
    SPLITK_MAX, gemm_route, split_range, splitk_splits, unpack_nibbles,
    w4a16_gemm_plain, wgmma_rows)

torch.set_num_threads(1)

SMS = 132                 # an H100 SXM's streaming multiprocessors
K, N = 1024, 272          # 4 half groups; 3 column tiles, the last of 16
LLAMA2_7B = ((4096, 12288), (4096, 4096), (4096, 11008), (4096, 11008),
             (11008, 4096))
# one rank's projections at tp = 2 (inter 11008 padded to 11264)
TP2 = ((4096, 6144), (2048, 4096), (4096, 5632), (4096, 5632), (5632, 4096))


def _bf16(x):
    return x.to(torch.bfloat16).float()


@functools.lru_cache(maxsize=None)
def _case(m):
    rng = np.random.default_rng(1300 + m)
    x = rng.normal(size=(m, K)).astype(np.float32)
    packed = rng.integers(0, 256, size=(2, K // 2, N), dtype=np.uint8)
    scales = _bf16(torch.from_numpy(rng.uniform(
        0.01, 0.1, size=(2, K // 128, 1, N)).astype(np.float32))).numpy()
    want = np.array(jax_packed_matmul(
        jnp.asarray(x), jnp.asarray(packed),
        jnp.asarray(scales, jnp.bfloat16), 1, interpret=True), np.float32)
    return x, packed, scales, want


def emulate_route(x, packed, scales, layer, splits):
    """The wgmma kernel's sum over ``splits`` splits of the half groups
    (1: route tiles), in its order; f32 [M, N]."""
    m, k = x.shape
    n = packed.shape[-1]
    s = scales[layer].reshape(-1, n).float()
    g_half = s.shape[0] // 2
    q = unpack_nibbles(packed[layer]).float()            # [K, N]
    xb = _bf16(x)
    y = None
    for split in range(splits):
        lo, hi = split_range(split, splits, g_half)
        acc = torch.zeros(m, n)
        for gb in range(lo, hi):
            for g in (gb, g_half + gb):
                rows = slice(g * 128, (g + 1) * 128)
                acc = acc + (xb[:, rows] @ q[rows]) * s[g]
        y = acc if y is None else y + acc
    return y


@pytest.mark.parametrize('route', ['splitk', 'tiles'])
@pytest.mark.parametrize('m', [1, 4, 8, 9, 40, 64, 130, 512])
def test_route_sum_order_matches_pallas_and_plain(m, route):
    """Each route's emulated order (splitk at the plan's S, or two splits
    where the plan takes one; tiles in one sum) and the plain version
    agree with packed_int4_matmul (interpret) within 1e-3 max|y| + 1e-3, at
    ragged N, at the decode steps' M <= 8 and at M on both sides of the
    64-row tiles."""
    x, packed, scales, want = _case(m)
    splits = (max(2, splitk_splits(m, K, N, SMS, 128)) if route == 'splitk'
              else 1)
    args = (torch.from_numpy(x), torch.from_numpy(packed),
            torch.from_numpy(scales).to(torch.bfloat16), 1)
    want = torch.from_numpy(want)
    tol = 1e-3 * want.abs().max().item() + 1e-3
    for got in (emulate_route(*args, splits), w4a16_gemm_plain(*args)):
        assert got.shape == (m, N)
        assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize('splits', [1, 2, 3, 4])
def test_split_orders_agree_with_each_other(splits):
    """Every split count the plan can take at K = 1024 gives one answer up
    to f32 rounding: the splits change the order of the sum, not its
    terms."""
    x, packed, scales, _ = _case(40)
    args = (torch.from_numpy(x), torch.from_numpy(packed),
            torch.from_numpy(scales).to(torch.bfloat16), 1)
    ref = emulate_route(*args, 1)
    got = emulate_route(*args, splits)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize('k', [4096, 11008])
@pytest.mark.parametrize('m', [1, 4, 8])
def test_decode_rows_sum_order_matches_pallas(m, k):
    """The decode steps' rows at Llama-2-7B's K: the order of route tiles
    (wqkv, w1, w3) and of route splitk at the plan's S for wo and w2 (N =
    4096: four splits), on 272 columns of such a projection, agree with
    packed_int4_matmul (interpret) within 1e-3 max|y| + 1e-3."""
    rng = np.random.default_rng(1400 + m + k)
    n = 272
    x = rng.normal(size=(m, k)).astype(np.float32)
    packed = rng.integers(0, 256, size=(1, k // 2, n), dtype=np.uint8)
    scales = _bf16(torch.from_numpy(rng.uniform(
        0.01, 0.1, size=(1, k // 128, 1, n)).astype(np.float32))).numpy()
    want = torch.from_numpy(np.array(jax_packed_matmul(
        jnp.asarray(x), jnp.asarray(packed),
        jnp.asarray(scales, jnp.bfloat16), 0, interpret=True), np.float32))
    args = (torch.from_numpy(x), torch.from_numpy(packed),
            torch.from_numpy(scales).to(torch.bfloat16), 0)
    splits = splitk_splits(m, k, 4096, SMS, 128)
    assert splits == 4 and gemm_route(m, k, 4096, SMS, 128) == 'splitk'
    tol = 1e-3 * want.abs().max().item() + 1e-3
    for s in (1, splits):
        assert (emulate_route(*args, s) - want).abs().max().item() <= tol


@pytest.mark.parametrize('k,n', LLAMA2_7B + TP2)
def test_gemm_route_at_main_path_shapes(k, n):
    """At group 128 every M takes the wgmma kernel: decode steps (M = 8),
    a bs1 step (M = 1) and the pp = 2 ring's microbatches (M = 4, 2) as
    much as the verify (8 slots x (k + 1) = 40 rows) and the buckets; the
    route is splitk exactly where the output tiles fill at most half the
    card, at every 7B and tp = 2 rank projection, and the 512-row bucket
    takes tiles."""
    assert gemm_route(512, k, n, SMS, 128) == 'tiles'
    assert splitk_splits(512, k, n, SMS, 128) == 1
    for m in (1, 2, 4, 8, 9, 16, 40, 64, 65, 128, 256):
        tiles = -(-n // 128) * -(-m // wgmma_rows(m))
        s = splitk_splits(m, k, n, SMS, 128)
        assert gemm_route(m, k, n, SMS, 128) == ('splitk' if s > 1
                                                 else 'tiles')
        assert (s > 1) == (2 * tiles <= SMS)
        assert s <= SPLITK_MAX and tiles * s <= max(tiles, SMS)


def test_gemm_route_at_the_verify():
    """The verify's M = 40: wo and w2 (32 column tiles) split K four ways
    (128 items, one wave), wqkv, w1 and w3 (96 / 86 tiles) run unsplit;
    every projection of a tp = 2 rank (32-48 tiles) splits."""
    routes = [gemm_route(40, k, n, SMS, 128) for k, n in LLAMA2_7B]
    assert routes == ['tiles', 'splitk', 'tiles', 'tiles', 'splitk']
    assert [splitk_splits(40, k, n, SMS, 128) for k, n in LLAMA2_7B] == [
        1, 4, 1, 1, 4]
    assert all(gemm_route(40, k, n, SMS, 128) == 'splitk' for k, n in TP2)
    assert [splitk_splits(40, k, n, SMS, 128) for k, n in TP2] == [
        2, 4, 3, 3, 4]


def test_gemm_route_keeps_other_groups_on_the_decode_kernel():
    """The kernel that serves the decode steps is the wgmma kernel at
    every group (the mma.sync decode kernel the name refers to is gone):
    groups that are not multiples of 64 (16, 32, 48) take its step form
    and multiples of 64 (64, 128) its stage pieces, on the wgmma routes at
    every M, each on the route its split plan gives."""
    for m in (1, 8, 9, 40, 64, 65, 512):
        for k, n, group in ((1536, 256, 48), (1536, 256, 32),
                            (1536, 256, 16), (1536, 256, 64),
                            (4096, 4096, 128)):
            route = gemm_route(m, k, n, SMS, group)
            assert route == ('splitk' if splitk_splits(m, k, n, SMS, group)
                             > 1 else 'tiles')
    assert gemm_route(1, 4096, 4096, SMS, 128) == 'splitk'
    assert gemm_route(1, 1536, 256, SMS, 32) == 'splitk'


def test_tiles_that_underfill_the_card_split():
    """At M = 128 wqkv has 96 tiles of 128 x 128 and keeps one item each;
    wo and w2 have 32, which would leave 100 SMs idle, so they split; at
    M = 512 (128 tiles) none splits."""
    assert gemm_route(128, 4096, 12288, SMS, 128) == 'tiles'
    assert gemm_route(128, 4096, 4096, SMS, 128) == 'splitk'
    assert gemm_route(128, 11008, 4096, SMS, 128) == 'splitk'
    assert gemm_route(512, 11008, 4096, SMS, 128) == 'tiles'


@pytest.mark.parametrize('k', [512, 1024, 2816, 4096, 5632, 11008])
def test_split_plan_covers_each_group_once(k):
    """For every split count the kernel takes (1 to min(K/256,
    SPLITK_MAX)), the splits' half groups cover [0, K/256) in order, each
    non-empty, so every group (low gb and high K/256 + gb) is summed
    exactly once."""
    g_half = k // 256
    for splits in range(1, min(g_half, SPLITK_MAX) + 1):
        seen = []
        prev_hi = 0
        for split in range(splits):
            lo, hi = split_range(split, splits, g_half)
            assert lo == prev_hi and hi > lo
            prev_hi = hi
            for gb in range(lo, hi):
                seen += [gb, g_half + gb]
        assert prev_hi == g_half
        assert sorted(seen) == list(range(2 * g_half))


def test_wgmma_rows_round_m_up():
    """x tiles are M rounded up to 8 rows (at least 16) up to 64 (wgmma
    n16 to n64; the verify's 40 rows take n40), else 128 rows in row
    tiles."""
    assert [wgmma_rows(m) for m in (9, 16, 17, 24, 25, 32, 40, 41, 48, 57,
                                    64, 65, 128, 512)] == [
        16, 16, 24, 24, 32, 32, 40, 48, 48, 64, 64, 128, 128, 128]


def test_gemm_breakdown_variants_edit_the_kernel_source():
    """chip_smoke.py's opt-in breakdown phase times text-edited copies of
    kernel 1's source: every edit still matches the source (a stale one
    raises), each variant differs from it, no_order and all_order only flip
    the ping-pong switch, weight_only keeps no x tile load, the step
    form's three variants each guard or replace one line of it, and
    steps_runtime sends every step group to the runtime step count."""
    import chip_smoke
    from lmdeploy_tpu_torch.ops.cuda import build
    src = (build.CSRC / 'w4a16_gemm.cu').read_text()
    variants = chip_smoke.gemm_breakdown_variants(src)
    assert variants.pop('full') == src
    assert sorted(variants) == ['all_order', 'loads_only', 'no_abuild',
                                'no_order', 'no_products',
                                'steps_no_abuild', 'steps_no_fold',
                                'steps_no_products', 'steps_runtime',
                                'weight_only']
    for name in ('steps_no_abuild', 'steps_no_fold', 'steps_no_products'):
        assert len(variants[name].splitlines()) <= len(src.splitlines())
    for text in variants.values():
        assert text != src
    switch = '  constexpr bool kPingPong = BM > 64;'
    for name, value in (('no_order', 'false'), ('all_order', 'true')):
        assert variants[name] == src.replace(
            switch, f'  constexpr bool kPingPong = {value};')
    assert '&tm_x, krow' in src and '&tm_x, krow' not in \
        variants['weight_only']
    assert variants['steps_runtime'] == src.replace(
        '  switch (group / 16) {', '  switch (0) {')
    with pytest.raises(RuntimeError, match='does not match'):
        chip_smoke.gemm_breakdown_variants(src.replace('kPingPong = BM',
                                                       'kPingPong = M'))
