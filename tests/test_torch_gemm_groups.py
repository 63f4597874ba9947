"""Kernel 1 over the JAX kernel's whole domain of groups: every group that
is a multiple of 16, at every M.

``lmdeploy_tpu/ops/pallas/quant_matmul.py::packed_int4_matmul`` takes any
group that divides K/2 with an even group count, and every M (an M grid
axis).  The port serves a group that is a multiple of 64 on the wgmma
kernel (routes ``splitk`` and ``tiles``) and any other multiple of 16 on
the decode kernel (route ``decode``, in slabs of M), at every M.
The kernels run on the card only; here, on the CPU:

- the plain version against ``packed_int4_matmul`` (Pallas in interpret
  mode, as the JAX package's own tests run it) at groups 32, 64 and 256;
- the wgmma kernel's summation order at groups 64 and 256 (its pieces:
  one partial of 64 or 128 packed rows, folded with the group's scales)
  against the same;
- ``gemm_route`` / ``splitk_splits`` as tables over groups 32, 48, 64, 128
  and 256;
- the wrapper's host side at every (group, M), with the kernels' library
  replaced by a recorder: no ValueError, and what it hands the C entry
  point passes that entry point's own checks (a copy of them).
"""
import functools
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lmdeploy_tpu.ops.pallas.quant_matmul import \
    packed_int4_matmul as jax_packed_matmul
from lmdeploy_tpu_torch.ops.cuda import counts
from lmdeploy_tpu_torch.ops.cuda import quant_matmul as QM
from lmdeploy_tpu_torch.ops.cuda.quant_matmul import (
    SPLITK_MAX, gemm_route, split_range, splitk_splits, unpack_nibbles,
    w4a16_gemm_plain, wgmma_rows)

torch.set_num_threads(1)

SMS = 132                 # an H100 SXM's streaming multiprocessors
K, N = 1024, 272          # groups of 32 / 64 / 256: 32 / 16 / 4 of them
GROUPS = (32, 48, 64, 128, 256)
ROWS = (1, 8, 40, 96, 513)


def _bf16(x):
    return x.to(torch.bfloat16).float()


@functools.lru_cache(maxsize=None)
def _case(m, group):
    rng = np.random.default_rng(1500 + m + group)
    x = rng.normal(size=(m, K)).astype(np.float32)
    packed = rng.integers(0, 256, size=(2, K // 2, N), dtype=np.uint8)
    scales = _bf16(torch.from_numpy(rng.uniform(
        0.01, 0.1, size=(2, K // group, 1, N)).astype(np.float32))).numpy()
    want = np.array(jax_packed_matmul(
        jnp.asarray(x), jnp.asarray(packed),
        jnp.asarray(scales, jnp.bfloat16), 1, interpret=True), np.float32)
    return x, packed, scales, want


def _torch_args(x, packed, scales):
    return (torch.from_numpy(x), torch.from_numpy(packed),
            torch.from_numpy(scales).to(torch.bfloat16), 1)


def wgmma_piece(group):
    """Stages (64 packed rows each) that one partial of the wgmma kernel
    spans: two where a half group has an even count of stages, else one
    (``w4a16_gemm.cu::wgmma_piece``)."""
    return 2 if (group // 64) % 2 == 0 else 1


def emulate_wgmma(x, packed, scales, layer, splits, group):
    """The wgmma kernel's sum at ``group`` over ``splits`` splits of the
    half groups, in its order: per half group, pieces of 64 P rows, each
    piece's low then high partial folded with its group's scales."""
    m, k = x.shape
    n = packed.shape[-1]
    s = scales[layer].reshape(-1, n).float()
    g_half = s.shape[0] // 2
    q = unpack_nibbles(packed[layer]).float()            # [K, N]
    xb = _bf16(x)
    rows = 64 * wgmma_piece(group)
    y = None
    for split in range(splits):
        lo, hi = split_range(split, splits, g_half)
        acc = torch.zeros(m, n)
        for gb in range(lo, hi):
            for r0 in range(0, group, rows):
                for g in (gb, g_half + gb):
                    part = slice(g * group + r0, g * group + r0 + rows)
                    acc = acc + (xb[:, part] @ q[part]) * s[g]
        y = acc if y is None else y + acc
    return y


@pytest.mark.parametrize('m', ROWS)
@pytest.mark.parametrize('group', [32, 64, 256])
def test_plain_matches_pallas_at_every_group(group, m):
    """The plain version (the CPU side of every wrapper) agrees with
    packed_int4_matmul (interpret) within 1e-3 max|y| + 1e-3 at groups 32,
    64 and 256, at the decode steps' M, the verify's 40, a row count
    between the decode kernel's slabs and one past the 512-row bucket."""
    x, packed, scales, want = _case(m, group)
    got = w4a16_gemm_plain(*_torch_args(x, packed, scales))
    want = torch.from_numpy(want)
    assert got.shape == (m, N)
    assert (got - want).abs().max().item() <= \
        1e-3 * want.abs().max().item() + 1e-3


@pytest.mark.parametrize('m', [1, 40, 513])
@pytest.mark.parametrize('group', [64, 256])
def test_wgmma_order_at_other_groups_matches_pallas(group, m):
    """The wgmma kernel's order at group 64 (one partial a group of one
    stage) and 256 (two partials of 128 rows a group, each folded with its
    scales), on route tiles and on route splitk at the plan's S (or two),
    agrees with packed_int4_matmul (interpret) within 1e-3 max|y| +
    1e-3."""
    x, packed, scales, want = _case(m, group)
    args = _torch_args(x, packed, scales)
    want = torch.from_numpy(want)
    tol = 1e-3 * want.abs().max().item() + 1e-3
    splits = max(2, splitk_splits(m, K, N, SMS, group))
    for s in (1, splits):
        assert (emulate_wgmma(*args, s, group) - want).abs().max().item() \
            <= tol


def test_wgmma_order_at_group_128_is_the_parent_order():
    """At group 128 a partial spans the whole group (two stages), so the
    order is one partial a group, low then high: the order the kernel
    had when it took group 128 only."""
    x, packed, scales, _ = _case(40, 64)
    x, packed = torch.from_numpy(x), torch.from_numpy(packed)
    rng = np.random.default_rng(3)
    s = _bf16(torch.from_numpy(rng.uniform(
        0.01, 0.1, size=(2, K // 128, 1, N)).astype(np.float32)))
    s = s.to(torch.bfloat16)
    got = emulate_wgmma(x, packed, s, 1, 1, 128)
    q = unpack_nibbles(packed[1]).float()
    sf = s[1].reshape(-1, N).float()
    acc = torch.zeros(40, N)
    for gb in range(K // 256):
        for g in (gb, K // 256 + gb):
            rows = slice(g * 128, (g + 1) * 128)
            acc = acc + (_bf16(x)[:, rows] @ q[rows]) * sf[g]
    assert torch.equal(got, acc)


# (K, N) of Llama-2-7B's projections, w2 at a K each group divides into
# an even count (11008 at 32, 64, 128; padded to 11264 at 256; 11520 at 48)
SHAPES = {32: 11008, 48: 11520, 64: 11008, 128: 11008, 256: 11264}


@pytest.mark.parametrize('group', GROUPS)
def test_gemm_route_table_over_groups(group):
    """At every M, a group that is a multiple of 64 takes the wgmma
    kernel's routes (splitk exactly where the output tiles fill at most
    half the card, with at most SPLITK_MAX splits of the K / (2 group)
    half groups) and any other group the decode route."""
    gemms = ((4096, 12288), (4096, 4096), (4096, 11008),
             (SHAPES[group], 4096))
    for k, n in gemms:
        g_half = k // (2 * group)
        for m in (1, 2, 8, 9, 40, 64, 65, 128, 512, 1000):
            route = gemm_route(m, k, n, SMS, group)
            s = splitk_splits(m, k, n, SMS, group)
            tiles = -(-n // 128) * -(-m // wgmma_rows(m))
            if group % 64:
                assert route == 'decode'
                continue
            assert route == ('splitk' if s > 1 else 'tiles')
            assert 1 <= s <= min(SPLITK_MAX, g_half)
            assert (s > 1) == (2 * tiles <= SMS and g_half > 1)


def test_gemm_route_table_at_7b_decode_and_verify():
    """The table at the decode step's M = 8 and the verify's M = 40 over
    one Llama-2-7B layer (wqkv, wo, w1, w2): groups 64, 128 and 256 split
    wo and w2 four ways (32 column tiles) and run wqkv and w1 unsplit;
    groups 32 and 48 take the decode route."""
    for m in (8, 40):
        for group in GROUPS:
            got = [(gemm_route(m, k, n, SMS, group),
                    splitk_splits(m, k, n, SMS, group))
                   for k, n in ((4096, 12288), (4096, 4096), (4096, 11008),
                                (SHAPES[group], 4096))]
            if group % 64:
                assert [r for r, _ in got] == ['decode'] * 4
            else:
                assert got == [('tiles', 1), ('splitk', 4), ('tiles', 1),
                               ('splitk', 4)]


def test_a_single_half_group_never_splits():
    """K = 2 group has one half group: the plan keeps it on route tiles at
    every M, and a forced splitk is refused by the wrapper."""
    for group in (64, 128, 256):
        for m in (1, 8, 40, 512):
            assert splitk_splits(m, 2 * group, 256, SMS, group) == 1
            assert gemm_route(m, 2 * group, 256, SMS, group) == 'tiles'


def _decode_splits(k, group):
    """``w4a16_gemm.cu::decode_splits``."""
    gs = group // 16
    steps = 4 if gs % 4 == 0 else (2 if gs % 2 == 0 else 1)
    rows = 4 * steps * 16
    return (k // 2 + rows - 1) // rows


class _Recorder:
    """Stands in for the kernels' library: records each lmd_w4a16_gemm
    call and checks it as the C entry point does before it launches."""

    def __init__(self):
        self.calls = []

    def lmd_w4a16_decode_splits(self, k, group):
        return _decode_splits(k, group) if group > 0 and group % 16 == 0 \
            else -1

    def lmd_w4a16_gemm(self, x, packed, scales, y, ws, counter, m, k, n,
                       group, regime, splits, stream):
        ok = m > 0 and n % 16 == 0 and k % 16 == 0
        if regime == 0:
            ok = ok and group % 16 == 0 and (k // 2) % group == 0 and (
                _decode_splits(k, group) == 1 or (ws and counter
                                                  and ws % 16 == 0))
        else:
            ok = ok and regime == 1 and group > 0 and group % 64 == 0 and (
                k // 2) % group == 0 and 1 <= splits <= k // (2 * group) \
                and splits <= 8 and (splits == 1 or (ws and counter)) \
                and x % 16 == 0 and packed % 16 == 0 and scales % 16 == 0
        self.calls.append((m, k, n, group, regime, splits, ok))
        return 0 if ok else 1


@pytest.mark.parametrize('group', GROUPS)
def test_wrapper_takes_every_group_at_every_m(monkeypatch, group):
    """The wrapper's host side (its checks, the route, the split plan, the
    workspace and the ticket counters) at every group and M, the kernels'
    library replaced by a recorder holding each call to the C entry
    point's own checks: no ValueError, the route gemm_route picks, the
    wgmma regime at multiples of 64 and the decode regime otherwise, a
    workspace of S x M x N floats where the sum is split, and one count
    under the kernel, the regime and the route."""
    rec = _Recorder()
    monkeypatch.setattr(QM.build, 'load', lambda: rec)
    monkeypatch.setattr(QM, 'sm_count', lambda device: SMS)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    empty = torch.empty
    spaces = []

    def recording_empty(shape, *a, **kw):
        t = empty(shape, *a, **kw)
        if kw.get('dtype') == torch.float32 and len(shape) == 3:
            spaces.append(tuple(shape))
        return t
    monkeypatch.setattr(QM.torch, 'empty', recording_empty)
    monkeypatch.setattr(QM, '_splits', {})
    monkeypatch.setattr(QM, '_counters', {})
    k, n = SHAPES[group], 4096
    packed = torch.zeros((1, k // 2, n), dtype=torch.uint8)
    scales = torch.ones((1, k // group, 1, n), dtype=torch.bfloat16)
    counts.LAUNCHES.clear()
    for m in (1, 8, 40, 64, 65, 200, 512):
        x = torch.zeros((m, k))
        route = gemm_route(m, k, n, SMS, group)
        spaces.clear()
        y = QM.w4a16_gemm_route(x, packed, scales, 0, route)
        assert y.shape == (m, n)
        mm, kk, nn, gg, regime, splits, ok = rec.calls[-1]
        assert ok and (mm, kk, nn, gg) == (m, k, n, group)
        assert regime == (0 if route == 'decode' else 1)
        if route == 'decode':
            s = _decode_splits(k, group)
        else:
            s = splitk_splits(m, k, n, SMS, group)
            assert splits == s
        assert spaces == ([(s, m, n)] if s > 1 else [])
        want = [QM.NAME] + ([] if route == 'decode' else
                            [QM.WGMMA, f'{QM.WGMMA}:{route}'])
        for name in want:
            assert counts.LAUNCHES[name] > 0
    assert len(rec.calls) == 7
    if group % 64 == 0:
        # a forced splitk at a shape whose plan is one split takes two
        x = torch.zeros((512, k))
        QM.w4a16_gemm_route(x, packed, scales, 0, 'splitk')
        assert rec.calls[-1][4:] == (1, 2, True)
    else:
        for route in QM.WGMMA_ROUTES:
            with pytest.raises(ValueError, match='unsupported shape'):
                QM.w4a16_gemm_route(torch.zeros((8, k)), packed, scales, 0,
                                    route)
    counts.LAUNCHES.clear()
