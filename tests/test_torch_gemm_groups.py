"""Kernel 1 over the JAX kernel's whole domain of groups: every group that
is a multiple of 16, at every M.

``lmdeploy_tpu/ops/pallas/quant_matmul.py::packed_int4_matmul`` takes any
group that divides K/2 with an even group count, and every M (an M grid
axis).  The port serves every group that is a multiple of 16 on the
wgmma kernel (routes ``splitk`` and ``tiles``), at every M: a multiple of
64 in stage pieces (one partial of 64 or 128 packed rows), any other
group in the step form (one partial a group of group / 16 k16 steps,
which may straddle the kernel's 64-row stages).  The kernels run on the
card only; here, on the CPU:

- the plain version against ``packed_int4_matmul`` (Pallas in interpret
  mode, as the JAX package's own tests run it) at groups 32, 64 and 256;
- the wgmma kernel's summation order at groups 64 and 256 (stage pieces)
  and at groups 16, 32, 48 and 80 (the step form, emulated down to its
  stages and their boxes of scale rows) against the same and the plain
  version;
- the split plan of the step form: every group once, items that start
  off the 64-row grid;
- ``gemm_route`` / ``splitk_splits`` as tables over groups 16, 32, 48, 64,
  128 and 256;
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
GROUPS = (16, 32, 48, 64, 128, 256)
# the step form's groups and a K each divides into an even count
STEP_K = {16: 1024, 32: 1024, 48: 1152, 80: 640}
ROWS = (1, 8, 40, 96, 513)


def _bf16(x):
    return x.to(torch.bfloat16).float()


@functools.lru_cache(maxsize=None)
def _case(m, group, k=K):
    rng = np.random.default_rng(1500 + m + group)
    x = rng.normal(size=(m, k)).astype(np.float32)
    packed = rng.integers(0, 256, size=(2, k // 2, N), dtype=np.uint8)
    scales = _bf16(torch.from_numpy(rng.uniform(
        0.01, 0.1, size=(2, k // group, 1, N)).astype(np.float32))).numpy()
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


def step_scale_rows(group):
    """Scale rows a stage of the step form brings per nibble half: the
    most groups that begin in its 4 k16 steps
    (``w4a16_gemm.cu::wgmma_step_rows``)."""
    gs = group // 16
    return 1 if gs >= 4 else -(-4 // gs)


def step_stages(x, packed, s, gb0, gb1, group):
    """The stages the step form's producer fills for an item of half
    groups [gb0, gb1): 64 packed rows from the item's first, with both x
    tiles (zero where the tensor maps fill past K), and a box of
    ``step_scale_rows`` scale rows a half from the first group that
    begins in the stage (zero past the last group), where one does."""
    m, k = x.shape
    n = packed.shape[-1]
    g_rows, half_k, gs = s.shape[0], k // 2, group // 16
    g_half, srows = g_rows // 2, step_scale_rows(group)
    steps = (gb1 - gb0) * gs

    def rows_of(t, r, width):
        out = torch.zeros((len(r),) + t.shape[1:], dtype=t.dtype)
        ok = r < width
        out[ok] = t[r[ok]]
        return out
    stages = []
    for c in range(-(-steps // 4)):
        r = torch.arange(gb0 * group + 64 * c, gb0 * group + 64 * c + 64)
        jb = -(-4 * c // gs)                 # first group begun here
        box = None
        if jb < gb1 - gb0 and jb * gs < 4 * c + 4:
            box = [rows_of(s, torch.arange(g0, g0 + srows), g_rows)
                   for g0 in (gb0 + jb, g_half + gb0 + jb)]
        stages.append(dict(w=rows_of(packed, r, half_k),
                           x=[rows_of(x.T, r, k).T,
                              rows_of(x.T, half_k + r, k).T],
                           jb=jb, box=box))
    return stages


def emulate_step_form(x, packed, scales, layer, splits, group):
    """The wgmma kernel's step form at ``group`` (not a multiple of 64)
    over ``splits`` splits of the half groups, as the kernel walks it:
    each item's stages from its own first packed row
    (:func:`step_stages`), its groups' k16 steps in order, each step's
    low and high products into two f32 partials (reset at the group's
    first step), the group's scale pairs read at that step from the box
    of the stage it begins in, and after its last step the low partial
    then the high one folded with them; the splits' sums in split
    order."""
    m, k = x.shape
    n = packed.shape[-1]
    s = scales[layer].reshape(-1, n).float()
    g_half, gs = s.shape[0] // 2, group // 16
    xb = _bf16(x)
    y = None
    for split in range(splits):
        gb0, gb1 = split_range(split, splits, g_half)
        stages = step_stages(xb, packed[layer], s, gb0, gb1, group)
        acc = torch.zeros(m, n)
        for j in range(gb1 - gb0):
            parts = [torch.zeros(m, n), torch.zeros(m, n)]
            for u in range(gs):
                c, kk = divmod(j * gs + u, 4)
                st = stages[c]
                if u == 0:
                    slot = j - st['jb']
                    assert 0 <= slot < step_scale_rows(group)
                    sc = [b[slot] for b in st['box']]
                rows = slice(16 * kk, 16 * kk + 16)
                q = st['w'][rows]
                for h, nib in enumerate((q & 0xF, q >> 4)):
                    parts[h] = parts[h] + st['x'][h][:, rows] @ nib.float()
            for h in range(2):
                acc = acc + parts[h] * sc[h]
        y = acc if y is None else y + acc
    return y


def emulate_wgmma(x, packed, scales, layer, splits, group):
    """The wgmma kernel's sum at ``group`` over ``splits`` splits of the
    half groups, in its order: at a multiple of 64, per half group,
    pieces of 64 P rows, each piece's low then high partial folded with
    its group's scales; at any other group the step form
    (:func:`emulate_step_form`)."""
    if group % 64:
        return emulate_step_form(x, packed, scales, layer, splits, group)
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


@pytest.mark.parametrize('m', [1, 8, 40, 130])
@pytest.mark.parametrize('group', sorted(STEP_K))
def test_wgmma_step_form_matches_pallas_and_plain(group, m):
    """The step form at groups 16, 32, 48 and 80 (groups of one, two,
    three and five k16 steps; 48 and 80 straddle stages), on route tiles
    and on route splitk at the plan's S (or two: items that start off the
    64-row grid), agrees with packed_int4_matmul (interpret) and with the
    plain version within 1e-3 max|y| + 1e-3."""
    k = STEP_K[group]
    x, packed, scales, want = _case(m, group, k)
    args = _torch_args(x, packed, scales)
    want = torch.from_numpy(want)
    tol = 1e-3 * want.abs().max().item() + 1e-3
    plain = w4a16_gemm_plain(*args)
    assert (plain - want).abs().max().item() <= tol
    splits = max(2, splitk_splits(m, k, N, SMS, group))
    for s in (1, splits):
        got = emulate_wgmma(*args, s, group)
        assert got.shape == (m, N)
        assert (got - want).abs().max().item() <= tol
        assert (got - plain).abs().max().item() <= tol


@pytest.mark.parametrize('group', sorted(STEP_K))
def test_step_form_plan_covers_every_group_once(group):
    """At every split count the kernel takes, the step form's items cover
    each group once: each item's stages (from its own first packed row)
    hold exactly its k16 steps, every group's scale rows lie in the box
    of the stage it begins in, and at S > 1 some item starts off the
    64-row grid (mid-stage on a grid from row 0)."""
    for k in (STEP_K[group], 11 * 2 * group, 4 * 2 * group):
        g_half, gs = k // (2 * group), group // 16
        s = torch.arange(2 * g_half, dtype=torch.float32)[:, None]
        x = torch.zeros(1, k)
        packed = torch.zeros((k // 2, 1), dtype=torch.uint8)
        off_grid = False
        for splits in range(1, min(g_half, SPLITK_MAX) + 1):
            seen = []
            for split in range(splits):
                gb0, gb1 = split_range(split, splits, g_half)
                off_grid |= (gb0 * group) % 64 != 0
                stages = step_stages(x, packed, s, gb0, gb1, group)
                assert len(stages) == -(-(gb1 - gb0) * gs // 4)
                for j in range(gb1 - gb0):
                    st = stages[j * gs // 4]
                    slot = j - st['jb']
                    assert 0 <= slot < step_scale_rows(group)
                    lo, hi = (float(b[slot, 0]) for b in st['box'])
                    assert (lo, hi) == (gb0 + j, g_half + gb0 + j)
                    seen += [gb0 + j, g_half + gb0 + j]
            assert sorted(seen) == list(range(2 * g_half))
        assert off_grid


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


# (K, N) of Llama-2-7B's projections at a K each group divides into an
# even count: K = 4096 (4128 at 48), w2 11008 (11264 at 256, 11040 at 48)
SHAPES = {16: (4096, 11008), 32: (4096, 11008), 48: (4128, 11040),
          64: (4096, 11008), 128: (4096, 11008), 256: (4096, 11264)}


def _layer(group):
    """(K, N) of wqkv, wo, w1 and w2 at ``group``'s K."""
    k, k2 = SHAPES[group]
    return ((k, 12288), (k, 4096), (k, 11008), (k2, 4096))


@pytest.mark.parametrize('group', GROUPS)
def test_gemm_route_table_over_groups(group):
    """At every M and every group that is a multiple of 16, a call takes
    the wgmma kernel's routes: splitk exactly where the output tiles
    fill at most half the card, with at most SPLITK_MAX splits of the K /
    (2 group) half groups, else tiles."""
    for k, n in _layer(group):
        g_half = k // (2 * group)
        for m in (1, 2, 8, 9, 40, 64, 65, 128, 512, 1000):
            route = gemm_route(m, k, n, SMS, group)
            s = splitk_splits(m, k, n, SMS, group)
            tiles = -(-n // 128) * -(-m // wgmma_rows(m))
            assert route == ('splitk' if s > 1 else 'tiles')
            assert 1 <= s <= min(SPLITK_MAX, g_half)
            assert (s > 1) == (2 * tiles <= SMS and g_half > 1)


def test_gemm_route_table_at_7b_decode_and_verify():
    """The table at the decode step's M = 8 and the verify's M = 40 over
    one Llama-2-7B layer (wqkv, wo, w1, w2): at every group, 16 to 256,
    wo and w2 split four ways (32 column tiles) and wqkv and w1 run
    unsplit."""
    for m in (8, 40):
        for group in GROUPS:
            got = [(gemm_route(m, k, n, SMS, group),
                    splitk_splits(m, k, n, SMS, group))
                   for k, n in _layer(group)]
            assert got == [('tiles', 1), ('splitk', 4), ('tiles', 1),
                           ('splitk', 4)]


def test_a_single_half_group_never_splits():
    """K = 2 group has one half group: the plan keeps it on route tiles at
    every M, and a forced splitk is refused by the wrapper."""
    for group in GROUPS:
        for m in (1, 8, 40, 512):
            assert splitk_splits(m, 2 * group, 256, SMS, group) == 1
            assert gemm_route(m, 2 * group, 256, SMS, group) == 'tiles'


class _Recorder:
    """Stands in for the kernels' library: records each lmd_w4a16_gemm
    call and checks it as the C entry point does before it launches."""

    def __init__(self):
        self.calls = []

    def lmd_w4a16_gemm(self, x, packed, scales, y, ws, counter, m, k, n,
                       group, splits, stream):
        ok = (m > 0 and n % 16 == 0 and k % 16 == 0 and group > 0
              and group % 16 == 0 and (k // 2) % group == 0
              and 1 <= splits <= k // (2 * group) and splits <= 8
              and (splits == 1 or (ws and counter)) and x % 16 == 0
              and packed % 16 == 0 and scales % 16 == 0)
        self.calls.append((m, k, n, group, splits, ok))
        return 0 if ok else 1


@pytest.mark.parametrize('group', GROUPS)
def test_wrapper_takes_every_group_at_every_m(monkeypatch, group):
    """The wrapper's host side (its checks, the route, the split plan, the
    workspace and the ticket counters) at every group and M, the kernels'
    library replaced by a recorder holding each call to the C entry
    point's own checks: no ValueError, the route gemm_route picks, a
    workspace of S x M x N floats where the sum is split, and one count
    under the kernel, the wgmma kernel and the route; a forced splitk at
    a shape whose plan is one split takes two."""
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
    monkeypatch.setattr(QM, '_counters', {})
    k, n = SHAPES[group][1], 4096
    packed = torch.zeros((1, k // 2, n), dtype=torch.uint8)
    scales = torch.ones((1, k // group, 1, n), dtype=torch.bfloat16)
    counts.LAUNCHES.clear()
    for m in (1, 8, 40, 64, 65, 200, 512):
        x = torch.zeros((m, k))
        route = gemm_route(m, k, n, SMS, group)
        spaces.clear()
        y = QM.w4a16_gemm_route(x, packed, scales, 0, route)
        assert y.shape == (m, n)
        mm, kk, nn, gg, splits, ok = rec.calls[-1]
        assert ok and (mm, kk, nn, gg) == (m, k, n, group)
        s = splitk_splits(m, k, n, SMS, group)
        assert splits == s
        assert spaces == ([(s, m, n)] if s > 1 else [])
        for name in (QM.NAME, QM.WGMMA, f'{QM.WGMMA}:{route}'):
            assert counts.LAUNCHES[name] > 0
    assert len(rec.calls) == 7
    x = torch.zeros((512, k))
    QM.w4a16_gemm_route(x, packed, scales, 0, 'splitk')
    assert rec.calls[-1][4:] == (2, True)
    with pytest.raises(ValueError, match='bad operands'):
        QM.w4a16_gemm_route(x, packed, scales, 0, 'decode')
    counts.LAUNCHES.clear()
