"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``cuda`` and skips without a GPU.  The file
imports neither JAX nor the JAX package, so on the card it runs without
the suite's conftest (which sets JAX up):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from lmdeploy_tpu_torch.ops.cuda import paged_attention as PA
from lmdeploy_tpu_torch.ops.cuda.paged_attention import (
    paged_decode_attention_write, paged_decode_attention_write_plain)
from lmdeploy_tpu_torch.ops.cuda.prefill_attention import (
    paged_prefill_attention, paged_prefill_attention_plain)
from lmdeploy_tpu_torch.ops.cuda.quant_matmul import (ROUTES, gemm_route,
                                                      sm_count, w4a16_gemm,
                                                      w4a16_gemm_plain,
                                                      w4a16_gemm_route)


def _gemm_case(rng, m, k, n, layers=2, group=128):
    x = rng.normal(size=(m, k)).astype(np.float32)
    packed = rng.integers(0, 256, size=(layers, k // 2, n), dtype=np.uint8)
    scales = rng.uniform(0.01, 0.1, size=(layers, k // group, 1, n)).astype(
        np.float32)
    return x, packed, scales


def _decode_case(rng, b, kh, g, page, maxp, p, layers=2):
    dh = 128
    kc = rng.normal(size=(layers, p, page, kh, dh)).astype(np.float32)
    vc = rng.normal(size=(layers, p, page, kh, dh)).astype(np.float32)
    ctx = rng.integers(1, maxp * page, size=b).astype(np.int32)
    pt = np.full((b, maxp), -1, np.int32)
    free = list(rng.permutation(p))     # slots never share a page
    for i in range(b):
        need = -(-int(ctx[i]) // page)
        pt[i, :need] = [free.pop() for _ in range(need)]
    q = rng.normal(size=(b, kh * g, dh)).astype(np.float32)
    kn = rng.normal(size=(b, kh, dh)).astype(np.float32)
    vn = rng.normal(size=(b, kh, dh)).astype(np.float32)
    return q, kn, vn, kc, vc, pt, ctx


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: CUDA is not available')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('m', [1, 8, 64, 100])
def test_w4a16_kernel_matches_plain_on_card(cuda_device, m):
    rng = np.random.default_rng(40 + m)
    x, packed, scales = _gemm_case(rng, m, 1024, 512)
    args = (torch.from_numpy(x).to(cuda_device),
            torch.from_numpy(packed).to(cuda_device),
            torch.from_numpy(scales).to(torch.bfloat16).to(cuda_device), 1)
    got = w4a16_gemm(*args)
    want = w4a16_gemm_plain(*args)
    # f32 sums in another order (the kernel splits K over blocks)
    tol = 1e-3 * want.abs().max().item() + 1e-3
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_decode_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(50)
    q, kn, vn, kc, vc, pt, ctx = _decode_case(rng, 4, 2, 2, 16, 8, 40)
    bf = torch.bfloat16

    def t(a, dtype=None):
        x = torch.from_numpy(a).to(cuda_device)
        return x.to(dtype) if dtype else x
    valid = t(np.array([1, 1, 0, 1], np.int32))
    k1, v1 = t(kc, bf), t(vc, bf)
    k2, v2 = k1.clone(), v1.clone()
    args = (t(q, bf), t(kn, bf), t(vn, bf))
    got = paged_decode_attention_write(*args, k1, v1, 1, t(pt), t(ctx),
                                       valid)
    want = paged_decode_attention_write_plain(*args, k2, v2, 1, t(pt),
                                              t(ctx), valid)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    ok = valid.bool()
    assert (got.float() - want.float())[ok].abs().max().item() <= 1e-2


@pytest.mark.cuda
def test_prefill_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(60)
    kh, g, page, maxp, p = 2, 2, 16, 16, 40
    starts = torch.tensor([0, 37], dtype=torch.int32, device=cuda_device)
    lens = [100, 64]
    ends = starts + torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    bf = torch.bfloat16
    kc = torch.from_numpy(rng.normal(size=(2, p, page, kh, 128)).astype(
        np.float32)).to(cuda_device, bf)
    vc = torch.from_numpy(rng.normal(size=(2, p, page, kh, 128)).astype(
        np.float32)).to(cuda_device, bf)
    pt = torch.from_numpy(np.stack([rng.permutation(p)[:maxp]
                                    for _ in range(2)]).astype(np.int32))
    q = torch.from_numpy(rng.normal(size=(2, 100, kh * g, 128)).astype(
        np.float32)).to(cuda_device, bf)
    args = (q, kc, vc, 1, pt.to(cuda_device), starts, ends)
    got = paged_prefill_attention(*args)
    want = paged_prefill_attention_plain(*args)
    for i, n in enumerate(lens):
        assert (got[i, :n].float() - want[i, :n].float()).abs().max() \
            .item() <= 1e-2


# int8 / int4 pools: qparams (k_scale, k_zp, v_scale, v_zp) that span the
# random K/V's range, so values round across many steps and some clip
QPARAMS = {8: (0.021, 1.5, 0.017, -2.0), 4: (0.31, 0.5, 0.27, -0.5)}


def _quant_pool(rng, shape, kv_bits, device):
    """A random bf16 / int8 / nibble-packed int4 pool [L, P, page, KH, Dh]
    (last dim Dh/2 for int4)."""
    if kv_bits == 0:
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device, torch.bfloat16)
    if kv_bits == 8:
        return torch.from_numpy(rng.integers(-128, 128, shape).astype(
            np.int8)).to(device)
    shape = shape[:-1] + (shape[-1] // 2,)
    return torch.from_numpy(rng.integers(0, 256, shape).astype(
        np.uint8)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize('kv_bits', [0, 8, 4])
@pytest.mark.parametrize('mode', ['attend', 'write', 'rope_write'])
def test_decode_variants_match_plain_on_card(cuda_device, kv_bits, mode):
    """Kernels 2, 4 and 5 at each KV width against their plain versions:
    the pool bit-identical after the store, bf16 outputs within 1e-2."""
    rng = np.random.default_rng(70 + kv_bits)
    q, kn, vn, _, _, pt, ctx = _decode_case(rng, 4, 2, 4, 16, 8, 40)
    bf = torch.bfloat16

    def t(a, dtype=None):
        x = torch.from_numpy(a).to(cuda_device)
        return x.to(dtype) if dtype else x
    kc = _quant_pool(rng, (2, 40, 16, 2, 128), kv_bits, cuda_device)
    vc = _quant_pool(rng, (2, 40, 16, 2, 128), kv_bits, cuda_device)
    qp = (torch.tensor(QPARAMS[kv_bits], device=cuda_device)
          if kv_bits else None)
    valid = t(np.array([1, 1, 0, 1], np.int32))
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    q, kn, vn = t(q, bf), t(kn * 3, bf), t(vn * 3, bf)
    common = (t(pt), t(ctx))
    if mode == 'attend':
        got = PA.paged_decode_attention(q, k1, v1, 1, *common, qp)
        want = PA.paged_decode_attention_plain(q, k2, v2, 1, *common, qp)
        ok = torch.ones(4, dtype=torch.bool, device=cuda_device)
    elif mode == 'write':
        got = PA.paged_decode_attention_write(q, kn, vn, k1, v1, 1, *common,
                                              valid, qp)
        want = PA.paged_decode_attention_write_plain(q, kn, vn, k2, v2, 1,
                                                     *common, valid, qp)
        ok = valid.bool()
    else:
        pos = t(ctx).float() - 1
        inv = 10000.0 ** (-torch.arange(32, device=cuda_device).float()
                          / 32)
        ang = pos[:, None] * inv                  # partial rotary: dim 64
        cos_f, sin_f = PA.rope_full_tables(torch.cos(ang), torch.sin(ang),
                                           128)
        qs = torch.tensor([1.0, 1.25, 0.8, 1.1], device=cuda_device)
        got = PA.paged_decode_attention_rope_write(
            q, kn, vn, cos_f, sin_f, qs, k1, v1, 1, *common, valid, qp,
            half=32)
        want = PA.paged_decode_attention_rope_write_plain(
            q, kn, vn, cos_f, sin_f, qs, k2, v2, 1, *common, valid, qp,
            half=32)
        ok = valid.bool()
    torch.cuda.synchronize()
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    assert (got.float() - want.float())[ok].abs().max().item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize('kv_bits', [8, 4])
def test_prefill_quantized_matches_plain_on_card(cuda_device, kv_bits):
    rng = np.random.default_rng(80 + kv_bits)
    kh, g, page, maxp, p = 2, 2, 16, 16, 40
    starts = torch.tensor([0, 37], dtype=torch.int32, device=cuda_device)
    lens = [100, 64]
    ends = starts + torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    kc = _quant_pool(rng, (2, p, page, kh, 128), kv_bits, cuda_device)
    vc = _quant_pool(rng, (2, p, page, kh, 128), kv_bits, cuda_device)
    pt = torch.from_numpy(np.stack([rng.permutation(p)[:maxp]
                                    for _ in range(2)]).astype(np.int32))
    q = torch.from_numpy(rng.normal(size=(2, 100, kh * g, 128)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    qp = torch.tensor(QPARAMS[kv_bits], device=cuda_device)
    args = (q, kc, vc, 1, pt.to(cuda_device), starts, ends, qp)
    got = paged_prefill_attention(*args)
    want = paged_prefill_attention_plain(*args)
    for i, n in enumerate(lens):
        assert (got[i, :n].float() - want[i, :n].float()).abs().max() \
            .item() <= 1e-2


GEMM_SHAPES = [(k, n, group, m)
               for k, n, group in ((1024, 512, 128), (2816, 528, 128),
                                   (1536, 256, 48), (1536, 256, 64),
                                   (1536, 256, 256), (1536, 256, 16),
                                   (1536, 256, 32), (1280, 272, 80))
               for m in (1, 2, 3, 5, 8, 9, 16, 33, 64, 65, 130, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize('k,n,group,m', GEMM_SHAPES)
def test_w4a16_shapes_match_plain_on_card(cuda_device, k, n, group, m):
    """The route gemm_route picks at every M at ragged shapes: an odd
    count of half groups (K = 2816: 11 low and 11 high groups), N not a
    multiple of the block's 128 columns, groups of one stage (64) and of
    four (256), and the step form's groups of one, two, three and five
    k16 steps (16, 32, 48, 80; 48 and 80 straddle stages)."""
    rng = np.random.default_rng(k + n + m)
    x = rng.normal(size=(m, k)).astype(np.float32)
    packed = rng.integers(0, 256, size=(2, k // 2, n), dtype=np.uint8)
    scales = rng.uniform(0.01, 0.1, size=(2, k // group, 1, n)).astype(
        np.float32)
    args = (torch.from_numpy(x).to(cuda_device),
            torch.from_numpy(packed).to(cuda_device),
            torch.from_numpy(scales).to(torch.bfloat16).to(cuda_device), 1)
    got = w4a16_gemm(*args)
    want = w4a16_gemm_plain(*args)
    tol = 1e-3 * want.abs().max().item() + 1e-3
    assert (got - want).abs().max().item() <= tol


def _prefill_batch(rng, kv_bits, kh, page, t, histories, device,
                   pad_starts=(7,)):
    """One batch of chunks of length t over the given histories, plus
    padding rows (context_end == start_pos) at ``pad_starts``; pages
    scattered and disjoint."""
    b = len(histories) + len(pad_starts)
    starts = list(histories) + list(pad_starts)
    lens = [t] * len(histories) + [0] * len(pad_starts)
    ends = [s + n for s, n in zip(starts, lens)]
    maxp = -(-max(max(ends), 1) // page) + 1
    p = b * maxp + 3
    kc = _quant_pool(rng, (2, p, page, kh, 128), kv_bits, device)
    vc = _quant_pool(rng, (2, p, page, kh, 128), kv_bits, device)
    perm = rng.permutation(p)
    pt = np.full((b, maxp), -1, np.int32)
    for i, e in enumerate(ends):
        need = max(1, -(-e // page))
        pt[i, :need] = perm[:need]
        perm = perm[need:]
    as_t = lambda a: torch.tensor(a, dtype=torch.int32, device=device)
    return kc, vc, as_t(pt), as_t(starts), as_t(ends), lens


def _check_prefill(rng, kv_bits, kh, g, page, t, histories, device,
                   pad_starts=(7,)):
    kc, vc, pt, sp, ce, lens = _prefill_batch(rng, kv_bits, kh, page, t,
                                              histories, device, pad_starts)
    q = torch.from_numpy(rng.normal(size=(len(lens), t, kh * g, 128))
                         .astype(np.float32)).to(device, torch.bfloat16)
    qp = (torch.tensor(QPARAMS[kv_bits], device=device) if kv_bits
          else None)
    args = (q, kc, vc, 1, pt, sp, ce, qp)
    got = paged_prefill_attention(*args)
    want = paged_prefill_attention_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    for i, n in enumerate(lens):
        if n:
            err = (got[i, :n].float() - want[i, :n].float()).abs().max()
            assert err.item() <= 1e-2, (t, histories[i], err.item())


@pytest.mark.cuda
@pytest.mark.parametrize('page', [16, 64])
@pytest.mark.parametrize('g', [1, 2, 4, 8])
@pytest.mark.parametrize('kv_bits', [0, 8, 4])
def test_prefill_chunks_match_plain_on_card(cuda_device, kv_bits, g, page):
    """Tensor-core prefill at every KV width, GQA group and page size:
    chunks of T = 5, 63, 64, 65, 100 over 0, 37 and 300 tokens of history
    and a padding row (finite; not compared).  P enters P V as two bf16
    terms, so the kernel stays within 1e-2 of the f32 plain version after
    both round to bf16."""
    rng = np.random.default_rng(90 + kv_bits + 10 * g + page)
    for t in (5, 63, 64, 65, 100):
        _check_prefill(rng, kv_bits, 2, g, page, t, (0, 37, 300),
                       cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize('t,history', [(512, 0), (200, 100), (64, 300)])
@pytest.mark.parametrize('kv_bits', [0, 8, 4])
def test_prefill_block_shapes_on_card(cuda_device, kv_bits, t, history):
    """Llama-2-7B heads (KH = 32), two slots (one a padding row): a
    512-token chunk takes 64-row blocks, a 200-token chunk 32-row blocks
    and a 64-token chunk 16-row blocks whose warps split each KV tile."""
    rng = np.random.default_rng(120 + kv_bits + t)
    _check_prefill(rng, kv_bits, 32, 1, 64, t, (history,), cuda_device)


# the speculative verify's shapes (T = K+1 = 5 rows a slot at Llama-2-7B
# heads): (histories of the live slots, padding rows' stale contexts)
VERIFY_SHAPES = {
    'B=8 ctx~512': (tuple(507 - 7 * i for i in range(8)), ()),
    'B=8 one live ctx 80, 7 padding rows': (
        (75,), tuple(500 + 9 * i for i in range(7))),
    'B=1 ctx 80': ((75,), ()),
    'B=1 ctx 512': ((507,), ()),
    'B=1 ctx 2048': ((2043,), ()),
}


@pytest.mark.cuda
@pytest.mark.parametrize('shape', list(VERIFY_SHAPES))
@pytest.mark.parametrize('kv_bits', [0, 8, 4])
def test_prefill_verify_shapes_on_card(cuda_device, kv_bits, shape):
    """Kernel 3 at the verify forward's T = 5: every live row within 1e-2
    of the plain version, padding rows finite."""
    histories, pads = VERIFY_SHAPES[shape]
    rng = np.random.default_rng(130 + kv_bits + len(histories))
    _check_prefill(rng, kv_bits, 32, 1, 64, 5, histories, cuda_device,
                   pad_starts=pads)


# the route boundary at G = 8 (KH = 4 of H = 32): T = 8 puts 64 rows in one
# route-split block, T = 9 is a chunk (route wgmma at every width, page 16
# and 64 alike); histories of 0, 70 and 1000 tokens (several splits)
@pytest.mark.cuda
@pytest.mark.parametrize('page', [16, 64])
@pytest.mark.parametrize('t', [8, 9])
@pytest.mark.parametrize('kv_bits', [0, 8, 4])
def test_prefill_route_boundary_at_g8_on_card(cuda_device, kv_bits, t, page):
    rng = np.random.default_rng(140 + kv_bits + t + page)
    _check_prefill(rng, kv_bits, 4, 8, page, t, (0, 70, 1000), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize('how', ['forced', 'page48'])
@pytest.mark.parametrize('g', [1, 4])
@pytest.mark.parametrize('kv_bits', [0, 8, 4])
def test_prefill_forced_route_matches_plain_on_card(cuda_device, monkeypatch,
                                                    kv_bits, how, g):
    """Route mma against the plain version: forced (FORCE_MMA) on the
    shapes routes split and wgmma take (T = 1 to 512 at page 16), and
    taken by the route rule itself on chunks at page 48, which neither
    divides 64 nor is a multiple of it."""
    from lmdeploy_tpu_torch.ops.cuda import prefill_attention as PF
    page, lengths = 16, (1, 5, 8, 64, 100, 512)
    if how == 'forced':
        monkeypatch.setattr(PF, 'FORCE_MMA', True)
    else:
        page, lengths = 48, (64, 100, 512)
    rng = np.random.default_rng(150 + g + len(how) + kv_bits)
    for t in lengths:
        assert how == 'forced' or PF.prefill_route(
            4, t, 2 * g, 2, page, kv_bits) == 'mma'
        _check_prefill(rng, kv_bits, 2, g, page, t, (0, 37, 300), cuda_device)


@pytest.mark.cuda
def test_prefill_route_counts_on_card(cuda_device):
    """Every launch counts under the kernel and under the route it took:
    split for T <= 8 and wgmma for chunks at every width, as
    prefill_route says from the shapes."""
    import lmdeploy_tpu_torch.ops.cuda as K
    from lmdeploy_tpu_torch.ops.cuda.prefill_attention import prefill_route
    rng = np.random.default_rng(160)
    cases = [(0, 5, (507,)), (0, 5, (2043,)), (0, 512, (0,)),
             (0, 64, (300,)), (8, 5, (300,)), (8, 64, (300,)),
             (4, 5, (80,)), (4, 512, (0,))]
    K.reset_launch_counts()
    want = {}
    for kv_bits, t, hist in cases:
        _check_prefill(rng, kv_bits, 32, 1, 64, t, hist, cuda_device)
        width = ('bf16', 'int8', 'int4')[(0, 8, 4).index(kv_bits)]
        name = f'paged_prefill_attention[{width}]'
        route = prefill_route(2, t, 32, 32, 64, kv_bits)
        assert route == ('split' if t <= 8 else 'wgmma')
        want[f'{name}:{route}'] = want.get(f'{name}:{route}', 0) + 1
        want[name] = want.get(name, 0) + 1
    assert {n: c for n, c in K.route_counts().items() if c} == {
        n: c for n, c in want.items() if ':' in n}
    assert {n: c[0] for n, c in K.launch_counts().items() if c[0]} == {
        n: c for n, c in want.items() if ':' not in n}


@pytest.mark.cuda
@pytest.mark.parametrize('t,history', [(5, 2043), (5, 75), (64, 300),
                                       (512, 0)])
def test_prefill_split_merges_are_bit_identical_across_calls(
        cuda_device, t, history):
    """The split merge runs in split order whichever split finishes last:
    two calls give the same bits (route split at T = 5 with several
    splits and one; route wgmma at the two prefill buckets)."""
    rng = np.random.default_rng(170 + t)
    kc, vc, pt, sp, ce, lens = _prefill_batch(rng, 0, 32, 64, t, (history,),
                                              cuda_device)
    q = torch.from_numpy(rng.normal(size=(len(lens), t, 32, 128))
                         .astype(np.float32)).to(cuda_device, torch.bfloat16)
    args = (q, kc, vc, 1, pt, sp, ce)
    first = paged_prefill_attention(*args)
    for _ in range(3):
        assert torch.equal(paged_prefill_attention(*args), first)


def _gemm_args(rng, m, k, n, device):
    x, packed, scales = _gemm_case(rng, m, k, n)
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(packed).to(device),
            torch.from_numpy(scales).to(torch.bfloat16).to(device), 1)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [11008, 1152, 176])
@pytest.mark.parametrize('m', [65, 96, 128, 200, 256, 512, 1000])
def test_w4a16_wgmma_matches_plain_on_card(cuda_device, m, n):
    """The wgmma regime at ragged M on route tiles (128-row x tiles; M =
    1000 leaves a ragged row tile), N = 11008 (86 column tiles, more items
    than SMs), 1152 (9) and 176 (a ragged 128-column tile); K = 2816 gives
    11 low and 11 high groups, so the stage ring wraps around."""
    rng = np.random.default_rng(m + n)
    args = _gemm_args(rng, m, 2816, n, cuda_device)
    got = w4a16_gemm(*args)
    want = w4a16_gemm_plain(*args)
    tol = 1e-3 * want.abs().max().item() + 1e-3
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize('group,regime', [(128, 'splitk'), (128, 'tiles'),
                                          (32, 'splitk'), (32, 'tiles')])
@pytest.mark.parametrize('m', [1, 16, 40, 64, 128])
def test_w4a16_both_regimes_at_crossover_rows(cuda_device, m, group,
                                              regime):
    """Both routes at group 128 (stage pieces) and 32 (the step form) at
    M = 1 to 128, whichever the wrapper would pick, and each twice
    (deterministic)."""
    rng = np.random.default_rng(300 + m)
    x, packed, scales = _gemm_case(rng, m, 4096, 1024, group=group)
    args = (torch.from_numpy(x).to(cuda_device),
            torch.from_numpy(packed).to(cuda_device),
            torch.from_numpy(scales).to(torch.bfloat16).to(cuda_device), 1)
    got = w4a16_gemm_route(*args, regime)
    want = w4a16_gemm_plain(*args)
    tol = 1e-3 * want.abs().max().item() + 1e-3
    assert (got - want).abs().max().item() <= tol
    assert torch.equal(got, w4a16_gemm_route(*args, regime))


@pytest.mark.cuda
@pytest.mark.parametrize('k', [4096, 11008])
@pytest.mark.parametrize('m', [1, 5, 8])
def test_w4a16_decode_is_bit_identical_across_calls(cuda_device, m, k):
    """The decode steps' rows at group 32 (the step form) on the route
    the wrapper picks (splitk: N = 4096 splits K four ways and sums the
    partials in split order): ten calls give the same bits, as the JAX
    kernel's sequential K loop does."""
    rng = np.random.default_rng(500 + m + k)
    x, packed, scales = _gemm_case(rng, m, k, 4096, group=32)
    args = (torch.from_numpy(x).to(cuda_device),
            torch.from_numpy(packed).to(cuda_device),
            torch.from_numpy(scales).to(torch.bfloat16).to(cuda_device), 1)
    first = w4a16_gemm(*args)
    for _ in range(9):
        assert torch.equal(first, w4a16_gemm(*args))
    want = w4a16_gemm_plain(*args)
    tol = 1e-3 * want.abs().max().item() + 1e-3
    assert (first - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize('route', ['splitk', 'tiles'])
@pytest.mark.parametrize('k,n', [(4096, 12288), (11008, 4096)])
@pytest.mark.parametrize('m', [40, 64, 512])
def test_w4a16_routes_are_bit_identical_across_calls(cuda_device, m, k, n,
                                                     route):
    """Both wgmma routes at the verify's M = 40, the 64-row bucket and the
    512-row bucket, at wqkv's and w2's shapes: splitk sums its splits'
    partials in split order (K = 11008: 43 half groups in uneven splits),
    tiles writes each tile once, so five calls give the same bits."""
    rng = np.random.default_rng(700 + m + k)
    args = _gemm_args(rng, m, k, n, cuda_device)
    first = w4a16_gemm_route(*args, route)
    for _ in range(4):
        assert torch.equal(first, w4a16_gemm_route(*args, route))
    want = w4a16_gemm_plain(*args)
    tol = 1e-3 * want.abs().max().item() + 1e-3
    assert (first - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize('route', ['splitk', 'tiles'])
@pytest.mark.parametrize('m', [9, 16, 17, 25, 33, 40, 48, 50, 63, 64, 65,
                               130, 512])
def test_w4a16_forced_route_matches_plain_on_card(cuda_device, m, route):
    """Each wgmma route forced at every M, across the x tile heights (16,
    24, 32, 40, 48, 56, 64, 128) and the 64-row boundary, at a ragged N
    (400: a column tile of 16) and K = 2816 (11 half groups)."""
    rng = np.random.default_rng(800 + m)
    args = _gemm_args(rng, m, 2816, 400, cuda_device)
    got = w4a16_gemm_route(*args, route)
    want = w4a16_gemm_plain(*args)
    tol = 1e-3 * want.abs().max().item() + 1e-3
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize('group,route', [(64, 'splitk'), (64, 'tiles'),
                                         (32, 'splitk'), (32, 'tiles'),
                                         (16, 'splitk')])
@pytest.mark.parametrize('m', [1, 40, 200])
def test_w4a16_other_groups_are_bit_identical_across_calls(cuda_device, m,
                                                           group, route):
    """At groups 64 (stage pieces), 32 and 16 (the step form), route
    splitk (its splits' partials summed in split order) and route tiles
    give the same bits on two launches, so that a seed still gives one
    sampled stream at every group; each within 1e-3 of the plain
    version."""
    rng = np.random.default_rng(1000 + m + group)
    x, packed, scales = _gemm_case(rng, m, 4096, 1024, group=group)
    args = (torch.from_numpy(x).to(cuda_device),
            torch.from_numpy(packed).to(cuda_device),
            torch.from_numpy(scales).to(torch.bfloat16).to(cuda_device), 1)
    first = w4a16_gemm_route(*args, route)
    assert torch.equal(first, w4a16_gemm_route(*args, route))
    want = w4a16_gemm_plain(*args)
    tol = 1e-3 * want.abs().max().item() + 1e-3
    assert (first - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_w4a16_plan_mirrors_the_kernel_on_card(cuda_device):
    """The wrapper's x tile height (which sizes the ticket counters) is the
    kernel's own at every M."""
    from lmdeploy_tpu_torch.ops.cuda import build
    from lmdeploy_tpu_torch.ops.cuda.quant_matmul import wgmma_rows
    lib = build.load()
    assert all(lib.lmd_w4a16_wgmma_rows(m) == wgmma_rows(m)
               for m in range(9, 700))


@pytest.mark.cuda
def test_w4a16_route_counts_on_card(cuda_device):
    """Every launch counts under the kernel, the wgmma regime and the
    route gemm_route picks from the shapes: a 4096 x 4096 projection
    takes splitk up to the 64 bucket (its 32 column tiles would leave the
    card idle) and tiles at 512."""
    import lmdeploy_tpu_torch.ops.cuda as K
    rng = np.random.default_rng(900)
    K.reset_launch_counts()
    want = {}
    for m in (1, 8, 9, 40, 64, 512):
        args = _gemm_args(rng, m, 4096, 4096, cuda_device)
        w4a16_gemm(*args)
        route = gemm_route(m, 4096, 4096, sm_count(cuda_device), 128)
        assert route == ('splitk' if m <= 64 else 'tiles')
        key = f'w4a16_gemm[wgmma]:{route}'
        want[key] = want.get(key, 0) + 1
    assert {n: c for n, c in K.route_counts().items() if c} == want
    assert K.launch_counts(True)['w4a16_gemm'] == (6, 0)
    assert K.launch_counts(True)['w4a16_gemm[wgmma]'] == (6, 0)


def _split_case(rng, ctxs, kv_bits, kh, page, device):
    """A pool, page table and decode inputs for the given contexts, with a
    table 2048 tokens wide (so the kernel splits the context)."""
    b = len(ctxs)
    maxp = 2048 // page
    p = b * maxp + 4
    kc = _quant_pool(rng, (2, p, page, kh, 128), kv_bits, device)
    vc = _quant_pool(rng, (2, p, page, kh, 128), kv_bits, device)
    pt = np.full((b, maxp), -1, np.int32)
    free = list(rng.permutation(p))
    for i, c in enumerate(ctxs):
        pt[i, :-(-c // page)] = [free.pop() for _ in range(-(-c // page))]
    return kc, vc, torch.from_numpy(pt).to(device), torch.tensor(
        ctxs, dtype=torch.int32, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize('g', [1, 4])
@pytest.mark.parametrize('kv_bits', [0, 8, 4])
@pytest.mark.parametrize('mode', ['attend', 'write', 'rope_write'])
def test_decode_splits_match_plain_on_card(cuda_device, mode, kv_bits, g):
    """Decode attention split over the context at ctx 1, 64, 65 and 2047
    (one tile, a tile edge, many splits), B = 1 and B = 8 with a valid=0
    slot, each called twice in a row: the same output twice shows that the
    ticket counter is back at zero; the pool is bit-identical to the plain
    version's and the masked slot's row untouched."""
    rng = np.random.default_rng(400 + kv_bits + 10 * g)
    kh, page, bf = 2, 16, torch.bfloat16
    qp = (torch.tensor(QPARAMS[kv_bits], device=cuda_device)
          if kv_bits else None)
    batches = [[c] for c in (1, 64, 65, 2047)] + [[1, 64, 65, 2047] * 2]
    for ctxs in batches:
        b = len(ctxs)
        kc, vc, pt, cl = _split_case(rng, ctxs, kv_bits, kh, page,
                                     cuda_device)
        valid = torch.ones(b, dtype=torch.int32, device=cuda_device)
        if b > 1:
            valid[2] = 0
        q, kn, vn = (torch.from_numpy(rng.normal(size=shape).astype(
            np.float32) * 2).to(cuda_device, bf)
            for shape in ((b, kh * g, 128), (b, kh, 128), (b, kh, 128)))
        pos = cl.float() - 1
        inv = 10000.0 ** (-torch.arange(64, device=cuda_device).float() / 64)
        cos_f, sin_f = PA.rope_full_tables(torch.cos(pos[:, None] * inv),
                                           torch.sin(pos[:, None] * inv),
                                           128)
        qs = torch.linspace(0.9, 1.2, b, device=cuda_device)

        def call(fn, k, v):
            if mode == 'attend':
                return getattr(PA, fn)(q, k, v, 1, pt, cl, qp)
            fn = fn.replace('attention', f'attention_{mode}')
            if mode == 'write':
                return getattr(PA, fn)(q, kn, vn, k, v, 1, pt, cl, valid, qp)
            return getattr(PA, fn)(q, kn, vn, cos_f, sin_f, qs, k, v, 1, pt,
                                   cl, valid, qp, half=64)
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        got = call('paged_decode_attention', k1, v1)
        again = call('paged_decode_attention', k1, v1)
        want = call('paged_decode_attention_plain', k2, v2)
        torch.cuda.synchronize()
        assert torch.equal(got, again), ctxs
        assert torch.equal(k1, k2) and torch.equal(v1, v2), ctxs
        ok = valid.bool() if mode != 'attend' else torch.ones_like(
            valid, dtype=torch.bool)
        err = (got.float() - want.float())[ok].abs().max().item()
        assert err <= 1e-2, (ctxs, err)
        if b > 1 and mode != 'attend':
            p2 = ctxs[2] - 1
            phys = int(pt[2, p2 // page])
            assert torch.equal(k1[1, phys, p2 % page], kc[1, phys, p2 % page])
            assert (got[2] == 0).all()


@pytest.mark.cuda
def test_dynamic_int4_store_and_gather_on_card_match_cpu(cuda_device):
    """The dynamic int4 pool's gather route (no kernel: plain PyTorch on
    every device) on the card against the CPU: after the same store the
    packed bytes are identical, scales and minima within one f32 rounding
    step on at most 0.5% of values, and the bf16 gather within one bf16
    ulp."""
    from lmdeploy_tpu_torch.kvcache import paged
    rng = np.random.default_rng(70)
    b, t, kh, page, maxp = 3, 40, 4, 16, 4
    k = torch.from_numpy(rng.normal(size=(b, t, kh, 128)).astype(
        np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(rng.normal(size=(b, t, kh, 128)).astype(
        np.float32)).to(torch.bfloat16)
    pos = torch.arange(t, dtype=torch.int32).expand(b, t).contiguous()
    pt = torch.arange(b * maxp, dtype=torch.int32).reshape(b, maxp)
    valid = torch.ones((b, t), dtype=torch.bool)
    valid[2, 30:] = False
    out = {}
    for dev in ('cpu', cuda_device):
        c = paged.init_cache(2, b * maxp, page, kh, 128, torch.uint8, dev,
                             dynamic_scales=True)
        paged.write_kv_dynamic(c.k, c.v, c.dyn, 1, k.to(dev), v.to(dev),
                               pos.to(dev), pt.to(dev), valid.to(dev))
        kk, vv = paged.gather_kv_layer_dynamic(c.k[1], c.v[1], c.dyn[1],
                                               pt.to(dev))
        out[str(dev)] = [x.cpu() for x in (c.k, c.v, c.dyn, kk, vv)]
    cpu, card = out['cpu'], out[str(cuda_device)]
    assert torch.equal(cpu[0], card[0]) and torch.equal(cpu[1], card[1])
    steps = ((cpu[2].view(torch.int32) - card[2].view(torch.int32)).abs())
    assert steps.max() <= 2 and (steps != 0).float().mean() <= 5e-3
    for a, c in zip(cpu[3:], card[3:]):
        ulps = (a.view(torch.int16).int() - c.view(torch.int16).int()).abs()
        assert ulps.max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['dynamic', 'per_head'])
def test_gather_route_forward_on_card_matches_cpu(cuda_device, kind):
    """A 2-layer Dh-128 model's prefill chunk and decode steps through a
    dynamic and a per-head int4 pool on the card against the CPU (dense
    bf16 weights): logits within 5% of max |logit|, cosine >= 0.999."""
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.kvcache.paged import init_cache
    from lmdeploy_tpu_torch.models import llama
    cfg = ModelConfig(head_num=4, kv_head_num=2, size_per_head=128,
                      inter_size=512, num_layer=2, vocab_size=256,
                      rotary_embedding=128, session_len=128)
    gen = torch.Generator().manual_seed(3)
    params = llama.init_params(cfg, gen, torch.bfloat16, 'cpu')
    kw = dict(dynamic_scales=True) if kind == 'dynamic' else dict(
        kv_scales=[[[0.5, 0.6]] * 2, [[0.0, 0.5]] * 2, [[0.4, 0.45]] * 2,
                   [[0.25, 0.0]] * 2])
    logits = {}
    for dev in ('cpu', cuda_device):
        p = {k: (v.to(dev) if torch.is_tensor(v) else
                 {n: t.to(dev) for n, t in v.items()})
             for k, v in params.items()}
        cache = init_cache(2, 8, 16, 2, 128, torch.uint8, dev, **kw)
        ids = torch.arange(3, 35, dtype=torch.int32)[None].to(dev)
        rows = []
        for step in range(4):
            t = ids.shape[1]
            start = 0 if step == 0 else 31 + step
            batch = llama.StepBatch(
                ids=ids, positions=(start + torch.arange(
                    t, dtype=torch.int32))[None].to(dev),
                valid=torch.ones((1, t), dtype=torch.bool, device=dev),
                context_len=torch.tensor([start + t], dtype=torch.int32,
                                         device=dev),
                page_table=torch.arange(8, dtype=torch.int32)[None].to(dev))
            lg, _ = llama.forward(p, cache, batch, cfg)
            rows.append(lg.float().cpu())
            ids = torch.tensor([[7 + step]], dtype=torch.int32, device=dev)
        logits[str(dev)] = torch.cat(rows)
    a, c = logits['cpu'], logits[str(cuda_device)]
    assert (a - c).abs().max() <= 0.05 * a.abs().max()
    assert torch.nn.functional.cosine_similarity(a, c, dim=-1).min() >= 0.999


# one rank's shapes of Llama-2-7B at tp = 2: (K, N) of wqkv, wo, w1 / w3
# and w2 (inter 11008 padded to 11264), attention at H = KH = 16
TP2_GEMMS = ((4096, 6144), (2048, 4096), (4096, 5632), (5632, 4096))


@pytest.mark.cuda
@pytest.mark.parametrize('m', [1, 8, 40, 512])
@pytest.mark.parametrize('k,n', TP2_GEMMS)
def test_w4a16_at_tp_rank_shapes_matches_plain_on_card(cuda_device, k, n,
                                                       m):
    """The GEMM at a tp = 2 rank's projections, on the route the wrapper
    picks for M, and on both routes forced at M <= 8."""
    rng = np.random.default_rng(k + n + m)
    args = _gemm_args(rng, m, k, n, cuda_device)
    want = w4a16_gemm_plain(*args)
    tol = 1e-3 * want.abs().max().item() + 1e-3
    for got in [w4a16_gemm(*args)] + (
            [w4a16_gemm_route(*args, r) for r in ROUTES] if m <= 8 else []):
        assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize('kv_bits', [0, 8, 4])
def test_decode_write_at_tp_rank_heads_matches_plain_on_card(cuda_device,
                                                             kv_bits):
    """Kernel 2 (append + attend) with a tp = 2 rank's 16 of Llama-2-7B's
    32 heads, B = 8 with one valid = 0 slot, 64-token pages: the pool
    bit-identical after the store, outputs within 1e-2."""
    rng = np.random.default_rng(150 + kv_bits)
    b, kh, page, maxp, p = 8, 16, 64, 16, 136
    q, kn, vn, _, _, pt, ctx = _decode_case(rng, b, kh, 1, page, maxp, p)
    bf = torch.bfloat16

    def t(a, dtype=None):
        x = torch.from_numpy(a).to(cuda_device)
        return x.to(dtype) if dtype else x
    kc = _quant_pool(rng, (2, p, page, kh, 128), kv_bits, cuda_device)
    vc = _quant_pool(rng, (2, p, page, kh, 128), kv_bits, cuda_device)
    qp = (torch.tensor(QPARAMS[kv_bits], device=cuda_device)
          if kv_bits else None)
    valid = t(np.array([1, 1, 1, 0, 1, 1, 1, 1], np.int32))
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    q, kn, vn = t(q, bf), t(kn * 3, bf), t(vn * 3, bf)
    got = PA.paged_decode_attention_write(q, kn, vn, k1, v1, 1, t(pt),
                                          t(ctx), valid, qp)
    want = PA.paged_decode_attention_write_plain(q, kn, vn, k2, v2, 1, t(pt),
                                                 t(ctx), valid, qp)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    ok = valid.bool()
    assert (got.float() - want.float())[ok].abs().max().item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize('t,histories', [(512, (0,)), (64, (300,)),
                                         (5, tuple(507 - 7 * i
                                                   for i in range(8)))],
                         ids=['chunk512', 'chunk64-over-300', 'verify-B8'])
@pytest.mark.parametrize('kv_bits', [0, 8, 4])
def test_prefill_at_tp_rank_heads_matches_plain_on_card(cuda_device,
                                                        kv_bits, t,
                                                        histories):
    """Kernel 3 with a tp = 2 rank's 16 heads: a 512-token chunk, a
    64-token chunk over 300 tokens and the T = 5 verify of 8 slots."""
    rng = np.random.default_rng(160 + kv_bits + t)
    _check_prefill(rng, kv_bits, 16, 1, 64, t, histories, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize('m', [1, 8, 40])
@pytest.mark.parametrize('w4a8', [False, True])
def test_byte_form_layer_linear_on_card_matches_cpu(cuda_device,
                                                    monkeypatch, w4a8, m):
    """A byte-per-int4 W4A16 weight (LMDEPLOY_TPU_PACKED_INT4=0's serving
    form) runs through models/llama.py::_layer_linear on the card, with the
    group, dequant or (LMDEPLOY_TPU_W4A8=1) W4A8 product of ops/linear.py,
    and gives the CPU's numbers on identical inputs within 1e-3 of
    max|ref| (f32 sums in another order; the bf16 and int8 roundings see
    the same values).  With packed residency (the default) the card
    refuses the byte form instead of bypassing the W4A16 kernel."""
    from lmdeploy_tpu_torch.models.llama import _layer_linear
    from lmdeploy_tpu_torch.ops.linear import QuantizedWeight
    monkeypatch.setenv('LMDEPLOY_TPU_PACKED_INT4', '0')
    if w4a8:
        monkeypatch.setenv('LMDEPLOY_TPU_W4A8', '1')
    else:
        monkeypatch.delenv('LMDEPLOY_TPU_W4A8', raising=False)
    rng = np.random.default_rng(170 + m)
    k, n, layers = 4096, 1536, 2
    qw = QuantizedWeight(
        qvals=torch.from_numpy(rng.integers(0, 16, (layers, k, n),
                                            dtype=np.uint8)),
        scales=torch.from_numpy(rng.uniform(0.001, 0.004, (
            layers, k // 128, n)).astype(np.float32)).to(torch.bfloat16),
        zeros=torch.from_numpy(rng.integers(6, 10, (layers, k // 128, n)
                                            ).astype(np.float32)
                               ).to(torch.bfloat16))
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)
                         ).to(torch.bfloat16)
    want = _layer_linear(x, qw, 1).float()
    got = _layer_linear(x.to(cuda_device), QuantizedWeight(
        *(t.to(cuda_device) for t in (qw.qvals, qw.scales, qw.zeros))), 1)
    assert got.device.type == 'cuda' and got.dtype == torch.bfloat16
    # bf16 outputs: one bf16 ulp of max|ref| on top of the sums' order
    tol = (1e-3 + 2 ** -8) * want.abs().max().item()
    assert (got.float().cpu() - want).abs().max().item() <= tol
    monkeypatch.delenv('LMDEPLOY_TPU_PACKED_INT4')
    with pytest.raises(NotImplementedError, match='packed residency'):
        _layer_linear(x.to(cuda_device), QuantizedWeight(
            *(t.to(cuda_device) for t in (qw.qvals, qw.scales, qw.zeros))), 1)


@pytest.mark.cuda
def test_debug_hook_off_has_no_host_sync_on_card(cuda_device, monkeypatch,
                                                 tmp_path):
    """With LMDEPLOY_TPU_DEBUG unset, dbg returns before it touches a CUDA
    tensor: under torch.cuda.set_sync_debug_mode('error') it raises
    nothing, while the dump mode's host copy does raise there."""
    import importlib

    from lmdeploy_tpu_torch.utils import debug
    x = torch.ones((4, 8), device=cuda_device) * 3
    try:
        for mode in ('', 'dump'):
            monkeypatch.setenv('LMDEPLOY_TPU_DEBUG', mode)
            monkeypatch.setenv('LMDEPLOY_TPU_DEBUG_DIR', str(tmp_path))
            importlib.reload(debug)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode('error')
            try:
                if mode:
                    with pytest.raises(RuntimeError):
                        debug.dbg('x', x)
                else:
                    debug.dbg('x', x)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        assert not list(tmp_path.iterdir())
    finally:
        monkeypatch.delenv('LMDEPLOY_TPU_DEBUG')
        importlib.reload(debug)


@pytest.mark.cuda
@pytest.mark.parametrize('kv_bits', [0, 8, 4])
@pytest.mark.parametrize('mode', ['attend', 'write', 'rope_write'])
def test_decode_engine_and_gqa8_shapes_bit_identical_on_card(cuda_device,
                                                             mode, kv_bits):
    """Decode attention at the engine's B = 8 (ctx ~512, one valid = 0
    slot), at a bs1 request among 7 masked slots and at G = 8 (KH = 4 of H
    = 32), 64-token pages: two calls give the same bits, the pool is
    bit-identical to the plain version's after the store, valid rows lie
    within 1e-2 and masked slots come back as zeros."""
    rng = np.random.default_rng(700 + kv_bits + len(mode))
    bf, page = torch.bfloat16, 64
    qp = (torch.tensor(QPARAMS[kv_bits], device=cuda_device)
          if kv_bits else None)
    cases = (([512 - 7 * i for i in range(8)], (3,), 32),
             ([600] + [500] * 7, tuple(range(1, 8)), 32),
             ([512 - 7 * i for i in range(8)], (3,), 4))
    for ctxs, masked, kh in cases:
        b, h = len(ctxs), 32
        kc, vc, pt, cl = _split_case(rng, ctxs, kv_bits, kh, page,
                                     cuda_device)
        valid = torch.ones(b, dtype=torch.int32, device=cuda_device)
        valid[list(masked)] = 0
        q, kn, vn = (torch.from_numpy(rng.normal(size=shape).astype(
            np.float32) * 2).to(cuda_device, bf)
            for shape in ((b, h, 128), (b, kh, 128), (b, kh, 128)))
        pos = cl.float() - 1
        inv = 10000.0 ** (-torch.arange(64, device=cuda_device).float() / 64)
        cos_f, sin_f = PA.rope_full_tables(torch.cos(pos[:, None] * inv),
                                           torch.sin(pos[:, None] * inv),
                                           128)
        qs = torch.linspace(0.9, 1.2, b, device=cuda_device)

        def call(fn, k, v):
            if mode == 'attend':
                return getattr(PA, fn)(q, k, v, 1, pt, cl, qp)
            fn = fn.replace('attention', f'attention_{mode}')
            if mode == 'write':
                return getattr(PA, fn)(q, kn, vn, k, v, 1, pt, cl, valid, qp)
            return getattr(PA, fn)(q, kn, vn, cos_f, sin_f, qs, k, v, 1, pt,
                                   cl, valid, qp, half=64)
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        got = call('paged_decode_attention', k1, v1)
        again = call('paged_decode_attention', k1, v1)
        want = call('paged_decode_attention_plain', k2, v2)
        torch.cuda.synchronize()
        assert torch.equal(got, again), (ctxs, kh)
        assert torch.equal(k1, k2) and torch.equal(v1, v2), (ctxs, kh)
        ok = valid.bool() if mode != 'attend' else torch.ones_like(
            valid, dtype=torch.bool)
        err = (got.float() - want.float())[ok].abs().max().item()
        assert err <= 1e-2, (ctxs, kh, err)
        if mode != 'attend':
            assert (got[~ok] == 0).all()


# -- the plain decode step as CUDA graphs ------------------------------------

def _qwen_graph_engine(device, **widths):
    """A 4-layer Qwen-14B-shaped engine, not started (hidden 5120, 40
    heads, w2's 107 groups padded by the engine, qkv bias, dynamic NTK and
    logn past 2,048 positions), B = 8 on an int8 pool whose pages hold
    seeded random codes; and an eager twin of its step functions with a
    pool of the same bytes.  Slots 0-5 run at contexts 2,040-2,045, so the
    dispatches cross 2,048."""
    import functools

    from lmdeploy_tpu_torch.config import EngineConfig, ModelConfig
    from lmdeploy_tpu_torch.engine import step as S
    from lmdeploy_tpu_torch.engine.engine import TorchEngine
    from lmdeploy_tpu_torch.models.llama import forward, random_packed_params
    nl = 4
    cfg = ModelConfig(**dict(
        dict(model_name='qwen-14b', head_num=40, kv_head_num=40,
             size_per_head=128, inter_size=13696, num_layer=nl,
             vocab_size=152064, rotary_embedding=128,
             max_position_embeddings=2048, session_len=4096,
             attn_bias=True, qkv_bias_only=True, use_dynamic_ntk=True,
             use_logn_attn=True, weight_type='int4', group_size=128),
        **widths))
    params = random_packed_params(cfg, 11, device)
    gen = torch.Generator(device=device).manual_seed(12)
    qkv = (cfg.head_num + 2 * cfg.kv_head_num) * cfg.size_per_head
    params['layers']['bqkv'] = (torch.randn(
        (nl, qkv), generator=gen, device=device) * 0.02).to(torch.bfloat16)
    ecfg = EngineConfig(max_batch_size=8, session_len=4096, page_size=64,
                        num_pages=8 * 64, quant_policy=4,
                        enable_prefix_caching=False)
    scales = ([0.05] * nl, [0.0] * nl, [0.04] * nl, [1.0] * nl)
    eng = TorchEngine(cfg, ecfg, params, device=device, start=False,
                      kv_scales=scales)
    fns = eng.fns
    twin = S.StepFns(cfg, device, fns.pool, fns.state_shape)
    twin.forward_fn = functools.partial(forward, group=None)   # eager
    cache2, state2 = twin.alloc_device_state()
    for a, b in ((eng.cache.k, cache2.k), (eng.cache.v, cache2.v)):
        a.copy_(torch.randint(-128, 128, a.shape, generator=gen,
                              device=device, dtype=torch.int8))
        b.copy_(a)
    for st in (eng.state, state2):
        for slot in range(6):
            _graph_slot(st, slot, 2040 + slot, cfg.vocab_size)
    return eng, twin, cache2, state2


def _graph_slot(state, slot, ctx, vocab):
    """Install a chat-like sampled request (top-p 0.8, repetition penalty
    1.1, 64 new tokens at most) at context ``ctx`` on its own pages, its
    history drawn from a ``vocab``-token vocabulary."""
    from lmdeploy_tpu_torch.engine import step as S
    from lmdeploy_tpu_torch.ops.sampling import make_rng_keys
    rng = np.random.default_rng(slot)
    hist = np.zeros(4096, np.int32)
    hist[:ctx + 1] = rng.integers(3, vocab, ctx + 1)
    row = np.full(64, -1, np.int32)
    row[:34] = np.arange(34) + 34 * slot
    S.install_slot(state, slot, int(hist[ctx]), ctx, hist, ctx + 1, row,
                   dict(top_k=1024, top_p=0.8, temperature=1.0,
                        repetition_penalty=1.1, ignore_eos=True,
                        max_new_tokens=64,
                        rng_key=make_rng_keys([5000 + slot])[0]))


@pytest.mark.cuda
def test_graph_replays_match_the_eager_step_on_card(cuda_device):
    """The plain decode step replayed from CUDA graphs gives the eager
    step's readbacks and states bit for bit over three dispatches after
    the key's eager one, with an admission and a retirement between them;
    LAUNCHES, which counts the kernel wrappers' launches, grows in the
    key's eager dispatch as the eager twin's does and not at all in a
    dispatch of replays; a reallocated device state drops the graphs."""
    import collections

    from lmdeploy_tpu_torch.engine import step as S
    from lmdeploy_tpu_torch.ops.cuda.counts import LAUNCHES
    eng, twin, cache2, state2 = _qwen_graph_engine(cuda_device)
    fns = eng.fns
    kw = dict(sampling_mode='candidates', topn=0, passes=(False, True))
    try:
        assert fns.graph_ok(eng.cache) and not twin.graph_ok(cache2)
        for d, k in enumerate((1, 8, 8, 8)):
            if d == 2:
                for st in (eng.state, state2):
                    _graph_slot(st, 6, 1000, eng.cfg.vocab_size)
            if d == 3:
                for st in (eng.state, state2):
                    S.clear_slot(st, 0)
            n0 = collections.Counter(LAUNCHES)
            st, got = fns.decode_steps(eng.params, eng.cache, eng.state, k,
                                       **kw)
            n1 = collections.Counter(LAUNCHES)
            _, want = twin.decode_steps(eng.params, cache2, state2, k, **kw)
            n2 = collections.Counter(LAUNCHES)
            assert st is eng.state
            np.testing.assert_array_equal(got, want)
            for a, b in zip(S._tensors(eng.state), S._tensors(state2)):
                assert torch.equal(a, b)
            eager = n2 - n1
            assert eager['w4a16_gemm'] == 5 * 4 * k
            assert n1 - n0 == (eager if d == 0 else collections.Counter())
        assert torch.equal(eng.cache.k, cache2.k)
        assert (fns.graph_captures, fns.graph_steps) == (1, 24)
        eng.cache, eng.state = fns.alloc_device_state()
        assert not fns._graphs and fns._graphed is None
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_no_graph_capture_while_profiled_and_replays_traced_on_card(
        cuda_device, tmp_path):
    """While torch's profiler records on the thread the dispatch that
    would capture runs eagerly; a replay inside a profile shows its
    kernels, tied by their correlation to a cudaGraphLaunch, as the
    benchmark's trace reader ties a kernel to its launch.  They are the
    eager twin's kernels of the same dispatch, copies aside (the graphs'
    static logits and plane move copies in and out of the graphs)."""
    import collections
    import json
    eng, twin, cache2, state2 = _qwen_graph_engine(cuda_device)
    fns = eng.fns
    kw = dict(sampling_mode='candidates', topn=0, passes=(False, True))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        fns.decode_steps(eng.params, eng.cache, eng.state, 1, **kw)
        with torch.profiler.profile(activities=acts):
            fns.decode_steps(eng.params, eng.cache, eng.state, 2, **kw)
        assert (fns.graph_captures, fns.graph_steps) == (0, 0)
        fns.decode_steps(eng.params, eng.cache, eng.state, 1, **kw)
        assert (fns.graph_captures, fns.graph_steps) == (1, 1)
        with torch.profiler.profile(activities=acts) as prof:
            fns.decode_steps(eng.params, eng.cache, eng.state, 2, **kw)
        assert (fns.graph_captures, fns.graph_steps) == (1, 3)
        prof.export_chrome_trace(str(tmp_path / 'trace.json'))
        evs = json.loads((tmp_path / 'trace.json').read_text())[
            'traceEvents']
        launches = {e['args']['correlation'] for e in evs
                    if e.get('cat') == 'cuda_runtime'
                    and 'GraphLaunch' in e.get('name', '')}
        assert len(launches) == 4          # two graphs a step, two steps
        gemms = [e for e in evs if e.get('cat') == 'kernel'
                 and 'w4a16_wgmma' in e.get('name', '')]
        assert len(gemms) == 2 * 5 * 4
        assert all(e['args']['correlation'] in launches for e in gemms)
        def computing(name):
            return 'copy' not in name.lower()
        replayed = collections.Counter(
            e['name'] for e in evs if e.get('cat') == 'kernel'
            and e['args'].get('correlation') in launches
            and computing(e['name']))
        with torch.profiler.profile(activities=acts) as prof:
            twin.decode_steps(eng.params, cache2, state2, 2, **kw)
        prof.export_chrome_trace(str(tmp_path / 'eager.json'))
        eager = collections.Counter(
            e['name'] for e in json.loads((tmp_path / 'eager.json')
                                          .read_text())['traceEvents']
            if e.get('cat') == 'kernel' and computing(e['name']))
        assert replayed == eager and sum(eager.values()) > 2 * 5 * 4
    finally:
        eng.shutdown()
