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
from lmdeploy_tpu_torch.ops.cuda.quant_matmul import (w4a16_gemm,
                                                      w4a16_gemm_plain)


def _gemm_case(rng, m, k, n, layers=2):
    x = rng.normal(size=(m, k)).astype(np.float32)
    packed = rng.integers(0, 256, size=(layers, k // 2, n), dtype=np.uint8)
    scales = rng.uniform(0.01, 0.1, size=(layers, k // 128, 1, n)).astype(
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
    # f32 sums in another order (split-K atomics at M <= 64)
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
