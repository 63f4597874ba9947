"""The port's three kernels (lmdeploy_tpu_torch/ops/cuda/) against the JAX
package's Pallas kernels they replace.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the Pallas kernels in interpret mode on identical numpy inputs.
The CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lmdeploy_tpu.ops.pallas.paged_attention import \
    paged_decode_attention_write as jax_decode_write
from lmdeploy_tpu.ops.pallas.prefill_attention import \
    paged_prefill_attention_batched as jax_prefill
from lmdeploy_tpu.ops.pallas.quant_matmul import \
    packed_int4_matmul as jax_packed_matmul
from lmdeploy_tpu_torch.ops import cuda as K
from lmdeploy_tpu_torch.ops.cuda.paged_attention import \
    paged_decode_attention_write
from lmdeploy_tpu_torch.ops.cuda.prefill_attention import \
    paged_prefill_attention
from lmdeploy_tpu_torch.ops.cuda.quant_matmul import (w4a16_gemm,
                                                      w4a16_gemm_plain)

torch.set_num_threads(1)


def _bf16_round(a):
    """numpy f32 values rounded to bf16 (so both sides see equal bf16)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _gemm_case(rng, m, k, n, layers=2):
    x = rng.normal(size=(m, k)).astype(np.float32)
    packed = rng.integers(0, 256, size=(layers, k // 2, n), dtype=np.uint8)
    scales = _bf16_round(rng.uniform(0.01, 0.1,
                                     size=(layers, k // 128, 1, n)))
    return x, packed, scales


@pytest.mark.parametrize('m', [1, 5, 300])
def test_w4a16_plain_matches_pallas_packed_matmul(m):
    """Plain W4A16 product == packed_int4_matmul (interpret), including
    the M-blocked prefill grid (M > 256)."""
    rng = np.random.default_rng(m)
    x, packed, scales = _gemm_case(rng, m, 512, 256)
    want = jax_packed_matmul(jnp.asarray(x), jnp.asarray(packed),
                             jnp.asarray(scales, jnp.bfloat16), 1,
                             interpret=True)
    got = w4a16_gemm_plain(torch.from_numpy(x), torch.from_numpy(packed),
                           torch.from_numpy(scales).to(torch.bfloat16), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-3)


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


@pytest.mark.parametrize('kh,g', [(2, 1), (1, 2)])
def test_decode_write_plain_matches_pallas(kh, g):
    """Plain fused append + attend == paged_decode_attention_write
    (interpret): pool contents after the append (a valid=0 slot never
    writes) and the valid slots' outputs."""
    rng = np.random.default_rng(10 + g)
    q, kn, vn, kc, vc, pt, ctx = _decode_case(rng, 4, kh, g, 16, 4, 24)
    valid = np.array([1, 0, 1, 1], np.int32)
    layer = 1
    jk, jv, jout = jax_decode_write(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
        jnp.asarray(vc), jnp.int32(layer), jnp.asarray(pt),
        jnp.asarray(ctx), jnp.asarray(valid), jnp.ones((4,), jnp.float32),
        quantized=False, interpret=True)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out = paged_decode_attention_write(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        tk, tv, layer, torch.from_numpy(pt), torch.from_numpy(ctx),
        torch.from_numpy(valid))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    ok = valid.astype(bool)
    np.testing.assert_allclose(out.numpy()[ok], np.asarray(jout)[ok],
                               rtol=2e-3, atol=2e-3)


def test_prefill_plain_matches_pallas():
    """Plain paged prefill attention == paged_prefill_attention_batched
    (interpret) on valid rows: a chunk from 0, a chunk over history, and a
    padding row (context_end == start_pos) whose rows are not compared."""
    rng = np.random.default_rng(20)
    kh, g, dh, page, maxp, p, layers, t = 2, 2, 128, 16, 16, 40, 2, 128
    starts = np.array([0, 37, 5], np.int32)
    lens = np.array([100, 128, 0], np.int32)
    ends = starts + lens
    kc = rng.normal(size=(layers, p, page, kh, dh)).astype(np.float32)
    vc = rng.normal(size=(layers, p, page, kh, dh)).astype(np.float32)
    pt = np.full((3, maxp), -1, np.int32)
    free = list(rng.permutation(p))
    for i in range(3):
        need = max(1, -(-int(ends[i]) // page))
        pt[i, :need] = [free.pop() for _ in range(need)]
    q = rng.normal(size=(3, t, kh * g, dh)).astype(np.float32)
    want = jax_prefill(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                       jnp.int32(0), jnp.asarray(pt), jnp.asarray(starts),
                       jnp.asarray(ends), jnp.ones((4,), jnp.float32),
                       quantized=False, interpret=True)
    got = paged_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc), 0,
        torch.from_numpy(pt), torch.from_numpy(starts),
        torch.from_numpy(ends))
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got.numpy()[i, :n],
                                   np.asarray(want)[i, :n],
                                   rtol=2e-3, atol=2e-3)
    assert np.isfinite(got.numpy()).all()


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor runs the plain version: plain counters move, kernel
    launch counters do not."""
    rng = np.random.default_rng(30)
    K.reset_launch_counts()
    x, packed, scales = _gemm_case(rng, 2, 256, 128)
    w4a16_gemm(torch.from_numpy(x), torch.from_numpy(packed),
               torch.from_numpy(scales).to(torch.bfloat16), 0)
    q, kn, vn, kc, vc, pt, ctx = _decode_case(rng, 2, 1, 1, 16, 2, 8)
    tq = torch.from_numpy(q)
    paged_decode_attention_write(
        tq, torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(kc), torch.from_numpy(vc), 0,
        torch.from_numpy(pt), torch.from_numpy(ctx),
        torch.ones(2, dtype=torch.int32))
    paged_prefill_attention(
        tq[:, None], torch.from_numpy(kc), torch.from_numpy(vc), 0,
        torch.from_numpy(pt), torch.from_numpy(ctx - 1),
        torch.from_numpy(ctx))
    moved = {n: c for n, c in K.launch_counts().items() if c != (0, 0)}
    assert moved == {'w4a16_gemm': (0, 1),
                     'paged_decode_attention_write[bf16]': (0, 1),
                     'paged_prefill_attention[bf16]': (0, 1)}
    K.reset_launch_counts()
