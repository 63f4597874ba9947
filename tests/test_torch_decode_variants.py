"""Kernels 2-5 of the port (plain versions, on the CPU) at every KV width
against the JAX package's Pallas kernels in interpret mode, on identical
numpy inputs:

- kernel 2 ``paged_decode_attention_write`` and kernel 4
  ``paged_decode_attention`` at kv_bits 0, 8 and 4;
- kernel 5 ``paged_decode_attention_rope_write`` with full and partial
  rotary, with and without a logn q scale;
- kernel 3 ``paged_prefill_attention`` at kv_bits 8 and 4 (bf16 is in
  tests/test_torch_kernels.py).

Outputs are f32 and held to rtol/atol 2e-3 (the tolerance of the bf16
kernels' tests; at these seeds the largest difference is 2.6e-6: the
same f32 math in another summation order).  Pools after a store of the same K/V rows are
bit-identical: both sides quantise as round(x / scale + zp) in f32 with
round half to even.  Kernel 5 rotates K first, and that rotation rounds
differently in XLA (see :func:`_assert_pool_close`).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lmdeploy_tpu.ops.pallas import paged_attention as jpa
from lmdeploy_tpu.ops.pallas.prefill_attention import \
    paged_prefill_attention_batched as jax_prefill
from lmdeploy_tpu_torch.kvcache.paged import unpack_kv_int4
from lmdeploy_tpu_torch.ops import cuda as K
from lmdeploy_tpu_torch.ops.cuda import paged_attention as tpa
from lmdeploy_tpu_torch.ops.cuda.prefill_attention import \
    paged_prefill_attention

torch.set_num_threads(1)

DH = 128
# (k_scale, k_zp, v_scale, v_zp): the random rows span many steps, and the
# tails clip
QPARAMS = {0: (1.0, 0.0, 1.0, 0.0), 8: (0.021, 1.5, 0.017, -2.0),
           4: (0.31, 0.5, 0.27, -0.5)}


def _pool(rng, shape, kv_bits):
    """Random pool contents as numpy: f32, int8, or packed uint8."""
    if kv_bits == 0:
        return rng.normal(size=shape).astype(np.float32)
    if kv_bits == 8:
        return rng.integers(-128, 128, shape).astype(np.int8)
    return rng.integers(0, 256, shape[:-1] + (shape[-1] // 2,)).astype(
        np.uint8)


def _case(seed, kv_bits, b=4, kh=2, g=2, page=16, maxp=4, p=24, layers=2):
    rng = np.random.default_rng(seed)
    kc = _pool(rng, (layers, p, page, kh, DH), kv_bits)
    vc = _pool(rng, (layers, p, page, kh, DH), kv_bits)
    ctx = rng.integers(1, maxp * page, size=b).astype(np.int32)
    pt = np.full((b, maxp), -1, np.int32)
    free = list(rng.permutation(p))     # slots never share a page
    for i in range(b):
        need = -(-int(ctx[i]) // page)
        pt[i, :need] = [free.pop() for _ in range(need)]
    q = rng.normal(size=(b, kh * g, DH)).astype(np.float32)
    kn = (rng.normal(size=(b, kh, DH)) * 2).astype(np.float32)
    vn = (rng.normal(size=(b, kh, DH)) * 2).astype(np.float32)
    return q, kn, vn, kc, vc, pt, ctx


def _assert_pool_close(got, want, kv_bits):
    """Pools whose stored K went through rope on each side: XLA contracts
    ``x * cos + rothalf(x) * sin`` differently from PyTorch's separately
    rounded products, so the rotated K differs in the last f32 bit on
    ~0.1% of values.  An f32 pool then agrees to 1e-6; a quantised pool
    differs by at most one step, on at most 0.1% of its values (a last-bit
    change moves x / scale across a .5 boundary only that rarely)."""
    if kv_bits == 0:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        return
    if kv_bits == 4:
        got, want = (torch.from_numpy(np.array(x)) for x in (got, want))
        got, want = (unpack_kv_int4(x).numpy() for x in (got, want))
    diff = np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3, (
        diff.max(), (diff != 0).mean())


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize('kv_bits', [0, 8, 4])
def test_decode_attend_plain_matches_pallas(kv_bits):
    """Kernel 4 (attend only) == paged_decode_attention (interpret)."""
    q, _, _, kc, vc, pt, ctx = _case(40 + kv_bits, kv_bits)
    qp = np.float32(QPARAMS[kv_bits])
    want = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(1),
        jnp.asarray(pt), jnp.asarray(ctx), jnp.asarray(qp),
        quantized=kv_bits != 0, interpret=True)
    tq, tk, tv, tpt, tctx, tqp = _t(q, kc, vc, pt, ctx, qp)
    got = tpa.paged_decode_attention(tq, tk, tv, 1, tpt, tctx,
                                     tqp if kv_bits else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize('kv_bits', [0, 8, 4])
def test_decode_write_plain_matches_pallas(kv_bits):
    """Kernel 2 at each width == paged_decode_attention_write (interpret):
    the pool after the store bit for bit (a valid=0 slot never writes),
    the valid slots' outputs within 2e-3."""
    q, kn, vn, kc, vc, pt, ctx = _case(50 + kv_bits, kv_bits)
    qp = np.float32(QPARAMS[kv_bits])
    valid = np.array([1, 0, 1, 1], np.int32)
    jk, jv, jout = jpa.paged_decode_attention_write(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
        jnp.asarray(vc), jnp.int32(1), jnp.asarray(pt), jnp.asarray(ctx),
        jnp.asarray(valid), jnp.asarray(qp), quantized=kv_bits != 0,
        interpret=True)
    tq, tkn, tvn, tk, tv, tpt, tctx, tvalid, tqp = _t(
        q, kn, vn, kc, vc, pt, ctx, valid, qp)
    out = tpa.paged_decode_attention_write(tq, tkn, tvn, tk, tv, 1, tpt,
                                           tctx, tvalid, tqp)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not np.array_equal(tk.numpy(), kc)        # the store happened
    ok = valid.astype(bool)
    np.testing.assert_allclose(out.numpy()[ok], np.asarray(jout)[ok],
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize('kv_bits', [0, 8, 4])
@pytest.mark.parametrize('rotary,logn', [(128, False), (128, True),
                                         (64, True)])
def test_decode_rope_write_plain_matches_pallas(kv_bits, rotary, logn):
    """Kernel 5 == paged_decode_attention_rope_write (interpret): full and
    partial rotary (the tail past 2*half passes through), with and without
    a per-slot logn q scale; rope_full_tables == the JAX one."""
    q, kn, vn, kc, vc, pt, ctx = _case(60 + kv_bits + rotary, kv_bits)
    qp = np.float32(QPARAMS[kv_bits])
    half = rotary // 2
    valid = np.array([1, 1, 0, 1], np.int32)
    inv = 10000.0 ** (-np.arange(half, dtype=np.float32) * 2 / rotary)
    ang = (ctx - 1).astype(np.float32)[:, None] * inv
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    qscale = (np.array([1.0, 1.25, 0.8, 1.1], np.float32) if logn
              else np.ones(4, np.float32))
    jcos_f, jsin_f = jpa.rope_full_tables(jnp.asarray(cos), jnp.asarray(sin),
                                          DH)
    cos_f, sin_f = tpa.rope_full_tables(*_t(cos, sin), DH)
    np.testing.assert_array_equal(cos_f.numpy(), np.asarray(jcos_f))
    np.testing.assert_array_equal(sin_f.numpy(), np.asarray(jsin_f))
    jk, jv, jout = jpa.paged_decode_attention_rope_write(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jcos_f, jsin_f,
        jnp.asarray(qscale), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(0),
        jnp.asarray(pt), jnp.asarray(ctx), jnp.asarray(valid),
        jnp.asarray(qp), half=half, quantized=kv_bits != 0, interpret=True)
    tq, tkn, tvn, tqs, tk, tv, tpt, tctx, tvalid, tqp = _t(
        q, kn, vn, qscale, kc, vc, pt, ctx, valid, qp)
    out = tpa.paged_decode_attention_rope_write(
        tq, tkn, tvn, cos_f, sin_f, tqs, tk, tv, 0, tpt, tctx, tvalid, tqp,
        half=half)
    _assert_pool_close(tk.numpy(), np.asarray(jk), kv_bits)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    ok = valid.astype(bool)
    np.testing.assert_allclose(out.numpy()[ok], np.asarray(jout)[ok],
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize('kv_bits', [8, 4])
def test_prefill_quantized_plain_matches_pallas(kv_bits):
    """Kernel 3 on an int8 / int4 pool == paged_prefill_attention_batched
    (interpret) on valid rows: a chunk from 0 and a chunk over history."""
    rng = np.random.default_rng(70 + kv_bits)
    kh, g, page, maxp, p, t = 2, 2, 16, 16, 40, 128
    starts = np.array([0, 37], np.int32)
    lens = np.array([100, 128], np.int32)
    ends = starts + lens
    kc = _pool(rng, (2, p, page, kh, DH), kv_bits)
    vc = _pool(rng, (2, p, page, kh, DH), kv_bits)
    pt = np.stack([rng.permutation(p)[:maxp] for _ in range(2)]).astype(
        np.int32)
    q = rng.normal(size=(2, t, kh * g, DH)).astype(np.float32)
    qp = np.float32(QPARAMS[kv_bits])
    want = jax_prefill(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                       jnp.int32(1), jnp.asarray(pt), jnp.asarray(starts),
                       jnp.asarray(ends), jnp.asarray(qp), quantized=True,
                       interpret=True)
    got = paged_prefill_attention(*_t(q, kc, vc), 1,
                                  *_t(pt, starts, ends, qp))
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got.numpy()[i, :n],
                                   np.asarray(want)[i, :n],
                                   rtol=2e-3, atol=2e-3)


def test_cpu_tensors_count_plain_calls_per_width():
    """On CPU tensors each kernel x width counts one plain call and no
    launch; a quantised pool without qparams4 raises."""
    K.reset_launch_counts()
    for kv_bits in (0, 8, 4):
        q, kn, vn, kc, vc, pt, ctx = _case(80, kv_bits, b=2, p=8)
        tq, tkn, tvn, tk, tv, tpt, tctx = _t(q, kn, vn, kc, vc, pt, ctx)
        qp = QPARAMS[kv_bits]           # host floats are accepted too
        valid = torch.ones(2, dtype=torch.int32)
        tpa.paged_decode_attention(tq, tk, tv, 0, tpt, tctx, qp)
        tpa.paged_decode_attention_write(tq, tkn, tvn, tk, tv, 0, tpt, tctx,
                                         valid, qp)
        cos_f, sin_f = tpa.rope_full_tables(torch.ones(2, 64),
                                            torch.zeros(2, 64), DH)
        tpa.paged_decode_attention_rope_write(
            tq, tkn, tvn, cos_f, sin_f, torch.ones(2), tk, tv, 0, tpt, tctx,
            valid, qp, half=64)
        paged_prefill_attention(tq[:, None], tk, tv, 0, tpt, tctx - 1, tctx,
                                qp)
    counts = K.launch_counts()
    assert set(counts) == set(K.KERNEL_NAMES) and len(counts) == 13
    assert counts['w4a16_gemm'] == (0, 0)
    assert all(c == (0, 1) for n, c in counts.items() if n != 'w4a16_gemm')
    q, kn, vn, kc, vc, pt, ctx = _case(81, 8, b=2, p=8)
    with pytest.raises(ValueError, match='qparams4'):
        tpa.paged_decode_attention(*_t(q, kc, vc), 0, *_t(pt, ctx))
    K.reset_launch_counts()
