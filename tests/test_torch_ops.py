"""The port's plain ops (lmdeploy_tpu_torch/ops, kvcache) against the JAX
functions they replace, on identical numpy inputs, on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lmdeploy_tpu.kvcache import paged as jpaged
from lmdeploy_tpu.ops import attention as jattn
from lmdeploy_tpu.ops import linear as jlin
from lmdeploy_tpu.ops import norms as jnorms
from lmdeploy_tpu.ops import rope as jrope
from lmdeploy_tpu.ops import sampling as jsamp
from lmdeploy_tpu.ops.pallas.quant_matmul import pack_nibbles as jpack
from lmdeploy_tpu_torch.kvcache import paged as tpaged
from lmdeploy_tpu_torch.ops import attention as tattn
from lmdeploy_tpu_torch.ops import linear as tlin
from lmdeploy_tpu_torch.ops import norms as tnorms
from lmdeploy_tpu_torch.ops import rope as trope
from lmdeploy_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=(64,)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jnorms.rms_norm(jnp.asarray(x, jd), jnp.asarray(w, jd), 1e-5)
    got = tnorms.rms_norm(T(x).to(td), T(w).to(td), 1e-5)
    tol = 1e-6 if dtype == 'float32' else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


ROPE_CASES = {
    'plain': {},
    'linear': dict(rope_scaling_type='linear', rope_scaling_factor=2.0),
    'dynamic': dict(rope_scaling_type='dynamic', rope_scaling_factor=2.0,
                    rope_original_max=64),
    'yarn': dict(rope_scaling_type='yarn', rope_scaling_factor=4.0,
                 rope_original_max=64),
    'llama3': dict(rope_scaling_type='llama3', rope_scaling_factor=8.0,
                   rope_original_max=64),
    'qwen_ntk_logn': dict(use_dynamic_ntk=True, use_logn_attn=True),
}


@pytest.mark.parametrize('case', sorted(ROPE_CASES))
def test_rope_tables_and_apply(case):
    """rope_tables + apply_rope_qk == the JAX versions for every preset,
    past the trained context so the scaled branches run."""
    rng = np.random.default_rng(1)
    kw = dict(rotary_dim=32, base=10000.0, max_position_embeddings=64,
              **ROPE_CASES[case])
    pos = rng.integers(0, 200, size=(2, 5)).astype(np.int32)
    ctx = pos.max(axis=1).astype(np.int32) + 1
    jt = jrope.rope_tables(jnp.asarray(pos), jnp.asarray(ctx), **kw)
    tt = trope.rope_tables(T(pos), T(ctx), **kw)
    for a, b in zip(jt, tt):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=1e-4, atol=1e-4)
    # a partial-rotary head (Dh 48 > rotary 32): the tail passes through
    q = rng.normal(size=(2, 5, 4, 48)).astype(np.float32)
    k = rng.normal(size=(2, 5, 2, 48)).astype(np.float32)
    jq, jk = jrope.apply_rope_qk(jnp.asarray(q), jnp.asarray(k), jt)
    tq, tk = trope.apply_rope_qk(T(q), T(k), tt)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4,
                               atol=1e-4)


def test_apply_rope_bf16():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 4, 128)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32).reshape(2, 3)
    cos, sin = jrope.rope_cos_sin(jnp.asarray(pos), 128, 10000.0)
    want = jrope.apply_rope(jnp.asarray(x, jnp.bfloat16), cos, sin)
    got = trope.apply_rope(T(x).to(torch.bfloat16),
                           T(cos), T(sin))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_gqa_attention():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 4, 6, 32)).astype(np.float32)
    k = rng.normal(size=(2, 10, 3, 32)).astype(np.float32)
    v = rng.normal(size=(2, 10, 3, 32)).astype(np.float32)
    qpos = np.array([[3, 4, 5, 6], [0, 1, 2, 3]], np.int32)
    kvl = np.array([7, 4], np.int32)
    want = jattn.gqa_attention(*map(jnp.asarray, (q, k, v, qpos, kvl)))
    got = tattn.gqa_attention(*map(T, (q, k, v, qpos, kvl)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_quantize_and_pack_match_jax():
    """quantize_weight_int4 and pack_quantized (half-split nibbles, sz in
    the scales' dtype) are byte-identical; unpack_int4 reads the JAX disk
    packing."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(512, 256)).astype(np.float32)
    jq = jlin.quantize_weight_int4(w, 128)
    tq = tlin.quantize_weight_int4(w, 128)
    np.testing.assert_array_equal(tq.qvals.numpy(), np.asarray(jq.qvals))
    for name in ('scales', 'zeros'):
        np.testing.assert_array_equal(
            getattr(tq, name).float().numpy(),
            np.asarray(getattr(jq, name), np.float32))
    jp, tp = jlin.pack_quantized(jq), tlin.pack_quantized(tq)
    np.testing.assert_array_equal(tp.packed.numpy(), np.asarray(jp.packed))
    np.testing.assert_array_equal(tp.packed.numpy(),
                                  jpack(np.asarray(jq.qvals)[None]))
    np.testing.assert_array_equal(tp.sz.float().numpy(),
                                  np.asarray(jp.sz, np.float32))
    assert tuple(tp.scales.shape) == tuple(jp.scales.shape)
    q = np.asarray(jq.qvals)
    np.testing.assert_array_equal(tlin.unpack_int4(jlin.pack_int4(q)), q)


@pytest.mark.parametrize('m', [1, 7, 40])
def test_quant_matmul_packed(m):
    """The packed W4A16 product (kernel term + zero-point rowsum term) ==
    the JAX quant_matmul_packed with the Pallas kernel interpreted."""
    rng = np.random.default_rng(5 + m)
    w = rng.normal(size=(2, 256, 256)).astype(np.float32)
    x = rng.normal(size=(m, 256)).astype(np.float32)
    jqs = [jlin.quantize_weight_int4(w[i], 128) for i in range(2)]
    jqw = jlin.QuantizedWeight(
        qvals=jnp.stack([q.qvals for q in jqs]),
        scales=jnp.stack([q.scales for q in jqs]),
        zeros=jnp.stack([q.zeros for q in jqs]))
    jp = jlin.pack_quantized(jqw)
    want = jlin.quant_matmul_packed(jnp.asarray(x), jp, 1, interpret=True)
    tp = tlin.PackedInt4Weight(
        packed=T(np.asarray(jp.packed)),
        scales=T(np.asarray(jp.scales, np.float32)).to(torch.bfloat16),
        sz=T(np.asarray(jp.sz, np.float32)).to(torch.bfloat16))
    got = tlin.quant_matmul_packed(T(x), tp, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize('m', [3, 40])
def test_linear_quantized_weight(m):
    """Byte-per-int4 linear (group-batched below M=32, dequant above) ==
    the JAX linear."""
    rng = np.random.default_rng(6)
    w = rng.normal(size=(256, 128)).astype(np.float32) * 0.1
    x = rng.normal(size=(m, 256)).astype(np.float32)
    bias = rng.normal(size=(128,)).astype(np.float32)
    jq = jlin.quantize_weight_int4(w, 128)
    want = jlin.linear(jnp.asarray(x), jq, jnp.asarray(bias))
    tq = tlin.QuantizedWeight(qvals=T(np.asarray(jq.qvals)),
                              scales=T(np.asarray(jq.scales, np.float32))
                              .to(torch.bfloat16),
                              zeros=T(np.asarray(jq.zeros, np.float32))
                              .to(torch.bfloat16))
    got = tlin.linear(T(x), tq, T(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def test_write_kv_and_gather():
    """write_kv (in place; invalid tokens and unmapped pages drop) and
    gather_kv_layer == the JAX scatter / gather."""
    rng = np.random.default_rng(7)
    layers, p, page, kh, dh = 2, 10, 4, 2, 8
    kc = rng.normal(size=(layers, p, page, kh, dh)).astype(np.float32)
    vc = rng.normal(size=(layers, p, page, kh, dh)).astype(np.float32)
    pt = np.array([[3, 7, -1], [5, -1, -1]], np.int32)
    pos = np.array([[2, 3, 4, 5, 6], [0, 1, 2, 5, 11]], np.int32)
    valid = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 1, 1]], bool)
    kn = rng.normal(size=(2, 5, kh, dh)).astype(np.float32)
    vn = rng.normal(size=(2, 5, kh, dh)).astype(np.float32)
    jk, jv = jpaged.write_kv(jnp.asarray(kc), jnp.asarray(vc), 1,
                             jnp.asarray(kn), jnp.asarray(vn),
                             jnp.asarray(pos), jnp.asarray(pt),
                             jnp.asarray(valid))
    tk, tv = T(kc.copy()), T(vc.copy())
    tpaged.write_kv(tk, tv, 1, T(kn), T(vn), T(pos), T(pt), T(valid))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    gk, gv = jpaged.gather_kv_layer(jk[1], jv[1], jnp.asarray(pt), None,
                                    dtype=jnp.float32)
    hk, hv = tpaged.gather_kv_layer(tk[1], tv[1], T(pt))
    np.testing.assert_array_equal(hk.numpy(), np.asarray(gk))
    np.testing.assert_array_equal(hv.numpy(), np.asarray(gv))
    cache = tpaged.init_cache(2, 3, 4, 1, 8, torch.bfloat16, 'cpu')
    assert cache.num_pages == 3 and cache.page_size == 4
    assert cache.k.dtype == torch.bfloat16 and not cache.k.any()


def test_greedy_sample_and_check_stop():
    """Greedy: the first maximal index (ties included), logprob 0;
    check_stop: EOS unless ignored, stop words, length."""
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(4, 50)).astype(np.float32)
    logits[2, [7, 31]] = 9.0                       # a tie
    js = jsamp.SamplingState.init(4)
    js = js.__class__(**{**js.__dict__,
                         'top_k': jnp.ones((4,), jnp.int32)})
    jtok, jkeys, jlp = jsamp.sample_step(jnp.asarray(logits), js,
                                         jnp.zeros((4, 8), jnp.int32),
                                         jnp.zeros((4,), jnp.int32),
                                         jnp.zeros((4,), jnp.int32),
                                         mode='greedy')
    ts = tsamp.SamplingState.init(4, device='cpu')
    zeros = torch.zeros(4, dtype=torch.int32)
    ttok, keys, tlp = tsamp.sample_step(
        T(logits), ts, torch.zeros((4, 8), dtype=torch.int32), zeros, zeros,
        mode='greedy')
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert int(ttok[2]) == 7
    np.testing.assert_array_equal(tlp.numpy(), np.asarray(jlp))
    # greedy draws nothing, yet splits the keys as the JAX package does
    np.testing.assert_array_equal(keys.numpy(),
                                  np.asarray(jkeys).view(np.int32))
    with pytest.raises(ValueError):
        tsamp.sample_step(T(logits), ts, torch.zeros((4, 8)), zeros, zeros,
                          mode='beam')

    toks = np.array([2, 5, 9, 4], np.int32)
    gen = np.array([1, 3, 2, 8], np.int32)
    stop = np.full((4, 32), -1, np.int32)
    stop[1, 0] = 5
    ign = np.array([False, False, False, True])
    mx = np.array([10, 10, 10, 8], np.int32)
    js = js.__class__(**{**js.__dict__, 'stop_words': jnp.asarray(stop),
                         'ignore_eos': jnp.asarray(ign),
                         'max_new_tokens': jnp.asarray(mx)})
    ts.stop_words, ts.ignore_eos, ts.max_new_tokens = T(stop), T(ign), T(mx)
    want = jsamp.check_stop(jnp.asarray(toks), js, jnp.asarray(gen))
    got = tsamp.check_stop(T(toks), ts, T(gen))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [True, True, False, True]
