"""The port's quantised KV cache against the JAX package's, on the CPU:

- ``quantize_kv`` / ``dequantize_kv`` / ``pack_kv_int4`` /
  ``unpack_kv_int4`` / ``write_kv(qparams)`` / ``gather_kv_layer(qparams)``
  give bit-identical pools and values on identical inputs;
- the whole-model ``forward`` with an int8 and an int4 pool matches the
  JAX ``forward`` on each of the three decode routes;
- a ``quant_policy=4`` engine streams the JAX engine's greedy tokens;
- ``kv_qparams`` and ``load_workspace`` carry calibrated scales across.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lmdeploy_tpu.config import EngineConfig as JEngineConfig
from lmdeploy_tpu.config import ModelConfig as JModelConfig
from lmdeploy_tpu.convert.converter import save_workspace
from lmdeploy_tpu.engine.engine import TPUEngine
from lmdeploy_tpu.kvcache import paged as jpaged
from lmdeploy_tpu.lite.apis.kv_qparams import kv_qparams as jkv_qparams
from lmdeploy_tpu.messages import GenerationConfig as JGen
from lmdeploy_tpu.models import llama as jllama
from lmdeploy_tpu.ops.pallas import paged_attention as jpa
from lmdeploy_tpu.ops.pallas import prefill_attention as jpf
from lmdeploy_tpu_torch import build_engine
from lmdeploy_tpu_torch.config import EngineConfig, ModelConfig
from lmdeploy_tpu_torch.convert.workspace import (load_workspace,
                                                  params_from_numpy)
from lmdeploy_tpu_torch.engine.engine import TorchEngine
from lmdeploy_tpu_torch.kvcache import paged as tpaged
from lmdeploy_tpu_torch.lite.apis.kv_qparams import kv_qparams
from lmdeploy_tpu_torch.messages import GenerationConfig
from lmdeploy_tpu_torch.models import llama as tllama
from lmdeploy_tpu_torch.ops import cuda as K

torch.set_num_threads(1)

# size_per_head 128 so the JAX Pallas attention path is eligible
CFG = dict(head_num=2, kv_head_num=1, size_per_head=128, inter_size=256,
           num_layer=2, vocab_size=256, rotary_embedding=128,
           max_position_embeddings=512, session_len=128, group_size=128,
           weight_type='int4', end_id=2)
# per-layer (k_scale, k_zp, v_scale, v_zp): K/V of the test model span
# about +-4, so int8 steps of ~0.03 and int4 steps of ~0.5 cover them
SCALES = {8: ([0.031, 0.034], [0.5, -1.0], [0.029, 0.027], [-0.5, 2.0]),
          4: ([0.52, 0.61], [0.25, -0.5], [0.47, 0.55], [-0.25, 0.5])}
POOL_DTYPES = {8: (jnp.int8, torch.int8), 4: (jnp.uint8, torch.uint8)}


@pytest.mark.parametrize('bits', [8, 4])
def test_quantize_pack_unpack_match_jax(bits):
    """quantize_kv (round half to even, true f32 division, clip), the
    half-split int4 pack and its sign-extending unpack, and dequantize_kv
    are bit-identical to the JAX functions, including .5 ties."""
    rng = np.random.default_rng(bits)
    x = (rng.normal(size=(6, 3, 128)) * 3).astype(np.float32)
    scale, zp = np.float32(0.37 if bits == 4 else 0.023), np.float32(0.5)
    x[0, 0, :8] = (np.arange(8) - 4 + 0.5 - zp) * scale   # ties at .5
    jq = jpaged.quantize_kv(jnp.asarray(x), scale, zp, bits=bits)
    tq = tpaged.quantize_kv(torch.from_numpy(x), scale, zp, bits=bits)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(
        tpaged.dequantize_kv(tq, scale, zp, torch.float32).numpy(),
        np.asarray(jpaged.dequantize_kv(jq, scale, zp, jnp.float32)))
    if bits == 4:
        jp = jpaged.pack_kv_int4(jq)
        tp = tpaged.pack_kv_int4(tq)
        assert tp.dtype == torch.uint8 and tuple(tp.shape) == (6, 3, 64)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tpaged.unpack_kv_int4(tp).numpy(),
                                      np.asarray(jpaged.unpack_kv_int4(jp)))
        np.testing.assert_array_equal(tpaged.unpack_kv_int4(tp).numpy(),
                                      tq.numpy())


@pytest.mark.parametrize('bits', [0, 8, 4])
def test_write_and_gather_kv_match_jax(bits):
    """write_kv(qparams) drops masked tokens and unmapped pages and leaves
    a pool bit-identical to the JAX scatter; gather_kv_layer(qparams)
    returns the same dequantised K/V."""
    rng = np.random.default_rng(10 + bits)
    layers, pages, page, kh = 2, 6, 8, 2
    jdt, tdt = POOL_DTYPES.get(bits, (jnp.float32, torch.float32))
    scales = SCALES.get(bits)
    jc = jpaged.init_cache(layers, pages, page, kh, 128, jdt,
                           kv_scales=scales)
    tc = tpaged.init_cache(layers, pages, page, kh, 128, tdt, 'cpu',
                           kv_scales=scales)
    assert tc.quant_bits == jc.quant_bits == bits
    assert tuple(tc.k.shape) == jc.k.shape
    k_new = (rng.normal(size=(2, 12, kh, 128)) * 2).astype(np.float32)
    v_new = (rng.normal(size=(2, 12, kh, 128)) * 2).astype(np.float32)
    pos = np.stack([np.arange(12), np.arange(5, 17)]).astype(np.int32)
    pt = np.array([[3, 0, -1], [5, 1, 2]], np.int32)
    valid = np.ones((2, 12), bool)
    valid[1, 9:] = False
    layer = 1

    def qp(c, i):
        return (None if not bits else
                tuple(getattr(c, n)[i] for n in ('k_scale', 'k_zp',
                                                 'v_scale', 'v_zp')))
    jk, jv = jpaged.write_kv(jc.k, jc.v, layer, jnp.asarray(k_new),
                             jnp.asarray(v_new), jnp.asarray(pos),
                             jnp.asarray(pt), jnp.asarray(valid),
                             qp(jc, layer))
    tpaged.write_kv(tc.k, tc.v, layer, torch.from_numpy(k_new),
                    torch.from_numpy(v_new), torch.from_numpy(pos),
                    torch.from_numpy(pt), torch.from_numpy(valid),
                    qp(tc, layer))
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jv))
    assert tc.k.abs().sum() > 0
    jkk, jvv = jpaged.gather_kv_layer(jk[layer], jv[layer], jnp.asarray(pt),
                                      qp(jc, layer), dtype=jnp.float32)
    tkk, tvv = tpaged.gather_kv_layer(tc.k[layer], tc.v[layer],
                                      torch.from_numpy(pt), qp(tc, layer),
                                      dtype=torch.float32)
    np.testing.assert_array_equal(tkk.numpy(), np.asarray(jkk))
    np.testing.assert_array_equal(tvv.numpy(), np.asarray(jvv))


def test_per_head_qparams_raise():
    """Per-head [L, KH] qparams (ported) are refused where the JAX package
    refuses them: on an int8 pool, with a head count that is not the
    pool's, and as an unsliced vector in quantize_kv."""
    with pytest.raises(ValueError, match='int4 pool'):
        tpaged.init_cache(2, 4, 8, 2, 128, torch.int8, 'cpu',
                          kv_scales=[np.ones((2, 2))] * 4)
    with pytest.raises(ValueError, match='per-head'):
        tpaged.init_cache(2, 4, 8, 2, 128, torch.uint8, 'cpu',
                          kv_scales=[np.ones((2, 3))] * 4)
    with pytest.raises(ValueError, match='do not match KV heads'):
        tpaged.quantize_kv(torch.ones(3, 2, 128), torch.ones(3),
                           torch.zeros(3), bits=4)
    c = tpaged.init_cache(2, 4, 8, 2, 128, torch.uint8, 'cpu',
                          kv_scales=[np.ones((2, 2))] * 4)
    assert c.per_head and tuple(c.qparams.shape) == (2, 4, 2)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run every JAX Pallas attention kernel in interpret mode."""
    for mod, name in ((jpa, 'paged_decode_attention_write'),
                      (jpa, 'paged_decode_attention'),
                      (jpa, 'paged_decode_attention_rope_write'),
                      (jpf, 'paged_prefill_attention_batched')):
        orig = getattr(mod, name)
        monkeypatch.setattr(
            mod, name,
            lambda *a, _o=orig, **kw: _o(*a, **{**kw, 'interpret': True}))


def dense_params(seed: int):
    """Dense f32 parameters from numpy draws (scaled so logits spread)."""
    rng = np.random.default_rng(seed)
    d, qkv, inter, nl, v = 256, 512, 256, 2, 256

    def w(*shape, s=0.06):
        return (rng.normal(size=shape) * s).astype(np.float32)
    return {
        'tok_embedding': w(v, d, s=1.0),
        'norm': rng.uniform(0.8, 1.2, size=(d,)).astype(np.float32),
        'lm_head': w(d, v),
        'layers': {
            'attn_norm': rng.uniform(0.8, 1.2, size=(nl, d)).astype(
                np.float32),
            'ffn_norm': rng.uniform(0.8, 1.2, size=(nl, d)).astype(
                np.float32),
            'wqkv': w(nl, d, qkv), 'wo': w(nl, d, d), 'w1': w(nl, d, inter),
            'w3': w(nl, d, inter), 'w2': w(nl, inter, d)},
    }


def _pool_values(pool: np.ndarray, bits: int) -> np.ndarray:
    if bits == 4:
        pool = tpaged.unpack_kv_int4(torch.from_numpy(np.array(pool)))
        return pool.numpy().astype(np.int32)
    return pool.astype(np.int32)


@pytest.mark.parametrize('bits', [8, 4])
@pytest.mark.parametrize('route', ['fused', 'unfused', 'fused_rope'])
def test_forward_quantized_pool_matches_jax(interpret_pallas, monkeypatch,
                                            bits, route):
    """A 2-row prefill chunk (one row right-padded) and 3 decode steps
    through an int8 / int4 pool, on each decode route
    (LMDEPLOY_TPU_FUSED_ATTN=0 and LMDEPLOY_TPU_FUSED_ROPE=1 switch both
    packages), against JAX forward(use_pallas_attn=True).  The JAX package
    sends the int4 pool through its XLA gather path (the int4 kernels are
    opt-in there); the port through its kernels' plain versions.

    Pools: the f32 K/V of XLA and PyTorch differ in last bits (norm,
    projection, rope), which can move x / scale across a .5 boundary: at
    most one step apart on at most 0.1% of values (here: 2.7e-5 of the
    int8 V pool, one value; none in int4).  Logits: within 1e-3 of max
    |logit| (here: 1.4e-4 at int8, from that one-step flip; ~1e-6 at
    int4).  Each route's plain version is counted, so the route really
    ran."""
    if route == 'unfused':
        monkeypatch.setenv('LMDEPLOY_TPU_FUSED_ATTN', '0')
    elif route == 'fused_rope':
        monkeypatch.setenv('LMDEPLOY_TPU_FUSED_ROPE', '1')
    jcfg, tcfg = JModelConfig(**CFG), ModelConfig(**CFG)
    tree = dense_params(0)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, device='cpu')
    page, pages = 16, 9
    jdt, tdt = POOL_DTYPES[bits]
    jcache = jpaged.init_cache(2, pages, page, 1, 128, jdt,
                               kv_scales=SCALES[bits])
    tcache = tpaged.init_cache(2, pages, page, 1, 128, tdt, 'cpu',
                               kv_scales=SCALES[bits])
    pt = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 256, size=(2, 24)).astype(np.int32)
    lens = np.array([24, 13], np.int32)
    step = (ids, np.tile(np.arange(24, dtype=np.int32), (2, 1)),
            np.arange(24)[None] < lens[:, None], lens)
    pos = lens.copy()
    K.reset_launch_counts()
    for _ in range(4):
        ids_s, pos_s, valid_s, ctx_s = step
        jb = jllama.StepBatch(ids=jnp.asarray(ids_s),
                              positions=jnp.asarray(pos_s),
                              valid=jnp.asarray(valid_s),
                              context_len=jnp.asarray(ctx_s),
                              page_table=jnp.asarray(pt))
        want, jcache = jllama.forward(jp, jcache, jb, jcfg,
                                      use_pallas_attn=True)
        tb = tllama.StepBatch(ids=torch.from_numpy(ids_s),
                              positions=torch.from_numpy(pos_s),
                              valid=torch.from_numpy(np.asarray(valid_s)),
                              context_len=torch.from_numpy(ctx_s),
                              page_table=torch.from_numpy(pt))
        got, _ = tllama.forward(tp, tcache, tb, tcfg)
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-3 * np.abs(want).max()
        nxt = want.argmax(-1).astype(np.int32)[:, None]
        step = (nxt, pos[:, None].copy(), np.ones((2, 1), bool), pos + 1)
        pos = pos + 1
    for tpool, jpool in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        diff = np.abs(_pool_values(tpool.numpy(), bits)
                      - _pool_values(np.asarray(jpool), bits))
        assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3, (
            diff.max(), (diff != 0).mean())
        assert np.abs(_pool_values(tpool.numpy(), bits)).sum() > 0
    width = {8: 'int8', 4: 'int4'}[bits]
    decode = {'fused': 'paged_decode_attention_write',
              'unfused': 'paged_decode_attention',
              'fused_rope': 'paged_decode_attention_rope_write'}[route]
    plain = {n: c[1] for n, c in K.launch_counts().items() if c[1]}
    assert plain == {f'{decode}[{width}]': 6,          # 3 steps x 2 layers
                     f'paged_prefill_attention[{width}]': 2}
    K.reset_launch_counts()


def jax_int4_params(seed=0):
    """The JAX package's W4A16 parameters (byte-per-int4 QuantizedWeight,
    as its CPU engine holds them)."""
    tree = jax.tree.map(jnp.asarray, dense_params(seed))
    return jllama.quantize_params(tree, JModelConfig(**CFG), 128)


ECFG = dict(max_batch_size=4, session_len=128, page_size=16, num_pages=40,
            max_context_token_num=32, prefill_buckets=(16, 32),
            step_length=4, enable_prefix_caching=False)
PROMPTS = [[5, 9, 200, 31, 77], list(range(40, 60)),
           [(7 * i) % 250 + 3 for i in range(45)]]


def test_int8_engine_greedy_matches_jax_engine():
    """quant_policy=4 with calibrated scales: the port's engine streams the
    JAX engine's greedy tokens (dense f32 weights, so that only the KV
    path differs) up to the first step whose top-2 logit gap (JAX forward
    over an int8 pool with the same scales) is within 1e-3 of that step's
    largest |logit|: 7x the worst logit difference of the two packages'
    int8 forward (test_forward_quantized_pool_matches_jax)."""
    tree = dense_params(0)
    jp = jax.tree.map(jnp.asarray, tree)
    jcfg = JModelConfig(**CFG)
    ecfg = dict(ECFG, quant_policy=4)
    jeng = TPUEngine(jcfg, JEngineConfig(**ecfg), jp, kv_scales=SCALES[8])
    try:
        jinst = jeng.create_instance()
        jouts = [jinst.infer(100 + i, p, gen_config=JGen(
            max_new_tokens=10, top_k=1, ignore_eos=True),
            sequence_end=True).token_ids for i, p in enumerate(PROMPTS)]
    finally:
        jeng.shutdown()
    eng = TorchEngine(ModelConfig(**CFG), EngineConfig(**ecfg),
                      params_from_numpy(tree, 'cpu'), device='cpu',
                      kv_scales=SCALES[8])
    try:
        assert eng.cache.k.dtype == torch.int8
        np.testing.assert_array_equal(eng.cache.k_scale.numpy(),
                                      np.float32(SCALES[8][0]))
        inst = eng.create_instance()
        touts = [inst.infer(200 + i, p, gen_config=GenerationConfig(
            max_new_tokens=10, top_k=1, ignore_eos=True),
            sequence_end=True).token_ids for i, p in enumerate(PROMPTS)]
    finally:
        eng.shutdown()
    compared = 0
    for prompt, jt, tt in zip(PROMPTS, jouts, touts):
        assert len(jt) == len(tt) == 10
        ids = np.asarray(prompt + jt[:-1], np.int32)[None]
        t = ids.shape[1]
        batch = jllama.StepBatch(
            ids=jnp.asarray(ids),
            positions=jnp.arange(t, dtype=jnp.int32)[None],
            valid=jnp.ones((1, t), bool),
            context_len=jnp.asarray([t], jnp.int32),
            page_table=jnp.arange(8, dtype=jnp.int32)[None])
        cache = jpaged.init_cache(2, 9, 16, 1, 128, jnp.int8,
                                  kv_scales=SCALES[8])
        logits, _ = jllama.forward(jp, cache, batch, jcfg,
                                   return_all_logits=True)
        logits = np.asarray(logits)[0, len(prompt) - 1:]
        for step, (a, b) in enumerate(zip(jt, tt)):
            top2 = np.sort(logits[step])[-2:]
            if top2[1] - top2[0] < 1e-3 * np.abs(logits[step]).max():
                break
            assert a == b, (prompt, step, jt, tt)
            compared += 1
    assert compared >= 25, compared


@pytest.mark.parametrize('kv_scales', [None, [np.ones((2, 1))] * 4],
                         ids=['dynamic', 'per_head'])
def test_unported_kv_routes_raise(kv_scales):
    """Dynamic per-token int4 (quant_policy 8 without kv_scales) and
    per-head int4 qparams, which raised before they were ported, now
    allocate their pools; what the JAX engine refuses still raises: an
    odd head size for an int4 pool, and per-head scales on an int8
    pool."""
    eng = TorchEngine(ModelConfig(**CFG),
                      EngineConfig(**dict(ECFG, quant_policy=8)), {},
                      device='cpu', start=False, kv_scales=kv_scales)
    assert eng.cache.quant_bits == 4
    assert eng.cache.dynamic_scales == (kv_scales is None)
    assert eng.cache.per_head == (kv_scales is not None)
    if kv_scales is None:
        with pytest.raises(ValueError, match='even head_dim'):
            TorchEngine(ModelConfig(**dict(CFG, size_per_head=127,
                                           rotary_embedding=126)),
                        EngineConfig(**dict(ECFG, quant_policy=8)), {},
                        device='cpu', start=False)
    else:
        with pytest.raises(ValueError, match='int4 pool'):
            TorchEngine(ModelConfig(**CFG),
                        EngineConfig(**dict(ECFG, quant_policy=4)), {},
                        device='cpu', start=False, kv_scales=kv_scales)


def test_int4_engine_pool_and_page_bytes():
    """quant_policy=8 with calibrated per-layer scales: a nibble-packed
    pool [L, P, page, KH, Dh/2] carrying the scales; quant_policy=4
    without scales: an int8 pool at scale 1 / zero point 0, as the JAX
    engine allocates it."""
    eng = TorchEngine(ModelConfig(**CFG),
                      EngineConfig(**dict(ECFG, quant_policy=8)), {},
                      device='cpu', start=False, kv_scales=SCALES[4])
    assert eng.cache.k.dtype == torch.uint8 and eng.cache.k.shape[-1] == 64
    assert eng.cache.quant_bits == 4
    np.testing.assert_array_equal(eng.cache.v_zp.numpy(),
                                  np.float32(SCALES[4][3]))
    eng = TorchEngine(ModelConfig(**CFG),
                      EngineConfig(**dict(ECFG, quant_policy=4)), {},
                      device='cpu', start=False)
    assert eng.cache.k.dtype == torch.int8
    assert eng.cache.k_scale.tolist() == [1.0, 1.0]
    assert eng.cache.k_zp.tolist() == [0.0, 0.0]


def _stats_npz(path, nl=3, kh=2, dh=128, seed=7):
    """A synthetic calib_stats.npz in the JAX CalibrationContext layout."""
    rng = np.random.default_rng(seed)
    out = {}
    for kind in ('keys', 'values'):
        for i in range(nl):
            lo = -rng.uniform(0.5, 4, size=(kh, dh)).astype(np.float32)
            hi = rng.uniform(0.5, 4, size=(kh, dh)).astype(np.float32)
            out[f'{kind}/{i}/min'] = lo
            out[f'{kind}/{i}/max'] = hi
            out[f'{kind}/{i}/absmax'] = np.maximum(-lo, hi)
    out['inputs/wqkv/absmean'] = rng.uniform(size=(16,)).astype(np.float32)
    np.savez(path, **out)


@pytest.mark.parametrize('kv_bits,kv_sym', [(8, False), (8, True),
                                            (4, False)])
def test_kv_qparams_matches_jax(tmp_path, kv_bits, kv_sym):
    """The port's kv_qparams (its own load_stats) writes the same
    kv_scales, quant_policy and kv_dtype into a workspace config as the
    JAX package's."""
    _stats_npz(tmp_path / 'calib_stats.npz')
    for side in ('jax', 'port'):
        (tmp_path / side).mkdir()
        with open(tmp_path / side / 'config.json', 'w') as f:
            json.dump({'model': {}, 'engine': {'session_len': 64}}, f)
    jkv_qparams(str(tmp_path), str(tmp_path / 'jax'), kv_bits, kv_sym)
    kv_qparams(str(tmp_path), str(tmp_path / 'port'), kv_bits, kv_sym)
    want, got = (json.load(open(tmp_path / s / 'config.json'))
                 for s in ('jax', 'port'))
    assert got == want
    assert got['engine']['kv_dtype'] == ('int8' if kv_bits == 8 else 'int4')


def test_load_workspace_returns_kv_scales(tmp_path):
    """load_workspace returns a JAX-written workspace's kv_scales, and
    build_engine's quant_policy override allocates the int8 pool with
    them and serves."""
    jp = jax_int4_params(2)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                      if a.dtype == jnp.float32 else a, jp)
    save_workspace(str(tmp_path), JModelConfig(**CFG), jp,
                   JEngineConfig(**ECFG), kv_scales=SCALES[8])
    _, ecfg, _, kv_scales = load_workspace(str(tmp_path), device='cpu')
    assert ecfg.quant_policy == 0
    for got, want in zip(kv_scales, SCALES[8]):
        np.testing.assert_array_equal(np.float32(got), np.float32(want))
    eng = build_engine(str(tmp_path), device='cpu', quant_policy=4)
    try:
        assert eng.ecfg.kv_dtype == 'int8'
        assert eng.cache.k.dtype == torch.int8
        np.testing.assert_array_equal(eng.cache.v_scale.numpy(),
                                      np.float32(SCALES[8][2]))
        out = eng.create_instance().infer(1, PROMPTS[0],
                                          gen_config=GenerationConfig(
                                              max_new_tokens=4, top_k=1,
                                              ignore_eos=True))
        assert len(out.token_ids) == 4
        assert eng.cache.k.abs().sum() > 0
    finally:
        eng.shutdown()


# -- dynamic per-token-head-group int4 and per-head int4 qparams -----------

@pytest.mark.parametrize('groups', [1, 2, 4])
def test_quantize_kv_dynamic_matches_jax(groups):
    """quantize_kv_dynamic gives the JAX function's packed bytes, scales
    and minima bit for bit, on rows with .5 ties and on constant rows
    (whose scale clamps at 1e-8)."""
    rng = np.random.default_rng(20 + groups)
    x = (rng.normal(size=(5, 7, 3, 128)) * 2).astype(np.float32)
    x[0, 0, 0] = 1.25                                # a constant row
    x[0, 1, 1, :16] = np.arange(16) * 0.5 / 15 * 2   # steps of exact halves
    jq, js, jm = jpaged.quantize_kv_dynamic(jnp.asarray(x), groups)
    tq, ts, tm = tpaged.quantize_kv_dynamic(torch.from_numpy(x), groups)
    assert tq.dtype == torch.uint8 and tuple(tq.shape) == (5, 7, 3, 64)
    assert tuple(ts.shape) == (5, 7, 3, groups)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tpaged.unpack_kv_uint4(tq).numpy(),
                                  np.asarray(jpaged.unpack_kv_uint4(jq)))


@pytest.mark.parametrize('env,want', [(None, 2), ('4', 4), ('3', 2),
                                      ('0', 1)])
def test_kv_dyn_groups_matches_jax(monkeypatch, env, want):
    """LMDEPLOY_TPU_KV_DYN_GROUPS, default 2, clamped to a divisor of
    Dh/2, as in the JAX package."""
    if env is None:
        monkeypatch.delenv('LMDEPLOY_TPU_KV_DYN_GROUPS', raising=False)
    else:
        monkeypatch.setenv('LMDEPLOY_TPU_KV_DYN_GROUPS', env)
    assert tpaged.kv_dyn_groups(128) == jpaged.kv_dyn_groups(128) == want


def _write_case(seed):
    rng = np.random.default_rng(seed)
    kh = 2
    k_new = (rng.normal(size=(2, 12, kh, 128)) * 2).astype(np.float32)
    v_new = (rng.normal(size=(2, 12, kh, 128)) * 2).astype(np.float32)
    pos = np.stack([np.arange(12), np.arange(5, 17)]).astype(np.int32)
    pt = np.array([[3, 0, -1], [5, 1, 2]], np.int32)
    valid = np.ones((2, 12), bool)
    valid[1, 9:] = False
    return k_new, v_new, pos, pt, valid


def _bf16_ulps_apart(a: torch.Tensor, b: np.ndarray) -> np.ndarray:
    """|a - b| in units of the bf16 spacing at b (both bf16 values)."""
    bt = torch.from_numpy(np.array(b, np.float32)).to(torch.bfloat16)
    ai = a.view(torch.int16).to(torch.int32)
    bi = bt.view(torch.int16).to(torch.int32)
    return (ai - bi).abs().numpy()


def test_write_and_gather_kv_dynamic_match_jax():
    """write_kv_dynamic drops masked tokens and unmapped pages and leaves
    codes and qparams bit-identical to the JAX pools (its four
    [L, P, page, KH, G] arrays are the port's dyn[..., j, :]); the bf16
    gather agrees to one bf16 ulp on at most 0.1% of values (XLA may fuse
    q * scale + min)."""
    layers, pages, page, kh = 2, 6, 8, 2
    jc = jpaged.init_cache(layers, pages, page, kh, 128, jnp.uint8,
                           dynamic_scales=True)
    tc = tpaged.init_cache(layers, pages, page, kh, 128, torch.uint8, 'cpu',
                           dynamic_scales=True)
    assert tc.dynamic_scales and tc.dyn_groups == jc.dyn_groups == 2
    assert tuple(tc.dyn.shape) == (layers, pages, page, kh, 4, 2)
    k_new, v_new, pos, pt, valid = _write_case(30)
    layer = 1
    out = jpaged.write_kv_dynamic(
        jc.k, jc.v, jc.k_scale, jc.k_zp, jc.v_scale, jc.v_zp, layer,
        jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(pos),
        jnp.asarray(pt), jnp.asarray(valid))
    tpaged.write_kv_dynamic(tc.k, tc.v, tc.dyn, layer,
                            torch.from_numpy(k_new), torch.from_numpy(v_new),
                            torch.from_numpy(pos), torch.from_numpy(pt),
                            torch.from_numpy(valid))
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(out[0]))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(out[1]))
    for j in range(4):
        np.testing.assert_array_equal(tc.dyn[..., j, :].numpy(),
                                      np.asarray(out[2 + j]))
    assert tc.k.int().sum() > 0
    jk, jv = jpaged.gather_kv_layer_dynamic(
        out[0][layer], out[1][layer], out[2][layer], out[3][layer],
        out[4][layer], out[5][layer], jnp.asarray(pt), dtype=jnp.bfloat16)
    tk, tv = tpaged.gather_kv_layer_dynamic(tc.k[layer], tc.v[layer],
                                            tc.dyn[layer],
                                            torch.from_numpy(pt),
                                            dtype=torch.bfloat16)
    for got, want in ((tk, jk), (tv, jv)):
        ulps = _bf16_ulps_apart(got, np.asarray(want.astype(jnp.float32)))
        assert ulps.max() <= 1 and (ulps != 0).mean() <= 1e-3, (
            ulps.max(), (ulps != 0).mean())


def test_write_and_gather_kv_per_head_match_jax():
    """write_kv and gather_kv_layer with one layer's [KH] qparams
    broadcast per head as the JAX functions do: bit-identical codes and
    f32 values."""
    layers, pages, page, kh = 2, 6, 8, 2
    scales = ([[0.5, 0.7], [0.6, 0.45]], [[0.25, -0.5], [0.0, 1.0]],
              [[0.4, 0.55], [0.52, 0.61]], [[-0.25, 0.5], [0.5, -1.0]])
    jc = jpaged.init_cache(layers, pages, page, kh, 128, jnp.uint8,
                           kv_scales=scales)
    tc = tpaged.init_cache(layers, pages, page, kh, 128, torch.uint8, 'cpu',
                           kv_scales=scales)
    k_new, v_new, pos, pt, valid = _write_case(31)
    layer = 1
    jqp = (jc.k_scale[layer], jc.k_zp[layer], jc.v_scale[layer],
           jc.v_zp[layer])
    jk, jv = jpaged.write_kv(jc.k, jc.v, layer, jnp.asarray(k_new),
                             jnp.asarray(v_new), jnp.asarray(pos),
                             jnp.asarray(pt), jnp.asarray(valid), jqp)
    tpaged.write_kv(tc.k, tc.v, layer, torch.from_numpy(k_new),
                    torch.from_numpy(v_new), torch.from_numpy(pos),
                    torch.from_numpy(pt), torch.from_numpy(valid),
                    tc.qparams[layer])
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jv))
    jkk, jvv = jpaged.gather_kv_layer(jk[layer], jv[layer], jnp.asarray(pt),
                                      jqp, dtype=jnp.float32)
    tkk, tvv = tpaged.gather_kv_layer(tc.k[layer], tc.v[layer],
                                      torch.from_numpy(pt),
                                      tc.qparams[layer].unbind(),
                                      dtype=torch.float32)
    np.testing.assert_array_equal(tkk.numpy(), np.asarray(jkk))
    np.testing.assert_array_equal(tvv.numpy(), np.asarray(jvv))


PER_HEAD = ([[0.52], [0.61]], [[0.25], [-0.5]], [[0.47], [0.55]],
            [[-0.25], [0.5]])


@pytest.mark.parametrize('kind', ['dynamic', 'per_head'])
def test_forward_dynamic_and_per_head_pool_matches_jax(kind):
    """A 2-row prefill chunk (one row right-padded) and 3 decode steps
    through a dynamic and a per-head int4 pool, against the JAX forward
    (its XLA gather route for these pools), at the quantised pools' gates:
    logits within 1e-3 of max |logit|, codes at most one step apart on at
    most 0.1% of values.  No kernel's plain version runs: the gather route
    is the model's own."""
    jcfg, tcfg = JModelConfig(**CFG), ModelConfig(**CFG)
    tree = dense_params(0)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, device='cpu')
    page, pages = 16, 9
    kw = dict(dynamic_scales=True) if kind == 'dynamic' \
        else dict(kv_scales=PER_HEAD)
    jcache = jpaged.init_cache(2, pages, page, 1, 128, jnp.uint8, **kw)
    tcache = tpaged.init_cache(2, pages, page, 1, 128, torch.uint8, 'cpu',
                               **kw)
    pt = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 256, size=(2, 24)).astype(np.int32)
    lens = np.array([24, 13], np.int32)
    step = (ids, np.tile(np.arange(24, dtype=np.int32), (2, 1)),
            np.arange(24)[None] < lens[:, None], lens)
    pos = lens.copy()
    K.reset_launch_counts()
    for _ in range(4):
        ids_s, pos_s, valid_s, ctx_s = step
        jb = jllama.StepBatch(ids=jnp.asarray(ids_s),
                              positions=jnp.asarray(pos_s),
                              valid=jnp.asarray(valid_s),
                              context_len=jnp.asarray(ctx_s),
                              page_table=jnp.asarray(pt))
        want, jcache = jllama.forward(jp, jcache, jb, jcfg,
                                      use_pallas_attn=False)
        tb = tllama.StepBatch(ids=torch.from_numpy(ids_s),
                              positions=torch.from_numpy(pos_s),
                              valid=torch.from_numpy(np.asarray(valid_s)),
                              context_len=torch.from_numpy(ctx_s),
                              page_table=torch.from_numpy(pt))
        got, _ = tllama.forward(tp, tcache, tb, tcfg)
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-3 * np.abs(want).max()
        nxt = want.argmax(-1).astype(np.int32)[:, None]
        step = (nxt, pos[:, None].copy(), np.ones((2, 1), bool), pos + 1)
        pos = pos + 1
    unpack = tpaged.unpack_kv_uint4 if kind == 'dynamic' \
        else tpaged.unpack_kv_int4
    for tpool, jpool in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        a = unpack(tpool).numpy().astype(np.int32)
        b = unpack(torch.from_numpy(np.array(jpool))).numpy().astype(
            np.int32)
        diff = np.abs(a - b)
        assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3, (
            diff.max(), (diff != 0).mean())
        assert np.abs(a).sum() > 0
    if kind == 'dynamic':
        ks = np.asarray(jcache.k_scale)
        np.testing.assert_allclose(tcache.dyn[..., 0, :].numpy(), ks,
                                   rtol=1e-5, atol=1e-7)
    assert not any(c[1] for c in K.launch_counts().values())


def _engine_streams(make, gen_cls, script):
    eng = make()
    try:
        return script(eng.create_instance(), gen_cls), dict(eng.stats)
    finally:
        eng.shutdown()


@pytest.mark.parametrize('mode', ['plain', 'spec', 'prefix'])
def test_dynamic_engine_greedy_matches_jax_engine(mode):
    """quant_policy 8 without kv_scales: the port's engine on a dynamic
    int4 pool streams the JAX engine's greedy tokens (dense f32 weights, so
    that only the KV path differs) up to the first step whose top-2 logit
    gap (JAX forward over a dynamic pool) is within 1e-3 of that step's
    largest |logit|, on plain rounds, speculative rounds (k = 4) and with
    a prefix-cache hit (the follower's hits equal the JAX engine's)."""
    tree = dense_params(0)
    jp = jax.tree.map(jnp.asarray, tree)
    jcfg = JModelConfig(**CFG)
    ecfg = dict(ECFG, quant_policy=8)
    prompts = PROMPTS
    if mode == 'spec':
        ecfg.update(speculative_k=4, speculative_ngram=3,
                    speculative_ngram_min=2)
        prompts = [[3, 4, 5] * 4] + PROMPTS[:2]
    elif mode == 'prefix':
        ecfg.update(enable_prefix_caching=True)
        prompts = [PROMPTS[2], PROMPTS[2][:40] + [9, 8, 7]]

    def script(inst, gen):
        return [inst.infer(100 + i, p, gen_config=gen(
            max_new_tokens=10, top_k=1, ignore_eos=True),
            sequence_end=True).token_ids for i, p in enumerate(prompts)]
    jouts, jstats = _engine_streams(
        lambda: TPUEngine(jcfg, JEngineConfig(**ecfg), jp), JGen, script)
    touts, tstats = _engine_streams(
        lambda: TorchEngine(ModelConfig(**CFG), EngineConfig(**ecfg),
                            params_from_numpy(tree, 'cpu'), device='cpu'),
        GenerationConfig, script)
    if mode == 'spec':
        assert tstats['spec_rounds'] > 0 and jstats['spec_rounds'] > 0
    if mode == 'prefix':
        assert tstats['prefix_hit_tokens'] == jstats['prefix_hit_tokens'] \
            == 32
    compared = 0
    for prompt, jt, tt in zip(prompts, jouts, touts):
        assert len(jt) == len(tt) == 10
        ids = np.asarray(prompt + jt[:-1], np.int32)[None]
        t = ids.shape[1]
        batch = jllama.StepBatch(
            ids=jnp.asarray(ids),
            positions=jnp.arange(t, dtype=jnp.int32)[None],
            valid=jnp.ones((1, t), bool),
            context_len=jnp.asarray([t], jnp.int32),
            page_table=jnp.arange(8, dtype=jnp.int32)[None])
        cache = jpaged.init_cache(2, 9, 16, 1, 128, jnp.uint8,
                                  dynamic_scales=True)
        logits, _ = jllama.forward(jp, cache, batch, jcfg,
                                   return_all_logits=True)
        logits = np.asarray(logits)[0, len(prompt) - 1:]
        for step, (a, b) in enumerate(zip(jt, tt)):
            top2 = np.sort(logits[step])[-2:]
            if top2[1] - top2[0] < 1e-3 * np.abs(logits[step]).max():
                break
            assert a == b, (prompt, step, jt, tt)
            compared += 1
    assert compared >= 8 * len(prompts), compared


@pytest.mark.parametrize('per_head', [False, True])
def test_kv_qparams_per_head_matches_jax(tmp_path, per_head):
    """kv_qparams --kv-bits 4, per layer and per head: the same kv_scales
    as the JAX package's, and a workspace carrying per-head scales serves
    through build_engine on a per-head pool."""
    _stats_npz(tmp_path / 'calib_stats.npz', nl=2, kh=1)
    jp = jax_int4_params(2)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                      if a.dtype == jnp.float32 else a, jp)
    for side in ('jax', 'port'):
        save_workspace(str(tmp_path / side), JModelConfig(**CFG), jp,
                       JEngineConfig(**ECFG))
    jkv_qparams(str(tmp_path), str(tmp_path / 'jax'), 4, per_head=per_head)
    kv_qparams(str(tmp_path), str(tmp_path / 'port'), 4, per_head=per_head)
    want, got = (json.load(open(tmp_path / s / 'config.json'))
                 for s in ('jax', 'port'))
    assert got == want
    assert np.asarray(got['kv_scales'][0]).shape == \
        ((2, 1) if per_head else (2,))
    _, _, _, kv_scales = load_workspace(str(tmp_path / 'port'), 'cpu')
    eng = build_engine(str(tmp_path / 'port'), device='cpu')
    try:
        assert eng.cache.quant_bits == 4 and eng.cache.per_head == per_head
        np.testing.assert_array_equal(eng.cache.k_scale.numpy(),
                                      np.float32(kv_scales[0]))
        out = eng.create_instance().infer(1, PROMPTS[0],
                                          gen_config=GenerationConfig(
                                              max_new_tokens=4, top_k=1,
                                              ignore_eos=True))
        assert len(out.token_ids) == 4
    finally:
        eng.shutdown()


def test_build_engine_quant_policy_8_without_scales_is_dynamic(tmp_path):
    """build_engine(ws, quant_policy=8) on a workspace without kv_scales
    serves a dynamic int4 pool, and the engine sizes its pages with the
    qparams' bytes."""
    jp = jax_int4_params(2)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                      if a.dtype == jnp.float32 else a, jp)
    save_workspace(str(tmp_path), JModelConfig(**CFG), jp,
                   JEngineConfig(**ECFG))
    eng = build_engine(str(tmp_path), device='cpu', quant_policy=8)
    try:
        assert eng.cache.dynamic_scales and eng.cache.quant_bits == 4
        out = eng.create_instance().infer(1, PROMPTS[1],
                                          gen_config=GenerationConfig(
                                              max_new_tokens=4, top_k=1,
                                              ignore_eos=True))
        assert len(out.token_ids) == 4
        assert eng.cache.dyn[..., 0, :].ne(1).any()      # scales written
    finally:
        eng.shutdown()
