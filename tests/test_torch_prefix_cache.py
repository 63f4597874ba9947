"""Cross-session prefix caching and prompt logits of the port's engine,
against the JAX engine on the same weights.

Ports of ``tests/test_prefix_cache.py``'s engine tests: streams with
caching on equal those with it off (exactly: the CPU runs the same plain
arithmetic either way), on each of the port's session stores (the native
C++ manager and the Python one), a rewind into shared pages stays private, seeded
sampling is unperturbed, and a prompt is shareable while its request still
generates; on the same traffic the port's ``prefix_hit_tokens`` equals the
JAX engine's.  Then ``EngineInstance.decode`` against the JAX one on a
dense f32 model (rtol 2e-3, atol 5e-3, ``tests/test_model_parity.py``'s
f32 tolerance).
"""
import dataclasses
import json
import os
import os.path as osp
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdeploy_tpu.config import EngineConfig as JEngineConfig
from lmdeploy_tpu.config import ModelConfig as JModelConfig
from lmdeploy_tpu.convert.converter import save_workspace as jsave_workspace
from lmdeploy_tpu.engine.engine import TPUEngine
from lmdeploy_tpu.messages import GenerationConfig as JGen
from lmdeploy_tpu_torch.config import EngineConfig, ModelConfig
from lmdeploy_tpu_torch.convert.workspace import (load_workspace,
                                                  params_from_numpy)
from lmdeploy_tpu_torch.engine.engine import TorchEngine
from lmdeploy_tpu_torch.messages import GenerationConfig
from test_torch_engine import CFG, ECFG, jax_int4_params, to_numpy

torch.set_num_threads(1)

# the JAX tests' engine shape: 8-token pages, 2 slots, every bucket small
PC_ECFG = dict(ECFG, max_batch_size=2, session_len=96, page_size=8,
               num_pages=48, max_context_token_num=16,
               prefill_buckets=(8, 16, 32), enable_prefix_caching=True)
SYSTEM = [3, 7, 11, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71,
          73, 79]                                  # 18-token shared prefix


@pytest.fixture(params=['native', 'python'])
def store(request, monkeypatch):
    """The port's session store under test: the native C++ manager (the
    default) or the Python one (LMDEPLOY_TPU_NATIVE=0)."""
    monkeypatch.setenv('LMDEPLOY_TPU_NATIVE',
                       '1' if request.param == 'native' else '0')
    return request.param


@pytest.fixture(scope='module')
def weights():
    jp = jax_int4_params()
    return jp, params_from_numpy(to_numpy(jp), 'cpu')


def port_engine(params, **over):
    eng = TorchEngine(ModelConfig(**CFG), EngineConfig(**dict(PC_ECFG,
                                                              **over)),
                      params, device='cpu')
    assert eng.metrics()['native_cache_manager'] == \
        (os.environ['LMDEPLOY_TPU_NATIVE'] != '0')
    return eng


def jax_engine(jp, **over):
    return TPUEngine(JModelConfig(**CFG),
                     JEngineConfig(**dict(PC_ECFG, **over)), jp)


def greedy(n, **kw):
    return dict(max_new_tokens=n, top_k=1, ignore_eos=True, **kw)


def drive(eng, gen_cls, script):
    """Run ``script(inst, gen_cls)`` on ``eng``; (its result, stats)."""
    try:
        return script(eng.create_instance(), gen_cls), dict(eng.stats)
    finally:
        eng.shutdown()


def both(weights, script, **over):
    """The script on the port with caching on and off and on the JAX
    engine with caching on: streams on == off, hits == JAX's."""
    jp, params = weights
    on, s_on = drive(port_engine(params, **over), GenerationConfig, script)
    off, s_off = drive(port_engine(params, enable_prefix_caching=False,
                                   **over), GenerationConfig, script)
    _, s_jax = drive(jax_engine(jp, **over), JGen, script)
    assert on == off
    assert s_off['prefix_hit_tokens'] == 0
    assert s_on['prefix_hit_tokens'] == s_jax['prefix_hit_tokens'] > 0
    return on, s_on


def test_prefix_cache_exact_streams(weights, store):
    sessions = [(1, SYSTEM + [101, 103]), (2, SYSTEM + [107, 109, 113]),
                (3, SYSTEM + [101, 103])]          # an exact repeat of 1

    def script(inst, gen):
        return {sid: inst.infer(sid, p, gen_config=gen(**greedy(10)),
                                sequence_end=True).token_ids
                for sid, p in sessions}
    out, stats = both(weights, script)
    assert out[1] == out[3]
    # 18-token prefix -> 2 full pages (16 tokens) per follower
    assert stats['prefix_hit_tokens'] == 32


def test_prefix_cache_rewind_isolation(weights, store):
    """A session that rewinds into shared pages must not corrupt another
    that reuses the same published prefix afterwards."""
    prompt = SYSTEM + [101, 103]

    def script(inst, gen):
        g = gen(**greedy(8))
        a1 = inst.infer(1, prompt, gen_config=g).token_ids
        a2 = inst.infer(1, [87, 89], gen_config=g, step=10,
                        sequence_start=False).token_ids
        b = inst.infer(2, prompt, gen_config=g, sequence_end=True).token_ids
        inst.end(1)
        return a1, a2, b
    (a1, _, b), _ = both(weights, script)
    assert a1 == b


def test_prefix_cache_sampled_reproducible(weights, store):
    """Prefix hits do not perturb the sampled path: the same seed gives
    the same stream, caching on or off."""
    prompt = SYSTEM + [101]

    def script(inst, gen):
        g = gen(max_new_tokens=8, top_k=20, top_p=0.9, temperature=0.9,
                random_seed=5, ignore_eos=True)
        return [inst.infer(sid, prompt, gen_config=g,
                           sequence_end=True).token_ids for sid in (10, 11)]
    (first, second), _ = both(weights, script)
    assert first == second


def test_prefix_cache_publishes_prompt_during_generation(weights, store):
    """A running request's prompt is shareable right after its prefill
    (an insert-only publish), not only at retirement."""

    def script(inst, gen):
        stream = inst.stream_infer(1, SYSTEM + [101], gen(**greedy(40)),
                                   sequence_end=True)
        next(stream)                  # A prefilled, still generating
        got = {}

        def run_b():
            got['b'] = inst.infer(2, SYSTEM + [107], gen_config=gen(
                **greedy(4)), sequence_end=True).token_ids
        t = threading.Thread(target=run_b)
        t.start()
        for _ in stream:
            pass
        t.join(timeout=120)
        assert not t.is_alive()
        return got['b']
    b, stats = both(weights, script)
    assert len(b) == 4 and stats['prefix_hit_tokens'] == 16


def test_prefix_cache_off_under_dynamic_ntk():
    """Dynamic-NTK rope makes a page's K depend on the whole context, so
    the engine turns caching off, as the JAX engine does."""
    eng = TorchEngine(ModelConfig(**dict(CFG, use_dynamic_ntk=True)),
                      EngineConfig(**PC_ECFG), {}, device='cpu', start=False)
    assert not eng.ecfg.enable_prefix_caching
    assert EngineConfig().enable_prefix_caching      # the default is on


@pytest.mark.parametrize('caching', [True, False])
def test_load_workspace_keeps_prefix_caching(tmp_path, weights, caching):
    jsave_workspace(str(tmp_path), JModelConfig(**CFG), weights[0],
                    JEngineConfig(**dict(PC_ECFG,
                                         enable_prefix_caching=caching)))
    with open(osp.join(tmp_path, 'config.json')) as f:
        assert json.load(f)['engine']['enable_prefix_caching'] == caching
    _, ecfg, _, _ = load_workspace(str(tmp_path), 'cpu')
    assert ecfg.enable_prefix_caching == caching


def dense_f32_params(seed=3):
    rng = np.random.default_rng(seed)
    d, nl, v = 256, 2, 256

    def w(*shape, s=0.06):
        return (rng.normal(size=shape) * s).astype(np.float32)
    return {'tok_embedding': w(v, d, s=1.0), 'norm': np.ones(d, np.float32),
            'lm_head': w(d, v),
            'layers': {'attn_norm': np.ones((nl, d), np.float32),
                       'ffn_norm': np.ones((nl, d), np.float32),
                       'wqkv': w(nl, d, 512), 'wo': w(nl, d, d),
                       'w1': w(nl, d, 256), 'w3': w(nl, d, 256),
                       'w2': w(nl, 256, d)}}


def _jax_tree(tree):
    return {k: (_jax_tree(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in tree.items()}


@pytest.mark.parametrize('length', [1, 13, 45])
def test_decode_matches_jax(length, store):
    """Prompt logits (``EngineInstance.decode``) against the JAX engine's
    on a dense f32 model, over one chunk and over several (the budget is
    32 tokens), within rtol 2e-3 / atol 5e-3."""
    cfg = dict(CFG, weight_type='fp32')
    params = dense_f32_params()
    ids = [(7 * i) % 250 + 3 for i in range(length)]
    eng = TorchEngine(ModelConfig(**cfg), EngineConfig(**ECFG),
                      params_from_numpy(params, 'cpu'), device='cpu')
    try:
        got = eng.create_instance().decode(ids)
        assert eng.seqs.free_count(0) == ECFG['num_pages']   # scratch gone
    finally:
        eng.shutdown()
    jeng = TPUEngine(JModelConfig(**cfg), JEngineConfig(**ECFG),
                     _jax_tree(params))
    try:
        want = jeng.create_instance().decode(ids)
    finally:
        jeng.shutdown()
    assert got.shape == want.shape == (length, CFG['vocab_size'])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=5e-3)


def test_decode_leaves_running_requests_undisturbed(weights, store):
    """A prompt-logits request served between decode rounds leaves a
    running request's stream as it is alone."""
    _, params = weights
    eng = port_engine(params, enable_prefix_caching=True)
    try:
        inst = eng.create_instance()
        prompt = SYSTEM + [101]
        alone = inst.infer(1, prompt, gen_config=GenerationConfig(
            **greedy(24)), sequence_end=True).token_ids
        stream = inst.stream_infer(2, prompt, GenerationConfig(**greedy(24)),
                                   sequence_end=True)
        next(stream)
        lg = inst.decode(SYSTEM * 2)
        outs = list(stream)
        assert not outs[0].finished          # decode ran mid-request
        assert outs[-1].token_ids == alone
        assert lg.shape == (36, CFG['vocab_size'])
        assert np.isfinite(lg).all()
    finally:
        eng.shutdown()


def test_decode_refuses_empty_and_too_long(weights, store):
    _, params = weights
    eng = port_engine(params)
    try:
        inst = eng.create_instance()
        for ids in ([], list(range(3, 3 + PC_ECFG['session_len'] + 1))):
            with pytest.raises(RuntimeError, match='INPUT_TOO_LONG'):
                inst.decode(ids)
    finally:
        eng.shutdown()


def test_jax_engine_config_fields_match():
    """The copied config's fields and defaults are the JAX package's,
    prefix caching included."""
    j = {f.name: f.default for f in dataclasses.fields(JEngineConfig)}
    t = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    assert j == t
