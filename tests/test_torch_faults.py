"""The port's engine faults, each against the JAX package's behaviour:
``build_engine``'s overrides, ``spec_rounds`` counting and the engine's
survival of a failed rebuild of its device state.

Tiny f32 / W4A16 configs on the CPU (the kernels' plain versions), inputs
from numpy seeds; the JAX side runs its CPU engine.
"""
import jax.numpy as jnp
import pytest
import torch

from lmdeploy_tpu.config import EngineConfig as JEngineConfig
from lmdeploy_tpu.config import ModelConfig as JModelConfig
from lmdeploy_tpu.convert.converter import save_workspace as jsave_workspace
from lmdeploy_tpu.engine.engine import TPUEngine
from lmdeploy_tpu.messages import GenerationConfig as JGen
from lmdeploy_tpu_torch import build_engine
from lmdeploy_tpu_torch.config import EngineConfig, ModelConfig
from lmdeploy_tpu_torch.convert.workspace import params_from_numpy
from lmdeploy_tpu_torch.engine import step as S
from lmdeploy_tpu_torch.engine.engine import TorchEngine
from lmdeploy_tpu_torch.messages import GenerationConfig, ResponseType
from test_torch_engine import (CFG, CYCLE, ECFG, SPEC, cycling_params,
                               jax_int4_params, to_numpy)

torch.set_num_threads(1)


def _numpy_int4():
    return to_numpy(jax_int4_params())


def greedy(n, **kw):
    return GenerationConfig(max_new_tokens=n, top_k=1, ignore_eos=True,
                            **kw)


@pytest.fixture(scope='module')
def workspace(tmp_path_factory):
    """A W4A16 workspace written by the JAX converter."""
    ws = str(tmp_path_factory.mktemp('ws'))
    jsave_workspace(ws, JModelConfig(**CFG), jax_int4_params(),
                    JEngineConfig(**ECFG))
    return ws


def test_build_engine_takes_speculative_k(workspace):
    """``speculative_k`` (and ``quant_policy``) override the workspace's
    engine config, as ``lmdeploy_tpu.api.build_engine`` does; the engine
    then serves speculative rounds."""
    eng = build_engine(workspace, device='cpu', speculative_k=4,
                       quant_policy=4)
    try:
        assert eng.ecfg.speculative_k == 4
        assert eng.ecfg.quant_policy == 4 and eng.ecfg.kv_dtype == 'int8'
        out = eng.create_instance().infer(1, [3, 4, 5, 3, 4, 5, 3, 4],
                                          gen_config=greedy(12),
                                          sequence_end=True)
        assert out.status == ResponseType.FINISH
        assert len(out.token_ids) == 12
        assert eng.stats['spec_rounds'] > 0
    finally:
        eng.shutdown()


@pytest.mark.parametrize('kw', [dict(pp=3), dict(pp=2),
                                dict(dp=2, pp=2)])
def test_build_engine_parallelism_raises_not_implemented(workspace, kw):
    """pp through build_engine, which raised NotImplementedError before
    parallel/pp.py was ported: pp = 2, alone and beside dp, builds at
    start=False with a pool of L/pp layers on every rank and stops its
    ranks cleanly; pp = 3 does not divide the workspace's 2 layers and
    raises ValueError before any rank starts, as the JAX engine does."""
    if kw['pp'] == 3:
        with pytest.raises(ValueError, match='num_layer 2 not divisible '
                                             'by pp=3'):
            build_engine(workspace, device='cpu', start=False, **kw)
        return
    eng = build_engine(workspace, device='cpu', start=False,
                       rank_timeout=60, **kw)
    try:
        assert eng.ecfg.pp == 2 and eng.metrics()['pp'] == 2
        assert eng.cache.k.shape[0] == 1
        assert all(eng._rank_shapes(r)[0]['num_layers'] == 1
                   for r in range(eng.ranks.world))
    finally:
        eng.shutdown()
    assert eng.rank_exitcodes == [0] * (2 * kw.get('dp', 1) - 1)


@pytest.mark.parametrize('n_new', [9, 13, 17, 30])
def test_spec_rounds_count_as_the_jax_engine(n_new):
    """On the cycling model (no near-tie) a greedy speculative request
    whose last dispatch ends before its last round: ``spec_rounds`` and
    ``spec_emitted`` equal the JAX engine's, which counts rounds up to
    the one in which the last running slot finished."""
    prompt = CYCLE * 2 + [17, 40]
    params = cycling_params()
    ecfg = dict(ECFG, **SPEC)
    eng = TorchEngine(ModelConfig(**dict(CFG, weight_type='fp32')),
                      EngineConfig(**ecfg),
                      params_from_numpy(params, 'cpu'), device='cpu')
    try:
        got = eng.create_instance().infer(1, prompt, gen_config=greedy(
            n_new), sequence_end=True).token_ids
        stats = dict(eng.stats)
    finally:
        eng.shutdown()
    jtree = {k: ({a: jnp.asarray(b) for a, b in v.items()}
                 if isinstance(v, dict) else jnp.asarray(v))
             for k, v in params.items()}
    jeng = TPUEngine(JModelConfig(**dict(CFG, weight_type='fp32')),
                     JEngineConfig(**ecfg), jtree)
    try:
        want = jeng.create_instance().infer(1, prompt, gen_config=JGen(
            max_new_tokens=n_new, top_k=1, ignore_eos=True),
            sequence_end=True).token_ids
        jstats = dict(jeng.stats)
    finally:
        jeng.shutdown()
    assert got == want and len(got) == n_new
    assert stats['spec_emitted'] == jstats['spec_emitted'] == n_new
    assert stats['spec_rounds'] == jstats['spec_rounds']
    # the request ended inside a dispatch of step_length rounds
    assert stats['spec_rounds'] % ecfg['step_length'] != 1


def test_engine_survives_dispatch_and_recovery_failure(monkeypatch):
    """Port of tests/test_engine.py's test of the same name: a device
    error on the plain decode path fails the in-flight request, and when
    rebuilding the device state fails too, the engine thread survives and
    rebuilds on a later turn instead of ending with clients queued."""
    eng = TorchEngine(ModelConfig(**CFG), EngineConfig(**ECFG),
                      params_from_numpy(_numpy_int4(), 'cpu'), device='cpu')
    try:
        inst = eng.create_instance()
        out = inst.infer(1, [3, 9], gen_config=greedy(2), sequence_end=True)
        assert out.status == ResponseType.FINISH

        real_steps = S.decode_step_into
        real_alloc = eng._alloc_device_state
        fails = {'steps': 1, 'alloc': 1}

        def bad_steps(*a, **k):
            if fails['steps']:
                fails['steps'] -= 1
                raise RuntimeError('CUDA error: out of memory (simulated)')
            return real_steps(*a, **k)

        def bad_alloc(*a, **k):
            if fails['alloc']:
                fails['alloc'] -= 1
                raise RuntimeError('still out of memory (simulated)')
            return real_alloc(*a, **k)

        monkeypatch.setattr(S, 'decode_step_into', bad_steps)
        eng._alloc_device_state = bad_alloc
        out = inst.infer(2, [5, 7], gen_config=greedy(4), sequence_end=True)
        assert out.status == ResponseType.INTERNAL_ERROR
        assert fails['steps'] == 0
        # alive and serving after the double failure
        out = inst.infer(3, [3, 9], gen_config=greedy(3), sequence_end=True)
        assert out.status == ResponseType.FINISH
        assert len(out.token_ids) == 3
        assert fails['alloc'] == 0 and eng.alive()
    finally:
        eng.shutdown()


def test_device_error_in_a_request_rebuilds_the_state(monkeypatch):
    """A device error while handling one request (here the prompt-logits
    pass) answers that request with INTERNAL_ERROR and rebuilds the device
    state, as the JAX engine's ``_handle_safe`` does; the engine serves
    on."""
    eng = TorchEngine(ModelConfig(**CFG), EngineConfig(**ECFG),
                      params_from_numpy(_numpy_int4(), 'cpu'), device='cpu')
    try:
        inst = eng.create_instance()
        old_cache = eng.cache

        def bad_logits(*a, **k):
            raise RuntimeError('CUDA error: an illegal memory access '
                               '(simulated)')

        monkeypatch.setattr(S, 'prefill_logits', bad_logits)
        with pytest.raises(RuntimeError, match='INTERNAL_ERROR'):
            inst.decode([3, 9, 11])
        monkeypatch.undo()
        out = inst.infer(4, [3, 9], gen_config=greedy(3), sequence_end=True)
        assert out.status == ResponseType.FINISH
        assert eng.cache is not old_cache and eng.stats['errors'] == 1
        assert inst.decode([3, 9, 11]).shape == (3, CFG['vocab_size'])
    finally:
        eng.shutdown()


def test_overloaded_and_metrics():
    """The server-facing gauges of ``lmdeploy_tpu/engine/engine.py``:
    ``overloaded`` against ``max_pending_requests`` and ``metrics``."""
    eng = TorchEngine(ModelConfig(**CFG),
                      EngineConfig(**dict(ECFG, max_pending_requests=1)),
                      params_from_numpy(_numpy_int4(), 'cpu'), device='cpu',
                      start=False)
    assert not eng.overloaded()
    m = eng.metrics()
    assert m['slots_total'] == ECFG['max_batch_size'] and m['slots_busy'] == 0
    assert m['free_pages_group0'] == ECFG['num_pages']
    assert m['prefix_hit_tokens'] == 0 and m['queue_depth'] == 0
    eng._pending.append(None)
    assert eng.overloaded()


def test_cpu_lm_head_logits_are_f32_products():
    """On the CPU, bf16 hidden states and a bf16 lm_head give the JAX
    package's f32 logits (``jnp.dot(..., preferred_element_type=f32)``),
    not logits rounded to bf16: the plain path multiplied in bf16 and lost
    ~0.4% of each logit (a dense bf16 workspace's perplexity moved from
    396.66 to 397.22)."""
    import numpy as np

    from lmdeploy_tpu.models import llama as jllama
    from lmdeploy_tpu_torch.models import llama as tllama
    rng = np.random.default_rng(4)
    h = rng.normal(size=(2, 3, 256)).astype(np.float32)
    head = (rng.normal(size=(256, 384)) * 0.06).astype(np.float32)
    norm = np.ones(256, np.float32)
    cfg = dict(CFG, weight_type='bf16')
    jp = {'norm': jnp.asarray(norm, jnp.bfloat16),
          'lm_head': jnp.asarray(head, jnp.bfloat16)}
    tp = {'norm': torch.from_numpy(norm).to(torch.bfloat16),
          'lm_head': torch.from_numpy(head).to(torch.bfloat16)}
    want = np.asarray(jllama.lm_head_logits(
        jp, jnp.asarray(h, jnp.bfloat16), None, JModelConfig(**cfg),
        return_all_logits=True))
    got = tllama.lm_head_logits(
        tp, torch.from_numpy(h).to(torch.bfloat16), None,
        ModelConfig(**cfg), return_all_logits=True)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 384)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
