"""The port's pipeline-parallel engine (ranks spawned as processes, gloo on
the CPU) against the JAX package's pp engine at the same EngineConfig, on
``tests/test_pp.py``'s model: the relay, the microbatch ring decode with
its host-side stops, ring-mode switches and top-N logprobs.  Every group
of ranks has a 60 s timeout and every spawned rank a 30 s join."""
import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lmdeploy_tpu.config import EngineConfig as JEngineConfig
from lmdeploy_tpu.config import ModelConfig as JModelConfig
from lmdeploy_tpu.engine.engine import TPUEngine
from lmdeploy_tpu.messages import GenerationConfig as JGen
from lmdeploy_tpu.models import llama as jllama
from lmdeploy_tpu_torch.config import EngineConfig, ModelConfig
from lmdeploy_tpu_torch.convert.workspace import params_from_numpy
from lmdeploy_tpu_torch.engine.engine import TorchEngine
from lmdeploy_tpu_torch.messages import GenerationConfig

torch.set_num_threads(1)
TIMEOUT = 60
# tests/test_pp.py's model and engine
CFG = dict(head_num=8, kv_head_num=4, size_per_head=16, inter_size=64,
           num_layer=4, vocab_size=128, rotary_embedding=16,
           max_position_embeddings=128, session_len=64, end_id=2)
ECFG = dict(max_batch_size=2, session_len=64, page_size=8, num_pages=32,
            max_context_token_num=16, prefill_buckets=(8, 16), step_length=4)


def np_tree(t):
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if dataclasses.is_dataclass(t):
        return {f.name: np.asarray(getattr(t, f.name))
                for f in dataclasses.fields(t)}
    return np.asarray(t)


def both_engines(seed, ecfg, script, **kw):
    """``script(engine, GenerationConfig class)`` on the JAX engine and on
    the port's engine at one EngineConfig (tests/test_pp.py's weights,
    ``seed``), JAX first.  Checks the port's ranks: one readback digest per
    dp group, every spawned rank exits 0.  Returns (want, got)."""
    jp = jllama.init_params(JModelConfig(**CFG), jax.random.PRNGKey(seed),
                            jnp.float32)
    jeng = TPUEngine(JModelConfig(**CFG), JEngineConfig(use_pallas=False,
                                                        **ecfg), jp, **kw)
    try:
        want = script(jeng, JGen)
    finally:
        jeng.shutdown()
    eng = TorchEngine(ModelConfig(**CFG), EngineConfig(**ecfg),
                      params_from_numpy(np_tree(jp), 'cpu'), device='cpu',
                      rank_timeout=TIMEOUT, **kw)
    try:
        got = script(eng, GenerationConfig)
        reports = eng.fns.rank_report()
    finally:
        eng.shutdown()
    world = eng.tp * eng.pp * eng.dp
    assert eng.metrics()['pp'] == ecfg.get('pp', 1)
    assert [r['rank'] for r in reports] == list(range(world))
    assert len({r['readback_sha256'] for r in reports}) == eng.dp
    assert eng.rank_exitcodes == [0] * (world - 1)
    return want, got


def greedy(gen_cls, n, **kw):
    return gen_cls(max_new_tokens=n, top_k=1, ignore_eos=True, **kw)


def test_engine_serves_over_pp_mesh():
    """The relay (pp_ring_decode off) at pp = 2 x tp = 2: a greedy and a
    seeded sampled request stream the JAX engine's tokens on plain decode
    steps (no ring round), and prompt logits over two prefill chunks lie
    within rtol / atol 2e-4 of its."""
    ecfg = dict(ECFG, pp=2, tp=2, pp_ring_decode=False)
    prompt = [3, 9, 4, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72,
              73, 74, 75]

    def script(eng, gen_cls):
        inst = eng.create_instance()
        gens = [greedy(gen_cls, 6),
                gen_cls(max_new_tokens=6, top_k=20, top_p=0.9,
                        temperature=0.8, random_seed=7, ignore_eos=True)]
        return {'streams': [inst.infer(i + 1, [3 + i, 9, 4], gen_config=g,
                                       sequence_end=True).token_ids
                            for i, g in enumerate(gens)],
                'logits': inst.decode(prompt),
                'ring_rounds': eng.stats['ring_rounds']}

    want, got = both_engines(2, ecfg, script)
    assert all(len(t) == 6 for t in want['streams'])
    assert got['streams'] == want['streams']
    assert got['ring_rounds'] == want['ring_rounds'] == 0
    assert got['logits'].shape == (len(prompt), CFG['vocab_size'])
    np.testing.assert_allclose(got['logits'], want['logits'], rtol=2e-4,
                               atol=2e-4)


def test_engine_ring_decode_parity_and_stops():
    """The ring at pp = 2 x tp = 2: a greedy request, the same request
    with a mid-stream token as stop word (host-side retirement of the
    ring's ungated rounds, in its second dispatch) and the max_new_tokens
    clamp (10 new at step_length 4: dispatches of 1, 4, 4 and 1 rounds),
    and a seeded sampled, penalised
    request with logprobs stream the JAX engine's tokens; the logprobs lie
    within rtol / atol 2e-4 of its, and each request rode the ring."""
    ecfg = dict(ECFG, pp=2, tp=2)

    def script(eng, gen_cls):
        inst = eng.create_instance()
        out, rings = {}, []

        def run(name, gen):
            before = eng.stats['ring_rounds']
            res = inst.infer(1, [33, 29, 114, 30, 31], gen_config=gen,
                             sequence_end=True)
            rings.append(eng.stats['ring_rounds'] - before)
            out[name] = res.token_ids
            return res
        base = run('base', greedy(gen_cls, 10)).token_ids
        # the first token of the stream's second dispatch that is new
        stop = next(t for i, t in enumerate(base) if i >= 5
                    and t not in base[:i])
        run('stop', greedy(gen_cls, 10, stop_words=[int(stop)]))
        res = run('sampled', gen_cls(
            max_new_tokens=6, top_k=20, top_p=0.9, temperature=0.8,
            random_seed=7, repetition_penalty=1.1, ignore_eos=True,
            output_logprobs=True))
        out['logprobs'] = res.logprobs
        out['rings'] = rings
        return out

    want, got = both_engines(4, ecfg, script)
    assert len(want['base']) == 10 and 5 <= len(want['stop']) < 9
    for name in ('base', 'stop', 'sampled'):
        assert got[name] == want[name], name
    assert all(r > 0 for r in got['rings']) and got['rings'][0] == 10
    np.testing.assert_allclose(got['logprobs'], want['logprobs'],
                               rtol=2e-4, atol=2e-4)


def test_engine_ring_relay_switching():
    """A seeded sampled request joining a long greedy one mid-stream moves
    the ring from its greedy mode to its sampling mode and back when it
    retires: both streams equal the JAX engine's, and every decode round
    rode the ring."""
    ecfg = dict(ECFG, session_len=128, num_pages=48, pp=2, tp=2)

    def script(eng, gen_cls):
        inst = eng.create_instance()
        res = {}

        def run_b():
            res['b'] = inst.infer(2, [8, 2, 6], gen_config=gen_cls(
                max_new_tokens=5, top_k=20, top_p=0.9, temperature=0.8,
                random_seed=3, ignore_eos=True),
                sequence_end=True).token_ids
        stream = inst.stream_infer(1, [3, 9, 4], greedy(gen_cls, 30),
                                   sequence_end=True)
        out = next(stream)                  # A is decoding now
        tb = threading.Thread(target=run_b)
        tb.start()
        for out in stream:
            pass
        tb.join(120)
        return out.token_ids, res['b'], eng.stats['ring_rounds']

    want, got = both_engines(6, ecfg, script)
    assert len(got[0]) == 30 and len(got[1]) == 5
    assert got[:2] == want[:2]
    assert got[2] >= 30


def test_top_logprobs_on_pp_mesh_rides_ring():
    """A top_logprobs request at pp = 2 rides the ring: its tokens, its
    top-2 alternatives and their logprobs (within 1e-4) equal the JAX
    engine's, the chosen token is the best alternative and its logprob
    its own entry."""
    ecfg = dict(ECFG, pp=2)

    def script(eng, gen_cls):
        out = eng.create_instance().infer(
            2, [3, 9, 4], gen_config=greedy(gen_cls, 6, top_logprobs=2),
            sequence_end=True)
        return out, eng.stats['ring_rounds']

    (want, _), (got, rings) = both_engines(9, ecfg, script)
    assert rings > 0
    assert got.token_ids == want.token_ids
    assert len(got.top_logprobs) == 6
    for tok, lp, tops, ref in zip(got.token_ids, got.logprobs,
                                  got.top_logprobs, want.top_logprobs):
        assert set(tops) == set(ref) and len(tops) == 2
        assert all(abs(tops[t] - ref[t]) < 1e-4 for t in tops)
        assert max(tops, key=tops.get) == tok
        assert lp == pytest.approx(tops[tok], abs=1e-5)
