"""The port's engine, workspace loader and entry point against the JAX
package's, on the CPU (every kernel wrapper runs its plain version)."""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lmdeploy_tpu.config import EngineConfig as JEngineConfig
from lmdeploy_tpu.config import ModelConfig as JModelConfig
from lmdeploy_tpu.convert.converter import save_workspace
from lmdeploy_tpu.engine.engine import TPUEngine
from lmdeploy_tpu.kvcache.paged import init_cache as jinit_cache
from lmdeploy_tpu.messages import GenerationConfig as JGen
from lmdeploy_tpu.models import llama as jllama
from lmdeploy_tpu.ops.linear import QuantizedWeight as JQuant
from lmdeploy_tpu.ops.pallas.quant_matmul import pack_nibbles as jpack
from lmdeploy_tpu_torch import build_engine
from lmdeploy_tpu_torch.config import EngineConfig, ModelConfig
from lmdeploy_tpu_torch.convert.workspace import (load_workspace,
                                                  params_from_numpy)
from lmdeploy_tpu_torch.engine.engine import TorchEngine
from lmdeploy_tpu_torch.messages import GenerationConfig, ResponseType
from lmdeploy_tpu_torch.ops.linear import PackedInt4Weight

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(head_num=2, kv_head_num=1, size_per_head=128, inter_size=256,
           num_layer=2, vocab_size=256, rotary_embedding=128,
           max_position_embeddings=512, session_len=128, group_size=128,
           weight_type='int4', end_id=2)
ECFG = dict(max_batch_size=4, session_len=128, page_size=16, num_pages=40,
            max_context_token_num=32, prefill_buckets=(16, 32),
            step_length=4, enable_prefix_caching=False)


def jax_int4_params(seed=0):
    """The JAX package's W4A16 parameters (byte-per-int4 QuantizedWeight,
    as its CPU engine holds them) from numpy draws."""
    rng = np.random.default_rng(seed)
    d, qkv, inter, nl, v = 256, 512, 256, 2, 256

    def w(*shape, s=0.06):
        return jnp.asarray((rng.normal(size=shape) * s).astype(np.float32))
    params = {
        'tok_embedding': w(v, d, s=1.0), 'norm': jnp.ones((d,)),
        'lm_head': w(d, v),
        'layers': {'attn_norm': jnp.ones((nl, d)),
                   'ffn_norm': jnp.ones((nl, d)),
                   'wqkv': w(nl, d, qkv), 'wo': w(nl, d, d),
                   'w1': w(nl, d, inter), 'w3': w(nl, d, inter),
                   'w2': w(nl, inter, d)},
    }
    return jllama.quantize_params(params, JModelConfig(**CFG), 128)


def to_numpy(tree):
    if isinstance(tree, JQuant):
        return {'qvals': np.asarray(tree.qvals),
                'scales': np.asarray(tree.scales),
                'zeros': np.asarray(tree.zeros)}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope='module')
def port_engine():
    eng = TorchEngine(ModelConfig(**CFG), EngineConfig(**ECFG),
                      params_from_numpy(to_numpy(jax_int4_params()), 'cpu'),
                      device='cpu')
    yield eng
    eng.shutdown()


def greedy(n=8, **kw):
    kw.setdefault('ignore_eos', True)
    return GenerationConfig(max_new_tokens=n, top_k=1, **kw)


def run(inst, sid, prompt, gen, **kw):
    outs = list(inst.stream_infer(sid, prompt, gen, **kw))
    assert outs[-1].finished
    return outs[-1]


PROMPTS = [[5, 9, 200, 31, 77], list(range(40, 60)),
           [(7 * i) % 250 + 3 for i in range(45)]]


def test_greedy_streams_match_jax_engine(port_engine):
    """A JAX TPUEngine and the port's engine on the same int4 weights emit
    the same greedy tokens up to the first step whose JAX top-2 logit gap
    is within the tolerance: 2% of that step's largest |logit|, about
    twice the logit difference the two sides show (bf16 activation
    rounding before each W4A16 product; the JAX CPU engine also sums W4A16
    group partials in bf16)."""
    jp = jax_int4_params()
    jcfg = JModelConfig(**CFG)
    jeng = TPUEngine(jcfg, JEngineConfig(**ECFG), jp)
    try:
        jinst = jeng.create_instance()
        jouts = [jinst.infer(100 + i, p, gen_config=JGen(
            max_new_tokens=10, top_k=1, ignore_eos=True),
            sequence_end=True).token_ids for i, p in enumerate(PROMPTS)]
    finally:
        jeng.shutdown()
    inst = port_engine.create_instance()
    touts = [run(inst, 200 + i, p, greedy(10), sequence_end=True).token_ids
             for i, p in enumerate(PROMPTS)]
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
        logits, _ = jllama.forward(jp, jinit_cache(2, 9, 16, 1, 128), batch,
                                   jcfg, return_all_logits=True)
        logits = np.asarray(logits)[0, len(prompt) - 1:]
        for step, (a, b) in enumerate(zip(jt, tt)):
            top2 = np.sort(logits[step])[-2:]
            if top2[1] - top2[0] < 0.02 * np.abs(logits[step]).max():
                break
            assert a == b, (prompt, step, jt, tt)
            compared += 1
    assert compared >= 12, compared


def test_concurrent_requests_match_solo_runs(port_engine):
    inst = port_engine.create_instance()
    solo = [run(inst, 300 + i, p, greedy(6), sequence_end=True).token_ids
            for i, p in enumerate(PROMPTS)]
    results = {}

    def go(i, p):
        results[i] = run(inst, 310 + i, p, greedy(6),
                         sequence_end=True).token_ids
    ts = [threading.Thread(target=go, args=(i, p))
          for i, p in enumerate(PROMPTS)]
    [t.start() for t in ts]
    [t.join(timeout=120) for t in ts]
    assert [results[i] for i in range(3)] == solo


def test_stop_words_and_streaming(port_engine):
    inst = port_engine.create_instance()
    outs = list(inst.stream_infer(320, PROMPTS[0], greedy(6),
                                  sequence_end=True))
    base = outs[-1].token_ids
    lens = [o.num_generated for o in outs]
    assert lens == sorted(lens) and outs[-1].status == ResponseType.FINISH
    got = run(inst, 321, PROMPTS[0], greedy(6, stop_words=[base[2]]),
              sequence_end=True).token_ids
    assert got == base[:base.index(base[2])]
    seq = [base[1], base[2]]
    got = run(inst, 322, PROMPTS[0], greedy(6, stop_words=[seq]),
              sequence_end=True).token_ids
    assert got == base[:1]


def test_interactive_session_and_errors(port_engine):
    """A two-turn session == one concatenated prompt; unknown sessions and
    over-long prompts are refused."""
    inst = port_engine.create_instance()
    p1, p2 = [3, 7, 11, 13], [17, 19, 23]
    out1 = run(inst, 330, p1, greedy(4)).token_ids
    out2 = run(inst, 330, p2, greedy(4), sequence_start=False).token_ids
    want = run(inst, 331, p1 + out1 + p2, greedy(4),
               sequence_end=True).token_ids
    assert out2 == want
    inst.end(330)
    assert run(inst, 332, [1, 2], greedy(2),
               sequence_start=False).status == ResponseType.SESSION_NOT_EXIST
    assert run(inst, 333, list(range(3, 200)), greedy(2)).status == \
        ResponseType.INPUT_TOO_LONG


def test_cancel_ends_the_stream(port_engine):
    inst = port_engine.create_instance()
    stream = inst.stream_infer(340, PROMPTS[1], greedy(100),
                               sequence_end=True)
    first = next(stream)
    inst.cancel(340)
    last = first
    for last in stream:
        pass
    assert last.finished and last.status in (ResponseType.CANCELED,
                                             ResponseType.FINISH)
    assert len(last.token_ids) < 100


@pytest.mark.parametrize('kw', [dict(tp=2), dict(pp=2), dict(dp=2),
                                dict(quant_policy=8)])
def test_unported_engine_options_raise(kw):
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        TorchEngine(ModelConfig(**CFG), EngineConfig(**dict(ECFG, **kw)),
                    {}, device='cpu', start=False)


REPEAT = [3, 4, 5, 3, 4, 5, 3, 4, 5, 3, 4]
SPEC = dict(speculative_k=4, speculative_ngram=3, speculative_ngram_min=2)


@pytest.fixture(scope='module')
def spec_engine():
    eng = TorchEngine(ModelConfig(**CFG), EngineConfig(**dict(ECFG, **SPEC)),
                      params_from_numpy(to_numpy(jax_int4_params()), 'cpu'),
                      device='cpu')
    yield eng
    eng.shutdown()


def sampled(n=12, **kw):
    kw.setdefault('ignore_eos', True)
    return GenerationConfig(max_new_tokens=n, top_k=20, top_p=0.9,
                            temperature=0.9, **kw)


def agree_up_to_near_tie(prompts, streams_a, streams_b, jp, jcfg):
    """Compare two greedy streams per prompt up to the first step whose
    top-2 logit gap, in the JAX forward teacher-forced over the prompt and
    stream a, is within 2% of that step's largest |logit| (the rule of
    test_greedy_streams_match_jax_engine).  Returns the steps compared."""
    compared = 0
    for prompt, a_toks, b_toks in zip(prompts, streams_a, streams_b):
        ids = np.asarray(prompt + a_toks[:-1], np.int32)[None]
        t = ids.shape[1]
        batch = jllama.StepBatch(
            ids=jnp.asarray(ids),
            positions=jnp.arange(t, dtype=jnp.int32)[None],
            valid=jnp.ones((1, t), bool),
            context_len=jnp.asarray([t], jnp.int32),
            page_table=jnp.arange(8, dtype=jnp.int32)[None])
        logits, _ = jllama.forward(jp, jinit_cache(2, 9, 16, 1, 128), batch,
                                   jcfg, return_all_logits=True)
        logits = np.asarray(logits)[0, len(prompt) - 1:]
        for step, (a, b) in enumerate(zip(a_toks, b_toks)):
            top2 = np.sort(logits[step])[-2:]
            if top2[1] - top2[0] < 0.02 * np.abs(logits[step]).max():
                break
            assert a == b, (prompt, step, a_toks, b_toks)
            compared += 1
    return compared


def test_spec_streams_match_plain_and_jax_spec_engine(port_engine,
                                                      spec_engine):
    """Greedy speculative streams equal the port's plain greedy streams
    and the JAX engine's
    speculative streams up to near-ties: a verify row and a decode step sum
    in other orders, so a step whose top-2 gap is within the W4A16
    rounding may go either way (agree_up_to_near_tie)."""
    prompts = [REPEAT] + PROMPTS[:2]
    plain = [run(port_engine.create_instance(), 400 + i, p, greedy(16),
                 sequence_end=True).token_ids for i, p in enumerate(prompts)]
    before = dict(spec_engine.stats)
    got = [run(spec_engine.create_instance(), 410 + i, p, greedy(16),
               sequence_end=True).token_ids for i, p in enumerate(prompts)]
    assert spec_engine.stats['spec_rounds'] > before['spec_rounds']
    jp = jax_int4_params()
    jcfg = JModelConfig(**CFG)
    jeng = TPUEngine(jcfg, JEngineConfig(**dict(ECFG, **SPEC)), jp)
    try:
        jinst = jeng.create_instance()
        jouts = [jinst.infer(420 + i, p, gen_config=JGen(
            max_new_tokens=16, top_k=1, ignore_eos=True),
            sequence_end=True).token_ids for i, p in enumerate(prompts)]
        assert jeng.stats['spec_rounds'] > 0
    finally:
        jeng.shutdown()
    assert agree_up_to_near_tie(prompts, plain, got, jp, jcfg) >= 16
    assert agree_up_to_near_tie(prompts, jouts, got, jp, jcfg) >= 16


CYCLE = [17, 40, 99, 5, 60]


def cycling_params():
    """Dense f32 weights whose greedy next token is CYCLE's successor of
    the current one (identity elsewhere), by a wide margin: the lm_head's
    column j is the embedding of j's predecessor and the layers are small
    perturbations of the residual stream."""
    rng = np.random.default_rng(8)
    d, nl, v = 256, 2, 256

    def w(*shape, s=0.02):
        return (rng.normal(size=shape) * s).astype(np.float32)
    emb = w(v, d, s=1.0)
    pred = np.arange(v)
    pred[CYCLE] = np.roll(CYCLE, 1)
    return {'tok_embedding': emb, 'norm': np.ones(d, np.float32),
            'lm_head': np.ascontiguousarray(emb[pred].T),
            'layers': {'attn_norm': np.ones((nl, d), np.float32),
                       'ffn_norm': np.ones((nl, d), np.float32),
                       'wqkv': w(nl, d, 512), 'wo': w(nl, d, d),
                       'w1': w(nl, d, 256), 'w3': w(nl, d, 256),
                       'w2': w(nl, 256, d)}}


def test_spec_accepts_drafts_and_equals_plain_on_a_cycling_model():
    """On a model that continues CYCLE, prompt lookup's drafts are
    accepted (more than 3 tokens per round), and greedy and seeded
    sampled streams on speculative rounds equal the plain rounds'
    token for token (the model leaves no near-tie)."""
    cfg = ModelConfig(**dict(CFG, weight_type='fp32'))
    params = params_from_numpy(cycling_params(), 'cpu')
    prompt = CYCLE * 2 + [17, 40]
    outs, stats = [], []
    for extra in ({}, SPEC):
        eng = TorchEngine(cfg, EngineConfig(**dict(ECFG, **extra)), params,
                          device='cpu')
        try:
            inst = eng.create_instance()
            outs.append([run(inst, 500 + i, prompt, gen,
                             sequence_end=True).token_ids
                         for i, gen in enumerate((
                             greedy(30), sampled(30, random_seed=1),
                             greedy(30, top_logprobs=2)))])
            stats.append(dict(eng.stats))
        finally:
            eng.shutdown()
    assert outs[0] == outs[1]
    assert outs[0][0][:5] == [99, 5, 60, 17, 40]
    assert stats[1]['spec_emitted'] > 3 * stats[1]['spec_rounds'] > 0
    assert stats[1]['decode_steps'] == 0 and stats[0]['spec_rounds'] == 0


@pytest.mark.parametrize('eng', ['port_engine', 'spec_engine'])
def test_sampled_requests_reproducible_from_seed(request, eng):
    """A sampled request with a fixed seed streams the same tokens twice
    (plain rounds and speculative 'candidates' rounds); another seed
    streams other tokens; a top_k = 0 request takes the 'full' mode."""
    inst = request.getfixturevalue(eng).create_instance()
    a, b, c = (run(inst, 430 + i, REPEAT, sampled(random_seed=seed),
                   sequence_end=True).token_ids
               for i, seed in enumerate((7, 7, 8)))
    assert a == b and a != c and len(a) == 12
    full = [run(inst, 433 + i, PROMPTS[1], GenerationConfig(
        max_new_tokens=8, top_k=0, temperature=1.0, random_seed=3,
        ignore_eos=True), sequence_end=True).token_ids for i in range(2)]
    assert full[0] == full[1] and len(full[0]) == 8


def test_saved_key_after_greedy_then_sampled_turn_matches_jax(port_engine):
    """A session's key advances on every greedy step too: after a greedy
    turn (seeded) and a sampled turn (the session's own key), the key the
    session keeps equals the JAX engine's."""
    jeng = TPUEngine(JModelConfig(**CFG), JEngineConfig(**ECFG),
                     jax_int4_params())
    keys = []
    try:
        for eng, jax_side in ((jeng, True), (port_engine, False)):
            inst = eng.create_instance()
            gen1 = (JGen if jax_side else GenerationConfig)(
                max_new_tokens=5, top_k=1, ignore_eos=True, random_seed=11)
            gen2 = (JGen if jax_side else GenerationConfig)(
                max_new_tokens=6, top_k=20, top_p=0.9, temperature=0.9,
                ignore_eos=True)
            assert len(inst.infer(440, PROMPTS[0], gen_config=gen1)
                       .token_ids) == 5
            assert len(inst.infer(440, [9, 8], gen_config=gen2,
                                  sequence_start=False).token_ids) == 6
            # the FINISH frame is queued before the engine thread retires
            # the slot and stores the key: wait for the slot's release
            deadline = time.monotonic() + 60
            while any(s is not None and s.request.session_id == 440
                      for s in eng.slots):
                assert time.monotonic() < deadline, 'slot never retired'
                time.sleep(0.01)
            keys.append(np.asarray(eng.seqs.get(440).rng_key, np.uint32))
            inst.end(440)
    finally:
        jeng.shutdown()
    np.testing.assert_array_equal(keys[1], keys[0])


@pytest.mark.parametrize('eng', ['port_engine', 'spec_engine'])
def test_bad_words_are_never_emitted(request, eng):
    """Banning the tokens a greedy stream emits changes the stream and
    none of them comes out, in greedy and in sampled requests."""
    inst = request.getfixturevalue(eng).create_instance()
    base = run(inst, 450, REPEAT, greedy(10), sequence_end=True).token_ids
    banned = sorted(set(base))[:4]
    for gen in (greedy(10, bad_words=banned),
                sampled(10, bad_words=banned, random_seed=2)):
        out = run(inst, 451, REPEAT, gen, sequence_end=True).token_ids
        assert len(out) == 10 and not set(out) & set(banned)


def test_min_new_tokens_holds_back_eos(port_engine):
    """With EOS as the greedy first token a request stops at once; with
    min_new_tokens = 4 (greedy, and on speculative rounds) it emits at
    least 4 tokens, the first of them not EOS."""
    first = run(port_engine.create_instance(), 460, PROMPTS[0], greedy(1),
                sequence_end=True).token_ids[0]
    params = params_from_numpy(to_numpy(jax_int4_params()), 'cpu')
    for extra in ({}, SPEC):
        eng = TorchEngine(ModelConfig(**dict(CFG, end_id=first)),
                          EngineConfig(**dict(ECFG, **extra)), params,
                          device='cpu')
        try:
            inst = eng.create_instance()
            out = run(inst, 461, PROMPTS[0], GenerationConfig(
                max_new_tokens=8, top_k=1), sequence_end=True)
            assert out.token_ids == [first]
            out = run(inst, 462, PROMPTS[0], GenerationConfig(
                max_new_tokens=8, top_k=1, min_new_tokens=4),
                sequence_end=True)
            assert len(out.token_ids) >= 4 and out.token_ids[0] != first
        finally:
            eng.shutdown()


@pytest.mark.parametrize('eng', ['port_engine', 'spec_engine'])
def test_top_logprobs(request, eng):
    """top_logprobs = 3: three alternatives per token; the chosen token's
    logprob equals its own entry; a greedy token is the top one."""
    inst = request.getfixturevalue(eng).create_instance()
    for gen in (greedy(8, top_logprobs=3),
                sampled(8, top_logprobs=3, random_seed=4)):
        out = run(inst, 470, REPEAT, gen, sequence_end=True)
        assert len(out.token_ids) == len(out.logprobs) == 8
        assert len(out.top_logprobs) == 8
        for tok, lp, tops in zip(out.token_ids, out.logprobs,
                                 out.top_logprobs):
            assert len(tops) == 3 and lp <= 0.0
            if tok in tops:
                assert lp == pytest.approx(tops[tok], abs=1e-5)
            if gen.top_k == 1:
                assert tok == max(tops, key=tops.get)


def test_spec_adaptive_fallback_on_low_acceptance():
    """Acceptance below the gate's break-even hands rounds back to plain
    decode (spec_fallbacks > 0), and the stream still equals the plain
    engine's (the cycling model leaves no near-tie)."""
    cfg = ModelConfig(**dict(CFG, weight_type='fp32'))
    params = params_from_numpy(cycling_params(), 'cpu')
    streams, stats = [], None
    for extra in ({}, SPEC):
        eng = TorchEngine(cfg, EngineConfig(**dict(ECFG, step_length=16,
                                                   **extra)),
                          params, device='cpu')
        eng.SPEC_MIN_ACCEPT = 10.0      # unreachable: every probe cools off
        try:
            streams.append(run(eng.create_instance(), 481, REPEAT,
                               greedy(60), sequence_end=True).token_ids)
            stats = dict(eng.stats)
        finally:
            eng.shutdown()
    assert streams[0] == streams[1]
    assert stats['spec_fallbacks'] > 0 and stats['decode_steps'] > 0
    assert 0 < stats['spec_emitted'] < 60


def test_spec_max_new_tokens_and_continuation():
    """Speculative rounds stop at max_new_tokens exactly, and a two-turn
    session on the speculative engine equals the plain engine's (the
    cycling model)."""
    cfg = ModelConfig(**dict(CFG, weight_type='fp32'))
    params = params_from_numpy(cycling_params(), 'cpu')
    turns = []
    for extra in ({}, SPEC):
        eng = TorchEngine(cfg, EngineConfig(**dict(ECFG, **extra)), params,
                          device='cpu')
        try:
            inst = eng.create_instance()
            o1 = run(inst, 490, CYCLE * 2, greedy(7)).token_ids
            o2 = run(inst, 490, [5, 60], greedy(9),
                     sequence_start=False).token_ids
            assert len(o1) == 7 and len(o2) == 9
            assert eng.stats['spec_rounds'] > 0 or not extra
            turns.append((o1, o2))
        finally:
            eng.shutdown()
    assert turns[0] == turns[1]


def test_default_device_needs_cuda():
    """Entry points run on the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        TorchEngine(ModelConfig(**CFG), EngineConfig(**ECFG), {})


def test_load_workspace_written_by_jax_converter(tmp_path):
    """load_workspace reads the JAX converter's format (column-pair int4,
    bf16 dense tensors) without safetensors, and carries weights across
    byte for byte; build_engine serves from it.  The workspace's prefix
    caching setting (the JAX default, on) is kept."""
    jp = jax_int4_params(2)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                      if a.dtype == jnp.float32 else a, jp)
    jcfg = JModelConfig(**CFG)
    save_workspace(str(tmp_path), jcfg, jp,
                   JEngineConfig(**dict(ECFG, enable_prefix_caching=True)))
    cfg, ecfg, params, kv_scales = load_workspace(str(tmp_path),
                                                  device='cpu')
    assert kv_scales is None
    assert cfg == ModelConfig(**CFG)
    assert ecfg.prefill_buckets == (16, 32) and ecfg.page_size == 16
    assert ecfg.enable_prefix_caching
    for name in ('wqkv', 'wo', 'w1', 'w3', 'w2'):
        got, want = params['layers'][name], jp['layers'][name]
        assert isinstance(got, PackedInt4Weight)
        np.testing.assert_array_equal(got.packed.numpy(),
                                      jpack(np.asarray(want.qvals)))
        np.testing.assert_array_equal(
            got.scales[:, :, 0].float().numpy(),
            np.asarray(want.scales, np.float32))
    for name in ('tok_embedding', 'lm_head', 'norm'):
        assert params[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(params[name].float().numpy(),
                                      np.asarray(jp[name], np.float32))
    eng = build_engine(str(tmp_path), device='cpu')
    try:
        out = run(eng.create_instance(), 1, PROMPTS[0], greedy(4),
                  sequence_end=True)
    finally:
        eng.shutdown()
    ref = TorchEngine(cfg, ecfg, params_from_numpy(to_numpy(jp), 'cpu'),
                      device='cpu')
    try:
        want = run(ref.create_instance(), 1, PROMPTS[0], greedy(4),
                   sequence_end=True)
    finally:
        ref.shutdown()
    assert out.token_ids == want.token_ids and len(out.token_ids) == 4


def test_port_imports_nothing_of_jax():
    """With jax, the JAX package, safetensors, ml_dtypes and transformers
    unimportable, every module of the port (and chip_smoke.py) imports
    and a CPU engine serves a request; so do bench_torch.py and the
    serving front door, whose tokenizer falls back to DummyTokenizer."""
    code = '''
import sys
for name in ('jax', 'jaxlib', 'lmdeploy_tpu', 'safetensors', 'ml_dtypes',
             'transformers'):
    sys.modules[name] = None
import importlib, pkgutil, torch
import lmdeploy_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(lmdeploy_tpu_torch.__path__,
                                              'lmdeploy_tpu_torch.')]
for m in mods:
    importlib.import_module(m)
import bench_torch
import chip_smoke
from lmdeploy_tpu_torch import EngineConfig, ModelConfig, TorchEngine
from lmdeploy_tpu_torch import GenerationConfig
from lmdeploy_tpu_torch.models.llama import (init_params, pack_params,
                                             quantize_params)
cfg = ModelConfig(head_num=2, kv_head_num=1, size_per_head=128,
                  inter_size=256, num_layer=1, vocab_size=256,
                  rotary_embedding=128, session_len=64, weight_type='int4')
p = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, 'cpu')
eng = TorchEngine(cfg, EngineConfig(max_batch_size=2, session_len=64,
                                    page_size=16, num_pages=8,
                                    prefill_buckets=(16,)),
                  pack_params(quantize_params(p, cfg)), device='cpu')
out = eng.create_instance().infer(1, [3, 4, 5], gen_config=GenerationConfig(
    max_new_tokens=3, top_k=1, ignore_eos=True))
eng.shutdown()
assert len(out.token_ids) == 3, out
import asyncio, tempfile
from lmdeploy_tpu_torch.convert.workspace import save_workspace
from lmdeploy_tpu_torch.serve.async_engine import AsyncEngine
from lmdeploy_tpu_torch.tokenizer import DummyTokenizer
with tempfile.TemporaryDirectory() as ws:
    save_workspace(ws, cfg, quantize_params(p, cfg))
    open(ws + '/tokenizer.json', 'w').write('{}')
    ae = AsyncEngine(ws, device='cpu')
    assert isinstance(ae.tokenizer, DummyTokenizer)
    async def gen():
        return [o async for o in ae.generate('hi', 1, top_k=1,
                                             request_output_len=3)]
    outs = asyncio.run(gen())
    ae.shutdown()
    assert outs[-1].generate_token_len == 3, outs
assert not any(n.split('.')[0] in ('jax', 'lmdeploy_tpu')
               for n, m in sys.modules.items() if m is not None)
print('OK', len(mods))
'''
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith('OK')


def test_serving_modules_load_neither_aiohttp_nor_pydantic():
    """The server's core, its protocol, the router, the gradio app and
    the CLI import without aiohttp, pydantic or gradio (the card's machine
    has none of them) and load none of them; only the transports'
    functions (build_app, main, run_server) import aiohttp or gradio."""
    code = '''
import sys
import importlib
mods = ['lmdeploy_tpu_torch.serve.openai.api_server',
        'lmdeploy_tpu_torch.serve.openai.protocol',
        'lmdeploy_tpu_torch.serve.openai.api_client',
        'lmdeploy_tpu_torch.serve.router',
        'lmdeploy_tpu_torch.serve.gradio.app',
        'lmdeploy_tpu_torch.cli.main', 'lmdeploy_tpu_torch.cli.chat',
        'lmdeploy_tpu_torch.cli.decode',
        'lmdeploy_tpu_torch.convert.converter']
for m in mods:
    importlib.import_module(m)
loaded = sorted({n.split('.')[0] for n in sys.modules} &
                {'aiohttp', 'pydantic', 'gradio', 'jax', 'lmdeploy_tpu'})
print('LOADED', loaded)
for name in ('aiohttp', 'pydantic', 'gradio'):
    sys.modules[name] = None
for m in mods:
    importlib.reload(sys.modules[m])
print('OK')
'''
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert 'LOADED []' in res.stdout and 'OK' in res.stdout
