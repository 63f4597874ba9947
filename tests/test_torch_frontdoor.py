"""The port's serving front door against the JAX package: chat templates
(``model.py``), the tokenizer (``tokenizer.py``), ``save_workspace``,
``AsyncEngine`` and ``bench_torch.py``'s CPU mode.

The templates and the tokenizer are copies, so each case must give what
the JAX module gives; ``AsyncEngine`` runs both packages on one workspace
of a model whose greedy continuation wins by a wide margin
(``test_torch_engine.cycling_params``), so the token ids must be equal.
"""
import asyncio
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import lmdeploy_tpu.model as jmodel
import lmdeploy_tpu.tokenizer as jtok
import lmdeploy_tpu_torch.model as tmodel
import lmdeploy_tpu_torch.tokenizer as ttok
from lmdeploy_tpu.config import EngineConfig as JEngineConfig
from lmdeploy_tpu.config import ModelConfig as JModelConfig
from lmdeploy_tpu.convert.converter import load_workspace as jload_workspace
from lmdeploy_tpu.convert.converter import save_workspace as jsave_workspace
from lmdeploy_tpu.ops.linear import QuantizedWeight as JQuant
from lmdeploy_tpu.serve.async_engine import AsyncEngine as JAsyncEngine
from lmdeploy_tpu_torch.config import EngineConfig, ModelConfig
from lmdeploy_tpu_torch.convert.workspace import (load_workspace,
                                                  save_workspace)
from lmdeploy_tpu_torch.models.llama import random_packed_params
from lmdeploy_tpu_torch.ops.linear import PackedInt4Weight, QuantizedWeight
from lmdeploy_tpu_torch.serve.async_engine import AsyncEngine
from test_torch_engine import (CFG, ECFG, REPO, cycling_params,
                               jax_int4_params)

torch.set_num_threads(1)

MESSAGES = [dict(role='system', content='sys'),
            dict(role='user', content='q1'),
            dict(role='assistant', content='a1'),
            dict(role='user', content='q2')]


def _outcome(fn):
    """fn()'s value, or its exception's type name and message."""
    try:
        return ('ok', fn())
    except Exception as e:  # noqa: BLE001 - compared, not handled
        return ('raises', type(e).__name__, str(e))


@pytest.mark.parametrize('name', sorted(jmodel.MODELS.module_dict))
def test_chat_template_matches_jax(name):
    """Every registered template: prompts at the start and in the middle
    of a session, message histories, stop words, session length and
    sampling defaults equal the JAX template's, for each capability."""
    assert sorted(tmodel.MODELS.module_dict) == \
        sorted(jmodel.MODELS.module_dict)
    for kw in ({}, dict(capability='completion'),
               dict(capability='infilling')):
        a = jmodel.MODELS.get(name)(**kw)
        b = tmodel.MODELS.get(name)(**kw)
        for fn in (lambda m: m.get_prompt('hi', True),
                   lambda m: m.get_prompt('hi', False),
                   lambda m: m.messages2prompt('hi'),
                   lambda m: m.messages2prompt(MESSAGES),
                   lambda m: m.messages2prompt(MESSAGES[1:], False),
                   lambda m: (m.stop_words, m.session_len, m.top_p,
                              m.top_k, m.temperature,
                              m.repetition_penalty)):
            assert _outcome(lambda: fn(b)) == _outcome(lambda: fn(a))
    path = f'/models/{name}-hf'
    assert tmodel.best_match_model(path) == jmodel.best_match_model(path)


def _hf_dir(tmp_path, corpus):
    """A tiny trained word-level HF tokenizer directory (no network)."""
    pytest.importorskip('tokenizers')
    pytest.importorskip('transformers')
    from tokenizers import Tokenizer as RawTok
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.trainers import WordLevelTrainer
    raw = RawTok(WordLevel(unk_token='<unk>'))
    raw.pre_tokenizer = Whitespace()
    raw.train_from_iterator([corpus] * 4, WordLevelTrainer(
        special_tokens=['<unk>', '<s>', '</s>']))
    raw.save(str(tmp_path / 'tokenizer.json'))
    with open(tmp_path / 'tokenizer_config.json', 'w') as f:
        json.dump({'bos_token': '<s>', 'eos_token': '</s>',
                   'model_max_length': 512,
                   'tokenizer_class': 'PreTrainedTokenizerFast'}, f)
    return str(tmp_path)


def _tiktoken_dir(tmp_path):
    """256 single-byte ranks and a few merges: a minimal BPE vocab."""
    pytest.importorskip('tiktoken')
    import base64
    lines = [b'%s %d' % (base64.b64encode(bytes([i])), i)
             for i in range(256)]
    for j, merge in enumerate((b'he', b'll', b'llo', b' wo')):
        lines.append(b'%s %d' % (base64.b64encode(merge), 256 + j))
    (tmp_path / 'qwen.tiktoken').write_bytes(b'\n'.join(lines) + b'\n')
    return str(tmp_path)


def case_dummy_roundtrip(m, tmp_path):
    tok = m.DummyTokenizer(vocab_size=512)
    ids = tok.encode('hello world')
    assert all(0 <= i < 512 for i in ids)
    assert tok.decode(ids) == 'hello world'
    return ids


def case_dummy_bos_marker(m, tmp_path):
    tok = m.DummyTokenizer(vocab_size=512)
    ids = tok.encode('<BOS>abc')
    assert ids[0] == tok.bos_token_id and tok.decode(ids[1:]) == 'abc'
    return ids


def case_incremental_decode_offsets(m, tmp_path):
    tok = m.DummyTokenizer(vocab_size=512)
    ids = tok.encode('the quick brown fox')
    pieces = [tok.decode(ids[:end], offset=end - 1)
              for end in range(1, len(ids) + 1)]
    assert ''.join(pieces) == tok.decode(ids)
    return pieces


def case_dummy_stop_sequences_for(m, tmp_path):
    tok = m.DummyTokenizer(vocab_size=512)
    seqs = tok.stop_sequences_for(['x', 'xyz'])
    assert seqs[0] == tok.encode('x') and len(seqs[1]) == 3
    return seqs


def case_hf_tokenizer(m, tmp_path):
    tok = m.Tokenizer(_hf_dir(tmp_path, 'hello world foo bar baz qux'))
    ids = tok.encode('hello world')
    assert len(ids) == 2
    out = tok.decode(ids)
    assert 'hello' in out and 'world' in out
    return ids, out, tok.bos_token_id, tok.eos_token_id, tok.vocab_size


def case_hf_vocab_scan_stop_expansion(m, tmp_path):
    tok = m.Tokenizer(_hf_dir(tmp_path, 'hello world helloish bar'))
    hello, helloish = tok.encode('hello')[0], tok.encode('helloish')[0]
    ids = tok.indexes_containing_token('hello')
    assert hello in ids and helloish in ids
    seqs = tok.stop_sequences_for(['hello world'])
    assert [tok.encode('hello world')] == seqs
    return sorted(ids), seqs


def case_stop_string_cross_boundary(m, tmp_path):
    tok = m.Tokenizer.__new__(m.Tokenizer)
    tok.model = types.SimpleNamespace(
        encode=lambda s, add_bos=False: [3, 3] if s == '\n\n' else [9],
        indexes_containing_token=lambda t: [7] if t == '\n\n' else [])
    seqs = tok.stop_sequences_for(['\n\n'])
    assert [7] in seqs and [3, 3] in seqs
    return seqs


def case_tiktoken_roundtrip(m, tmp_path):
    tok = m.Tokenizer(_tiktoken_dir(tmp_path))
    assert type(tok.model).__name__ == 'TiktokenTokenizer'
    ids = tok.encode('hello world')
    assert tok.decode(ids) == 'hello world' and len(ids) < 11
    assert tok.eos_token_id == 260 and tok.model.bos_token_id is None
    return ids, tok.decode(ids, offset=len(ids) - 1)


def case_tiktoken_specials_and_stops(m, tmp_path):
    tok = m.Tokenizer(_tiktoken_dir(tmp_path))
    ids = tok.encode('<|im_start|>hi<|im_end|>')
    assert ids[0] == 261 and ids[-1] == 262
    stops = tok.stop_sequences_for(['<|im_end|>'])
    assert [262] in stops
    more = tok.stop_sequences_for(['xy'])
    assert list(tok.encode('xy')) in more
    return ids, stops, more


TOKENIZER_CASES = [case_dummy_roundtrip, case_dummy_bos_marker,
                   case_incremental_decode_offsets,
                   case_dummy_stop_sequences_for, case_hf_tokenizer,
                   case_hf_vocab_scan_stop_expansion,
                   case_stop_string_cross_boundary, case_tiktoken_roundtrip,
                   case_tiktoken_specials_and_stops]


@pytest.mark.parametrize('case', TOKENIZER_CASES,
                         ids=[c.__name__[5:] for c in TOKENIZER_CASES])
def test_tokenizer_matches_jax(case, tmp_path):
    """The cases of tests/test_tokenizer.py on the port's copy, each
    giving what the JAX module gives."""
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'port').mkdir()
    assert case(ttok, tmp_path / 'port') == case(jtok, tmp_path / 'jax')


# -- save_workspace ----------------------------------------------------------

def _assert_same_trees(a, b):
    assert set(a) == set(b)
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, dict):
            _assert_same_trees(x, y)
        elif isinstance(x, JQuant):
            for part in ('qvals', 'scales', 'zeros'):
                np.testing.assert_array_equal(
                    np.asarray(getattr(x, part)).astype(np.float32),
                    np.asarray(getattr(y, part)).astype(np.float32))
        else:
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(
                np.asarray(x).astype(np.float32),
                np.asarray(y).astype(np.float32))


def test_save_workspace_round_trips_through_jax(tmp_path):
    """JAX writes a workspace, the port loads it and writes it again, and
    the JAX package reads the port's copy to arrays equal to its own, with
    the same config; the bytes of the weights file are the same too."""
    jcfg = JModelConfig(**CFG)
    jecfg = JEngineConfig(**ECFG)
    jsave_workspace(str(tmp_path / 'a'), jcfg, jax_int4_params(), jecfg,
                    kv_scales=([0.1, 0.2], [1.0, 2.0], [0.3, 0.4],
                               [0.0, -1.0]))
    cfg, ecfg, params, kv = load_workspace(str(tmp_path / 'a'), 'cpu')
    assert isinstance(params['layers']['wqkv'], PackedInt4Weight)
    save_workspace(str(tmp_path / 'b'), cfg, params, ecfg, kv_scales=kv)
    want = jload_workspace(str(tmp_path / 'a'))
    got = jload_workspace(str(tmp_path / 'b'))
    assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3]
    _assert_same_trees(want[2], got[2])
    from safetensors.numpy import load_file
    fa = load_file(str(tmp_path / 'a' / 'weights.safetensors'))
    fb = load_file(str(tmp_path / 'b' / 'weights.safetensors'))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype
        assert fa[k].tobytes() == fb[k].tobytes(), k


def test_save_workspace_of_random_packed_weights(tmp_path):
    """Packed-residency weights (as the bench and chip_smoke.py draw them)
    saved by the port load in the JAX package with zero points 8 and in
    the port to the same bytes; a QuantizedWeight and an f32 leaf (stored
    in bf16) go through too, and a packed weight whose sz is not scale
    times an integer zero point is refused."""
    cfg = ModelConfig(**CFG)
    params = random_packed_params(cfg, 3, 'cpu')
    params['layers']['extra_f32'] = torch.linspace(-1, 1, 6).reshape(2, 3)
    save_workspace(str(tmp_path), cfg, params, EngineConfig(**ECFG))
    jcfg, jecfg, jparams, _ = jload_workspace(str(tmp_path))
    assert jcfg == JModelConfig(**CFG) and jecfg == JEngineConfig(**ECFG)
    jq = jparams['layers']['w2']
    assert np.all(np.asarray(jq.zeros).astype(np.float32) == 8.0)
    _, _, back, _ = load_workspace(str(tmp_path), 'cpu')
    for name in ('wqkv', 'wo', 'w1', 'w3', 'w2'):
        a, b = params['layers'][name], back['layers'][name]
        assert torch.equal(a.packed, b.packed)
        assert torch.equal(a.scales, b.scales) and torch.equal(a.sz, b.sz)
    for name in ('tok_embedding', 'lm_head', 'norm'):
        assert torch.equal(params[name], back[name])
    assert back['layers']['extra_f32'].dtype == torch.bfloat16
    qw = QuantizedWeight(qvals=torch.randint(0, 16, (2, 256, 32),
                                             dtype=torch.uint8),
                         scales=torch.rand(2, 2, 32).to(torch.bfloat16),
                         zeros=torch.randint(0, 16, (2, 2, 32)).to(
                             torch.bfloat16))
    save_workspace(str(tmp_path / 'q'), cfg, {'layers': {'w': qw}})
    jw = jload_workspace(str(tmp_path / 'q'))[2]['layers']['w']
    np.testing.assert_array_equal(np.asarray(jw.qvals), qw.qvals.numpy())
    bad = params['layers']['wo']
    bad = PackedInt4Weight(packed=bad.packed, scales=bad.scales,
                           sz=bad.sz * 1.01)
    with pytest.raises(ValueError, match='integer zero points'):
        save_workspace(str(tmp_path / 'bad'), cfg, {'layers': {'wo': bad}})


# -- AsyncEngine -------------------------------------------------------------

@pytest.fixture(scope='module')
def cycling_workspace(tmp_path_factory):
    """The cycling model as a workspace (the JAX converter stores it in
    bf16; its greedy margins stay wide)."""
    ws = str(tmp_path_factory.mktemp('cycle'))
    import jax.numpy as jnp

    def tree(t):
        return {k: tree(v) if isinstance(v, dict) else jnp.asarray(v)
                for k, v in t.items()}
    jsave_workspace(ws, JModelConfig(**dict(CFG, weight_type='fp32')),
                    tree(cycling_params()),
                    JEngineConfig(**dict(ECFG, session_len=256)))
    return ws


# DummyTokenizer ids are bytes + 3: '%' is 40, a CYCLE token, so a prompt
# ending in it continues the cycle
PROMPTS = ['ab%', 'hello there%', 'x\x0e']


def _drive(engine):
    """3 concurrent generate streams, then an interactive second turn of
    session 1; per request the joined text and ids, finish reason and the
    session's step counts."""
    async def one(sid, prompt, start=True, n=12):
        text, ids, last = '', [], None
        async for out in engine.generate(
                prompt, sid, sequence_start=start, request_output_len=n,
                top_k=1, ignore_eos=True):
            text += out.response
            ids += out.token_ids or []
            last = out
        return (text, ids, last.finish_reason, last.history_token_len,
                last.input_token_len, last.generate_token_len)

    async def main():
        first = await asyncio.gather(*[one(i + 1, p)
                                       for i, p in enumerate(PROMPTS)])
        second = await one(1, 'more%', start=False, n=8)
        return list(first) + [second, dict(engine.steps)]
    return asyncio.run(main())


def test_async_engine_matches_jax(cycling_workspace):
    """Concurrent ``generate`` streams and a resumed session give the JAX
    AsyncEngine's greedy token ids, text, finish reasons and step
    bookkeeping on one workspace."""
    port = AsyncEngine(cycling_workspace, device='cpu')
    try:
        assert isinstance(port.tokenizer, ttok.DummyTokenizer)
        assert port.engine.template_name == 'llama'
        got = _drive(port)
    finally:
        port.shutdown()
    ref = JAsyncEngine(cycling_workspace)
    try:
        want = _drive(ref)
    finally:
        ref.shutdown()
    assert got == want
    first = got[0]
    assert first[2] == 'length' and first[5] == 12
    assert first[1][:5] == [99, 5, 60, 17, 40]
    assert got[3][3] == len(ttok.DummyTokenizer(256).encode('ab%')) + 12


PUYU_STOP = 45623          # the 'puyu' template's stop word


@pytest.fixture(scope='module')
def stop_workspace(tmp_path_factory):
    """The cycling model widened to a 45696-id vocabulary whose cycle
    passes through the 'puyu' template's stop word: 40 -> 99 -> 45623."""
    import jax.numpy as jnp
    params = cycling_params()
    v = 45696
    rng = np.random.default_rng(9)
    emb = np.concatenate([params['tok_embedding'], rng.normal(
        size=(v - 256, 256)).astype(np.float32)])
    cycle = [17, 40, 99, PUYU_STOP, 60]
    pred = np.arange(v)
    pred[cycle] = np.roll(cycle, 1)
    params = dict(params, tok_embedding=emb,
                  lm_head=np.ascontiguousarray(emb[pred].T))

    def tree(t):
        return {k: tree(x) if isinstance(x, dict) else jnp.asarray(x)
                for k, x in t.items()}
    ws = str(tmp_path_factory.mktemp('stop'))
    jsave_workspace(ws, JModelConfig(**dict(CFG, weight_type='fp32',
                                            vocab_size=v,
                                            model_name='puyu')),
                    tree(params), JEngineConfig(**dict(ECFG,
                                                       session_len=256)))
    return ws


def test_template_stop_word_ends_a_request(stop_workspace):
    """``build_engine`` resolves the workspace's template ('puyu') and
    hands its stop word to the engine as the default: the greedy cycle
    stops at it, the stop token is not streamed, and the finish reason is
    'stop' -- as in the JAX AsyncEngine."""
    async def run(engine):
        outs = [o async for o in engine.generate(
            'ab%', 7, request_output_len=12, top_k=1, do_preprocess=False)]
        return (sum((o.token_ids or [] for o in outs), []),
                outs[-1].finish_reason, outs[-1].generate_token_len)
    port = AsyncEngine(stop_workspace, device='cpu')
    try:
        assert port.engine.template_name == 'puyu'
        assert port.engine.default_stop_words == [PUYU_STOP]
        got = asyncio.run(run(port))
    finally:
        port.shutdown()
    ref = JAsyncEngine(stop_workspace)
    try:
        want = asyncio.run(run(ref))
    finally:
        ref.shutdown()
    assert got == want == ([99], 'stop', 1)


# -- bench_torch.py ----------------------------------------------------------

BENCH_KEYS = ('ttft_ms', 'bs1_no_spec_tok_s', 'spec_accept_tokens_per_round',
              'bs8_throughput_tok_s', 'bf16_bs1_tok_s',
              'int4_vs_bf16_speedup', 'out_tokens', 'device')


def test_bench_torch_tiny_prints_one_line_with_every_key():
    res = subprocess.run([sys.executable, 'bench_torch.py', '--device',
                          'cpu', '--tiny'], cwd=REPO, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS='2'))
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line['unit'] == 'tok/s' and line['value'] > 0
    assert 'partial' not in line and 'vs_baseline' not in line
    detail = line['detail']
    for key in BENCH_KEYS:
        assert key in detail, key
    assert detail['device'].startswith('cpu')
    for key in ('value', 'ttft_ms', 'bs1_no_spec_tok_s',
                'bs8_throughput_tok_s', 'bf16_bs1_tok_s'):
        lo, hi = detail['spread'][key]
        assert len(detail['runs'][key]) == 3 and lo <= hi
        med = line['value'] if key == 'value' else detail[key]
        assert lo <= med <= hi


def test_bench_torch_budget_prints_a_partial_line():
    res = subprocess.run([sys.executable, 'bench_torch.py', '--device',
                          'cpu', '--tiny', '--budget-s', '0.5'], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 3
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line['partial'] is True and 'value' not in line
