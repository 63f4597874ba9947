"""The port's HF eager baseline (``lmdeploy_tpu_torch/pytorch/``) against
the JAX package's (``lmdeploy_tpu/pytorch/``) on a tiny in-process HF
Llama, on the CPU: session managers, ``generate_stream``, the prompt-logits
``Engine`` and ``perplexity``, the port engine's prompt logits against the
HF ones, and ``cli.main chat-baseline``."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lmdeploy_tpu.pytorch import chat as jchat
from lmdeploy_tpu.pytorch import decode as jdecode
from lmdeploy_tpu.pytorch import session as jsession
from lmdeploy_tpu_torch.pytorch import chat as tchat
from lmdeploy_tpu_torch.pytorch import decode as tdecode
from lmdeploy_tpu_torch.pytorch import session as tsession

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def tiny_hf(tmp_path_factory):
    """tests/test_pytorch_baseline.py's tiny HF Llama, with a word-level
    tokenizer over its whole vocabulary (w0..w252 and <unk>, <s>, </s>)."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, vocab_size=256,
                      max_position_embeddings=128,
                      tie_word_embeddings=False, bos_token_id=1,
                      eos_token_id=2)
    torch.manual_seed(0)
    model = LlamaForCausalLM(cfg).eval()
    d = tmp_path_factory.mktemp('hf')
    model.save_pretrained(d)
    vocab = {'<unk>': 0, '<s>': 1, '</s>': 2}
    vocab.update({f'w{i}': i + 3 for i in range(253)})
    tok = Tokenizer(WordLevel(vocab, unk_token='<unk>'))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(d / 'tokenizer.json'))
    with open(d / 'tokenizer_config.json', 'w') as f:
        json.dump({'bos_token': '<s>', 'eos_token': '</s>',
                   'unk_token': '<unk>', 'model_max_length': 128,
                   'tokenizer_class': 'PreTrainedTokenizerFast'}, f)
    return str(d)


@pytest.fixture(scope='module')
def hf_model(tiny_hf):
    from transformers import AutoModelForCausalLM, AutoTokenizer
    return (AutoModelForCausalLM.from_pretrained(
        tiny_hf, torch_dtype=torch.float32).eval(),
        AutoTokenizer.from_pretrained(tiny_hf))


SEQUENCES = [([1, 2, 3], [4, 5]), ([6, 7, 8, 9, 10, 11], [12]),
             (list(range(20, 27)), [30, 31, 32]), ([40], [])]


@pytest.mark.parametrize('kind', ['plain', 'history'])
def test_session_managers_match_jax(kind):
    """The same turns through both packages' managers give the same
    prompts, histories and trimming (max_session_len 10, reduce 4)."""
    if kind == 'plain':
        mgrs = (jsession.BasicSessionManager(),
                tsession.BasicSessionManager())
    else:
        mgrs = (jsession.BasicSessionManagerWithHistory(10, 4),
                tsession.BasicSessionManagerWithHistory(10, 4))
    for i, (inp, out) in enumerate(SEQUENCES):
        got = [m.prepend_history(inp) for m in mgrs]
        assert got[0] == got[1]
        for m in mgrs:
            m.add_to_history(out)
        if kind == 'history':
            assert mgrs[0].history == mgrs[1].history
            assert len(got[1]) <= 10
        if i == 2:
            for m in mgrs:
                m.new_session()
    if kind == 'history':
        with pytest.raises(AssertionError):
            tsession.BasicSessionManagerWithHistory(4, 4)


@pytest.mark.parametrize('mode', ['greedy', 'sampled', 'penalised'])
def test_generate_stream_matches_jax(hf_model, mode):
    """The port's generate_stream gives the JAX version's ids: greedy, and
    sampled with the same seed (the port through its explicit generator,
    the JAX version through torch.manual_seed's global one)."""
    model, tok = hf_model
    prompt = [1, 17, 33, 99, 5]
    kw = dict(max_new_tokens=12)
    if mode == 'greedy':
        kw['greedy'] = True
    else:
        kw.update(temperature=0.7, top_k=40, top_p=0.8)
        if mode == 'penalised':
            kw['repetition_penalty'] = 1.3
    torch.manual_seed(123)
    want = list(jchat.generate_stream(model, tok, prompt, **kw))
    torch.manual_seed(999)         # the port does not draw from it
    got = list(tchat.generate_stream(
        model, tok, prompt, device='cpu',
        generator=torch.Generator().manual_seed(123), **kw))
    assert got == want and len(got) >= 1
    if mode == 'greedy':
        assert list(tchat.generate_stream(model, tok, prompt, device='cpu',
                                          **kw)) == want


def test_hf_engine_decode_equals_jax_bit_for_bit(tiny_hf):
    """Engine.decode's padded [n, max_len, vocab] f32 logits equal the JAX
    Engine's bit for bit (padded rows zeroed), over two batches of
    max_bs, and perplexity agrees."""
    prompts = [[1, 5, 9, 13, 21, 30], [2, 4, 6], [7, 8, 9, 10], [3]]
    want = jdecode.Engine(tiny_hf).decode(prompts, max_bs=3)
    got = tdecode.Engine(tiny_hf, device='cpu').decode(prompts, max_bs=3)
    assert got.dtype == np.float32 and got.shape == (4, 6, 256)
    np.testing.assert_array_equal(got, want)
    assert (got[1, 3:] == 0).all() and (got[3, 1:] == 0).all()
    assert tdecode.perplexity(got, prompts) == \
        jdecode.perplexity(want, prompts)


def test_hf_engine_default_device_needs_cuda(tiny_hf):
    """The Engine defaults to the card and raises without one."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default does not raise')
    with pytest.raises(RuntimeError, match='CUDA'):
        tdecode.Engine(tiny_hf)


def test_port_engine_logits_match_hf_baseline(tiny_hf, tmp_path):
    """The port's engine on the converted checkpoint against the port's HF
    Engine, as tests/test_pytorch_baseline.py holds the JAX engine: the
    same top-1 at every position, correlation > 0.999, perplexity within
    2%."""
    from lmdeploy_tpu_torch.api import build_engine
    from lmdeploy_tpu_torch.config import EngineConfig
    from lmdeploy_tpu_torch.convert.converter import convert_hf
    ws = str(tmp_path / 'ws')
    convert_hf(tiny_hf, ws)
    prompts = [[1, 5, 9, 13, 21, 30], [2, 4, 6]]
    hf_logits = tdecode.Engine(tiny_hf, device='cpu').decode(prompts)
    ecfg = EngineConfig(max_batch_size=2, session_len=64, page_size=8,
                        num_pages=32, prefill_buckets=(8, 16),
                        max_context_token_num=16)
    eng = build_engine(ws, engine_config=ecfg, device='cpu')
    try:
        inst = eng.create_instance()
        port_logits = np.zeros_like(hf_logits)
        for i, p in enumerate(prompts):
            got = inst.decode(p)
            want = hf_logits[i, :len(p)]
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
            assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999
            port_logits[i, :len(p)] = got
    finally:
        eng.shutdown()
    ppl_hf = tdecode.perplexity(hf_logits, prompts)
    assert abs(tdecode.perplexity(port_logits, prompts) - ppl_hf) / ppl_hf \
        < 0.02


def test_cli_chat_baseline_serves_two_turns(tiny_hf):
    """``python -m lmdeploy_tpu_torch.cli.main chat-baseline <dir> --device
    cpu`` serves a two-turn session from stdin, then exits on "exit"."""
    res = subprocess.run(
        [sys.executable, '-m', 'lmdeploy_tpu_torch.cli.main',
         'chat-baseline', tiny_hf, '--device', 'cpu', '--max-new-tokens',
         '4'], input='w5 w6 w7\nw8 w9\nexit\n', cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert '[pytorch baseline] template=base' in res.stdout
    assert res.stdout.count('>>> ') == 3
