"""The port's command line (``cli/main.py``, ``cli/chat.py``,
``cli/decode.py``) against the JAX package's, on the CPU: dispatch, a
scripted chat transcript on one workspace, and perplexity.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lmdeploy_tpu.cli.chat as jchat
import lmdeploy_tpu_torch.cli.chat as tchat
import lmdeploy_tpu_torch.cli.decode as tdecode
import lmdeploy_tpu_torch.cli.main as tmain
from lmdeploy_tpu.config import EngineConfig as JEngineConfig
from lmdeploy_tpu.config import ModelConfig as JModelConfig
from lmdeploy_tpu.convert.converter import save_workspace as jsave_workspace
from lmdeploy_tpu.pytorch.decode import perplexity as jperplexity
from lmdeploy_tpu_torch.pytorch.decode import perplexity
from test_torch_engine import CFG, ECFG, REPO
from test_torch_frontdoor import cycling_workspace  # noqa: F401
from test_torch_prefix_cache import _jax_tree, dense_f32_params

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def dense_workspace(tmp_path_factory):
    """A dense model whose logits are small (|logit| < ~2), stored by the
    JAX converter (bf16)."""
    ws = str(tmp_path_factory.mktemp('dense'))
    jsave_workspace(ws, JModelConfig(**dict(CFG, weight_type='fp32')),
                    _jax_tree(dense_f32_params()),
                    JEngineConfig(**dict(ECFG, session_len=128)))
    return ws


SCRIPT = ['ab%', 'more%', 'end', 'x%', 'exit']


def _transcript(mod, ws, **kw):
    lines, prompts = [], iter(SCRIPT)

    def print_fn(*a, end='\n', flush=False):
        lines.append(' '.join(map(str, a)) + end)
    rc = mod.main(ws, max_new_tokens=8, top_k=1, input_fn=lambda _: next(
        prompts), print_fn=print_fn, **kw)
    return rc, ''.join(lines)


def test_chat_transcript_matches_jax(cycling_workspace):  # noqa: F811
    """A scripted session (two turns, ``end``, a new session, ``exit``)
    prints the JAX chat's transcript on the same workspace."""
    got = _transcript(tchat, cycling_workspace, device='cpu')
    want = _transcript(jchat, cycling_workspace)
    assert got == want
    assert got[0] == 0 and got[1].startswith('[lmdeploy-tpu] model=llama')


JAX_DECODE = """
import sys
import numpy as np
import lmdeploy_tpu.cli.decode as jdecode
np.save(sys.argv[2], np.asarray(jdecode.main(sys.argv[1], sys.argv[3:])))
"""


def test_decode_ppl_matches_jax(dense_workspace, tmp_path, capsys):
    """cli/decode.py's prompt logits give the JAX one's perplexity within
    1e-4 relative, and equal EngineInstance.decode logits taken
    in-process.  The JAX side runs with XLA's excess precision off: by
    default XLA's CPU fusions skip the bf16 rounding between element-wise
    ops that both packages' code asks for, which moves every logit by up
    to ~0.6% (perplexity 396.66 against 397.07 here); with it off, the two
    agree to ~1e-6."""
    prompts = ['hello world', 'the quick brown fox jumps over it']
    got = tdecode.main(dense_workspace, prompts, device='cpu')
    out = capsys.readouterr().out
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               XLA_FLAGS='--xla_allow_excess_precision=false')
    res = subprocess.run([sys.executable, '-c', JAX_DECODE, dense_workspace,
                          str(tmp_path / 'jax.npy'), *prompts], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    want = np.load(tmp_path / 'jax.npy')
    from lmdeploy_tpu_torch.tokenizer import DummyTokenizer
    ids = [DummyTokenizer(256).encode(p) for p in prompts]
    ppl = perplexity(got, ids)
    assert ppl == pytest.approx(jperplexity(want, ids), rel=1e-4)
    assert f'ppl: {ppl:.4f}' in out and f'ppl: {ppl:.4f}' in res.stdout
    from lmdeploy_tpu_torch import build_engine
    eng = build_engine(dense_workspace, device='cpu')
    try:
        inst = eng.create_instance()
        direct = [inst.decode(i) for i in ids]
    finally:
        eng.shutdown()
    for row, lg, i in zip(got, direct, ids):
        np.testing.assert_array_equal(row[:len(i)], lg)
    # the same function as the JAX package's on the same logits
    assert perplexity(got, ids) == pytest.approx(jperplexity(got, ids),
                                                 rel=1e-12)


def test_main_dispatch(monkeypatch, tmp_path, capsys):
    """main dispatches chat, convert, serve and decode with their flags
    (numbers parsed), prints the commands on --help, and returns 1 on an
    unknown command."""
    seen = {}
    monkeypatch.setattr(tchat, 'main', lambda path, **kw: seen.update(
        chat=(path, kw)) or 0)
    import lmdeploy_tpu_torch.serve.openai.api_server as server
    monkeypatch.setattr(server, 'main', lambda path, **kw: seen.update(
        serve=(path, kw)) or 0)
    monkeypatch.setattr(tdecode, 'main', lambda path, prompts, **kw:
                        seen.update(decode=(path, prompts, kw)))
    assert tmain.main(['chat', 'ws', '--device', 'cpu',
                       '--max-new-tokens', '16']) == 0
    assert seen['chat'] == ('ws', {'device': 'cpu', 'max_new_tokens': 16})
    assert tmain.main(['serve', 'ws', '--server-port', '8080',
                       '--quant-policy', '4']) == 0
    assert seen['serve'] == ('ws', {'server_port': 8080, 'quant_policy': 4})
    assert tmain.main(['decode', 'ws', 'one text', '--device', 'cpu',
                       'two']) == 0
    assert seen['decode'] == ('ws', ['one text', 'two'], {'device': 'cpu'})
    ws = str(tmp_path / 'ws')
    assert tmain.main(['convert', '--random', 'tiny', ws]) is None
    assert os.path.exists(os.path.join(ws, 'weights.safetensors'))
    with open(os.path.join(ws, 'config.json')) as f:
        assert json.load(f)['model']['model_name'] == 'tiny'
    assert tmain.main(['--help']) == 0 and 'convert' in \
        capsys.readouterr().out
    assert tmain.main(['frobnicate']) == 1


def test_unported_commands_return_1_and_import_nothing_missing():
    """With JAX, the JAX package and transformers unimportable (as on the
    card's machine), lite refuses an unknown command with 1 and
    chat-baseline (ported since its command answered "not ported" and
    returned 1) raises an ImportError that names transformers."""
    code = '''
import sys
for name in ('jax', 'jaxlib', 'lmdeploy_tpu', 'transformers', 'aiohttp',
             'pydantic', 'gradio'):
    sys.modules[name] = None
from lmdeploy_tpu_torch.cli.main import main
rcs = [main(['lite', 'frobnicate'])]
try:
    main(['chat-baseline', 'x', '--device', 'cpu'])
except ImportError as e:
    print('IMPORT ERROR:', e)
print('RCS', rcs)
'''
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert 'RCS [1]' in res.stdout
    assert 'IMPORT ERROR:' in res.stdout and 'transformers package' in \
        res.stdout
    assert 'unknown lite command: frobnicate' in res.stdout
