"""The port's engine, workspace loader and entry point against the JAX
package's, on the CPU (every kernel wrapper runs its plain version)."""
import os
import subprocess
import sys
import threading

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
                                dict(quant_policy=8),
                                dict(speculative_k=4),
                                dict(enable_prefix_caching=True)])
def test_unported_engine_options_raise(kw):
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        TorchEngine(ModelConfig(**CFG), EngineConfig(**dict(ECFG, **kw)),
                    {}, device='cpu', start=False)


@pytest.mark.parametrize('gen', [dict(top_k=40), dict(top_k=1,
                                                      repetition_penalty=1.1),
                                 dict(top_k=1, bad_words=[5]),
                                 dict(top_k=1, min_new_tokens=2)])
def test_non_greedy_requests_raise(port_engine, gen):
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        port_engine.create_instance().infer(
            350, [1, 2, 3], gen_config=GenerationConfig(**gen))


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
    caching setting (the JAX default, on) is not taken: it is not ported."""
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
    assert not ecfg.enable_prefix_caching
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
    and a CPU engine serves a request."""
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
assert not any(n.split('.')[0] in ('jax', 'lmdeploy_tpu')
               for n, m in sys.modules.items() if m is not None)
print('OK', len(mods))
'''
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith('OK')
