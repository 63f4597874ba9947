"""The port's tensor-parallel engine (ranks spawned as processes, gloo on
the CPU) against the JAX package's tp engine at the same EngineConfig, and
the rank protocol launched through ``python -m
lmdeploy_tpu_torch.parallel.multihost``.  Every group of ranks has a 60 s
timeout and every process a join timeout."""
import dataclasses
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from lmdeploy_tpu.config import EngineConfig as JEngineConfig
from lmdeploy_tpu.config import ModelConfig as JModelConfig
from lmdeploy_tpu.engine.engine import TPUEngine
from lmdeploy_tpu.kvcache import paged as jpaged
from lmdeploy_tpu.messages import GenerationConfig as JGen
from lmdeploy_tpu.models import llama as jllama
from lmdeploy_tpu_torch.config import EngineConfig, ModelConfig
from lmdeploy_tpu_torch.convert.workspace import (params_from_numpy,
                                                  save_workspace)
from lmdeploy_tpu_torch.engine.engine import TorchEngine
from lmdeploy_tpu_torch.messages import GenerationConfig, ResponseType
from lmdeploy_tpu_torch.parallel.multihost import RankFailure

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60
# tests/test_parallel.py's model and engine
CFG = dict(head_num=8, kv_head_num=4, size_per_head=16, inter_size=64,
           num_layer=2, vocab_size=128, rotary_embedding=16,
           max_position_embeddings=128, session_len=64, end_id=2)
ECFG = dict(max_batch_size=2, session_len=64, page_size=8, num_pages=32,
            max_context_token_num=16, prefill_buckets=(8, 16), step_length=2,
            tp=2)
PROMPTS = [[3, 17, 42, 99, 5], [9, 11, 4, 100, 7, 30]]
REPEAT = [3, 4, 5] * 4
LOGITS_PROMPT = [3, 17, 42, 9, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70,
                 71, 72, 73, 74]          # two prefill chunks of 16


def np_tree(t):
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if dataclasses.is_dataclass(t):
        return {f.name: np.asarray(getattr(t, f.name))
                for f in dataclasses.fields(t)}
    return np.asarray(t)


def jax_params(seed, cfg=CFG, group_size=None):
    jcfg = JModelConfig(**cfg)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    if group_size:
        jp = jllama.quantize_params(jp, jcfg, group_size=group_size)
    return jp


def greedy(gen_cls, n=8, **kw):
    return gen_cls(max_new_tokens=n, top_k=1, ignore_eos=True, **kw)


def sampled(gen_cls):
    return gen_cls(max_new_tokens=6, top_k=20, top_p=0.9, temperature=0.9,
                   random_seed=11, ignore_eos=True)


def script(eng, gen_cls):
    """Plain greedy requests, prompt logits over two chunks, then the
    running engine switched to speculative rounds (k = 2): a greedy and a
    seeded sampled request."""
    inst = eng.create_instance()
    out = {'greedy': [inst.infer(10 + i, p, gen_config=greedy(gen_cls),
                                 sequence_end=True).token_ids
                      for i, p in enumerate(PROMPTS)],
           'logits': inst.decode(LOGITS_PROMPT)}
    eng.ecfg.speculative_k = 2
    before = eng.stats['spec_rounds']
    out['spec'] = inst.infer(20, REPEAT, gen_config=greedy(gen_cls, 12),
                             sequence_end=True).token_ids
    out['sampled'] = inst.infer(21, [5, 7, 5, 7], gen_config=sampled(
        gen_cls), sequence_end=True).token_ids
    out['spec_rounds'] = eng.stats['spec_rounds'] - before
    return out


@pytest.fixture(scope='module')
def jax_tp2():
    jeng = TPUEngine(JModelConfig(**CFG),
                     JEngineConfig(use_pallas=False, **ECFG), jax_params(3))
    try:
        yield script(jeng, JGen)
    finally:
        jeng.shutdown()


@pytest.fixture(scope='module')
def port_tp2():
    """One tp = 2 port engine for the module: its streams, and the rank
    bookkeeping after shutdown."""
    eng = TorchEngine(ModelConfig(**CFG), EngineConfig(**ECFG),
                      params_from_numpy(np_tree(jax_params(3)), 'cpu'),
                      device='cpu', rank_timeout=TIMEOUT)
    try:
        out = script(eng, GenerationConfig)
        out['metrics'] = eng.metrics()
        out['report'] = eng.fns.rank_report()
    finally:
        eng.shutdown()
    out['exitcodes'] = eng.rank_exitcodes
    out['final_reports'] = eng.rank_reports
    return out


def test_tp2_engine_streams_and_logits_match_jax(jax_tp2, port_tp2):
    """tp = 2 over two processes: greedy streams on plain rounds and on
    speculative rounds (k = 2), and a seeded sampled stream (threefry keys
    on every rank), equal the JAX tp = 2 engine's; decode() logits over two
    prefill chunks within rtol / atol 2e-4 (f32 weights)."""
    assert port_tp2['greedy'] == jax_tp2['greedy']
    assert port_tp2['spec'] == jax_tp2['spec']
    assert port_tp2['sampled'] == jax_tp2['sampled']
    assert port_tp2['spec_rounds'] > 0 and jax_tp2['spec_rounds'] > 0
    v = CFG['vocab_size']
    assert port_tp2['logits'].shape == (len(LOGITS_PROMPT), v)
    np.testing.assert_allclose(port_tp2['logits'], jax_tp2['logits'],
                               rtol=2e-4, atol=2e-4)


def test_tp2_ranks_stay_in_step_and_exit(port_tp2):
    """Both ranks read back the same bytes on every dispatch (equal
    digests), the follower replayed every frame, no kernel counter moved
    on the CPU, the device group is gloo, and the follower exited 0."""
    report = port_tp2['report']
    assert [r['rank'] for r in report] == [0, 1]
    assert report[0]['readback_sha256'] == report[1]['readback_sha256']
    assert all(r['backend'] == 'gloo' for r in report)
    assert port_tp2['metrics']['tp'] == 2
    assert port_tp2['metrics']['device_group_nccl'] == 0
    final = port_tp2['final_reports']
    assert len(final) == 1 and final[0]['rank'] == 1
    assert final[0]['frames'] > 20
    assert port_tp2['exitcodes'] == [0]


def _agree_up_to_near_tie(jp, jcfg, prompts, jouts, touts, tol, pool=None):
    """Two greedy streams per prompt agree up to the first step whose
    top-2 gap, in the JAX forward teacher-forced over the prompt and the
    JAX stream (one device, a pool of the same kind), is within ``tol`` of
    that step's largest |logit|.  Returns the steps compared."""
    compared = 0
    for prompt, jt, tt in zip(prompts, jouts, touts):
        assert len(jt) == len(tt)
        ids = np.asarray(prompt + jt[:-1], np.int32)[None]
        t = ids.shape[1]
        pages = -(-t // 8)
        batch = jllama.StepBatch(
            ids=jnp.asarray(ids),
            positions=jnp.arange(t, dtype=jnp.int32)[None],
            valid=jnp.ones((1, t), bool),
            context_len=jnp.asarray([t], jnp.int32),
            page_table=jnp.arange(pages, dtype=jnp.int32)[None])
        cache = jpaged.init_cache(jcfg.num_layer, pages, 8,
                                  jcfg.kv_head_num, jcfg.size_per_head,
                                  **(pool or {'dtype': jnp.float32}))
        logits, _ = jllama.forward(jp, cache, batch, jcfg,
                                   return_all_logits=True)
        logits = np.asarray(logits)[0, len(prompt) - 1:]
        for step, (a, b) in enumerate(zip(jt, tt)):
            top2 = np.sort(logits[step])[-2:]
            if top2[1] - top2[0] < tol * np.abs(logits[step]).max():
                break
            assert a == b, (prompt, step, jt, tt)
            compared += 1
    return compared


def _both_engines(jp, port_params, ecfg, prompts, n, cfg=CFG, **kw):
    """Greedy streams of the JAX and the port engine at one config."""
    jeng = TPUEngine(JModelConfig(**cfg), JEngineConfig(use_pallas=False,
                                                        **ecfg), jp, **kw)
    try:
        jinst = jeng.create_instance()
        jouts = [jinst.infer(i, p, gen_config=greedy(JGen, n),
                             sequence_end=True).token_ids
                 for i, p in enumerate(prompts)]
    finally:
        jeng.shutdown()
    eng = TorchEngine(ModelConfig(**cfg), EngineConfig(**ecfg), port_params,
                      device='cpu', rank_timeout=TIMEOUT, **kw)
    try:
        inst = eng.create_instance()
        touts = [inst.infer(i, p, gen_config=greedy(GenerationConfig, n),
                            sequence_end=True).token_ids
                 for i, p in enumerate(prompts)]
        layers = eng.params['layers']
    finally:
        eng.shutdown()
    assert eng.rank_exitcodes == [0]
    return jouts, touts, layers


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


LEADER = '''
import json, sys
import torch.distributed as dist
from lmdeploy_tpu_torch import build_engine
from lmdeploy_tpu_torch.messages import GenerationConfig
from lmdeploy_tpu_torch.parallel.multihost import (init_multihost,
                                                   serve_leader,
                                                   stop_followers)
init_multihost(timeout_s=60)
eng = build_engine(sys.argv[1], tp=2, device='cpu', start=False,
                   rank_timeout=60)
fns = serve_leader(eng)
inst = eng.create_instance()
out = [inst.infer(10 + i, p, gen_config=GenerationConfig(
    max_new_tokens=8, top_k=1, ignore_eos=True), sequence_end=True).token_ids
    for i, p in enumerate(json.loads(sys.argv[2]))]
eng.shutdown()
reports = stop_followers(fns)
# the caller made the group: it ends it, as the follower does
dist.destroy_process_group()
print(json.dumps({'greedy': out, 'frames': [r['frames'] for r in reports]}))
'''


def test_ranks_launched_through_the_module_entry(tmp_path, port_tp2):
    """Rank 1 started with ``python -m lmdeploy_tpu_torch.parallel.multihost
    <workspace> --tp 2`` and rank 0 a leader script, both through an
    ``env://`` rendezvous: the leader serves, the follower replays, and the
    streams equal the single-process tp = 2 engine's on the same weights."""
    ws = str(tmp_path / 'ws')
    save_workspace(ws, ModelConfig(**CFG),
                   params_from_numpy(np_tree(jax_params(3)), 'cpu'),
                   EngineConfig(**dict(ECFG, tp=1)))
    env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(_free_port()), WORLD_SIZE='2')
    procs = [
        subprocess.Popen([sys.executable, '-c', LEADER, ws,
                          json.dumps(PROMPTS)], cwd=REPO,
                         env=dict(env, RANK='0'), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True),
        subprocess.Popen([sys.executable, '-m',
                          'lmdeploy_tpu_torch.parallel.multihost', ws,
                          '--tp', '2', '--device', 'cpu', '--timeout',
                          str(TIMEOUT)], cwd=REPO, env=dict(env, RANK='1'),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    leader = json.loads(outs[0][0].strip().splitlines()[-1])
    assert leader['greedy'] == port_tp2['greedy']
    assert leader['frames'][0] > 10
    assert outs[1][0].strip() == f'rank 1: replayed {leader["frames"][0]} ' \
                                 'frames'


def test_a_rank_that_dies_stops_the_engine():
    """A follower killed while the engine serves: the leader's next
    dispatch fails, the request ends with INTERNAL_ERROR instead of
    hanging, the engine stops (it never serves on with fewer ranks) and
    shutdown reports the killed rank's exit code."""
    eng = TorchEngine(ModelConfig(**CFG), EngineConfig(**ECFG),
                      params_from_numpy(np_tree(jax_params(3)), 'cpu'),
                      device='cpu', rank_timeout=TIMEOUT)
    try:
        inst = eng.create_instance()
        assert len(inst.infer(1, PROMPTS[0], gen_config=greedy(
            GenerationConfig), sequence_end=True).token_ids) == 8
        eng._procs[0].kill()
        eng._procs[0].join(10)
        out = inst.infer(2, PROMPTS[1], gen_config=greedy(
            GenerationConfig, 40), sequence_end=True)
        assert out.status == ResponseType.INTERNAL_ERROR
        eng._thread.join(10)
        assert not eng.alive()
        assert inst.infer(3, PROMPTS[0]).status == \
            ResponseType.INTERNAL_ERROR
    finally:
        eng.shutdown()
    assert eng.rank_exitcodes == [-9]


def test_a_rank_that_cannot_start_raises(monkeypatch):
    """A follower that fails before it joins (here: handed 0 intra-op
    threads, which torch refuses) makes the constructor raise RankFailure
    with its exit code at once, not at the group timeout, and no rank
    process is left running."""
    monkeypatch.setattr(torch, 'get_num_threads', lambda: 0)
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match=r'exit codes \[1\]'):
        TorchEngine(ModelConfig(**CFG), EngineConfig(**ECFG),
                    params_from_numpy(np_tree(jax_params(3)), 'cpu'),
                    device='cpu', rank_timeout=TIMEOUT)
    assert time.monotonic() - t0 < TIMEOUT / 2
    assert not dist.is_initialized()
    assert not [p for p in multiprocessing.active_children()
                if p.name.startswith('lmdeploy-rank')]
