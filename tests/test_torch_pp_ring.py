"""The port's pipeline-parallel engine against the JAX package's pp engine
at the same EngineConfig (continued from test_torch_pp_engine.py): the
ring on an int4 pool, speculation's priority over the ring, an
indivisible batch, the GPipe batched prefill and dp x pp; then pp ranks
launched through ``python -m lmdeploy_tpu_torch.parallel.multihost``."""
import json
import os
import queue
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lmdeploy_tpu.config import ModelConfig as JModelConfig
from lmdeploy_tpu.messages import EngineRequest as JRequest
from lmdeploy_tpu.models import llama as jllama
from lmdeploy_tpu_torch.config import EngineConfig, ModelConfig
from lmdeploy_tpu_torch.convert.workspace import (params_from_numpy,
                                                  save_workspace)
from lmdeploy_tpu_torch.engine.engine import TorchEngine
from lmdeploy_tpu_torch.messages import EngineRequest, GenerationConfig
from test_torch_pp_engine import (CFG, ECFG, TIMEOUT, both_engines, greedy,
                                  np_tree)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_engine_ring_with_int4_kv():
    """An int4 pool with static per-layer qparams (quant_policy 8) at pp =
    2 x tp = 2: the ring streams the JAX engine's tokens, each stage's pool
    holds its two layers as nibble-packed bytes."""
    scales = [np.full(CFG['num_layer'], 0.1, np.float32),
              np.zeros(CFG['num_layer'], np.float32),
              np.full(CFG['num_layer'], 0.1, np.float32),
              np.zeros(CFG['num_layer'], np.float32)]
    ecfg = dict(ECFG, quant_policy=8, pp=2, tp=2)

    def script(eng, gen_cls):
        out = eng.create_instance().infer(1, [3, 9, 4],
                                          gen_config=greedy(gen_cls, 6),
                                          sequence_end=True)
        return out.token_ids, eng.stats['ring_rounds'], eng.cache

    want, got = both_engines(9, ecfg, script, kv_scales=scales)
    assert len(got[0]) == 6 and got[0] == want[0]
    assert got[1] > 0
    assert got[2].quant_bits == 4 and got[2].k.shape[0] == 2
    assert got[2].k_scale.tolist() == pytest.approx([0.1, 0.1])


def test_spec_keeps_priority_on_pp_mesh():
    """At pp = 2 x tp = 2 a repetitive greedy request rides the ring
    without speculation, and with speculative_k = 4 turned on (on both
    running engines) speculative rounds take priority over the ring (the
    relay verify; no ring round) and stream the same tokens; both streams
    equal the JAX engine's."""
    ecfg = dict(ECFG, max_context_token_num=32, prefill_buckets=(8, 16, 32),
                pp=2, tp=2)
    prompt = [5, 6, 7] * 6

    def script(eng, gen_cls):
        inst = eng.create_instance()
        out = {}
        for name, k in (('ring', 0), ('spec', 4)):
            eng.ecfg.speculative_k = k
            before = dict(eng.stats)
            out[name] = inst.infer(1, prompt, gen_config=greedy(gen_cls, 8),
                                   sequence_end=True).token_ids
            out[name + '_counts'] = tuple(
                eng.stats[c] - before[c] for c in ('spec_rounds',
                                                   'ring_rounds'))
        return out

    want, got = both_engines(8, ecfg, script)
    assert got['ring'] == got['spec'] == want['ring'] == want['spec']
    assert got['ring_counts'][0] == 0 and got['ring_counts'][1] > 0
    assert got['spec_counts'][0] > 0 and got['spec_counts'][1] == 0


# three requests admitted in one loop turn on an engine of B = 3 slots:
# their prompts prefill in one pass of three rows (a 32-token budget), and
# the ring cuts B = 3 into two microbatches of two rows, one a pad row
B3_ECFG = dict(ECFG, max_batch_size=3, max_context_token_num=32,
               prefill_buckets=(8, 16, 32), pp=2)
B3_PROMPTS = [[33, 29, 114, 30, 31], [12, 35, 84, 7, 90, 11, 4],
              [110, 59, 114, 102, 3, 8, 9, 10, 11, 12, 13, 14]]


def _submit_all(eng, gen_cls, req_cls, prompts, n, end=True):
    """Queue every request before the scheduler starts (as ``submit`` does
    on a running engine; it answers INTERNAL_ERROR before the start), so
    that one loop turn admits them all; returns each request's final
    output."""
    qs = []
    for i, p in enumerate(prompts):
        qs.append(queue.Queue())
        eng._requests.put((req_cls(session_id=i + 1, input_ids=p,
                                   gen_config=greedy(gen_cls, n),
                                   sequence_end=end), qs[-1],
                           time.monotonic()))
    eng.start()
    outs = []
    for q in qs:
        while True:
            out = q.get(timeout=120)
            if out.finished:
                outs.append(out)
                break
    return outs


@pytest.fixture(scope='module')
def b3_runs():
    """The JAX and the port engine of B3_ECFG (started after the three
    requests are queued), and the job count of each GPipe pass the port's
    rank 0 ran (its rank report's ``prefill_jobs``)."""
    def script(eng, gen_cls):
        port = isinstance(eng, TorchEngine)
        req_cls = EngineRequest if port else JRequest
        outs = _submit_all(eng, gen_cls, req_cls, B3_PROMPTS, 6)
        return ([o.token_ids for o in outs], eng.stats['ring_rounds'],
                eng.stats['prefill_passes'] if port else None,
                eng.fns.rank_report()[0]['prefill_jobs'] if port else None)

    want, got = both_engines(11, B3_ECFG, script, start=False)
    return want, got, got[3]


def test_pp_ring_indivisible_batch(b3_runs):
    """B = 3 slots at pp = 2: the ring pads the batch to two microbatches
    of two rows (one an inactive pad row) and the three concurrent streams
    equal the JAX engine's."""
    want, got, _ = b3_runs
    assert all(len(t) == 6 for t in got[0])
    assert got[0] == want[0]
    assert got[1] > 0


def test_pp_batched_prefill_ring(b3_runs):
    """The three admissions prefill through the GPipe ring in passes of
    several jobs (one job per stage per iteration), and decode after them
    streams the JAX engine's tokens."""
    want, got, jobs = b3_runs
    assert got[0] == want[0]
    assert max(jobs) == 3 and len(jobs) == got[2]


def test_engine_serves_over_dp_pp():
    """dp = 2 x pp = 2 (four ranks): three concurrent requests spread over
    both dp groups as the JAX engine spreads them (free pages per group
    equal) and stream its tokens on the ring, and prompt logits (dp group
    0's relay) lie within rtol / atol 2e-4 of its."""
    ecfg = dict(ECFG, max_batch_size=4, dp=2, pp=2)
    prompts = [[5, 9, 4], [6, 9, 4, 30], [110, 59, 114, 102]]

    def script(eng, gen_cls):
        req_cls = EngineRequest if isinstance(eng, TorchEngine) else JRequest
        outs = _submit_all(eng, gen_cls, req_cls, prompts, 5, end=False)
        groups = [eng.seqs.group_of(i + 1) for i in range(len(prompts))]
        free = [eng.metrics()[f'free_pages_group{g}'] for g in range(2)]
        logits = eng.create_instance().decode([5, 9, 4, 60, 61])
        return [o.token_ids for o in outs], logits, (groups, free), \
            eng.stats['ring_rounds']

    want, got = both_engines(3, ecfg, script, start=False)
    assert all(len(t) == 5 for t in got[0])
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=2e-4, atol=2e-4)
    assert got[2] == want[2] and set(got[2][0]) == {0, 1}
    assert got[3] > 0


LEADER = '''
import json, sys
import torch.distributed as dist
from lmdeploy_tpu_torch import build_engine
from lmdeploy_tpu_torch.messages import GenerationConfig
from lmdeploy_tpu_torch.parallel.multihost import (init_multihost,
                                                   serve_leader,
                                                   stop_followers)
init_multihost(timeout_s=60)
eng = build_engine(sys.argv[1], pp=2, device='cpu', start=False,
                   rank_timeout=60)
fns = serve_leader(eng)
inst = eng.create_instance()
out = [inst.infer(10 + i, p, gen_config=GenerationConfig(
    max_new_tokens=8, top_k=1, ignore_eos=True), sequence_end=True).token_ids
    for i, p in enumerate(json.loads(sys.argv[2]))]
rings = eng.stats['ring_rounds']
eng.shutdown()
reports = stop_followers(fns)
# the caller made the group: it ends it, as the follower does
dist.destroy_process_group()
print(json.dumps({'greedy': out, 'rings': rings,
                  'frames': [r['frames'] for r in reports]}))
'''


def test_pp_ranks_launched_through_the_module_entry(tmp_path):
    """Stage 1 started with ``python -m lmdeploy_tpu_torch.parallel.multihost
    <workspace> --pp 2`` and stage 0 a leader script, both through an
    ``env://`` rendezvous (the caller's process group, which the engine
    joins): the ring serves, the follower replays every frame, and the
    streams equal a one-rank engine's on the same workspace."""
    jp = jllama.init_params(JModelConfig(**CFG), jax.random.PRNGKey(4),
                            jnp.float32)
    params = params_from_numpy(np_tree(jp), 'cpu')
    ws = str(tmp_path / 'ws')
    save_workspace(ws, ModelConfig(**CFG), params, EngineConfig(**ECFG))
    prompts = [[33, 29, 114, 30, 31], [12, 35, 84]]
    eng = TorchEngine(ModelConfig(**CFG), EngineConfig(**ECFG), params,
                      device='cpu')
    try:
        inst = eng.create_instance()
        want = [inst.infer(10 + i, p, gen_config=greedy(GenerationConfig, 8),
                           sequence_end=True).token_ids
                for i, p in enumerate(prompts)]
    finally:
        eng.shutdown()
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR='127.0.0.1',
               MASTER_PORT=str(port), WORLD_SIZE='2')
    procs = [
        subprocess.Popen([sys.executable, '-c', LEADER, ws,
                          json.dumps(prompts)], cwd=REPO,
                         env=dict(env, RANK='0'), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True),
        subprocess.Popen([sys.executable, '-m',
                          'lmdeploy_tpu_torch.parallel.multihost', ws,
                          '--pp', '2', '--device', 'cpu', '--timeout',
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
    assert leader['greedy'] == want and leader['rings'] > 0
    assert outs[1][0].strip() == f'rank 1: replayed {leader["frames"][0]} ' \
                                 'frames'
