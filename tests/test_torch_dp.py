"""The port's dp groups (dp = 2, and dp x tp = 2 x 2 over four rank
processes) against the JAX package's dp engine at the same EngineConfig:
streams, prompt logits, top-N logprobs, the group each session lands in
and stays in, and each group's free pages."""
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
# tests/test_parallel.py's model and dp engine
CFG = dict(head_num=8, kv_head_num=4, size_per_head=16, inter_size=64,
           num_layer=2, vocab_size=128, rotary_embedding=16,
           max_position_embeddings=128, session_len=64, end_id=2)
ECFG = dict(max_batch_size=4, session_len=64, page_size=8, num_pages=32,
            max_context_token_num=16, prefill_buckets=(8, 16), step_length=2)
PROMPTS = {1: [3, 17, 42, 99, 5], 2: [9, 11], 3: [120, 7, 30]}


def script(eng, gen_cls):
    """Three concurrent requests (both groups fill), prompt logits (group
    0's scratch session), top-3 logprobs, then two kept sessions and a
    continuation of the first."""
    inst = eng.create_instance()
    gen = gen_cls(max_new_tokens=5, top_k=1, ignore_eos=True)
    streams = {sid: inst.stream_infer(sid, p, gen_config=gen,
                                      sequence_end=True)
               for sid, p in PROMPTS.items()}
    out = {'streams': {sid: list(g)[-1].token_ids
                       for sid, g in streams.items()},
           'logits': inst.decode(PROMPTS[1])}
    tops = gen_cls(max_new_tokens=5, top_k=1, ignore_eos=True,
                   top_logprobs=3)
    out['tops'] = [inst.infer(10 + i, p, gen_config=tops, sequence_end=True)
                   for i, p in enumerate([[3, 17, 42], [9, 11]])]
    gen3 = gen_cls(max_new_tokens=3, top_k=1, ignore_eos=True)
    first = inst.infer(21, [3, 17, 42], gen_config=gen3).token_ids
    g1 = eng.seqs.group_of(21)
    second = inst.infer(22, [9, 11, 13], gen_config=gen3).token_ids
    g2 = eng.seqs.group_of(22)
    cont = inst.infer(21, [5], gen_config=gen3,
                      sequence_start=False).token_ids
    out['sticky'] = (first, second, cont, g1, g2, eng.seqs.group_of(21))
    m = eng.metrics()
    out['free'] = [m[f'free_pages_group{g}'] for g in range(2)]
    return out


@pytest.mark.parametrize('dp,tp', [(2, 1), (2, 2)])
def test_dp_engine_matches_jax_dp_engine(dp, tp):
    """dp groups: concurrent sessions spread over both groups stream the
    JAX dp engine's greedy tokens, prompt logits (pinned to group 0) within
    rtol / atol 2e-4, the same top-3 alternatives (logprobs within 1e-3),
    and sessions land in, and stay in, the same groups with the same free
    pages per group; every follower rank exits 0."""
    jcfg = JModelConfig(**CFG)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(7), jnp.float32)
    ecfg = dict(ECFG, dp=dp, tp=tp)
    jeng = TPUEngine(jcfg, JEngineConfig(use_pallas=False, **ecfg), jp)
    try:
        want = script(jeng, JGen)
    finally:
        jeng.shutdown()
    eng = TorchEngine(ModelConfig(**CFG), EngineConfig(**ecfg),
                      params_from_numpy(jax.tree.map(np.asarray, jp), 'cpu'),
                      device='cpu', rank_timeout=60)
    try:
        assert eng.metrics()['dp'] == dp
        got = script(eng, GenerationConfig)
    finally:
        eng.shutdown()
    assert eng.rank_exitcodes == [0] * (dp * tp - 1)
    assert got['streams'] == want['streams']
    np.testing.assert_allclose(got['logits'], want['logits'], rtol=2e-4,
                               atol=2e-4)
    for a, b in zip(got['tops'], want['tops']):
        assert a.token_ids == b.token_ids
        assert len(a.top_logprobs) == len(b.top_logprobs) == 5
        for x, y in zip(a.top_logprobs, b.top_logprobs):
            assert set(x) == set(y)
            assert all(abs(x[t] - y[t]) < 1e-3 for t in x)
    first, second, cont, g1, g2, g1b = got['sticky']
    assert got['sticky'] == want['sticky']
    assert g1 != g2 and g1b == g1 and len(cont) == 3
    assert got['free'] == want['free']
