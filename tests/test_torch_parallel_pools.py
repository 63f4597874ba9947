"""The port's tensor-parallel engine at tp = 2 with nibble-packed W4A16
weights and with quantised KV pools, against the JAX package's tp = 2
engine at the same EngineConfig (ranks spawned as processes, gloo on the
CPU, 60 s group timeouts)."""
import jax.numpy as jnp
import numpy as np
import pytest

from lmdeploy_tpu.config import ModelConfig as JModelConfig
from lmdeploy_tpu_torch.convert.workspace import params_from_numpy
from lmdeploy_tpu_torch.ops.linear import PackedInt4Weight
from test_torch_parallel import (CFG, ECFG, PROMPTS, REPEAT,
                                 _agree_up_to_near_tie, _both_engines,
                                 jax_params, np_tree)


def test_tp2_packed_w4a16_engine_matches_jax():
    """W4A16 at tp = 2 (group 16): the port's ranks hold nibble-packed
    blocks, the row-split ones packed per rank, and stream the JAX tp = 2
    engine's tokens (byte-per-int4 on its CPU) up to the first near-tie:
    2% of max|logit|, the rule of test_torch_engine.py, since the JAX CPU
    engine sums its W4A16 group partials in bf16."""
    cfg = dict(CFG, weight_type='int4', group_size=16)
    jp = jax_params(2, cfg, group_size=16)
    prompts = PROMPTS + [REPEAT]
    jouts, touts, layers = _both_engines(
        jp, params_from_numpy(np_tree(jp), 'cpu'), ECFG, prompts, 10,
        cfg=cfg)
    assert all(isinstance(layers[n], PackedInt4Weight)
               for n in ('wqkv', 'wo', 'w1', 'w3', 'w2'))
    assert layers['w2'].k == 32 and layers['wqkv'].n == 128  # per rank
    assert _agree_up_to_near_tie(jp, JModelConfig(**cfg), prompts, jouts,
                                 touts, 0.02) >= 15


POOLS = {
    'int8': (dict(quant_policy=4),
             [[0.05, 0.06], [1.0, -2.0], [0.04, 0.05], [0.0, 1.0]]),
    'int4-dynamic': (dict(quant_policy=8), None),
    'int4-per-head': (dict(quant_policy=8),
                      [np.full((2, 4), 0.3), np.zeros((2, 4)),
                       np.full((2, 4), 0.25), np.zeros((2, 4))]),
}


@pytest.mark.parametrize('pool', list(POOLS))
def test_tp2_quantised_pool_engine_matches_jax(pool):
    """int8, dynamic int4 and per-head int4 pools at tp = 2 (each rank
    holds 2 of the 4 KV heads and their qparams): greedy streams equal the
    JAX tp = 2 engine's up to the first step whose top-2 gap is within
    1e-3 of max|logit| (the rule of test_torch_kvquant.py's engine tests)."""
    over, scales = POOLS[pool]
    jp = jax_params(5)
    ecfg = dict(ECFG, **over)
    jouts, touts, _ = _both_engines(
        jp, params_from_numpy(np_tree(jp), 'cpu'), ecfg, PROMPTS, 10,
        kv_scales=scales)
    kind = {'int8': {'dtype': jnp.int8, 'kv_scales': scales},
            'int4-dynamic': {'dtype': jnp.uint8, 'dynamic_scales': True},
            'int4-per-head': {'dtype': jnp.uint8, 'kv_scales': scales}}
    assert _agree_up_to_near_tie(jp, JModelConfig(**CFG), PROMPTS, jouts,
                                 touts, 1e-3, kind[pool]) >= 10
