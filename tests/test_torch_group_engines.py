"""Engines whose W4A16 weights use other groups or an odd group count, on
the CPU, against the JAX package's engine.

- An intermediate size with an odd count of quantisation groups (inter
  384 at group 128: w2 has 3 groups; Qwen-14B's 13696 has 107) at tp = 1:
  the JAX engine serves such a w2 byte-per-int4 with XLA, which the card
  has no kernel for; the port pads inter to a multiple of 2 x group with
  exact zeros (as its tp >= 2 path does) so that every weight packs and
  passes ``parallel/tp.py::check_kernel_shapes``, and its output does not
  move.
- A tiny Qwen-shaped engine: qkv bias, dynamic-NTK rope, logn attention
  (``max_position_embeddings`` 32, so prompts and streams cross it), KV
  heads = heads, the odd inter groups above.
- A tiny group-64 engine whose prompts are longer than 64 tokens (prefill
  passes of more than 64 rows).

Each engine's greedy streams equal the JAX engine's, or part from them
first at a step whose JAX top-2 logit gap is under 2% of that step's
max|logit| (after which they may differ), and its
prompt logits (``EngineInstance.decode``) lie within 2% of max|logit|:
the W4A16 parity rule and tolerance of tests/test_torch_engine.py (the
port's product is the packed kernel's plain version, the JAX CPU engine's
the byte form).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lmdeploy_tpu.config import EngineConfig as JEngineConfig
from lmdeploy_tpu.config import ModelConfig as JModelConfig
from lmdeploy_tpu.engine.engine import TPUEngine
from lmdeploy_tpu.kvcache.paged import init_cache as jinit_cache
from lmdeploy_tpu.messages import GenerationConfig as JGen
from lmdeploy_tpu.models import llama as jllama
from lmdeploy_tpu.ops.linear import QuantizedWeight as JQuant
from lmdeploy_tpu_torch.config import EngineConfig, ModelConfig
from lmdeploy_tpu_torch.convert.workspace import params_from_numpy
from lmdeploy_tpu_torch.engine import engine as tengine
from lmdeploy_tpu_torch.engine.engine import TorchEngine
from lmdeploy_tpu_torch.messages import GenerationConfig
from lmdeploy_tpu_torch.ops.cuda.quant_matmul import unpack_nibbles
from lmdeploy_tpu_torch.ops.linear import PackedInt4Weight, QuantizedWeight
from lmdeploy_tpu_torch.parallel import tp as ttp

torch.set_num_threads(1)
BASE = dict(head_num=2, kv_head_num=1, size_per_head=128, inter_size=384,
            num_layer=2, vocab_size=256, rotary_embedding=128,
            max_position_embeddings=512, session_len=128, group_size=128,
            weight_type='int4', end_id=2)
CASES = {
    # w2's K = 384 is 3 groups of 128
    'odd_groups': BASE,
    # Qwen's shape at a tiny width: KV heads = heads, bias on qkv only,
    # dynamic NTK and logn past 32 tokens, w2 of 3 groups
    'qwen': dict(BASE, kv_head_num=2, attn_bias=True, qkv_bias_only=True,
                 use_dynamic_ntk=True, use_logn_attn=True,
                 max_position_embeddings=32),
    # group 64 (K = 256: 4 groups; w2 K = 256)
    'group64': dict(BASE, inter_size=256, group_size=64),
}
ECFG = dict(max_batch_size=4, session_len=128, page_size=16, num_pages=40,
            max_context_token_num=128, prefill_buckets=(16, 128),
            step_length=4, enable_prefix_caching=False)
PROMPTS = {
    'odd_groups': [[5, 9, 200, 31, 77], list(range(40, 60)),
                   [(7 * i) % 250 + 3 for i in range(45)]],
    'qwen': [[5, 9, 200, 31, 77], [(7 * i) % 250 + 3 for i in range(30)],
             [(11 * i) % 250 + 3 for i in range(45)]],
    'group64': [[(7 * i) % 250 + 3 for i in range(70)],
                [(5 * i) % 250 + 3 for i in range(100)], [5, 9, 200]],
}
N_NEW = 10


def jax_params(cfg, seed=0):
    """The JAX package's byte-per-int4 W4A16 parameters (its CPU engine's
    residency) for ``cfg``, from numpy draws; qkv bias where the config
    has one."""
    rng = np.random.default_rng(seed)
    dh, nl, v = cfg['size_per_head'], cfg['num_layer'], cfg['vocab_size']
    h, kh, inter = cfg['head_num'], cfg['kv_head_num'], cfg['inter_size']
    d, qkv = h * dh, (h + 2 * kh) * dh

    def w(*shape, s=0.06):
        return jnp.asarray((rng.normal(size=shape) * s).astype(np.float32))
    layers = {'attn_norm': jnp.ones((nl, d)), 'ffn_norm': jnp.ones((nl, d)),
              'wqkv': w(nl, d, qkv), 'wo': w(nl, d, d),
              'w1': w(nl, d, inter), 'w3': w(nl, d, inter),
              'w2': w(nl, inter, d)}
    if cfg.get('attn_bias'):
        layers['bqkv'] = w(nl, qkv, s=0.1)
    params = {'tok_embedding': w(v, d, s=1.0), 'norm': jnp.ones((d,)),
              'lm_head': w(d, v), 'layers': layers}
    return jllama.quantize_params(params, JModelConfig(**cfg),
                                  cfg['group_size'])


def to_numpy(tree):
    if isinstance(tree, JQuant):
        return {'qvals': np.asarray(tree.qvals),
                'scales': np.asarray(tree.scales),
                'zeros': np.asarray(tree.zeros)}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def port_engine(cfg, jp, ecfg=ECFG):
    return TorchEngine(ModelConfig(**cfg), EngineConfig(**ecfg),
                       params_from_numpy(to_numpy(jp), 'cpu'), device='cpu')


def test_odd_group_count_packs_every_weight_at_tp1():
    """At tp = 1, w2 with 3 groups of 128 (inter 384) leaves the engine's
    packing nibble-packed at K = 512 (inter padded with exact zeros, as
    tp >= 2 pads it), w1 and w3 at N = 512, and the engine's weights pass
    the card's kernel check: before, w2 stayed byte-per-int4 and the
    check refused it."""
    eng = port_engine(BASE, jax_params(BASE))
    try:
        layers = eng.params['layers']
        for name in ('wqkv', 'wo', 'w1', 'w3', 'w2'):
            assert isinstance(layers[name], PackedInt4Weight), name
        assert layers['w2'].k == 512 and layers['w2'].scales.shape[1] == 4
        assert layers['w1'].n == layers['w3'].n == 512
        # the padding is exact zeros: zero codes, scale 1, no zero point
        assert not unpack_nibbles(layers['w2'].packed)[:, 384:].any()
        assert (layers['w2'].scales[:, 3] == 1).all()
        assert not layers['w1'].sz[..., 384:].any()
        ttp.check_kernel_shapes(eng.params)
    finally:
        eng.shutdown()


def test_cuda_engine_checks_kernel_shapes_at_start(monkeypatch):
    """A tp = 1 engine on the card checks its weights against the kernels
    when it is built, as one of tp > 1 does: an odd group count in wqkv's
    and wo's K (3 heads x 128 at group 128), which no padding repairs,
    raises there with the check's message, not inside the first
    request."""
    cfg = dict(BASE, head_num=3, kv_head_num=1)
    monkeypatch.setattr(tengine, 'resolve_device',
                        lambda device: torch.device('cuda'))
    with pytest.raises(NotImplementedError, match="'wqkv'.*3 groups"):
        TorchEngine(ModelConfig(**cfg), EngineConfig(**ECFG),
                    params_from_numpy(to_numpy(jax_params(cfg)), 'cpu'),
                    device='cuda')


def _jax_tf_logits(jp, jcfg, prompt, stream):
    """The JAX forward's logits over ``prompt`` + ``stream`` (teacher
    forced), one row per generated step."""
    ids = np.asarray(prompt + stream[:-1], np.int32)[None]
    t = ids.shape[1]
    pages = -(-t // 16)
    batch = jllama.StepBatch(
        ids=jnp.asarray(ids),
        positions=jnp.arange(t, dtype=jnp.int32)[None],
        valid=jnp.ones((1, t), bool),
        context_len=jnp.asarray([t], jnp.int32),
        page_table=jnp.arange(pages, dtype=jnp.int32)[None])
    logits, _ = jllama.forward(
        jp, jinit_cache(jcfg.num_layer, pages, 16, jcfg.kv_head_num,
                        jcfg.size_per_head), batch, jcfg,
        return_all_logits=True)
    return np.asarray(logits)[0, len(prompt) - 1:, :jcfg.vocab_size]


@pytest.mark.parametrize('case', list(CASES))
def test_engine_matches_jax_engine(case):
    """The port's engine and the JAX engine on the same W4A16 weights:
    greedy streams of three prompts equal, or parting first at a near-tie
    (2% of max|logit|), at least 12 steps agreeing in all, and the prompt
    logits of the longest prompt within 2% of max|logit|.  The port serves
    every weight packed (w2 padded where its group count is odd), the JAX
    CPU engine the byte form."""
    cfg = CASES[case]
    jcfg = JModelConfig(**cfg)
    jp = jax_params(cfg)
    prompts = PROMPTS[case]
    longest = max(prompts, key=len)
    gen = dict(max_new_tokens=N_NEW, top_k=1, ignore_eos=True)
    # the Qwen case asks for prefix caching, which dynamic NTK turns off
    ecfg = dict(ECFG, enable_prefix_caching=case == 'qwen')
    jax.clear_caches()
    jeng = TPUEngine(jcfg, JEngineConfig(**ecfg), jp)
    try:
        assert isinstance(jeng.params['layers']['w2'], JQuant)
        assert not jeng.ecfg.enable_prefix_caching
        jinst = jeng.create_instance()
        jouts = [jinst.infer(100 + i, p, gen_config=JGen(**gen),
                             sequence_end=True).token_ids
                 for i, p in enumerate(prompts)]
        jlogits = np.asarray(jinst.decode(longest))
    finally:
        jeng.shutdown()
    eng = port_engine(cfg, jp, ecfg)
    try:
        assert all(isinstance(w, PackedInt4Weight)
                   for w in eng.params['layers'].values()
                   if isinstance(w, (PackedInt4Weight, QuantizedWeight)))
        assert not eng.ecfg.enable_prefix_caching
        inst = eng.create_instance()
        touts = [inst.infer(200 + i, p, gen_config=GenerationConfig(**gen),
                            sequence_end=True).token_ids
                 for i, p in enumerate(prompts)]
        tlogits = inst.decode(longest)
    finally:
        eng.shutdown()
    assert tlogits.shape == jlogits.shape == (len(longest), 256)
    assert np.abs(tlogits - jlogits).max() <= 0.02 * np.abs(jlogits).max()
    agreed = 0
    for prompt, jt, tt in zip(prompts, jouts, touts):
        assert len(jt) == len(tt) == N_NEW
        part = next((i for i, (a, b) in enumerate(zip(jt, tt)) if a != b),
                    N_NEW)
        if part < N_NEW:
            # the streams may part only at a near-tie of the JAX forward
            logits = _jax_tf_logits(jp, jcfg, prompt, jt)[part]
            top2 = np.sort(logits)[-2:]
            assert top2[1] - top2[0] < 0.02 * np.abs(logits).max(), (
                case, prompt, part, jt, tt)
        agreed += part
    assert agreed >= 12
