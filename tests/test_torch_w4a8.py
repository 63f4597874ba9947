"""The port's byte-per-int4 W4A16 serving form and its opt-in W4A8 product
against the JAX package's, on the CPU: ``ops/linear.py::quant_matmul_a8``,
``linear()``'s choice of product under ``LMDEPLOY_TPU_W4A8`` and
``LMDEPLOY_TPU_DEQUANT_MIN_M``, the residency switch
``LMDEPLOY_TPU_PACKED_INT4`` at every place that packs, and byte-form
engines (plain and W4A8) against the JAX engine, which holds that form on
the CPU by default."""
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
from lmdeploy_tpu.ops import linear as jlinear
from lmdeploy_tpu.ops.linear import QuantizedWeight as JQuant
from lmdeploy_tpu_torch.config import EngineConfig, ModelConfig
from lmdeploy_tpu_torch.convert.workspace import params_from_numpy
from lmdeploy_tpu_torch.engine.engine import TorchEngine
from lmdeploy_tpu_torch.messages import GenerationConfig
from lmdeploy_tpu_torch.models import llama as tllama
from lmdeploy_tpu_torch.ops import linear as tlinear
from lmdeploy_tpu_torch.ops.linear import PackedInt4Weight, QuantizedWeight
from lmdeploy_tpu_torch.parallel import tp as ttp

torch.set_num_threads(1)
CFG = dict(head_num=2, kv_head_num=1, size_per_head=128, inter_size=256,
           num_layer=2, vocab_size=256, rotary_embedding=128,
           max_position_embeddings=512, session_len=128, group_size=128,
           weight_type='int4', end_id=2)
ECFG = dict(max_batch_size=4, session_len=128, page_size=16, num_pages=40,
            max_context_token_num=32, prefill_buckets=(16, 32),
            step_length=4, enable_prefix_caching=False)
PROMPTS = [[5, 9, 200, 31, 77], list(range(40, 60)),
           [(7 * i) % 250 + 3 for i in range(45)]]


def _weight(seed, m, k, n):
    """x [M, K] normal and the int4 quantisation of a [K, N] normal * 0.1
    weight (group 128), as both packages hold it."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    jq = jlinear.quantize_weight_int4(w, 128)
    tq = tlinear.quantize_weight_int4(w, 128)
    np.testing.assert_array_equal(np.asarray(jq.qvals), tq.qvals.numpy())
    return x, w, jq, tq


@pytest.mark.parametrize('k,n', [(256, 256), (256, 384), (384, 256),
                                 (384, 384)])
@pytest.mark.parametrize('m', [1, 8, 40, 64])
def test_quant_matmul_a8_matches_jax(m, k, n):
    """The port's W4A8 product equals the JAX function's within 1e-5 of
    max|ref| (summation order only: the activation codes, the integer
    group dots and their bf16 rounding are the same values), and stays
    within tests/test_ops.py's 3% of the W4A16 product and of the f32
    product on the dequantised weight."""
    x, w, jq, tq = _weight(1000 * m + k + n, m, k, n)
    want = np.asarray(jlinear.quant_matmul_a8(jnp.asarray(x), jq))
    got = tlinear.quant_matmul_a8(torch.from_numpy(x), tq)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    got = got.numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    a16 = tlinear.quant_matmul(torch.from_numpy(x), tq).numpy()
    ref = x @ tlinear.dequantize(tq, torch.float32).numpy()
    assert np.abs(got - a16).max() / scale < 0.03
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.03


def test_quant_matmul_a8_zero_rows_and_codes():
    """An all-zero row quantises with sx = 1e-8 / 127 (no division by
    zero) and gives only the zero-point term, 0; the per-token codes are
    round-half-to-even and clipped to +-127, as jnp.round and jnp.clip."""
    x, _, jq, tq = _weight(5, 3, 256, 128)
    x[1] = 0.0
    x[2, :4] = [63.5, -63.5, 127.0, 0.25]    # 63.5 * 127/127: halves
    want = np.asarray(jlinear.quant_matmul_a8(jnp.asarray(x), jq))
    got = tlinear.quant_matmul_a8(torch.from_numpy(x), tq).numpy()
    assert (got[1] == 0).all() and (want[1] == 0).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# (env, rows, the product both packages pick)
DISPATCH = [
    ({}, 4, 'quant_matmul'),
    ({}, 40, 'quant_matmul_dequant'),
    ({'LMDEPLOY_TPU_DEQUANT_MIN_M': '4'}, 4, 'quant_matmul_dequant'),
    ({'LMDEPLOY_TPU_DEQUANT_MIN_M': '64'}, 40, 'quant_matmul'),
    ({'LMDEPLOY_TPU_W4A8': '1'}, 4, 'quant_matmul_a8'),
    ({'LMDEPLOY_TPU_W4A8': '1', 'LMDEPLOY_TPU_DEQUANT_MIN_M': '1'}, 40,
     'quant_matmul_a8'),
]


@pytest.mark.parametrize('env,m,product', DISPATCH)
def test_linear_picks_the_jax_product(monkeypatch, env, m, product):
    """Under each setting of the two switches, read on each call, the
    port's linear() picks the product the JAX package's linear() picks
    (W4A8 first, then dequant from DEQUANT_MIN_M rows, else the group
    form) and gives its numbers within 1e-5 of max|ref|; the output has
    x's dtype and leading shape."""
    for name in ('LMDEPLOY_TPU_W4A8', 'LMDEPLOY_TPU_DEQUANT_MIN_M'):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    picked = {'jax': [], 'port': []}
    for side, mod in (('jax', jlinear), ('port', tlinear)):
        for name in ('quant_matmul', 'quant_matmul_dequant',
                     'quant_matmul_a8'):
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name,
                                _s=side: picked[_s].append(_n) or _f(*a))
    x, _, jq, tq = _weight(7 + m, m, 256, 256)
    x3 = x.reshape(2, m // 2, 256)
    want = np.asarray(jlinear.linear(jnp.asarray(x3), jq))
    got = tlinear.linear(torch.from_numpy(x3), tq)
    assert picked == {'jax': [product], 'port': [product]}
    assert got.dtype == torch.float32 and got.shape == (2, m // 2, 256)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def jax_int4_params(seed=0, cfg=CFG):
    """The JAX package's byte-per-int4 W4A16 parameters (its CPU engine's
    residency) from numpy draws."""
    rng = np.random.default_rng(seed)
    dh, inter, nl, v = cfg['size_per_head'], 256, 2, 256
    d = cfg['head_num'] * dh
    qkv = (cfg['head_num'] + 2 * cfg['kv_head_num']) * dh

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
    return jllama.quantize_params(params, JModelConfig(**cfg), 128)


def to_numpy(tree):
    if isinstance(tree, JQuant):
        return {'qvals': np.asarray(tree.qvals),
                'scales': np.asarray(tree.scales),
                'zeros': np.asarray(tree.zeros)}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


PROJECTIONS = ('wqkv', 'wo', 'w1', 'w3', 'w2')


@pytest.mark.parametrize('switch', ['0', '1', None])
@pytest.mark.parametrize('site', ['params_from_numpy', 'pack_params_for_tp',
                                  'TorchEngine'])
def test_residency_switch_at_every_packing_site(monkeypatch, site, switch):
    """LMDEPLOY_TPU_PACKED_INT4=0 keeps the byte form where the port packs
    (params_from_numpy, pack_params_for_tp at tp = 2, and TorchEngine
    handed a byte-form tree, as the JAX engine packs at start); '1' and
    the unset default (the port packs by default on the CPU too) pack
    every packable projection.  With the switch off, pack_params_for_tp
    returns a byte-form tree unchanged, as the JAX engine then skips it."""
    if switch is None:
        monkeypatch.delenv('LMDEPLOY_TPU_PACKED_INT4', raising=False)
    else:
        monkeypatch.setenv('LMDEPLOY_TPU_PACKED_INT4', switch)
    want = QuantizedWeight if switch == '0' else PackedInt4Weight
    # heads split over tp = 2, and wo's 4 groups of K 2 to a rank: every
    # projection packs at tp = 2
    cfg = dict(CFG, head_num=4, kv_head_num=2)
    tree = to_numpy(jax_int4_params(cfg=cfg))
    if site == 'params_from_numpy':
        layers = params_from_numpy(tree, 'cpu')['layers']
    else:
        monkeypatch.setenv('LMDEPLOY_TPU_PACKED_INT4', '0')
        params = params_from_numpy(tree, 'cpu')
        if switch is None:
            monkeypatch.delenv('LMDEPLOY_TPU_PACKED_INT4')
        else:
            monkeypatch.setenv('LMDEPLOY_TPU_PACKED_INT4', switch)
        if site == 'pack_params_for_tp':
            prepared = ttp.prepare_params_for_tp(params, ModelConfig(**cfg),
                                                 2)
            out = ttp.pack_params_for_tp(prepared, 2)
            if switch == '0':
                assert out is prepared
            layers = out['layers']
        else:
            eng = TorchEngine(ModelConfig(**cfg), EngineConfig(**ECFG),
                              params, device='cpu', start=False)
            layers = eng.params['layers']
            eng.shutdown()
    assert all(isinstance(layers[n], want) for n in PROJECTIONS), \
        {n: type(layers[n]).__name__ for n in PROJECTIONS}


@pytest.mark.parametrize('switch', ['0', None])
def test_kernel_shape_check_refuses_byte_form_unless_chosen(monkeypatch,
                                                            switch):
    """parallel/tp.py::check_kernel_shapes, which a multi-rank engine runs
    on each rank's block before it serves on the card, refuses a
    byte-per-int4 weight with packed residency on (the default: such a
    weight is one the W4A16 kernel cannot take) and passes it under
    LMDEPLOY_TPU_PACKED_INT4=0, where the user chose the byte form."""
    monkeypatch.setenv('LMDEPLOY_TPU_PACKED_INT4', '0')
    cfg = dict(CFG, head_num=4, kv_head_num=2)
    prepared = ttp.prepare_params_for_tp(
        params_from_numpy(to_numpy(jax_int4_params(cfg=cfg)), 'cpu'),
        ModelConfig(**cfg), 2)
    shard = ttp.shard_params(prepared, 2, 1)
    assert isinstance(shard['layers']['w2'], QuantizedWeight)
    if switch is None:
        monkeypatch.delenv('LMDEPLOY_TPU_PACKED_INT4')
        with pytest.raises(NotImplementedError, match='of rank 1'):
            ttp.check_kernel_shapes(shard, 1)
    else:
        ttp.check_kernel_shapes(shard, 1)


def _near_tie_parity(jp, jouts, touts, tie):
    """Greedy streams equal until the first step whose JAX top-2 logit gap
    (teacher-forced JAX forward of the JAX stream) is below ``tie`` of
    that step's max|logit| (tests/test_torch_engine.py's rule); the number
    of steps compared."""
    jcfg = JModelConfig(**CFG)
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
            if top2[1] - top2[0] < tie * np.abs(logits[step]).max():
                break
            assert a == b, (prompt, step, jt, tt)
            compared += 1
    return compared


CYCLE = [11, 23, 47, 91, 130, 7]


def cycling_int4_params():
    """tests/test_torch_engine.py's cycling model (greedy continues CYCLE
    by a wide margin: the lm_head's column j is the embedding of j's
    predecessor) with its layers quantised to W4A16 by the JAX package:
    a model with no near-tie for any product's rounding to move."""
    rng = np.random.default_rng(8)
    d, nl, v = 256, 2, 256

    def w(*shape, s=0.02):
        return jnp.asarray((rng.normal(size=shape) * s).astype(np.float32))
    emb = w(v, d, s=1.0)
    pred = np.arange(v)
    pred[CYCLE] = np.roll(CYCLE, 1)
    params = {'tok_embedding': emb, 'norm': jnp.ones((d,)),
              'lm_head': jnp.asarray(np.asarray(emb)[pred].T),
              'layers': {'attn_norm': jnp.ones((nl, d)),
                         'ffn_norm': jnp.ones((nl, d)),
                         'wqkv': w(nl, d, 512), 'wo': w(nl, d, d),
                         'w1': w(nl, d, 256), 'w3': w(nl, d, 256),
                         'w2': w(nl, 256, d)}}
    return jllama.quantize_params(params, JModelConfig(**CFG), 128)


def _serve_both(jp, prompts, n_new, logits_prompt):
    """Greedy streams of ``prompts`` and the prompt logits of
    ``logits_prompt`` from the JAX engine and from the port's engine on
    the same byte-form parameters (under the caller's env)."""
    gen = dict(max_new_tokens=n_new, top_k=1, ignore_eos=True)
    jax.clear_caches()    # the switches are read when JAX traces
    jeng = TPUEngine(JModelConfig(**CFG), JEngineConfig(**ECFG), jp)
    try:
        assert isinstance(jeng.params['layers']['w2'], JQuant)
        jinst = jeng.create_instance()
        jouts = [jinst.infer(100 + i, p, gen_config=JGen(**gen),
                             sequence_end=True).token_ids
                 for i, p in enumerate(prompts)]
        jlogits = np.asarray(jinst.decode(logits_prompt))
    finally:
        jeng.shutdown()
        jax.clear_caches()
    eng = TorchEngine(ModelConfig(**CFG), EngineConfig(**ECFG),
                      params_from_numpy(to_numpy(jp), 'cpu'), device='cpu')
    try:
        assert isinstance(eng.params['layers']['w2'], QuantizedWeight)
        inst = eng.create_instance()
        touts = [inst.infer(200 + i, p, gen_config=GenerationConfig(**gen),
                            sequence_end=True).token_ids
                 for i, p in enumerate(prompts)]
        tlogits = inst.decode(logits_prompt)
    finally:
        eng.shutdown()
    assert tlogits.shape == jlogits.shape == (len(logits_prompt), 256)
    return jouts, touts, jlogits, tlogits


def _w4a8_switch(monkeypatch, on):
    """Set LMDEPLOY_TPU_W4A8 and count the port's W4A8 products."""
    if on:
        monkeypatch.setenv('LMDEPLOY_TPU_W4A8', '1')
    else:
        monkeypatch.delenv('LMDEPLOY_TPU_W4A8', raising=False)
    picked = []
    fn = tlinear.quant_matmul_a8
    monkeypatch.setattr(tlinear, 'quant_matmul_a8',
                        lambda *a: picked.append(1) or fn(*a))
    return picked


def test_byte_form_engine_matches_jax_engine(monkeypatch):
    """With LMDEPLOY_TPU_PACKED_INT4=0 the port's engine serves
    byte-per-int4 weights through linear()'s group and dequant products,
    as the JAX engine serves them on the CPU: greedy streams equal up to
    near-ties, and prompt logits (EngineInstance.decode) within 2% of
    max|logit|: the W4A16 parity rule and tolerance of
    tests/test_torch_engine.py."""
    monkeypatch.setenv('LMDEPLOY_TPU_PACKED_INT4', '0')
    picked = _w4a8_switch(monkeypatch, False)
    jp = jax_int4_params()
    jouts, touts, jlogits, tlogits = _serve_both(jp, PROMPTS, 10,
                                                 PROMPTS[2])
    assert not picked
    assert _near_tie_parity(jp, jouts, touts, 0.02) >= 12
    assert np.abs(tlogits - jlogits).max() <= 0.02 * np.abs(jlogits).max()


def _port_prompt_logits(params, prompt, nudge_seed=None):
    """The port engine's prompt logits (EngineInstance.decode) on the CPU;
    with ``nudge_seed``, every byte-form product's input is first moved by
    one f32 ulp, up or down at random (seeded): a perturbation of the
    size by which two packages' f32 sums differ."""
    mp = pytest.MonkeyPatch()
    if nudge_seed is not None:
        gen = torch.Generator().manual_seed(nudge_seed)

        def nudged(x, w, bias=None):
            if isinstance(w, QuantizedWeight):
                up = torch.rand(x.shape, generator=gen) < 0.5
                x = torch.nextafter(x, torch.where(
                    up, torch.full_like(x, np.inf),
                    torch.full_like(x, -np.inf)))
            return tlinear.linear(x, w, bias)
        mp.setattr(tllama, 'linear', nudged)
    eng = TorchEngine(ModelConfig(**CFG), EngineConfig(**ECFG), params,
                      device='cpu')
    try:
        return eng.create_instance().decode(prompt)
    finally:
        eng.shutdown()
        mp.undo()


def _gap(got, ref):
    """max|got - ref| / max|ref| and the least cosine over rows."""
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1)
                                 * np.linalg.norm(ref, axis=-1))
    return np.abs(got - ref).max() / np.abs(ref).max(), cos.min()


def test_w4a8_engine_matches_jax_engine(monkeypatch):
    """With LMDEPLOY_TPU_PACKED_INT4=0 and LMDEPLOY_TPU_W4A8=1 both engines
    serve every byte-form projection through W4A8.

    Its arithmetic equals the JAX function's to 1e-5 on identical inputs
    (test_quant_matmul_a8_matches_jax), but W4A8 is not continuous in its
    input: a last-bit difference that moves an int8 code, or an integer
    group dot across a bf16 rounding boundary, moves a product by a step.
    The test measures that witness itself: the port against itself with
    every byte-form product's input nudged by one f32 ulp, four seeds.
    Without W4A8 the nudge stays within the W4A16 rule's 2% (the bf16
    rounding of the activations is a smaller step of the same kind); with
    W4A8 it moves the prompt logits further.  The JAX engine's logits are
    one more draw of such a perturbation, so on the cycling model (no
    near-tie) greedy streams equal token for token, and on the random
    model the prompt logits sit within max(2%, 1.5 times the witness's
    largest gap) of the JAX engine's, and 1 - cosine within 1.5^2 times
    the witness's largest (it grows as the gap's square)."""
    monkeypatch.setenv('LMDEPLOY_TPU_PACKED_INT4', '0')
    picked = _w4a8_switch(monkeypatch, True)
    prompts = [CYCLE * 2, [5, 9, 200, 31, 23]]
    jouts, touts, _, _ = _serve_both(cycling_int4_params(), prompts, 20,
                                     prompts[0])
    assert picked
    assert jouts == [(CYCLE * 4)[:20], (CYCLE * 4)[2:22]]
    assert touts == jouts
    jp = jax_int4_params()
    _, _, jlogits, tlogits = _serve_both(jp, PROMPTS[:1], 1, PROMPTS[2])
    params = params_from_numpy(to_numpy(jp), 'cpu')
    witness = {}
    for on in (False, True):
        _w4a8_switch(monkeypatch, on)
        base = _port_prompt_logits(params, PROMPTS[2])
        gaps = [_gap(_port_prompt_logits(params, PROMPTS[2], seed), base)
                for seed in range(4)]
        witness[on] = (max(g for g, _ in gaps), min(c for _, c in gaps))
    np.testing.assert_array_equal(base, tlogits)
    gap, cos = _gap(tlogits, jlogits)
    print('W4A8 against JAX', gap, cos, 'witness without / with W4A8',
          witness)
    assert witness[False][0] <= 0.02 <= witness[True][0]
    assert gap <= max(0.02, 1.5 * witness[True][0])
    assert 1 - cos <= 1.5 ** 2 * (1 - witness[True][1])
