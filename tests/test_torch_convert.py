"""The port's checkpoint conversion against the JAX package's: HF
(llama, internlm, baichuan, baichuan2, qwen), meta-llama and AWQ
checkpoints, ``convert_hf --quantize``, random workspaces, the
memory-mapped safetensors reader, and ``build_engine`` on an HF
directory.

Every case feeds the same numpy-seeded checkpoint to both packages.
Converted arrays must be equal exactly at f32 and bit-equal at bf16; the
workspaces the two converters write must hold the same tensors, and each
package must load the other's.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lmdeploy_tpu.convert.converter as jconv
import lmdeploy_tpu.convert.hf as jhf
import lmdeploy_tpu.convert.meta as jmeta
import lmdeploy_tpu_torch.convert.converter as tconv
import lmdeploy_tpu_torch.convert.hf as thf
import lmdeploy_tpu_torch.convert.meta as tmeta
from lmdeploy_tpu.api import build_engine as jbuild_engine
from lmdeploy_tpu.config import EngineConfig as JEngineConfig
from lmdeploy_tpu.config import ModelConfig as JModelConfig
from lmdeploy_tpu.messages import GenerationConfig as JGen
from lmdeploy_tpu.ops.linear import QuantizedWeight as JQuant
from lmdeploy_tpu_torch import build_engine
from lmdeploy_tpu_torch.config import EngineConfig, ModelConfig
from lmdeploy_tpu_torch.convert.awq import (AWQ_ORDER, convert_awq,
                                            unpack_awq_int32)
from lmdeploy_tpu_torch.convert.workspace import (read_safetensors,
                                                  write_safetensors)
from lmdeploy_tpu_torch.messages import GenerationConfig
from lmdeploy_tpu_torch.ops.linear import QuantizedWeight
from test_torch_engine import ECFG, agree_up_to_near_tie

torch.set_num_threads(1)

DTYPES = {'f32': (np.float32, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16)}


def _bits(a) -> np.ndarray:
    """A JAX / numpy / torch array as its raw bits (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == 'bfloat16' else a


def assert_trees_equal(jtree, ttree):
    """The JAX package's tree and the port's: same keys, shapes and
    bits (QuantizedWeight parts compared as values)."""
    if isinstance(jtree, JQuant):
        assert isinstance(ttree, QuantizedWeight)
        for part in ('qvals', 'scales', 'zeros'):
            np.testing.assert_array_equal(
                np.asarray(getattr(jtree, part)).astype(np.float32),
                getattr(ttree, part).float().numpy())
        return
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree)
        for k in jtree:
            assert_trees_equal(jtree[k], ttree[k])
        return
    j, t = _bits(jtree), _bits(ttree)
    assert j.dtype == t.dtype and j.shape == t.shape
    np.testing.assert_array_equal(j, t)


# -- synthetic HF state dicts (tests/test_convert.py's) ------------------------

def _llama_sd(nl=2, d=32, h=4, kh=2, inter=64, v=64, bias=False, seed=0):
    rng = np.random.default_rng(seed)
    dh = d // h

    def n(*shape):
        return rng.normal(size=shape).astype(np.float32)
    sd = {'model.embed_tokens.weight': n(v, d),
          'model.norm.weight': np.ones((d,), np.float32),
          'lm_head.weight': n(v, d)}
    for i in range(nl):
        p = f'model.layers.{i}'
        sd[f'{p}.self_attn.q_proj.weight'] = n(h * dh, d)
        sd[f'{p}.self_attn.k_proj.weight'] = n(kh * dh, d)
        sd[f'{p}.self_attn.v_proj.weight'] = n(kh * dh, d)
        sd[f'{p}.self_attn.o_proj.weight'] = n(d, h * dh)
        sd[f'{p}.mlp.gate_proj.weight'] = n(inter, d)
        sd[f'{p}.mlp.up_proj.weight'] = n(inter, d)
        sd[f'{p}.mlp.down_proj.weight'] = n(d, inter)
        sd[f'{p}.input_layernorm.weight'] = np.ones((d,), np.float32)
        sd[f'{p}.post_attention_layernorm.weight'] = np.ones((d,),
                                                             np.float32)
        if bias:
            for name, dim in (('q_proj', h * dh), ('k_proj', kh * dh),
                              ('v_proj', kh * dh), ('o_proj', d)):
                sd[f'{p}.self_attn.{name}.bias'] = n(dim)
    return sd


def _baichuan_sd(nl=1):
    sd = {k: v for k, v in _llama_sd(nl=nl).items()}
    for i in range(nl):
        p = f'model.layers.{i}.self_attn'
        sd[f'{p}.W_pack.weight'] = np.concatenate(
            [sd.pop(f'{p}.{n}_proj.weight') for n in 'qkv'], axis=0)
    return sd


def _qwen_sd():
    rng = np.random.default_rng(2)
    d, v, inter = 32, 64, 32

    def n(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return {'transformer.wte.weight': n(v, d),
            'transformer.ln_f.weight': np.ones((d,), np.float32),
            'lm_head.weight': n(v, d),
            'transformer.h.0.attn.c_attn.weight': n(3 * d, d),
            'transformer.h.0.attn.c_attn.bias': n(3 * d),
            'transformer.h.0.attn.c_proj.weight': n(d, d),
            'transformer.h.0.mlp.w1.weight': n(inter, d),
            'transformer.h.0.mlp.w2.weight': n(inter, d),
            'transformer.h.0.mlp.c_proj.weight': n(d, inter),
            'transformer.h.0.ln_1.weight': np.ones((d,), np.float32),
            'transformer.h.0.ln_2.weight': np.ones((d,), np.float32)}


SMALL = dict(head_num=4, size_per_head=8, inter_size=64, num_layer=2,
             vocab_size=64, rotary_embedding=8)
FAMILIES = {
    'llama': (lambda: _llama_sd(), dict(SMALL, model_name='llama',
                                        kv_head_num=2)),
    'internlm': (lambda: _llama_sd(bias=True),
                 dict(SMALL, model_name='internlm', kv_head_num=2,
                      attn_bias=True)),
    'baichuan': (lambda: _baichuan_sd(),
                 dict(SMALL, model_name='baichuan', kv_head_num=2,
                      num_layer=1)),
    'baichuan2': (lambda: _baichuan_sd(),
                  dict(SMALL, model_name='baichuan2', kv_head_num=2,
                       num_layer=1)),
    'qwen': (_qwen_sd, dict(SMALL, model_name='qwen', kv_head_num=4,
                            inter_size=32, num_layer=1, attn_bias=True,
                            qkv_bias_only=True, use_dynamic_ntk=True,
                            use_logn_attn=True)),
    # a tied embedding has no lm_head in the tree
    'llama-tied': (lambda: _llama_sd(),
                   dict(SMALL, model_name='llama', kv_head_num=2,
                        tie_word_embeddings=True)),
}


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_convert_hf_llama_matches_jax(family, dtype):
    """Every family of tests/test_convert.py, through both converters:
    the same keys and shapes, equal f32 values and identical bf16 bits
    (the baichuan2 lm_head normalised in numpy f32 on both sides)."""
    make_sd, kw = FAMILIES[family]
    sd = make_sd()
    jd, td = DTYPES[dtype]
    want = jhf.convert_hf_llama(sd, JModelConfig(**kw), jd)
    got = thf.convert_hf_llama(sd, ModelConfig(**kw), td)
    assert_trees_equal(want, got)
    # a torch state dict (as torch.load gives) converts to the same tree
    got_t = thf.convert_hf_llama({k: torch.from_numpy(v) for k, v in
                                  sd.items()}, ModelConfig(**kw), td)
    assert_trees_equal(want, got_t)


HF_CONFIGS = {
    'llama2': ({'architectures': ['LlamaForCausalLM'],
                'num_attention_heads': 32, 'hidden_size': 4096,
                'num_key_value_heads': 32, 'intermediate_size': 11008,
                'num_hidden_layers': 32, 'vocab_size': 32000,
                'rms_norm_eps': 1e-5, 'rope_theta': 10000.0,
                'max_position_embeddings': 4096}, 'llama2'),
    'qwen': ({'architectures': ['QWenLMHeadModel'],
              'num_attention_heads': 32, 'hidden_size': 4096,
              'intermediate_size': 22016, 'num_hidden_layers': 32,
              'vocab_size': 151936, 'layer_norm_epsilon': 1e-6,
              'seq_length': 8192, 'use_dynamic_ntk': True,
              'use_logn_attn': True}, ''),
    'internlm': ({'architectures': ['InternLMForCausalLM'], 'bias': True,
                  'num_attention_heads': 32, 'hidden_size': 4096,
                  'bos_token_id': 0, 'eos_token_id': 0}, 'internlm-7b'),
}
_ROPE_BASE = {'num_attention_heads': 8, 'hidden_size': 512,
              'num_hidden_layers': 2, 'vocab_size': 1000,
              'max_position_embeddings': 2048}
for _name, _scaling in (
        ('none', None),
        ('linear', {'type': 'linear', 'factor': 4.0}),
        ('yarn', {'rope_type': 'yarn', 'factor': 8.0,
                  'original_max_position_embeddings': 1024}),
        ('dynamic', {'type': 'dynamic', 'factor': 2.0}),
        ('llama3', {'rope_type': 'llama3', 'factor': 8.0,
                    'low_freq_factor': 1.0, 'high_freq_factor': 4.0,
                    'original_max_position_embeddings': 8192}),
        ('unsupported', {'type': 'su', 'factor': 2.0})):
    HF_CONFIGS[f'rope-{_name}'] = (
        dict(_ROPE_BASE, **({'rope_scaling': _scaling} if _scaling else {})),
        '')


def _outcome(fn):
    try:
        import dataclasses
        return ('ok', dataclasses.asdict(fn()))
    except Exception as e:  # noqa: BLE001 - compared, not handled
        return ('raises', type(e).__name__, str(e))


@pytest.mark.parametrize('case', sorted(HF_CONFIGS))
def test_config_from_hf_matches_jax(case):
    """Every config field equal, and the same ValueError on an
    unsupported rope_scaling type."""
    hf_cfg, name = HF_CONFIGS[case]
    got = _outcome(lambda: thf.config_from_hf(hf_cfg, name))
    assert got == _outcome(lambda: jhf.config_from_hf(hf_cfg, name))
    if case == 'rope-unsupported':
        assert got[:2] == ('raises', 'ValueError')


# -- files on disk ---------------------------------------------------------------

def _write_hf_dir(path, sd, fmt, hf_cfg):
    """An HF directory of ``sd``: one safetensors file, two shards, or
    pytorch_model .bin shards (torch.save, bf16 where asked)."""
    os.makedirs(path, exist_ok=True)
    keys = sorted(sd)
    half = len(keys) // 2
    if fmt == 'safetensors':
        write_safetensors(os.path.join(path, 'model.safetensors'),
                          {k: torch.from_numpy(sd[k]) for k in keys})
    elif fmt == 'sharded':
        for i, part in enumerate((keys[:half], keys[half:])):
            write_safetensors(
                os.path.join(path, f'model-0000{i + 1}-of-00002.safetensors'),
                {k: torch.from_numpy(sd[k]) for k in part})
    else:
        dt = torch.bfloat16 if fmt == 'bin-bf16' else torch.float32
        for i, part in enumerate((keys[:half], keys[half:])):
            torch.save({k: torch.from_numpy(sd[k]).to(dt) for k in part},
                       os.path.join(path,
                                    f'pytorch_model-0000{i + 1}.bin'))
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(hf_cfg, f)
    return str(path)


HF_SMALL = {'architectures': ['LlamaForCausalLM'], 'num_attention_heads': 4,
            'hidden_size': 32, 'num_key_value_heads': 2,
            'intermediate_size': 64, 'num_hidden_layers': 2,
            'vocab_size': 64, 'rms_norm_eps': 1e-6}


@pytest.mark.parametrize('fmt', ['safetensors', 'sharded', 'bin-f32',
                                 'bin-bf16'])
def test_load_hf_dir_matches_jax(tmp_path, fmt):
    """One safetensors file, two shards, and .bin shards at f32 and bf16
    load to the JAX package's config and tree (its loader reads the
    safetensors with the safetensors package)."""
    hf = _write_hf_dir(tmp_path / 'hf', _llama_sd(), fmt, HF_SMALL)
    jcfg, jp = jhf.load_hf_dir(hf, np.float32)
    cfg, p = thf.load_hf_dir(hf, torch.float32)
    assert jcfg == JModelConfig(**vars(cfg))
    assert_trees_equal(jp, p)
    if fmt == 'sharded':   # tests/test_convert.py's checks
        assert p['layers']['wqkv'].shape == (2, 32, (4 + 4) * 8)
        np.testing.assert_array_equal(
            p['layers']['wqkv'][0, :, :32].numpy(),
            _llama_sd()['model.layers.0.self_attn.q_proj.weight'].T)


def test_load_hf_dir_without_weights_raises(tmp_path):
    with open(tmp_path / 'config.json', 'w') as f:
        json.dump(HF_SMALL, f)
    with pytest.raises(FileNotFoundError, match='no weights'):
        thf.load_hf_dir(str(tmp_path))


def _meta_ckpt(tmp_path, nl=2, d=32, h=4, kh=2, inter=48, v=64, shards=2,
               scale=1.0):
    """A synthetic 2-shard meta-llama checkpoint (tests/test_convert.py's;
    ``scale`` scales the projections)."""
    rng = np.random.default_rng(1)
    dh = d // h

    def n(*shape):
        return rng.normal(size=shape) * scale
    full = {'tok_embeddings.weight': rng.normal(size=(v, d)),
            'norm.weight': np.ones((d,)),
            'output.weight': n(v, d)}
    for i in range(nl):
        p = f'layers.{i}'
        full[f'{p}.attention.wq.weight'] = n(h * dh, d)
        full[f'{p}.attention.wk.weight'] = n(kh * dh, d)
        full[f'{p}.attention.wv.weight'] = n(kh * dh, d)
        full[f'{p}.attention.wo.weight'] = n(d, h * dh)
        full[f'{p}.feed_forward.w1.weight'] = n(inter, d)
        full[f'{p}.feed_forward.w2.weight'] = n(d, inter)
        full[f'{p}.feed_forward.w3.weight'] = n(inter, d)
        full[f'{p}.attention_norm.weight'] = np.ones((d,))
        full[f'{p}.ffn_norm.weight'] = np.ones((d,))
    shard_sds = [dict() for _ in range(shards)]
    for key, arr in full.items():
        base = key.split('.', 2)[-1] if key.startswith('layers.') else key
        if base in tmeta._REPLICATED or key in tmeta._REPLICATED:
            parts = [arr] * shards
        else:
            parts = np.split(arr, shards, axis=tmeta._SHARD_DIM[base])
        for s, part in enumerate(parts):
            shard_sds[s][key] = torch.tensor(np.ascontiguousarray(part),
                                             dtype=torch.float32)
    mdir = tmp_path / 'meta7b'
    mdir.mkdir()
    with open(mdir / 'params.json', 'w') as f:
        json.dump({'dim': d, 'n_heads': h, 'n_kv_heads': kh,
                   'n_layers': nl, 'norm_eps': 1e-5, 'vocab_size': -1,
                   'multiple_of': 16}, f)
    for s, sd in enumerate(shard_sds):
        torch.save(sd, mdir / f'consolidated.{s:02d}.pth')
    return str(mdir)


@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_meta_llama_load_matches_jax(tmp_path, dtype):
    """A 2-shard meta-llama checkpoint: shard merge and the rope row
    permutation give the JAX package's config and tree, through
    load_meta_dir and through load_hf_dir's dispatch."""
    mdir = _meta_ckpt(tmp_path)
    assert tmeta.is_meta_llama(mdir) and jmeta.is_meta_llama(mdir)
    jd, td = DTYPES[dtype]
    jcfg, jp = jmeta.load_meta_dir(mdir, jd)
    for load in (tmeta.load_meta_dir, thf.load_hf_dir):
        cfg, p = load(mdir, td)
        assert jcfg == JModelConfig(**vars(cfg))
        assert cfg.vocab_size == 64 and cfg.inter_size == 48
        assert_trees_equal(jp, p)


def test_meta_rope_unpermute_matches_jax():
    w = np.random.default_rng(3).normal(size=(4 * 16, 8))
    np.testing.assert_array_equal(tmeta._unpermute_rope(w, 4),
                                  jmeta._unpermute_rope(w, 4))


# -- workspaces --------------------------------------------------------------

def _read_ws(path):
    """(config payload, {name: raw bits}) of a workspace."""
    with open(os.path.join(path, 'config.json')) as f:
        payload = json.load(f)
    flat = read_safetensors(os.path.join(path, 'weights.safetensors'))
    return payload, {k: (str(v.dtype), tuple(v.shape), _bits(v).tobytes())
                     for k, v in flat.items()}


def assert_same_workspace(a, b):
    pa, fa = _read_ws(a)
    pb, fb = _read_ws(b)
    assert pa == pb
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k] == fb[k], k


GS = 16   # group size of the small quantised checkpoints


@pytest.mark.parametrize('fmt', ['safetensors', 'bin-f32'])
def test_convert_hf_quantize_matches_jax(tmp_path, fmt):
    """convert_hf with and without --quantize writes the JAX converter's
    workspace: the same config.json and the same bytes of every tensor;
    tokenizer files are carried over."""
    hf = _write_hf_dir(tmp_path / 'hf', _llama_sd(), fmt, HF_SMALL)
    with open(os.path.join(hf, 'tokenizer_config.json'), 'w') as f:
        f.write('{}')
    for quantize in (False, True):
        j, t = tmp_path / f'j{quantize}', tmp_path / f't{quantize}'
        jconv.convert_hf(hf, str(j), 'llama', quantize, GS)
        tconv.convert_hf(hf, str(t), 'llama', quantize, GS)
        assert_same_workspace(str(j), str(t))
        assert os.path.exists(t / 'tokenizer_config.json')


def _awq_pack(q: np.ndarray) -> np.ndarray:
    """uint8 values 0..15 [..., N] -> AWQ int32 words [..., N/8]."""
    q = q.astype(np.uint32).reshape(*q.shape[:-1], -1, 8)
    words = np.zeros(q.shape[:-1], np.uint32)
    for slot in range(8):
        words |= q[..., AWQ_ORDER[slot]] << (4 * slot)
    return words.view(np.int32)


def _awq_dir(path, nl=2, d=64, h=4, kh=2, inter=128, v=64, bias=False):
    """An AWQ checkpoint (qweight / qzeros / scales per linear, fp16
    scales, bf16 dense tensors) drawn from a numpy seed."""
    rng = np.random.default_rng(7)
    dh = d // h
    sd = {'model.embed_tokens.weight': rng.normal(size=(v, d)),
          'model.norm.weight': rng.normal(size=(d,)),
          'lm_head.weight': rng.normal(size=(v, d))}
    sd = {k: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
          for k, a in sd.items()}

    def linear(prefix, k, n):
        sd[f'{prefix}.qweight'] = torch.from_numpy(_awq_pack(
            rng.integers(0, 16, size=(k, n))))
        sd[f'{prefix}.qzeros'] = torch.from_numpy(_awq_pack(
            rng.integers(0, 16, size=(k // GS, n))))
        sd[f'{prefix}.scales'] = torch.from_numpy(
            rng.uniform(1e-3, 2e-2, size=(k // GS, n)).astype(np.float16))
    for i in range(nl):
        p = f'model.layers.{i}'
        linear(f'{p}.self_attn.q_proj', d, h * dh)
        linear(f'{p}.self_attn.k_proj', d, kh * dh)
        linear(f'{p}.self_attn.v_proj', d, kh * dh)
        linear(f'{p}.self_attn.o_proj', h * dh, d)
        linear(f'{p}.mlp.gate_proj', d, inter)
        linear(f'{p}.mlp.up_proj', d, inter)
        linear(f'{p}.mlp.down_proj', inter, d)
        for n in ('input_layernorm', 'post_attention_layernorm'):
            sd[f'{p}.{n}.weight'] = torch.from_numpy(
                rng.normal(size=(d,)).astype(np.float32)).to(torch.bfloat16)
        if bias:
            for n, dim in (('q', h * dh), ('k', kh * dh), ('v', kh * dh)):
                sd[f'{p}.self_attn.{n}_proj.bias'] = torch.from_numpy(
                    rng.normal(size=(dim,)).astype(np.float16))
    os.makedirs(path)
    write_safetensors(os.path.join(path, 'model.safetensors'), sd)
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(dict(HF_SMALL, hidden_size=d, intermediate_size=inter,
                       num_hidden_layers=nl, vocab_size=v), f)
    return str(path)


@pytest.mark.parametrize('bias', [False, True])
def test_convert_awq_matches_jax(tmp_path, bias):
    """convert_awq writes the JAX converter's workspace byte for byte:
    nibble order [0,2,4,6,1,3,5,7], fp16 scales to bf16, q/k/v fused, the
    biases of a checkpoint that has them."""
    awq = _awq_dir(tmp_path / 'awq', bias=bias)
    from lmdeploy_tpu.convert.awq import convert_awq as jconvert_awq
    jconvert_awq(awq, str(tmp_path / 'j'), 'llama', GS)
    convert_awq(awq, str(tmp_path / 't'), 'llama', GS)
    assert_same_workspace(str(tmp_path / 'j'), str(tmp_path / 't'))
    qw = np.array([[0x76543210, -1]], np.int64).astype(np.int32)
    from lmdeploy_tpu.convert.awq import unpack_awq_int32 as junpack
    np.testing.assert_array_equal(unpack_awq_int32(qw), junpack(qw))
    assert unpack_awq_int32(qw)[0, :8].tolist() == [0, 4, 1, 5, 2, 6, 3, 7]


def test_each_package_loads_the_others_conversion(tmp_path):
    """The port's quantised workspace loads in the JAX package and the
    JAX converter's in the port, to equal trees."""
    from lmdeploy_tpu_torch.convert.workspace import load_workspace
    hf = _write_hf_dir(tmp_path / 'hf', _llama_sd(d=64, inter=128),
                       'safetensors', dict(HF_SMALL, hidden_size=64,
                                           intermediate_size=128))
    jconv.convert_hf(hf, str(tmp_path / 'j'), 'llama', True, GS)
    tconv.convert_hf(hf, str(tmp_path / 't'), 'llama', True, GS)
    jcfg, _, jp, _ = jconv.load_workspace(str(tmp_path / 't'))
    want = jconv.load_workspace(str(tmp_path / 'j'))
    assert jcfg == want[0]
    assert_trees_equal(want[2]['layers']['attn_norm'],
                       torch.from_numpy(np.asarray(
                           jp['layers']['attn_norm'], np.float32)).to(
                           torch.bfloat16))
    for name in ('wqkv', 'wo', 'w1', 'w3', 'w2'):
        for part in ('qvals', 'scales', 'zeros'):
            np.testing.assert_array_equal(
                np.asarray(getattr(jp['layers'][name], part)),
                np.asarray(getattr(want[2]['layers'][name], part)))
    cfg, _, p, _ = load_workspace(str(tmp_path / 'j'), 'cpu')
    _, _, p2, _ = load_workspace(str(tmp_path / 't'), 'cpu')
    assert cfg == ModelConfig(**vars(want[0]))
    for name in ('wqkv', 'wo', 'w1', 'w3', 'w2'):
        a, b = p['layers'][name], p2['layers'][name]
        assert torch.equal(a.packed, b.packed)
        assert torch.equal(a.scales, b.scales) and torch.equal(a.sz, b.sz)


@pytest.mark.parametrize('weight_type', ['bf16', 'int4'])
def test_random_workspace_matches_jax_shapes(tmp_path, weight_type):
    """converter.main --random: the JAX converter's config, tensor names,
    shapes and dtypes (the values come from another generator)."""
    argv = ['--random', 'tiny', '--weight-type', weight_type]
    tconv.main(argv + [str(tmp_path / 't')])
    jconv.main(argv + [str(tmp_path / 'j')])
    pj, fj = _read_ws(str(tmp_path / 'j'))
    pt, ft = _read_ws(str(tmp_path / 't'))
    assert pj == pt
    assert {k: v[:2] for k, v in fj.items()} == \
        {k: v[:2] for k, v in ft.items()}
    a = read_safetensors(str(tmp_path / 't' / 'weights.safetensors'))
    assert float(a['tok_embedding'].float().std()) == pytest.approx(
        0.02, rel=0.1)
    tconv.main(argv + [str(tmp_path / 't2')])   # seeded: the same bytes
    assert _read_ws(str(tmp_path / 't2')) == (pt, ft)


def test_read_safetensors_memmap_equals_whole_file_reader(tmp_path):
    """The memory-mapped reader gives what reading the whole file did, on
    every dtype it maps (and an empty tensor and a scalar)."""
    import struct

    def old_reader(path):
        from lmdeploy_tpu_torch.convert.workspace import _NP_DTYPES
        with open(path, 'rb') as f:
            (n,) = struct.unpack('<Q', f.read(8))
            header = json.loads(f.read(n))
            data = f.read()
        out = {}
        for name, meta in header.items():
            if name == '__metadata__':
                continue
            begin, end = meta['data_offsets']
            arr = np.frombuffer(data[begin:end],
                                _NP_DTYPES[meta['dtype']]).reshape(
                meta['shape'])
            t = torch.from_numpy(arr.copy())
            if meta['dtype'] == 'BF16':
                t = t.view(torch.int16).view(torch.bfloat16)
            out[name] = t
        return out
    g = torch.Generator().manual_seed(0)
    tensors = {
        'f32': torch.randn(3, 5, generator=g),
        'f16': torch.randn(7, generator=g).half(),
        'bf16': torch.randn(2, 3, 4, generator=g).to(torch.bfloat16),
        'i32': torch.randint(-2 ** 31, 2 ** 31 - 1, (9,), generator=g,
                             dtype=torch.int32),
        'u8': torch.randint(0, 256, (5, 3), generator=g, dtype=torch.uint8),
        'empty': torch.zeros(0, 4),
        'scalar': torch.tensor(1.5),
    }
    path = str(tmp_path / 'x.safetensors')
    write_safetensors(path, tensors)
    got, want = read_safetensors(path), old_reader(path)
    assert sorted(got) == sorted(want) == sorted(tensors)
    for k in tensors:
        assert got[k].dtype == want[k].dtype == tensors[k].dtype
        assert torch.equal(got[k], want[k]) and torch.equal(got[k],
                                                            tensors[k])
    empty = str(tmp_path / 'none.safetensors')
    write_safetensors(empty, {})
    assert read_safetensors(empty) == {}


# -- build_engine on an HF directory ---------------------------------------------

def _engine_hf_dir(tmp_path):
    """An HF llama directory at test_torch_engine.py's widths (bf16
    safetensors), with the JAX package's tree of it."""
    rng = np.random.default_rng(11)
    d, h, kh, dh, inter, v, nl = 256, 2, 1, 128, 256, 256, 2

    def w(*shape, s=0.06):
        return (rng.normal(size=shape) * s).astype(np.float32)
    sd = {'model.embed_tokens.weight': w(v, d, s=1.0),
          'model.norm.weight': np.ones(d, np.float32),
          'lm_head.weight': w(v, d)}
    for i in range(nl):
        p = f'model.layers.{i}'
        sd.update({f'{p}.self_attn.q_proj.weight': w(h * dh, d),
                   f'{p}.self_attn.k_proj.weight': w(kh * dh, d),
                   f'{p}.self_attn.v_proj.weight': w(kh * dh, d),
                   f'{p}.self_attn.o_proj.weight': w(d, h * dh),
                   f'{p}.mlp.gate_proj.weight': w(inter, d),
                   f'{p}.mlp.up_proj.weight': w(inter, d),
                   f'{p}.mlp.down_proj.weight': w(d, inter),
                   f'{p}.input_layernorm.weight': np.ones(d, np.float32),
                   f'{p}.post_attention_layernorm.weight':
                       np.ones(d, np.float32)})
    path = tmp_path / 'llama-hf'
    os.makedirs(path)
    write_safetensors(str(path / 'model.safetensors'),
                      {k: torch.from_numpy(a).to(torch.bfloat16)
                       for k, a in sd.items()})
    with open(path / 'config.json', 'w') as f:
        json.dump({'architectures': ['LlamaForCausalLM'],
                   'num_attention_heads': h, 'num_key_value_heads': kh,
                   'hidden_size': d, 'intermediate_size': inter,
                   'num_hidden_layers': nl, 'vocab_size': v,
                   'max_position_embeddings': 128, 'eos_token_id': 2}, f)
    return str(path)


PROMPTS = [[5, 9, 200, 31, 77], list(range(40, 60)),
           [(7 * i) % 250 + 3 for i in range(45)]]


def test_build_engine_on_hf_dir_matches_jax(tmp_path):
    """build_engine(hf_dir, device='cpu') serves bf16 dense weights: the
    tree equals the JAX build_engine's, greedy streams agree with the JAX
    engine's up to near-ties, and prompt logits lie within 2% of
    max|logit| of the JAX engine's (test_torch_engine.py's near-tie
    tolerance; both round activations to bf16 before each product)."""
    hf = _engine_hf_dir(tmp_path)
    ecfg = dict(ECFG, session_len=128)
    jeng = jbuild_engine(hf, engine_config=JEngineConfig(**ecfg))
    try:
        jinst = jeng.create_instance()
        jouts = [jinst.infer(100 + i, p, gen_config=JGen(
            max_new_tokens=10, top_k=1, ignore_eos=True),
            sequence_end=True).token_ids for i, p in enumerate(PROMPTS)]
        jlogits = jinst.decode(PROMPTS[2])
        jp, jcfg = jeng.params, jeng.cfg
    finally:
        jeng.shutdown()
    eng = build_engine(hf, engine_config=EngineConfig(**ecfg), device='cpu')
    try:
        assert eng.cfg == ModelConfig(**vars(jcfg))
        assert eng.params['layers']['wqkv'].dtype == torch.bfloat16
        inst = eng.create_instance()
        touts = [inst.infer(200 + i, p, gen_config=GenerationConfig(
            max_new_tokens=10, top_k=1, ignore_eos=True),
            sequence_end=True).token_ids for i, p in enumerate(PROMPTS)]
        tlogits = inst.decode(PROMPTS[2])
    finally:
        eng.shutdown()
    assert_trees_equal(jax.tree.map(np.asarray, dict(jp)),
                       {k: v for k, v in eng.params.items()})
    assert [len(t) for t in touts] == [10] * 3
    assert agree_up_to_near_tie(PROMPTS, jouts, touts, jp, jcfg) >= 12
    assert tlogits.shape == np.asarray(jlogits).shape == (45, 256)
    scale = np.abs(np.asarray(jlogits)).max()
    assert np.abs(tlogits - np.asarray(jlogits)).max() <= 0.02 * scale


def test_build_engine_on_meta_dir_serves(tmp_path):
    """build_engine takes a meta-llama directory too: its bf16 tree is
    load_meta_dir's, it serves a request, and its prompt logits lie
    within 2% of max|logit| of the JAX build_engine's (the tolerance of
    test_build_engine_on_hf_dir_matches_jax)."""
    mdir = _meta_ckpt(tmp_path, scale=0.15)
    ecfg = dict(max_batch_size=2, session_len=64, page_size=16,
                num_pages=8, max_context_token_num=32,
                prefill_buckets=(16, 32), step_length=4)
    ids = [(5 * i) % 60 + 3 for i in range(20)]
    eng = build_engine(mdir, engine_config=EngineConfig(**ecfg),
                       device='cpu')
    try:
        _, want = tmeta.load_meta_dir(mdir, torch.bfloat16)
        assert_trees_equal(want, eng.params)
        inst = eng.create_instance()
        out = inst.infer(1, ids, gen_config=GenerationConfig(
            max_new_tokens=6, top_k=1, ignore_eos=True), sequence_end=True)
        got = inst.decode(ids)
    finally:
        eng.shutdown()
    assert len(out.token_ids) == 6
    jeng = jbuild_engine(mdir, engine_config=JEngineConfig(**ecfg))
    try:
        jlogits = np.asarray(jeng.create_instance().decode(ids))
    finally:
        jeng.shutdown()
    assert got.shape == jlogits.shape == (20, 64)
    assert np.abs(got - jlogits).max() <= 0.02 * np.abs(jlogits).max()
