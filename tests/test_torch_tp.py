"""The port's tensor-parallel weight and pool shards (parallel/tp.py)
against the JAX package's ``prepare_params_for_tp`` +
``pack_params_for_tp`` sliced by ``param_pspecs`` / ``cache_pspecs``, and
its frame channel; no engine."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from lmdeploy_tpu.config import ModelConfig as JModelConfig
from lmdeploy_tpu.kvcache.paged import init_cache as jinit_cache
from lmdeploy_tpu.models import llama as jllama
from lmdeploy_tpu.parallel import tp as jtp
from lmdeploy_tpu_torch.config import ModelConfig
from lmdeploy_tpu_torch.convert.workspace import params_from_numpy
from lmdeploy_tpu_torch.kvcache.paged import init_cache
from lmdeploy_tpu_torch.ops.linear import (PackedInt4Weight,
                                           QuantizedWeight)
from lmdeploy_tpu_torch.parallel import tp as ttp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# N of every W4A16 weight a multiple of 128 after padding, so that the
# JAX package packs what the port packs (its kernel wants lane-aligned N)
BASE = dict(head_num=8, kv_head_num=4, size_per_head=32, inter_size=384,
            num_layer=2, vocab_size=200, rotary_embedding=32,
            max_position_embeddings=128, session_len=64, end_id=2)


def _flat(tree, prefix=''):
    """{path: leaf} over dicts and weight dataclasses (JAX or port)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f'{prefix}{k}.'))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            out.update(_flat(getattr(tree, f.name), f'{prefix}{f.name}.'))
    else:
        out[prefix[:-1]] = tree
    return out


def _bytes(x) -> tuple:
    if isinstance(x, torch.Tensor):
        x = x.contiguous().cpu()
        return tuple(x.shape), str(x.dtype).split('.')[-1], \
            x.view(torch.uint8).numpy().tobytes()
    x = np.ascontiguousarray(np.asarray(x))
    return x.shape, str(x.dtype), x.tobytes()


def _jax_rank_shards(jp, cfg, tp):
    """The JAX preparation, each leaf cut per rank as param_pspecs shards
    it: {path: [rank block, ...]}."""
    jp = jtp.pack_params_for_tp(jtp.prepare_params_for_tp(jp, cfg, tp), tp)
    specs = _flat(jax.tree_util.tree_map(
        lambda s: s, jtp.param_pspecs(jp),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))
    out = {}
    for path, leaf in _flat(jp).items():
        arr = np.asarray(leaf)
        spec = tuple(specs[path])
        dim = next((i for i, a in enumerate(spec) if a == jtp.TP_AXIS), None)
        out[path] = [arr if dim is None else np.split(arr, tp, axis=dim)[r]
                     for r in range(tp)]
    return out


def _port_params(jp, form):
    """The same parameters as the port holds them: 'bytes' keeps W4A16
    byte-per-int4, 'packed' loads them as a workspace does (nibble-packed
    where packable)."""
    tree = jax.tree_util.tree_map(np.asarray, jp)
    if form == 'packed':
        def np_tree(t):
            if isinstance(t, dict):
                return {k: np_tree(v) for k, v in t.items()}
            if dataclasses.is_dataclass(t):
                return {f.name: np.asarray(getattr(t, f.name))
                        for f in dataclasses.fields(t)}
            return np.asarray(t)
        return params_from_numpy(np_tree(jp), 'cpu')

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if dataclasses.is_dataclass(t):
            return QuantizedWeight(**{f.name: conv(getattr(t, f.name))
                                      for f in dataclasses.fields(t)})
        if t.dtype == jnp.bfloat16:
            return torch.from_numpy(t.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(t))
    return conv(tree)


CASES = {
    'dense': dict(),
    'w4a16': dict(weight_type='int4', group_size=32),
    'w4a16-inter-padding': dict(weight_type='int4', group_size=32,
                                inter_size=320),
    'w4a16-bqkv': dict(weight_type='int4', group_size=32, attn_bias=True),
    'tied-embeddings': dict(tie_word_embeddings=True),
    'w4a16-odd-wo-groups': dict(weight_type='int4', group_size=128),
}


@pytest.mark.parametrize('form', ['bytes', 'packed'])
@pytest.mark.parametrize('case', list(CASES))
@pytest.mark.parametrize('tp', [2, 4])
def test_rank_shards_byte_equal_jax_preparation(tp, case, form):
    """Every rank's block from prepare_params_for_tp + pack_params_for_tp
    + shard_params equals, byte for byte, the JAX package's prepared
    arrays cut by param_pspecs, for byte-per-int4 and for already packed
    W4A16 inputs.  A packed wo with an odd group count per rank has no
    zero points to go back to byte-per-int4 with, so it repacks per rank
    (where the JAX package keeps bytes) and the card refuses it; groups
    that would straddle ranks fail both packages' assertion."""
    over = CASES[case]
    cfg = dict(BASE, **over)
    jcfg, pcfg = JModelConfig(**cfg), ModelConfig(**cfg)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    if 'group_size' in over:
        jp = jllama.quantize_params(jp, jcfg, group_size=over['group_size'])
    if case == 'w4a16-bqkv':
        rng = np.random.default_rng(1)
        jp['layers']['bqkv'] = jnp.asarray(rng.normal(
            size=jp['layers']['bqkv'].shape).astype(np.float32))
    port = _port_params(jp, form)
    odd_wo = case == 'w4a16-odd-wo-groups'
    if odd_wo and tp == 4:
        # 2 groups of wo's K over 4 ranks: both packages refuse
        with pytest.raises(AssertionError, match='straddle'):
            jtp.prepare_params_for_tp(jp, jcfg, tp)
        with pytest.raises(AssertionError, match='straddle'):
            ttp.prepare_params_for_tp(port, pcfg, tp)
        return
    want = _jax_rank_shards(jp, jcfg, tp)
    prepared = ttp.pack_params_for_tp(
        ttp.prepare_params_for_tp(port, pcfg, tp), tp)
    for rank in range(tp):
        got = _flat(ttp.shard_params(prepared, tp, rank))
        if odd_wo and form == 'packed':
            assert isinstance(prepared['layers']['wo'], PackedInt4Weight)
            got = {k: v for k, v in got.items()
                   if not k.startswith('layers.wo.')}
            with pytest.raises(NotImplementedError, match="'wo' of rank"):
                ttp.check_kernel_shapes(ttp.shard_params(prepared, tp,
                                                         rank), rank)
        else:
            assert set(got) == set(want), (sorted(got), sorted(want))
        for path, t in got.items():
            assert _bytes(t) == _bytes(want[path][rank]), (path, rank)
    if case == 'w4a16-inter-padding':
        assert prepared['layers']['w2'].k == {2: 384, 4: 512}[tp]
    if case == 'tied-embeddings':
        assert 'lm_head' in prepared and 'lm_head' not in port


@pytest.mark.parametrize('pool', ['bf16', 'int8', 'int4-per-head',
                                  'int4-dynamic'])
@pytest.mark.parametrize('dp,tp', [(1, 2), (2, 2), (1, 4)])
def test_cache_shards_match_cache_pspecs(dp, tp, pool):
    """shard_cache cuts a pool as cache_pspecs shards it over the (dp, tp)
    mesh: pages by dp group, KV heads by tp rank, per-head qparams by
    head, dynamic qparams like the payload; each engine rank allocates
    that shape directly (init_cache at its local pages and heads)."""
    L, P, page, kh, dh = 2, 8, 4, 4, 32
    rng = np.random.default_rng(0)
    kw, jkw = {}, {}
    dtype, jdtype = torch.float32, jnp.float32
    if pool == 'int8':
        dtype, jdtype = torch.int8, jnp.int8
        kw['kv_scales'] = jkw['kv_scales'] = [
            rng.uniform(0.01, 0.1, L).astype(np.float32) for _ in range(4)]
    elif pool == 'int4-per-head':
        dtype, jdtype = torch.uint8, jnp.uint8
        kw['kv_scales'] = jkw['kv_scales'] = [
            rng.uniform(0.01, 0.1, (L, kh)).astype(np.float32)
            for _ in range(4)]
    elif pool == 'int4-dynamic':
        dtype, jdtype = torch.uint8, jnp.uint8
        kw['dynamic_scales'] = jkw['dynamic_scales'] = True
    full = init_cache(L, P, page, kh, dh, dtype, 'cpu', **kw)
    payload = rng.integers(0, 100, full.k.shape).astype(np.int8)
    full.k.copy_(torch.from_numpy(payload).to(dtype))
    jcache = jinit_cache(L, P, page, kh, dh, jdtype, **jkw)
    jcache = dataclasses.replace(jcache, k=jnp.asarray(payload).astype(
        jdtype))
    mesh = jtp.make_mesh(tp, dp)
    specs = jtp.cache_pspecs(dp_axis=jtp.DP_AXIS if dp > 1 else None,
                             per_head_scales=pool == 'int4-per-head',
                             token_scales=pool == 'int4-dynamic')
    jk = jax.device_put(jcache.k, NamedSharding(mesh, specs.k))
    jscale = jcache.k_scale
    jscale_sh = NamedSharding(mesh, specs.k_scale).shard_shape(jscale.shape)
    for g in range(dp):
        for r in range(tp):
            got = ttp.shard_cache(full, tp, r, dp, g)
            dev = mesh.devices[g, r]
            want_k = next(s.data for s in jk.addressable_shards
                          if s.device == dev)
            assert _bytes(got.k) == _bytes(np.asarray(want_k).view(
                np.uint8 if pool.startswith('int4') else np.asarray(
                    want_k).dtype)), (g, r)
            if pool == 'int4-dynamic':
                # one [.., KH, 4, G] pool for the JAX package's four
                # [.., KH, G] pools
                assert got.dyn.shape[:4] + got.dyn.shape[5:] == jscale_sh
            elif pool == 'int4-per-head':
                assert tuple(got.k_scale.shape) == jscale_sh
                np.testing.assert_array_equal(
                    got.k_scale.numpy(),
                    np.split(kw['kv_scales'][0], tp, axis=1)[r])
            else:
                assert tuple(got.k_scale.shape) == jscale_sh == (L,)
            scales = ttp.shard_kv_scales(kw.get('kv_scales'), tp, r)
            local = init_cache(L, P // dp, page, kh // tp, dh, dtype, 'cpu',
                               kv_scales=scales,
                               dynamic_scales=pool == 'int4-dynamic')
            for name in ('k', 'v', 'qparams', 'dyn'):
                a, b = getattr(local, name), getattr(got, name)
                assert (a is None and b is None) or a.shape == b.shape, name
            torch.testing.assert_close(local.qparams, got.qparams)


def test_frame_channel_round_trip_of_a_multi_chunk_payload(tmp_path):
    """FrameChannel carries a frame larger than one chunk from rank 0 to
    rank 1 over gloo (two processes, a 60 s group timeout), then a small
    one, in order."""
    code = '''
import datetime, sys
import numpy as np
import torch.distributed as dist
from lmdeploy_tpu_torch.parallel.multihost import FrameChannel, _FRAME_CHUNK
rank, port = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
ch = FrameChannel()
big = ('frame', np.arange(3 * _FRAME_CHUNK // 8 + 5, dtype=np.int64),
       {'k': list(range(100))})
if rank == 0:
    ch.send(big)
    ch.send(('small',))
else:
    got = ch.recv()
    assert got[0] == 'frame' and got[2] == big[2]
    np.testing.assert_array_equal(got[1], big[1])
    assert ch.recv() == ('small',)
    print('OK', len(got[1]) * 8 > 3 * _FRAME_CHUNK)
dist.destroy_process_group()
'''
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, '-c', code, str(r),
                               str(port)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=90) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[1][0].strip() == 'OK True'
