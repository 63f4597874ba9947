"""The port's pipeline-parallel preparation and cuts (parallel/pp.py,
parallel/tp.py with pp) against the JAX package's ``prepare_params_for_pp``
and its ``pp_param_pspecs`` / ``pp_cache_pspecs`` over ``make_mesh_3d``,
and the rank layout against that mesh's device order; no ranks."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from lmdeploy_tpu.config import ModelConfig as JModelConfig
from lmdeploy_tpu.kvcache.paged import init_cache as jinit_cache
from lmdeploy_tpu.models import llama as jllama
from lmdeploy_tpu.parallel import pp as jpp
from lmdeploy_tpu.parallel import tp as jtp
from lmdeploy_tpu_torch.config import ModelConfig
from lmdeploy_tpu_torch.kvcache.paged import init_cache
from lmdeploy_tpu_torch.parallel import pp as tpp
from lmdeploy_tpu_torch.parallel import tp as ttp
from test_torch_tp import BASE, _bytes, _flat, _port_params

# four layers: two or four stages; W4A16 N a multiple of 128 after
# padding, as in test_torch_tp.py
CFG = dict(BASE, num_layer=4)
CASES = {
    'dense': (dict(), 'bytes'),
    'w4a16-bytes': (dict(weight_type='int4', group_size=32), 'bytes'),
    'w4a16-packed': (dict(weight_type='int4', group_size=32), 'packed'),
    'tied-embeddings': (dict(tie_word_embeddings=True), 'bytes'),
}


def _cut(arr, spec, stage, rank, pp, tp):
    """``arr``'s block on the mesh device of (stage, rank) under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis == (jpp.PP_AXIS, jtp.TP_AXIS):
            arr = np.split(arr, pp * tp, axis=dim)[stage * tp + rank]
        elif axis == jpp.PP_AXIS:
            arr = np.split(arr, pp, axis=dim)[stage]
        elif axis == jtp.TP_AXIS:
            arr = np.split(arr, tp, axis=dim)[rank]
    return arr


def _jax_stage_shards(jp, cfg, tp, pp, pack):
    """The JAX engine's preparation (prepare_params_for_tp, then
    prepare_params_for_pp, then pack_params_for_tp when ``pack``: as both
    engines do with packed residency on, the port's default), each leaf
    cut per (stage, rank) as pp_param_pspecs shards it: {path: [block of
    stage * tp + rank]}."""
    jp = jpp.prepare_params_for_pp(jtp.prepare_params_for_tp(jp, cfg, tp),
                                   pp, tp)
    if pack:
        jp = jtp.pack_params_for_tp(jp, tp)
    specs = _flat(jax.tree_util.tree_map(
        lambda s: s, jpp.pp_param_pspecs(jp),
        is_leaf=lambda s: isinstance(s, PartitionSpec)))
    return {path: [_cut(np.asarray(leaf), tuple(specs[path]), s, r, pp, tp)
                   for s in range(pp) for r in range(tp)]
            for path, leaf in _flat(jp).items()}


def _jax_params(over):
    jcfg = JModelConfig(**dict(CFG, **over))
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(5), jnp.float32)
    if 'group_size' in over:
        jp = jllama.quantize_params(jp, jcfg, group_size=over['group_size'])
    return jcfg, jp


@pytest.mark.parametrize('case', list(CASES))
@pytest.mark.parametrize('pp,tp', [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_stage_shards_byte_equal_jax_pp_cut(pp, tp, case):
    """prepare_params_for_pp's output equals the JAX function's byte for
    byte (lm_head materialised from a tied embedding, its vocab padded to
    a multiple of 128 * pp * tp), and every rank's block from
    ``rank_shards`` (prepare for tp, prepare for pp, pack for tp, then the
    stage's layers and its tp block, lm_head's (pp, tp) block) equals the
    JAX preparation cut by pp_param_pspecs."""
    over, form = CASES[case]
    jcfg, jp = _jax_params(over)
    port = _port_params(jp, form)
    got = _flat(tpp.prepare_params_for_pp(port, pp, tp))
    want = _flat(jax.tree_util.tree_map(
        np.asarray, jpp.prepare_params_for_pp(jp, pp, tp)))
    assert _bytes(got['lm_head']) == _bytes(want['lm_head'])
    assert got['lm_head'].shape[-1] % (128 * pp * tp) == 0
    if case == 'tied-embeddings':
        assert 'lm_head' not in port

    want = _jax_stage_shards(jp, jcfg, tp, pp, True)
    shards = tpp.rank_shards(port, ModelConfig(**dict(CFG, **over)), tp, pp)
    assert len(shards) == pp * tp
    for i, shard in enumerate(shards):
        flat = _flat(shard)
        assert set(flat) == set(want), (sorted(flat), sorted(want))
        for path, t in flat.items():
            assert _bytes(t) == _bytes(want[path][i]), (path, i)
        assert shard['layers']['attn_norm'].shape[0] == CFG['num_layer'] // pp


@pytest.mark.parametrize('pool', ['bf16', 'int8', 'int4-per-head',
                                  'int4-dynamic'])
@pytest.mark.parametrize('dp,pp,tp', [(1, 2, 2), (2, 2, 1), (2, 2, 2),
                                      (1, 4, 2)])
def test_cache_shards_match_pp_cache_pspecs(dp, pp, tp, pool):
    """shard_cache cuts a pool as pp_cache_pspecs shards it over the (dp,
    pp, tp) mesh: layers by stage, pages by dp group, KV heads by tp rank;
    static per-layer qparams [L] to [L/pp], per-head [L, KH] to [L/pp,
    KH/tp], the dynamic qparam pool like the payload; shard_kv_scales
    gives each rank the qparams of the pool it allocates directly."""
    L, P, page, kh, dh = 4, 8, 4, 4, 32
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
    mesh = jpp.make_mesh_3d(dp, pp, tp)
    specs = jpp.pp_cache_pspecs(dp_axis=jtp.DP_AXIS if dp > 1 else None,
                                per_head_scales=pool == 'int4-per-head',
                                token_scales=pool == 'int4-dynamic')
    jk = jax.device_put(jcache.k, NamedSharding(mesh, specs.k))
    js = jax.device_put(jcache.k_scale, NamedSharding(mesh, specs.k_scale))
    for g in range(dp):
        for s in range(pp):
            for r in range(tp):
                got = ttp.shard_cache(full, tp, r, dp, g, pp, s)
                dev = mesh.devices[g, s, r]
                want_k = np.asarray(next(x.data for x in jk.addressable_shards
                                         if x.device == dev))
                want_s = np.asarray(next(x.data for x in js.addressable_shards
                                         if x.device == dev))
                assert _bytes(got.k) == _bytes(want_k.view(
                    np.uint8 if pool.startswith('int4') else want_k.dtype))
                if pool == 'int4-dynamic':
                    # one [.., KH, 4, G] pool for the JAX package's four
                    # [.., KH, G] pools
                    assert got.dyn.shape[:4] + got.dyn.shape[5:] == \
                        want_s.shape
                else:
                    np.testing.assert_array_equal(got.k_scale.numpy(),
                                                  want_s)
                scales = ttp.shard_kv_scales(kw.get('kv_scales'), tp, r, pp,
                                             s)
                local = init_cache(L // pp, P // dp, page, kh // tp, dh,
                                   dtype, 'cpu', kv_scales=scales,
                                   dynamic_scales=pool == 'int4-dynamic')
                for name in ('k', 'v', 'qparams', 'dyn'):
                    a, b = getattr(local, name), getattr(got, name)
                    assert (a is None and b is None) or a.shape == b.shape
                torch.testing.assert_close(local.qparams, got.qparams)


@pytest.mark.parametrize('dp,pp,tp', [(1, 2, 2), (2, 2, 1), (2, 2, 2)])
def test_rank_layout_is_make_mesh_3d_device_order(dp, pp, tp):
    """Global rank (g * pp + s) * tp + r is make_mesh_3d's device at (g, s,
    r); each rank's dp / pp / tp coordinates follow, and the tp, stage and
    vocab groups are the mesh's tp rows, pp columns and (pp, tp) blocks
    (the vocab group in the order P(None, (pp, tp)) splits lm_head)."""
    ids = np.vectorize(lambda d: d.id)(jpp.make_mesh_3d(dp, pp, tp).devices)
    assert sorted(ids.flatten()) == list(range(dp * pp * tp))
    for (g, s, r), rank in np.ndenumerate(ids):
        ranks = ttp.Ranks(tp=tp, dp=dp, rank=int(rank), device_group=None,
                          host_group=None, backend='gloo', pp=pp)
        assert (ranks.dp_rank, ranks.pp_rank, ranks.tp_rank) == (g, s, r)
        assert ranks.global_rank(g, s, r) == rank
        assert ranks.world == dp * pp * tp
    layout = ttp.rank_layout(tp, dp, pp)
    assert layout['tp'] == [ids[g, s].tolist() for g in range(dp)
                            for s in range(pp)]
    assert layout['stage'] == [ids[g, :, r].tolist() for g in range(dp)
                               for r in range(tp)]
    assert layout['vocab'] == [ids[g].flatten().tolist() for g in range(dp)]
