"""Tensor parallelism: per-rank weight and pool shards, and the ranks'
process groups.

Port of ``lmdeploy_tpu/parallel/tp.py``.  The reference's NCCL design
(SURVEY.md §2.3): column-split QKV / gate / up, row-split O / down with an
all-reduce after each, a vocab-split lm_head whose logits are gathered,
KV heads split over the ranks.  The JAX package runs it as one
``shard_map`` program; here each rank is a process that holds its own
contiguous block of every weight and of the KV pool, and the forward
(``models/llama.py``) calls ``torch.distributed`` where the JAX code calls
``psum`` / ``all_gather``.

The host-side preparation (:func:`prepare_params_for_tp`,
:func:`pack_params_for_tp`) is the JAX package's, bit for bit, so that a
contiguous shard of each tensor (:func:`shard_params`) is rank-correct; it
also takes weights that are already nibble-packed
(:class:`PackedInt4Weight`, the port's load form), re-laying them out to
the same bytes.

dp groups (``EngineConfig.dp``) are independent continuous batches: group
g's ranks hold slots ``[g * B/dp, (g+1) * B/dp)`` and a pool of
``num_pages / dp`` pages addressed by pool-local ids.  Pipeline stages
(``EngineConfig.pp``, ``parallel/pp.py``) cut the stacked layers: rank
``(g * pp + s) * tp + r`` is tp rank r of stage s of group g, the JAX
package's ``make_mesh_3d`` device order (dp outermost, tp innermost).
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from ..config import ModelConfig
from ..kvcache.paged import KVCache
from ..ops.cuda.quant_matmul import unpack_nibbles
from ..ops.linear import (PackedInt4Weight, QuantizedWeight, pack_nibbles,
                          packed_int4_enabled)

# ---------------------------------------------------------------------------
# host-side weight preparation (load-time equivalent of deploy.py's per-rank
# interleave)
# ---------------------------------------------------------------------------


def _qkv_column_perm(cfg: ModelConfig, tp: int) -> torch.Tensor:
    """Permutation of the fused-QKV output dim from [Q|K|V] global layout to
    concat-per-rank [q_r|k_r|v_r] so a plain contiguous shard of the last
    dim hands every rank its own q/k/v block (reference: merge_qkv)."""
    h, kh, dh = cfg.head_num, cfg.kv_head_num, cfg.size_per_head
    assert h % tp == 0 and kh % tp == 0, (h, kh, tp)
    q_cols = torch.arange(h * dh).reshape(tp, h // tp * dh)
    k_cols = h * dh + torch.arange(kh * dh).reshape(tp, kh // tp * dh)
    v_cols = (h + kh) * dh + torch.arange(kh * dh).reshape(tp, kh // tp * dh)
    return torch.cat([q_cols, k_cols, v_cols], dim=1).reshape(-1)


def _permute_cols(arr: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    return arr[..., perm.to(arr.device)].contiguous()


def _group_count(w) -> int:
    return w.scales.shape[1] if isinstance(w, PackedInt4Weight) \
        else w.scales.shape[-2]


def _group_size(w) -> int:
    return w.k // _group_count(w)


def _perm_colsplit_int4(qw, perm: torch.Tensor):
    """Apply an N-permutation to an int4 weight.  The nibble pack runs
    along K, so a packed weight permutes its bytes' columns as they are.
    Row-parallel (K-split) int4 weights need NO repack here — the K dim
    shards contiguously."""
    if isinstance(qw, PackedInt4Weight):
        return PackedInt4Weight(packed=_permute_cols(qw.packed, perm),
                                scales=_permute_cols(qw.scales, perm),
                                sz=_permute_cols(qw.sz, perm))
    return QuantizedWeight(qvals=_permute_cols(qw.qvals, perm),
                           scales=_permute_cols(qw.scales, perm),
                           zeros=_permute_cols(qw.zeros, perm))


def _pad_axis(arr: torch.Tensor, axis: int, count: int, value):
    if count == 0:
        return arr
    shape = list(arr.shape)
    shape[axis] = count
    return torch.cat([arr, torch.full(shape, value, dtype=arr.dtype,
                                      device=arr.device)], dim=axis)


def _pad_quant_cols(qw, count: int):
    """Pad the N (output) dim of an int4 weight with exact-zero columns:
    q=0, zero-point 0, scale 1 -> dequant (0-0)*1 = 0 (packed: byte 0,
    scale 1, scale * zero 0)."""
    if isinstance(qw, PackedInt4Weight):
        return PackedInt4Weight(packed=_pad_axis(qw.packed, -1, count, 0),
                                scales=_pad_axis(qw.scales, -1, count, 1),
                                sz=_pad_axis(qw.sz, -1, count, 0))
    return QuantizedWeight(qvals=_pad_axis(qw.qvals, -1, count, 0),
                           scales=_pad_axis(qw.scales, -1, count, 1),
                           zeros=_pad_axis(qw.zeros, -1, count, 0))


def _pad_quant_rows(qw, count: int):
    """Pad the K (input) dim of an int4 weight with whole zero groups.  A
    packed weight's rows k and k + K/2 share a byte, so it unpacks, pads
    and packs again."""
    group = _group_size(qw)
    assert count % group == 0, (count, group)
    if isinstance(qw, PackedInt4Weight):
        q = _pad_axis(unpack_nibbles(qw.packed), -2, count, 0)
        return PackedInt4Weight(
            packed=pack_nibbles(q).contiguous(),
            scales=_pad_axis(qw.scales, 1, count // group, 1),
            sz=_pad_axis(qw.sz, 1, count // group, 0))
    return QuantizedWeight(
        qvals=_pad_axis(qw.qvals, -2, count, 0),
        scales=_pad_axis(qw.scales, -2, count // group, 1),
        zeros=_pad_axis(qw.zeros, -2, count // group, 0))


def _is_int4(w) -> bool:
    return isinstance(w, (QuantizedWeight, PackedInt4Weight))


def _pad_inter_for_tp(layers: Dict[str, Any], tp: int,
                      mult: int = 1) -> Dict[str, Any]:
    """Row-parallel int4 w2 shards K (= inter_size) over tp with its
    per-group scales [L, K/group, N] sharded on the group dim — each rank
    must own whole groups, i.e. inter_size % (group*tp) == 0.  Llama-2-7B
    (inter 11008, group 128 -> 86 groups) breaks this at tp=4/8, so pad
    inter_size up to the next group*tp multiple with exact-zero columns in
    w1/w3 and zero rows in w2 (the reference instead pre-splits per-rank
    files offline and requires divisibility, deploy.py tp_m_s4)."""
    w2 = layers.get('w2')
    if not _is_int4(w2):
        return layers
    inter = w2.k
    quantum = _group_size(w2) * tp * mult
    pad = (-inter) % quantum
    if pad == 0:
        return layers
    layers = dict(layers)
    layers['w2'] = _pad_quant_rows(w2, pad)
    for name in ('w1', 'w3'):
        w = layers[name]
        if _is_int4(w):
            layers[name] = _pad_quant_cols(w, pad)
        else:
            layers[name] = _pad_axis(w, -1, pad, 0)
    return layers


def prepare_params_for_tp(params: Dict[str, Any], cfg: ModelConfig,
                          tp: int) -> Dict[str, Any]:
    """Reorder/repack weights so contiguous TP shards are rank-correct.

    - wqkv / bqkv: column permutation to per-rank [q_r|k_r|v_r].
    - int4 w1/w3/w2: inter_size padded to a group*tp multiple so row-
      parallel quant groups never straddle ranks (see _pad_inter_for_tp).
    - tied embeddings: materialize an explicit lm_head so the vocab-split
      logits gather is uniform.
    Everything else shards contiguously as-is.
    """
    if tp == 1:
        return params
    perm = _qkv_column_perm(cfg, tp)
    layers = _pad_inter_for_tp(dict(params['layers']), tp)
    # row-parallel int4 wo: K = head_num*size_per_head; every head is
    # whole groups when size_per_head % group == 0 (128/128 for llama),
    # otherwise sharding would split a quant group across ranks.
    wo = layers.get('wo')
    if _is_int4(wo):
        assert wo.k % (_group_size(wo) * tp) == 0, (
            f'wo K={wo.k} not divisible by group*tp='
            f'{_group_size(wo) * tp}; quant groups would straddle TP ranks')
    wqkv = layers['wqkv']
    if _is_int4(wqkv):
        layers['wqkv'] = _perm_colsplit_int4(wqkv, perm)
    else:
        layers['wqkv'] = _permute_cols(wqkv, perm)
    if 'bqkv' in layers:
        layers['bqkv'] = _permute_cols(layers['bqkv'], perm)
    out = dict(params)
    out['layers'] = layers
    if 'lm_head' not in out:
        out['lm_head'] = params['tok_embedding'].T.contiguous()
    vp = out['lm_head'].shape[-1]
    assert vp % tp == 0, f'padded vocab {vp} not divisible by tp={tp}'
    return out


def _packable(w) -> bool:
    """``models/llama.py::packable`` for either residency."""
    g = _group_count(w)
    return w.k % 2 == 0 and g % 2 == 0 and w.n % 16 == 0


def pack_params_for_tp(params: Dict[str, Any], tp: int) -> Dict[str, Any]:
    """Nibble-pack the int4 layers so every contiguous tp shard of the
    packed array is a correctly HALF-SPLIT packed local block
    (``ops/linear.py::pack_nibbles`` puts rows [0, K/2) in the low nibble
    and [K/2, K) in the high nibble — a K-sharded globally-packed array
    would pair rows across ranks).

    Column-split weights (wqkv/w1/w3: K unsharded) pack globally;
    row-split (wo/w2) pack each rank's K block independently and
    concatenate, so the shard boundary IS the pack boundary.  A weight
    that arrives packed over its global K unpacks first.  Run AFTER
    :func:`prepare_params_for_tp`.  A weight that cannot pack stays
    byte-per-int4, as in the JAX package, and so does every byte-form
    weight under ``LMDEPLOY_TPU_PACKED_INT4=0`` (a tree without packed
    weights then comes back as it is, as the JAX engine then skips this
    function).  A packed row-split weight with an odd group count per
    rank (it has no zero points to go back to byte-per-int4 with)
    repacks per rank all the same: its CPU plain version takes it, and
    the card refuses it at preparation."""
    pack_bytes = packed_int4_enabled()
    layers = params.get('layers')
    if not layers or not pack_bytes and not any(
            isinstance(w, PackedInt4Weight) for w in layers.values()):
        return params
    layers = dict(layers)
    # the packed kernel half-splits each rank's K, so the per-rank group
    # count must be EVEN: widen the inter padding quantum to 2*group*tp
    # (idempotent on top of prepare_params_for_tp's group*tp padding)
    layers = _pad_inter_for_tp(layers, tp, mult=2)
    for name, w in list(layers.items()):
        row_split = name in _ROW_SPLIT and tp > 1
        if isinstance(w, QuantizedWeight):
            if not pack_bytes or not _packable(w) or (row_split and (
                    w.k // (_group_size(w) * tp)) % 2):
                # unpackable shape, or an odd group count per rank: stays
                # byte-per-int4, as in the JAX package
                continue
            q, s = w.qvals, w.scales
            sz = (s.float() * w.zeros.float()).to(s.dtype)
        elif isinstance(w, PackedInt4Weight) and row_split:
            # packed over the global K: each rank's K block packs anew
            q, s, sz = unpack_nibbles(w.packed), w.scales[:, :, 0], w.sz
        else:
            continue
        if row_split:
            packed = torch.cat([pack_nibbles(b) for b in
                                torch.chunk(q, tp, dim=-2)], dim=-2)
        else:
            packed = pack_nibbles(q)
        layers[name] = PackedInt4Weight(
            packed=packed.contiguous(), scales=s[:, :, None, :].contiguous(),
            sz=sz.contiguous())
    out = dict(params)
    out['layers'] = layers
    return out


def check_kernel_shapes(params: Dict[str, Any], rank: int = 0) -> None:
    """Raise unless every W4A16 weight of one rank's shard has a kernel on
    the card: nibble-packed, an even group count, N % 16 == 0 (the
    kernel's vector loads), a group that is a multiple of 16 (every such
    group runs a kernel at every M).  A byte-per-int4 weight passes only under
    ``LMDEPLOY_TPU_PACKED_INT4=0``, where the user chose that form and
    ``ops/linear.py``'s products serve it; with packed residency it is a
    weight the kernel cannot take."""
    byte_ok = not packed_int4_enabled()
    for name, w in params['layers'].items():
        if (isinstance(w, QuantizedWeight) and not byte_ok) or (
                isinstance(w, PackedInt4Weight) and (
                    not _packable(w) or _group_size(w) % 16)):
            raise NotImplementedError(
                f'W4A16 weight {name!r} of rank {rank}: K={w.k} N={w.n}, '
                f'{_group_count(w)} groups of {_group_size(w)}, '
                f'{type(w).__name__}; the card\'s kernel needs it nibble-'
                'packed (an even group count per rank) with N % 16 == 0 '
                'and a group that is a multiple of 16')


# ---------------------------------------------------------------------------
# per-rank shards (the counterpart of param_pspecs + shard_tree and
# cache_pspecs)
# ---------------------------------------------------------------------------

# Column-parallel (output dim sharded) / row-parallel (input dim sharded)
# assignment per weight family, mirroring §2.3's table.
_COL_SPLIT = {'wqkv', 'w1', 'w3'}
_ROW_SPLIT = {'wo', 'w2'}


def _block(x: torch.Tensor, dim: int, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous 1/tp block of ``x`` along ``dim``, as a
    tensor of its own."""
    n = x.shape[dim]
    assert n % tp == 0, (tuple(x.shape), dim, tp)
    return x.narrow(dim, rank * (n // tp), n // tp).contiguous()


def _shard_leaf(x, dim: int, tp: int, rank: int):
    if isinstance(x, PackedInt4Weight):
        # dim 1 of each field: K/2 packed rows (per-rank half-split
        # blocks), G scale groups; the last dim: N
        return PackedInt4Weight(
            packed=_block(x.packed, dim, tp, rank),
            scales=_block(x.scales, dim, tp, rank),
            sz=_block(x.sz, dim, tp, rank))
    if isinstance(x, QuantizedWeight):
        return QuantizedWeight(qvals=_block(x.qvals, dim, tp, rank),
                               scales=_block(x.scales, dim, tp, rank),
                               zeros=_block(x.zeros, dim, tp, rank))
    return _block(x, dim, tp, rank)


def shard_params(params: Dict[str, Any], tp: int, rank: int, pp: int = 1,
                 stage: int = 0) -> Dict[str, Any]:
    """One rank's block of prepared (and packed) parameters: tp rank
    ``rank`` of pipeline stage ``stage``.

    Column-split tensors shard their last dim (wqkv, w1, w3, bqkv);
    row-split ones dim 1 (wo, w2: K rows, K/2 packed rows, K/group scale
    groups).  Under pp every per-layer leaf keeps its stage's layers
    ``[stage * L/pp, (stage+1) * L/pp)`` (``pp_param_pspecs``' ``P(pp,
    ...)``), and lm_head's vocab splits over (pp, tp), block ``stage * tp
    + rank`` (``P(None, (pp, tp))``).  The final norm and tok_embedding are
    replicated (shared, not copied)."""
    if tp == 1 and pp == 1:
        return params
    layers = {}
    for name, w in params['layers'].items():
        if pp > 1:
            w = _shard_leaf(w, 0, pp, stage)
        if tp > 1 and (name in _COL_SPLIT or name == 'bqkv'):
            w = _shard_leaf(w, -1, tp, rank)
        elif tp > 1 and name in _ROW_SPLIT:
            w = _shard_leaf(w, 1, tp, rank)
        layers[name] = w
    out = dict(params)
    out['layers'] = layers
    if 'lm_head' in out:
        out['lm_head'] = _block(out['lm_head'], -1, tp * pp,
                                stage * tp + rank)
    return out


def shard_kv_scales(kv_scales, tp: int, rank: int, pp: int = 1,
                    stage: int = 0):
    """A rank's calibrated KV qparams: its stage's layers, and of per-head
    ``[L, KH]`` arrays its KV heads' columns (``pp_cache_pspecs``: ``P(pp)``
    per layer, ``P(pp, tp)`` per head)."""
    if kv_scales is None or (tp == 1 and pp == 1):
        return kv_scales
    out = []
    for x in kv_scales:
        t = _block(torch.as_tensor(x, dtype=torch.float32), 0, pp, stage)
        out.append(_block(t, 1, tp, rank) if t.dim() == 2 else t)
    return out


def shard_cache(cache: KVCache, tp: int, rank: int, dp: int = 1,
                group: int = 0, pp: int = 1, stage: int = 0) -> KVCache:
    """One rank's block of a full KV pool: stage ``stage``'s layers, dp
    group ``group``'s pages and tp rank ``rank``'s KV heads.  Per-head
    ``[L, 4, KH]`` qparams and the dynamic ``[L, P, page, KH, 4, G]``
    qparam pool shard like the payload; per-layer ``[L, 4]`` qparams keep
    their stage's layers.  (The engine allocates each rank's block
    directly at these shapes.)"""
    def pool(x):
        return _block(_block(_block(x, 0, pp, stage), 1, dp, group), 3, tp,
                      rank)
    qp = _block(cache.qparams, 0, pp, stage)
    return KVCache(k=pool(cache.k), v=pool(cache.v),
                   qparams=_block(qp, 2, tp, rank) if qp.dim() == 3 else qp,
                   dyn=None if cache.dyn is None else pool(cache.dyn))


# ---------------------------------------------------------------------------
# the ranks' process groups
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Ranks:
    """This process's place among ``dp * pp * tp`` ranks, and its groups.

    ``device_group``: the tp ranks of this rank's dp group and stage, for
    the activation all-reduce (NCCL when every rank has a card of its own,
    gloo when ranks share a device or run on the CPU).  ``stage_group``:
    the pp ranks of this rank's dp group and tp rank, for the stage hops;
    ``vocab_group``: the pp * tp ranks of this rank's dp group, for the
    logits gather (the device group when pp is 1).  ``host_group``: every
    rank, gloo, for the control frames and the readback."""
    tp: int
    dp: int
    rank: int
    device_group: Any
    host_group: Any
    backend: str
    pp: int = 1
    stage_group: Any = None
    vocab_group: Any = None

    @property
    def world(self) -> int:
        return self.tp * self.pp * self.dp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def pp_rank(self) -> int:
        return self.rank // self.tp % self.pp

    @property
    def dp_rank(self) -> int:
        return self.rank // (self.tp * self.pp)

    def global_rank(self, group: int, stage: int, tp_rank: int) -> int:
        """The rank of tp rank ``tp_rank`` of stage ``stage`` of dp group
        ``group``."""
        return (group * self.pp + stage) * self.tp + tp_rank


def _device_key(device: torch.device) -> str:
    if device.type != 'cuda':
        return 'cpu'
    return str(torch.cuda.get_device_properties(device).uuid)


def rank_layout(tp: int, dp: int,
                pp: int = 1) -> Dict[str, List[List[int]]]:
    """The member ranks of every device-side group, in creation order:
    ``tp`` (one group per dp group and stage), ``stage`` (one per dp group
    and tp rank; none when pp is 1) and ``vocab`` (one per dp group, its
    ranks in the (pp, tp) block order of lm_head's vocab split; none when
    pp is 1)."""
    def rank(g, s, r):
        return (g * pp + s) * tp + r
    out = {'tp': [[rank(g, s, r) for r in range(tp)]
                  for g in range(dp) for s in range(pp)],
           'stage': [], 'vocab': []}
    if pp > 1:
        out['stage'] = [[rank(g, s, r) for s in range(pp)]
                        for g in range(dp) for r in range(tp)]
        out['vocab'] = [[rank(g, s, r) for s in range(pp) for r in range(tp)]
                        for g in range(dp)]
    return out


def make_ranks(tp: int, dp: int, device: torch.device, timeout_s: float,
               pp: int = 1) -> Ranks:
    """The groups of this rank, on an initialised default (gloo) group of
    world ``dp * pp * tp``.  Every rank must call this, in the same order
    of calls, and creates every group (:func:`rank_layout`), its own or
    not.  The device-side groups' backend follows from the ranks' devices:
    NCCL when they are distinct cards, gloo otherwise."""
    world = dist.get_world_size()
    if world != tp * dp * pp:
        raise ValueError(f'world size {world} != dp {dp} x pp {pp} x '
                         f'tp {tp}')
    timeout = datetime.timedelta(seconds=timeout_s)
    host = dist.new_group(list(range(world)), backend='gloo',
                          timeout=timeout)
    keys: List[Optional[str]] = [None] * world
    dist.all_gather_object(keys, _device_key(device), group=host)
    backend = 'nccl' if ('cpu' not in keys and len(set(keys)) == world) \
        else 'gloo'
    rank = dist.get_rank()
    mine = {}
    for kind, groups in rank_layout(tp, dp, pp).items():
        for members in groups:
            grp = dist.new_group(members, backend=backend, timeout=timeout)
            if rank in members:
                mine[kind] = grp
    return Ranks(tp=tp, dp=dp, rank=rank, device_group=mine['tp'],
                 host_group=host, backend=backend, pp=pp,
                 stage_group=mine.get('stage'),
                 vocab_group=mine.get('vocab', mine['tp']))


__all__ = ['prepare_params_for_tp', 'pack_params_for_tp',
           'check_kernel_shapes', 'shard_params', 'shard_kv_scales',
           'shard_cache', 'Ranks', 'rank_layout', 'make_ranks']
