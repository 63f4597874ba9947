"""Pipeline parallelism: stages of layers over ranks.

Port of ``lmdeploy_tpu/parallel/pp.py``.  The JAX package runs one
``shard_map`` program over a (dp, pp, tp) mesh; here each rank is a
process holding its stage's block of the weights and of the KV pool
(``parallel/tp.py::shard_params`` / ``shard_cache`` with ``pp``: stage s
keeps layers ``[s * L/pp, (s+1) * L/pp)`` of every stacked leaf, the
counterpart of ``pp_param_pspecs`` / ``pp_cache_pspecs``), and the step
functions below call ``torch.distributed`` on the rank groups of
``parallel/tp.py::make_ranks`` where the JAX code calls ``psum`` and
``ppermute``:

- the **stage group** (the pp ranks of one dp group and tp rank) carries
  the activations between stages;
- the **vocab group** (the pp * tp ranks of one dp group) gathers the
  logits: lm_head's vocab splits over (pp, tp)
  (:func:`prepare_params_for_pp`), every rank projects its block and the
  all-reduce into a zeroed full-vocab buffer is exact, so every rank holds
  the same logits and samples the same tokens with the same keys.

Three step functions:

- :func:`pp_forward`, the relay, with the contract of
  ``models/llama.py::forward``: it serves decode steps, the speculative
  verify, single prefill chunks and prompt logits (``StepFns`` over its
  ``forward_fn``).
- :func:`pp_prefill_chunks_ring`, the GPipe batched prefill: one job (a
  row's chunk) per stage per iteration.
- :func:`pp_decode_sampled`, the microbatch ring decode with the full
  sampling stack, all stages cooperating on one sampling step per
  iteration.

Every stage hop is one exchange over the stage group
(:func:`_exchange`): each stage puts its activation in its row of a zeroed
``[pp, ...]`` buffer and the group all-reduces it (exact, x + 0 = x), so
that every stage holds every stage's output.  gloo, which carries the
groups of ranks that share a card, takes no CUDA tensor in point-to-point
calls, but takes one in an all-reduce: one path serves gloo and NCCL, and
no send can wait on a receive (no ring deadlock).  The relay's hop is a
broadcast from the stage whose turn it is.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from ..config import ModelConfig
from ..engine.step import DecodeState, StepFns, _f32_bits
from ..kvcache.paged import KVCache
from ..models.llama import (StepBatch, embed_tokens, forward_layers,
                            lm_head_logits, mask_vocab_padding)
from ..ops.sampling import sample_step
from ..utils.profiler import span
from . import tp as TP

# ---------------------------------------------------------------------------
# host-side weight preparation
# ---------------------------------------------------------------------------


def prepare_params_for_pp(params: Dict[str, Any], pp: int,
                          tp: int = 1) -> Dict[str, Any]:
    """Materialise lm_head (from a tied embedding) and pad its vocab dim
    with zero columns to a multiple of 128 * pp * tp, so that it splits
    over (pp, tp) in whole blocks; padded columns are masked before
    sampling (``mask_vocab_padding``).  Bit for bit the JAX package's."""
    out = dict(params)
    if 'lm_head' not in out:
        out['lm_head'] = params['tok_embedding'].T.contiguous()
    lm = out['lm_head']
    m = 128 * pp * tp
    vp = lm.shape[-1]
    vp_new = (vp + m - 1) // m * m
    if vp_new != vp:
        out['lm_head'] = torch.cat(
            [lm, lm.new_zeros((lm.shape[0], vp_new - vp))], dim=-1)
    return out


def rank_shards(params: Dict[str, Any], cfg: ModelConfig, tp: int,
                pp: int = 1) -> List[Dict[str, Any]]:
    """Every rank's weight block of one dp group, indexed by ``stage * tp +
    tp_rank``: ``prepare_params_for_tp``, :func:`prepare_params_for_pp`
    and ``pack_params_for_tp`` (the JAX engine's order; it owns the
    residency switch), then ``shard_params``."""
    prepared = TP.prepare_params_for_tp(params, cfg, tp)
    if pp > 1:
        prepared = prepare_params_for_pp(prepared, pp, tp)
    prepared = TP.pack_params_for_tp(prepared, tp)
    return [TP.shard_params(prepared, tp, r, pp, s)
            for s in range(pp) for r in range(tp)]


# ---------------------------------------------------------------------------
# stage hops
# ---------------------------------------------------------------------------

def _tp_group(ranks):
    return ranks.device_group if ranks.tp > 1 else None


def _exchange(h: torch.Tensor, ranks) -> torch.Tensor:
    """Every stage's ``h`` on every stage of this rank's stage group:
    ``[pp, *h.shape]``, row s from stage s (module docstring)."""
    buf = h.new_zeros((ranks.pp, *h.shape))
    buf[ranks.pp_rank] = h
    dist.all_reduce(buf, group=ranks.stage_group)
    return buf


def pp_forward(params, cache: KVCache, batch: StepBatch, cfg: ModelConfig,
               *, ranks, return_all_logits: bool = False,
               logits_count=None):
    """The relay forward, with the contract of ``models/llama.py::forward``:
    stage 0 embeds, each stage in turn runs its layers on the previous
    stage's output and broadcasts it over the stage group, and every rank
    projects its vocab block of the last stage's output; the logits are
    gathered over the vocab group.  Returns (logits, cache).

    Deliberate difference from the JAX relay, which runs every stage at
    every hop with ``valid`` masked off its own (one SPMD program): here a
    stage idles in the broadcast off its hop.  Either way a masked slot
    writes no KV."""
    stage = ranks.pp_rank
    if stage == 0:
        h = embed_tokens(params, batch.ids)
    else:
        emb = params['tok_embedding']
        h = torch.empty((*batch.ids.shape, emb.shape[-1]), dtype=emb.dtype,
                        device=emb.device)
    g, r = ranks.dp_rank, ranks.tp_rank
    for s in range(ranks.pp):
        if s == stage:
            h = forward_layers(params, cache, batch, h, cfg,
                               group=_tp_group(ranks))
        dist.broadcast(h, src=ranks.global_rank(g, s, r),
                       group=ranks.stage_group)
    logits = lm_head_logits(params, h, batch, cfg,
                            return_all_logits=return_all_logits,
                            logits_count=logits_count,
                            group=ranks.vocab_group)
    return logits, cache


def pp_prefill_chunks_ring(params, cache: KVCache, state: DecodeState,
                           slots, ids, start_pos, lengths,
                           cfg: ModelConfig, *, ranks) -> torch.Tensor:
    """GPipe batched prefill, with the contract of
    ``engine/step.py::prefill_chunks``: job j (row j's chunk) enters stage
    0 at iteration j and stage s at iteration j + s, so the pipeline holds
    one job per stage; ``bp + pp - 1`` iterations, one exchange each.
    slots int [Bp] (this dp group's local slots), ids int [Bp, T],
    start_pos / lengths int [Bp].  Returns zero logits f32 [Bp, Vp], as
    the JAX ring does: both of the engine's callers discard them (the next
    decode round samples)."""
    bp, t = ids.shape
    pp, stage = ranks.pp, ranks.pp_rank
    d = params['tok_embedding'].shape[-1]
    dt = params['tok_embedding'].dtype
    ar = torch.arange(t, dtype=torch.int32, device=ids.device)
    h_recv = None
    for it in range(bp + pp - 1):
        j = it - stage
        if 0 <= j < bp:
            batch = StepBatch(
                ids=ids[j:j + 1], positions=(start_pos[j] + ar)[None],
                valid=(ar < lengths[j])[None],
                context_len=start_pos[j:j + 1] + lengths[j:j + 1],
                page_table=state.page_table[slots[j:j + 1].long()])
            h_in = embed_tokens(params, ids[j:j + 1]) if stage == 0 \
                else h_recv
            h_out = forward_layers(params, cache, batch, h_in, cfg,
                                   group=_tp_group(ranks))
        else:
            # fill or drain: this stage holds no job
            h_out = torch.zeros((1, t, d), dtype=dt, device=ids.device)
        h_recv = _exchange(h_out, ranks)[(stage - 1) % pp]
    vp = params['lm_head'].shape[-1] * ranks.pp * ranks.tp
    return torch.zeros((bp, vp), dtype=torch.float32, device=ids.device)


def pp_decode_sampled(params, cache: KVCache, state: DecodeState,
                      cfg: ModelConfig, *, ranks, rounds: int,
                      sampling_mode: str = 'candidates', topn: int = 0,
                      passes=None):
    """``rounds`` decode rounds on the microbatch ring, with the full
    sampling stack (``ops/sampling.py::sample_step``).

    The B slots are cut into M = pp microbatches of ``bu = ceil(B/pp)``
    rows (pad rows inactive).  Iteration t: stage s runs its layers on
    microbatch ``(t - s) % M`` of round ``(t - s) // M`` (stage 0 on the
    embedding of the token sampled for it one round before, or of the
    slot's token in round 0; stage s > 0 on stage s - 1's output of
    iteration t - 1); the exchange hands every stage every stage's output;
    then all ranks cooperate on the last stage's microbatch: each projects
    its vocab block, the logits are gathered, and one identical
    ``sample_step`` runs everywhere, so tokens, history and keys stay
    equal on every rank.  Stage 0 embeds the sampled token itself (every
    rank knows it), where the JAX ring sends the embedding round the
    wrap-around edge.  ``rounds * M + pp - 1`` iterations; a stage idles
    on the fill and drain iterations that hold no microbatch for it.

    The ring runs ungated: the host bounds ``rounds`` by every slot's
    allowance, grows its pages first and applies the stop criteria to the
    readback (``engine.py::_ring_round``).  The new state (tokens,
    context_len, generated, history, history_len, keys) is written for
    running slots only.

    Returns (new_state, packed int32 [4 + 2*topn, rounds, B]): per round,
    tokens, token-logprob f32 bits, rng words 0 and 1 (the key after the
    round), then with ``topn`` > 0 the top-N ids and their logprob f32
    bits."""
    b = state.tokens.shape[0]
    pp, stage = ranks.pp, ranks.pp_rank
    m_count = pp
    bu = -(-b // m_count)
    bp = bu * m_count
    total = rounds * m_count + pp - 1
    dev = state.tokens.device
    d = params['tok_embedding'].shape[-1]
    dt = params['tok_embedding'].dtype

    def padb(x):
        if bp == b:
            return x
        return torch.cat([x, x.new_zeros((bp - b, *x.shape[1:]))])

    run0 = padb(state.active & ~state.finished)      # pad rows: False
    smp0 = dataclasses.replace(state.sampling, **{
        f.name: padb(getattr(state.sampling, f.name))
        for f in dataclasses.fields(state.sampling)})
    page_table = padb(state.page_table)
    context_len = padb(state.context_len)
    tokens0 = padb(state.tokens)
    history_len0 = padb(state.history_len)
    generated0 = padb(state.generated)
    hist = padb(state.history).clone()
    cap = hist.shape[1]
    rng = smp0.rng_key.clone()
    toks = torch.zeros((rounds, bp), dtype=torch.int32, device=dev)
    lps = torch.zeros((rounds, bp), dtype=torch.float32, device=dev)
    rngs = torch.zeros((rounds, bp, 2), dtype=rng.dtype, device=dev)
    tids = torch.zeros((rounds, bp, topn), dtype=torch.int32, device=dev)
    tlps = torch.zeros((rounds, bp, topn), dtype=torch.float32, device=dev)
    ids = torch.zeros((bu, 1), dtype=torch.int32, device=dev)
    rows_ar = torch.arange(bu, device=dev)
    h_recv = next_in = None
    for t in range(total):
        # ---- this stage's layers on the microbatch it holds ----
        tm = t - stage
        if 0 <= tm < rounds * m_count:
            m, r = tm % m_count, tm // m_count
            rows = slice(m * bu, (m + 1) * bu)
            pos = context_len[rows] + r
            batch = StepBatch(ids=ids, positions=pos[:, None],
                              valid=run0[rows][:, None],
                              context_len=pos + 1,
                              page_table=page_table[rows])
            if stage > 0:
                h_in = h_recv
            elif r == 0:
                h_in = embed_tokens(params, tokens0[rows][:, None])
            else:
                h_in = next_in
            h_out = forward_layers(params, cache, batch, h_in, cfg,
                                   group=_tp_group(ranks))
        else:
            h_out = torch.zeros((bu, 1, d), dtype=dt, device=dev)
        buf = _exchange(h_out, ranks)
        h_recv = buf[(stage - 1) % pp]

        # ---- every rank: lm_head + sampling of the microbatch the last
        # stage just finished ----
        ts = t - (pp - 1)
        if not 0 <= ts < rounds * m_count:
            continue
        m_s, r_s = ts % m_count, ts // m_count
        rows = slice(m_s * bu, (m_s + 1) * bu)
        live = run0[rows]
        pos = context_len[rows] + r_s
        batch = StepBatch(ids=ids, positions=pos[:, None],
                          valid=live[:, None], context_len=pos + 1,
                          page_table=page_table[rows])
        logits = lm_head_logits(params, buf[pp - 1], batch, cfg,
                                group=ranks.vocab_group)
        logits = mask_vocab_padding(logits, cfg.vocab_size)
        smp = dataclasses.replace(smp0, **{
            f.name: getattr(smp0, f.name)[rows]
            for f in dataclasses.fields(smp0)})
        smp = dataclasses.replace(smp, rng_key=rng[rows])
        hist_mb = hist[rows]                          # a view of hist
        hl = history_len0[rows] + r_s
        sampled = sample_step(logits, smp, hist_mb, hl,
                              generated0[rows] + r_s, mode=sampling_mode,
                              topn=topn, passes=passes)
        tok, new_keys, lp = sampled[:3]
        tok = torch.where(live, tok, tokens0[rows])
        cols = torch.clamp(hl.long(), max=cap - 1)
        write = live & (hl < cap)              # a full row drops the write
        hist_mb[rows_ar, cols] = torch.where(write, tok,
                                             hist_mb[rows_ar, cols])
        rng[rows] = torch.where(live[:, None], new_keys, rng[rows])
        toks[r_s, rows] = tok
        lps[r_s, rows] = lp.float()
        rngs[r_s, rows] = rng[rows]
        if topn > 0:
            tids[r_s, rows] = sampled[3][0]
            tlps[r_s, rows] = sampled[3][1].float()
        if stage == 0:
            next_in = embed_tokens(params, tok[:, None])

    run0 = run0[:b]
    inc = run0.to(torch.int32) * rounds
    sampling = dataclasses.replace(
        state.sampling, rng_key=torch.where(run0[:, None], rng[:b],
                                            state.sampling.rng_key))
    new_state = dataclasses.replace(
        state, tokens=torch.where(run0, toks[rounds - 1, :b], state.tokens),
        context_len=state.context_len + inc,
        generated=state.generated + inc,
        history=torch.where(run0[:, None], hist[:b], state.history),
        history_len=state.history_len + inc, sampling=sampling)
    rng_i = rngs[:, :b].to(torch.int32)
    planes = [toks[:, :b], _f32_bits(lps[:, :b]), rng_i[..., 0],
              rng_i[..., 1]]
    if topn > 0:
        planes += list(tids[:, :b].permute(2, 0, 1))
        planes += list(_f32_bits(tlps[:, :b]).permute(2, 0, 1))
    return new_state, torch.stack(planes)


# ---------------------------------------------------------------------------
# the engine's dispatch seam
# ---------------------------------------------------------------------------

class PPStepFns(StepFns):
    """``engine/step.py::StepFns`` over pipeline stages: decode steps,
    speculative rounds, single prefill chunks and prompt logits run on
    :func:`pp_forward`; a prefill pass of several rows on
    :func:`pp_prefill_chunks_ring`; :meth:`decode_rounds_sampled` is the
    ring.  The readback is the dp group's first rank's: the planes are
    equal on every rank of the group."""

    def __init__(self, cfg: ModelConfig, device, pool: Dict[str, Any],
                 state_shape: Dict[str, Any], ranks):
        super().__init__(cfg, device, pool, state_shape, ranks)
        self.forward_fn = functools.partial(pp_forward, ranks=ranks)

    def prefill_chunks(self, params, cache, state, slots, ids, start_pos,
                       lengths) -> None:
        """This group's rows of the pass through the GPipe ring; its
        padding rows (length 0) are dropped first (the JAX ring runs them
        masked), so the ring holds real jobs only."""
        with span('step.prefill_issue', self.host_s):
            keep = np.asarray(lengths) > 0
            rows = self._group_rows(*(np.asarray(a)[keep] for a in (
                slots, ids, start_pos, lengths)))
            if rows is not None:
                self.prefill_jobs.append(len(rows[0]))
                pp_prefill_chunks_ring(params, cache, state, *rows,
                                       self.cfg, ranks=self.ranks)

    def decode_rounds_sampled(self, params, cache, state, rounds: int,
                              sampling_mode: str = 'candidates',
                              topn: int = 0, passes=None):
        """:func:`pp_decode_sampled`; returns (state, packed [4 + 2*topn,
        rounds, B]) as a host array."""
        t0 = time.perf_counter()
        state, packed = pp_decode_sampled(
            params, cache, state, self.cfg, ranks=self.ranks, rounds=rounds,
            sampling_mode=sampling_mode, topn=topn, passes=passes)
        return state, self._readback(packed, t0)


__all__ = ['prepare_params_for_pp', 'rank_shards', 'pp_forward',
           'pp_prefill_chunks_ring', 'pp_decode_sampled', 'PPStepFns']
