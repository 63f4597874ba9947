"""Device-side engine state and step functions.

Port of ``lmdeploy_tpu/engine/step.py``: the generation hot loop over
fixed [B] batch slots, in plain decode rounds (every sampling mode) and in
speculative prompt-lookup rounds.  Finished or empty slots keep running
masked (valid = False: their KV writes drop and their tokens are ignored),
as in the JAX package.  The jitted ``lax.scan`` over sub-steps or rounds
becomes a Python loop; nothing inside a dispatch waits for the device, and
the host reads one packed int32 tensor per dispatch ([5 + 2*topn, k, B]
for decode, [R, 3(K+1)+3 + 2(K+1)*topn, B] for speculative rounds).  The
JAX functions return new arrays; here the forward updates the KV pool and
the slot-surgery helpers update the state tensors in place.

Each decode step's host work sits in three spans (``utils/profiler.py::
span``): ``step.forward`` (the model), ``step.sampler`` (the vocabulary
mask and ``sample_step``) and ``step.update`` (the slots' state, and the
stacking of the readback planes); :class:`StepFns` sums the first two
into ``host_s['step.forward']`` / ``['step.sampler']`` and a prefill
dispatch into ``host_s['step.prefill_issue']``.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import ModelConfig
from ..kvcache.paged import KVCache, init_cache
from ..models.llama import StepBatch, forward, mask_vocab_padding
from ..ops import prng
from ..ops.cuda.counts import LAUNCHES, PLAIN_CALLS
from ..ops.sampling import (SamplingState, check_stop, greedy_tops,
                            sample_step)
from ..ops.speculative import (ngram_propose, repeat_rows,
                               spec_verify_sample)
from ..utils.profiler import span


@dataclasses.dataclass
class DecodeState:
    """Per-slot device state.  For a running slot: history[:history_len]
    holds prompt + generated tokens; tokens == history[history_len-1] (the
    next token to feed); context_len == history_len - 1 (tokens with KV
    cached)."""
    tokens: torch.Tensor        # int32 [B]
    context_len: torch.Tensor   # int32 [B]
    history: torch.Tensor       # int32 [B, S_hist]
    history_len: torch.Tensor   # int32 [B]
    generated: torch.Tensor     # int32 [B]
    active: torch.Tensor        # bool  [B]
    finished: torch.Tensor      # bool  [B]
    page_table: torch.Tensor    # int32 [B, MAXP]
    sampling: SamplingState


def init_decode_state(batch: int, max_pages: int, hist_len: int,
                      eos_id: int = 2, device='cuda') -> DecodeState:
    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return DecodeState(
        tokens=zeros(batch), context_len=zeros(batch),
        history=zeros(batch, hist_len), history_len=zeros(batch),
        generated=zeros(batch), active=zeros(batch, dtype=torch.bool),
        finished=zeros(batch, dtype=torch.bool),
        page_table=torch.full((batch, max_pages), -1, dtype=torch.int32,
                              device=device),
        sampling=SamplingState.init(batch, device=device, eos_id=eos_id))


def decode_step(params: Dict[str, Any], cache: KVCache, state: DecodeState,
                cfg: ModelConfig, *, sampling_mode: str = 'greedy',
                topn: int = 0, passes: Optional[Tuple[bool, bool]] = None,
                forward_fn: Callable = forward,
                host_s: Optional[Dict[str, float]] = None):
    """One generation step for every running slot.

    ``forward_fn`` has the signature of ``models/llama.py::forward`` and
    gives full-vocab logits on every rank (``forward`` over a
    tensor-parallel group, or the pipeline relay), so every rank samples
    from the same logits with the same keys and the ranks' states stay
    identical without another collective.

    ``sampling_mode`` ('greedy' / 'candidates' / 'full'), ``topn`` and
    ``passes`` are chosen by the host (ops/sampling.py::sample_step).
    ``host_s``: a dict whose ``step.forward`` and ``step.sampler``
    entries gain the host seconds of the step's forward and sampler.
    Returns (new_state, sampled_tokens [B], finished [B], logprob [B],
    tops), tops = (top ids [B, topn], top logprobs [B, topn]) or None."""
    with span('step.forward', host_s):
        run = state.active & ~state.finished
        batch = StepBatch(ids=state.tokens[:, None],
                          positions=state.context_len[:, None],
                          valid=run[:, None],
                          context_len=state.context_len + 1,
                          page_table=state.page_table)
        logits, _ = forward_fn(params, cache, batch, cfg)
    smp = state.sampling
    with span('step.sampler', host_s):
        logits = mask_vocab_padding(logits, cfg.vocab_size)
        sampled = sample_step(logits, smp, state.history, state.history_len,
                              state.generated, mode=sampling_mode, topn=topn,
                              passes=passes)
    with span('step.update'):
        new_tok, new_keys, logprob = sampled[:3]
        new_tok = torch.where(run, new_tok, state.tokens)
        inc = run.to(torch.int32)
        generated = state.generated + inc
        finished = state.finished | (check_stop(new_tok, smp, generated)
                                     & run)
        b, cap = state.history.shape
        rows = torch.arange(b, device=new_tok.device)
        cols = torch.clamp(state.history_len.long(), max=cap - 1)
        write = run & (state.history_len < cap)   # a full row drops it
        history = state.history.clone()
        history[rows, cols] = torch.where(write, new_tok,
                                          history[rows, cols])
        sampling = dataclasses.replace(
            smp, rng_key=torch.where(run[:, None], new_keys, smp.rng_key))
        new_state = dataclasses.replace(
            state, tokens=new_tok, context_len=state.context_len + inc,
            history=history, history_len=state.history_len + inc,
            generated=generated, finished=finished, sampling=sampling)
    return (new_state, new_tok, finished, logprob,
            sampled[3] if topn > 0 else None)


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32)


def decode_steps(params, cache: KVCache, state: DecodeState,
                 cfg: ModelConfig, *, num_steps: int,
                 sampling_mode: str = 'greedy', topn: int = 0,
                 passes: Optional[Tuple[bool, bool]] = None,
                 forward_fn: Callable = forward,
                 host_s: Optional[Dict[str, float]] = None):
    """``num_steps`` generation steps; the host reads ONE packed tensor.

    Returns (state, packed int32 [5 + 2*topn, k, B], logprobs f32 [k, B]);
    packed rows: tokens, finished, logprob f32 bits, rng word 0, rng word 1
    (the key after each sub-step, so the host can save a slot's key as of
    the sub-step it stopped), then with ``topn`` > 0 the top-N alternative
    ids and their logprob f32 bits, one row per rank.  ``host_s``: as in
    :func:`decode_step`, summed over the steps."""
    toks, fins, lps, rngs, tops = [], [], [], [], []
    for _ in range(num_steps):
        state, tok, fin, lp, top = decode_step(
            params, cache, state, cfg, sampling_mode=sampling_mode,
            topn=topn, passes=passes, forward_fn=forward_fn, host_s=host_s)
        toks.append(tok)
        fins.append(fin.to(torch.int32))
        lps.append(lp)
        rngs.append(state.sampling.rng_key)
        tops.append(top)
    with span('step.update'):
        logprobs = torch.stack(lps)                          # [k, B]
        rng = torch.stack(rngs).to(torch.int32)              # [k, B, 2]
        planes = [torch.stack(toks), torch.stack(fins), _f32_bits(logprobs),
                  rng[..., 0], rng[..., 1]]
        if topn > 0:
            tid = torch.stack([t[0] for t in tops])          # [k, B, topn]
            tlp = torch.stack([t[1] for t in tops])
            planes += list(tid.permute(2, 0, 1))
            planes += list(_f32_bits(tlp).permute(2, 0, 1))
        packed = torch.stack(planes)
    return state, packed, logprobs


def spec_decode_round(params, cache: KVCache, state: DecodeState,
                      cfg: ModelConfig, *, k_draft: int, ngram: int = 3,
                      ngram_min: int = 0, sampling: str = 'greedy',
                      topn: int = 0,
                      passes: Optional[Tuple[bool, bool]] = None,
                      forward_fn: Callable = forward):
    """One speculative round for every running slot: propose ``k_draft``
    tokens by prompt lookup, verify them and the model's own next token in
    ONE [B, K+1] forward (the paged prefill kernel at T = K+1), accept the
    matched prefix.  ``sampling`` 'greedy' is the raw-argmax verify (every
    slot plain greedy); 'candidates' / 'full' the exact rejection-sampling
    verify (ops/speculative.py).

    Deliberate difference from the JAX package: the rows of a slot that is
    not running pass context_end = start_pos, so the prefill kernel takes
    them as padding rows (writes zeros, walks no pages); the JAX verify
    gives every slot min(ctx + K + 1, cap) and attends idle slots' stale
    contexts.  Those rows are discarded on both sides.

    Returns (state, g [B, K+1] candidate tokens, fin_emit [B, K+1] finish
    flag per emitted token, n [B] tokens emitted, logp [B, K+1], tops),
    tops = (top ids [B, K+1, topn], top logprobs [B, K+1, topn]) or None.
    """
    b, cap = state.history.shape
    kp1 = k_draft + 1
    dev = state.tokens.device
    run = state.active & ~state.finished
    draft = ngram_propose(state.history, state.history_len, k_draft,
                          ngram, ngram_min)                   # [B, K]
    ids = torch.cat([state.tokens[:, None], draft], dim=1)
    t_idx = torch.arange(kp1, dtype=torch.int32, device=dev)[None]
    pos = state.context_len[:, None] + t_idx                  # [B, K+1]
    valid = run[:, None] & (pos < cap)
    ctx_end = torch.where(run, torch.clamp(state.context_len + kp1,
                                           max=cap), state.context_len)
    batch = StepBatch(ids=ids, positions=pos, valid=valid,
                      context_len=ctx_end, page_table=state.page_table)
    logits, _ = forward_fn(
        params, cache, batch, cfg, return_all_logits=True, logits_count=kp1)
    logits = mask_vocab_padding(logits, cfg.vocab_size)       # [B,K+1,V]

    smp = state.sampling
    # keys advance once per round in every mode (greedy draws nothing)
    split = prng.split(smp.rng_key)                           # [B, 2, 2]
    tops = None
    if sampling == 'greedy':
        g = torch.argmax(logits, dim=-1).to(torch.int32)      # [B, K+1]
        match = (draft == g[:, :-1]) & run[:, None]
        if topn > 0:
            # sample_step's greedy planes at every verify position
            tops = tuple(x.reshape(b, kp1, topn) for x in greedy_tops(
                logits.reshape(b * kp1, -1),
                repeat_rows(smp.temperature, kp1), topn))
            logp = tops[1][..., 0]
        else:
            logp = torch.zeros(g.shape, dtype=torch.float32, device=dev)
    else:
        out = spec_verify_sample(
            logits, draft, smp, state.history, state.history_len,
            state.generated, split[:, 1], mode=sampling, topn=topn,
            passes=passes)
        g, accept, logp = out[:3]
        tops = out[3] if topn > 0 else None
        match = accept & run[:, None]
    acc = torch.sum(torch.cumprod(match.to(torch.int32), dim=1), dim=1)
    cand = (t_idx <= acc[:, None]) & (pos < cap)              # [B, K+1]
    gen_at = state.generated[:, None] + t_idx + 1
    is_eos = (g == smp.eos_id[:, None]) & ~smp.ignore_eos[:, None]
    is_stop = torch.any(g[:, :, None] == smp.stop_words[:, None, :], dim=2)
    fin_t = is_eos | is_stop | (gen_at >= smp.max_new_tokens[:, None])
    # emitted: an accepted candidate that no earlier emitted token finished
    fc = (fin_t & cand).to(torch.int32)
    emit = cand & ((torch.cumsum(fc, dim=1) - fc) == 0)
    n = torch.where(run, torch.sum(emit.to(torch.int32), dim=1), 0) \
        .to(torch.int32)
    fin_emit = emit & fin_t

    last = torch.clamp(n.long() - 1, min=0)[:, None]
    new_tok = torch.gather(g, 1, last)[:, 0]
    new_tok = torch.where(run & (n > 0), new_tok, state.tokens)
    hist_pos = state.history_len.long()[:, None] + t_idx
    write_idx = torch.where(emit, hist_pos, cap)   # column cap+ drops
    history = F.pad(state.history, (0, kp1)).scatter(
        1, write_idx, g.to(state.history.dtype))[:, :cap]
    new_smp = dataclasses.replace(
        smp, rng_key=torch.where(run[:, None], split[:, 0], smp.rng_key))
    new_state = dataclasses.replace(
        state, tokens=new_tok, context_len=state.context_len + n,
        history=history, history_len=state.history_len + n,
        generated=state.generated + n,
        finished=state.finished | torch.any(fin_emit, dim=1),
        sampling=new_smp)
    return new_state, g, fin_emit, n, logp, tops


def spec_decode_rounds(params, cache: KVCache, state: DecodeState,
                       cfg: ModelConfig, *, num_rounds: int, k_draft: int,
                       ngram: int = 3, ngram_min: int = 0,
                       sampling: str = 'greedy', topn: int = 0,
                       passes: Optional[Tuple[bool, bool]] = None,
                       forward_fn: Callable = forward):
    """``num_rounds`` speculative rounds; the host reads ONE packed tensor.

    Returns (state, packed int32 [R, 3*(K+1)+3 + 2*(K+1)*topn, B]): per
    round, rows [0:K+1] candidate tokens, [K+1:2K+2] finish flag per token,
    2K+2 tokens emitted, [2K+3:3K+4] logprob f32 bits, [3K+4:3K+6] the rng
    key after the round (so the host saves a stopped slot's key as of ITS
    round), then with ``topn`` > 0 the top-N ids ((K+1)*topn rows,
    position-major) and their logprob f32 bits."""
    kp1 = k_draft + 1
    rows = []
    for _ in range(num_rounds):
        state, g, fin_emit, n, logp, tops = spec_decode_round(
            params, cache, state, cfg, k_draft=k_draft, ngram=ngram,
            ngram_min=ngram_min, sampling=sampling, topn=topn, passes=passes,
            forward_fn=forward_fn)
        b = g.shape[0]
        planes = [g.T, fin_emit.to(torch.int32).T, n[None], _f32_bits(logp).T,
                  state.sampling.rng_key.to(torch.int32).T]
        if topn > 0:
            tid, tlp = tops                          # [B, K+1, topn]
            planes.append(tid.permute(1, 2, 0).reshape(kp1 * topn, b))
            planes.append(_f32_bits(tlp).permute(1, 2, 0)
                          .reshape(kp1 * topn, b))
        rows.append(torch.cat(planes, dim=0))
    return state, torch.stack(rows)


def prefill_chunks(params, cache: KVCache, state: DecodeState, slots,
                   ids, start_pos, lengths, cfg: ModelConfig,
                   forward_fn: Callable = forward):
    """Append one chunk for every row in one pass (the reference's batched
    context decode).  slots int [Bp] (padding rows: any slot, length 0);
    ids int [Bp, T]; start_pos / lengths int [Bp].  Returns last-valid-
    token logits [Bp, V]."""
    t = ids.shape[1]
    pos = start_pos[:, None] + torch.arange(t, dtype=torch.int32,
                                            device=ids.device)[None]
    valid = torch.arange(t, device=ids.device)[None] < lengths[:, None]
    batch = StepBatch(ids=ids, positions=pos, valid=valid,
                      context_len=start_pos + lengths,
                      page_table=state.page_table[slots.long()])
    logits, _ = forward_fn(params, cache, batch, cfg)
    return logits


def prefill_logits(params, cache: KVCache, page_row, ids, start_pos: int,
                   length: int, cfg: ModelConfig,
                   forward_fn: Callable = forward):
    """Like :func:`prefill_chunks` for one chunk, but the logits of ALL its
    positions (the reference's return-logits path): ids int [T] padded,
    ``length`` of them real, at ``start_pos``; page_row int32 [MAXP], a
    standalone row, so DecodeState is never touched.  Returns [T, V]."""
    t = ids.shape[0]
    dev = ids.device
    pos = start_pos + torch.arange(t, dtype=torch.int32, device=dev)
    batch = StepBatch(ids=ids[None], positions=pos[None],
                      valid=(torch.arange(t, device=dev) < length)[None],
                      context_len=torch.full((1,), start_pos + length,
                                             dtype=torch.int32, device=dev),
                      page_table=page_row[None])
    logits, _ = forward_fn(params, cache, batch, cfg,
                                               return_all_logits=True)
    return logits[0]


# -- slot surgery (in place) -------------------------------------------------

def install_slot(state: DecodeState, slot: int, token: int,
                 context_len: int, history_row, history_len: int, page_row,
                 sampling_row: Dict[str, Any]) -> None:
    """Bind a request to batch slot ``slot`` (reference:
    LlamaBatch::initialize + initializeSampling for one index)."""
    for name, value in sampling_row.items():
        getattr(state.sampling, name)[slot] = torch.as_tensor(value)
    state.tokens[slot] = token
    state.context_len[slot] = context_len
    state.history[slot] = torch.as_tensor(history_row)
    state.history_len[slot] = history_len
    state.generated[slot] = 0
    state.active[slot] = True
    state.finished[slot] = False
    state.page_table[slot] = torch.as_tensor(page_row)


def clear_slot(state: DecodeState, slot: int) -> None:
    state.active[slot] = False
    state.finished[slot] = True


def set_finished(state: DecodeState, slot: int) -> None:
    """Host-initiated stop (cancel / multi-token stop word hit)."""
    state.finished[slot] = True


def set_active(state: DecodeState, slot: int, value: bool) -> None:
    """(De)activate a slot: admitted-but-still-prefilling slots sit
    inactive so interleaved decode rounds never touch their unwritten KV."""
    state.active[slot] = value


def set_page_row(state: DecodeState, slot: int, page_row) -> None:
    state.page_table[slot] = torch.as_tensor(page_row)


# -- the engine's dispatch seam ----------------------------------------------

class StepFns:
    """The step functions of one rank, as the engine calls them.

    The engine speaks in GLOBAL batch slots and host arrays; this object
    maps them onto this rank's dp group (slots ``[g * b_local, (g+1) *
    b_local)``, a pool of pool-local pages), runs its ``forward_fn``
    (``forward`` over the tensor-parallel group), and returns every readback as a host array
    over all B slots (gathered from the groups over the host group).  With
    one rank it is the module functions above.  ``parallel/pp.py::
    PPStepFns`` is the pipeline-parallel variant: the same methods over
    its ``forward_fn``, a GPipe prefill and the ring decode.  Every method
    whose name is in ``parallel/multihost.py::_DEV_IN`` takes host
    arguments only after the device state, so that the leader can frame
    the call to the other ranks before it issues it.

    ``pool`` and ``state_shape``: this rank's :func:`init_cache` and
    :func:`init_decode_state` arguments (local pages, KV heads, slots)."""

    def __init__(self, cfg: ModelConfig, device, pool: Dict[str, Any],
                 state_shape: Dict[str, Any], ranks=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.pool = pool
        self.state_shape = state_shape
        self.ranks = ranks
        self.b_local = state_shape['batch']
        self.dp = ranks.dp if ranks is not None else 1
        self.group = ranks.device_group if ranks is not None \
            and ranks.tp > 1 else None
        self.forward_fn: Callable = functools.partial(forward,
                                                      group=self.group)
        self._hash = hashlib.sha256()
        # the jobs of each GPipe prefill pass this rank ran (PPStepFns)
        self.prefill_jobs: List[int] = []
        # host seconds of the rounds' dispatches: issuing them, then
        # waiting for their readback (the device, and the other ranks);
        # of the plain decode steps' issue, the model forward and the
        # sampler; issuing the prefill passes
        self.host_s = {'issue': 0.0, 'wait': 0.0, 'step.forward': 0.0,
                       'step.sampler': 0.0, 'step.prefill_issue': 0.0}

    @property
    def dp_rank(self) -> int:
        return self.ranks.dp_rank if self.ranks is not None else 0

    def _dev(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr)).to(self.device)

    def _local(self, slot: int) -> Optional[int]:
        """This rank's index of global slot ``slot``, or None when another
        dp group holds it."""
        g, i = divmod(int(slot), self.b_local)
        return i if g == self.dp_rank else None

    def _readback(self, packed: torch.Tensor, t0: float) -> np.ndarray:
        """The packed readback, batch last, over every group's slots, of a
        dispatch issued from ``t0`` (perf_counter) until now."""
        t1 = time.perf_counter()
        with span('step.readback'):
            arr = packed.cpu().numpy()
        self.host_s['issue'] += t1 - t0
        self.host_s['wait'] += time.perf_counter() - t1
        self._hash.update(arr.tobytes())
        if self.dp == 1:
            return arr
        t = torch.from_numpy(arr)
        r = self.ranks
        parts = [torch.empty_like(t) for _ in range(r.world)] \
            if r.rank == 0 else None
        dist.gather(t, parts, dst=0, group=r.host_group)
        if r.rank != 0:
            return arr
        return np.concatenate([parts[r.global_rank(g, 0, 0)].numpy()
                               for g in range(r.dp)], axis=-1)

    def alloc_device_state(self):
        """A fresh zeroed pool and decode state for this rank."""
        cache = init_cache(**self.pool, device=self.device)
        state = init_decode_state(**self.state_shape, device=self.device)
        return cache, state

    def decode_steps(self, params, cache, state, num_steps: int,
                     sampling_mode: str = 'greedy', topn: int = 0,
                     passes=None):
        """:func:`decode_steps`; returns (state, packed [5 + 2*topn, k, B])
        as a host array."""
        t0 = time.perf_counter()
        parts = {'step.forward': 0.0, 'step.sampler': 0.0}
        state, packed, _ = decode_steps(
            params, cache, state, self.cfg, num_steps=num_steps,
            sampling_mode=sampling_mode, topn=topn, passes=passes,
            forward_fn=self.forward_fn, host_s=parts)
        # added with the dispatch's issue, so that a reader of host_s
        # between two dispatches finds the parts within the whole
        for key, s in parts.items():
            self.host_s[key] += s
        return state, self._readback(packed, t0)

    def spec_decode_rounds(self, params, cache, state, num_rounds: int,
                           k_draft: int, ngram: int = 3, ngram_min: int = 0,
                           sampling: str = 'greedy', topn: int = 0,
                           passes=None):
        """:func:`spec_decode_rounds`; returns (state, packed [R, rows, B])
        as a host array."""
        t0 = time.perf_counter()
        state, packed = spec_decode_rounds(
            params, cache, state, self.cfg, num_rounds=num_rounds,
            k_draft=k_draft, ngram=ngram, ngram_min=ngram_min,
            sampling=sampling, topn=topn, passes=passes,
            forward_fn=self.forward_fn)
        return state, self._readback(packed, t0)

    def _group_rows(self, slots, ids, start_pos, lengths):
        """This dp group's rows of a prefill pass (host arrays), as device
        tensors with group-local slots, or None when it has none.  The JAX
        dp program runs every row on every group with the other groups'
        rows masked; here a group runs its own rows, and none when it has
        none."""
        slots = np.asarray(slots)
        mine = slots // self.b_local == self.dp_rank
        if not mine.any():
            return None
        if not mine.all():
            slots, ids, start_pos, lengths = (
                np.asarray(a)[mine] for a in (slots, ids, start_pos,
                                              lengths))
        return (self._dev(slots % self.b_local), self._dev(ids),
                self._dev(start_pos), self._dev(lengths))

    def prefill_chunks(self, params, cache, state, slots, ids, start_pos,
                       lengths) -> None:
        """:func:`prefill_chunks` over this group's rows of the pass (host
        arrays; padding rows have length 0)."""
        with span('step.prefill_issue', self.host_s):
            rows = self._group_rows(slots, ids, start_pos, lengths)
            if rows is not None:
                prefill_chunks(params, cache, state, *rows, self.cfg,
                               forward_fn=self.forward_fn)

    def prefill_logits(self, params, cache, page_row, ids, start_pos: int,
                       length: int) -> Optional[torch.Tensor]:
        """:func:`prefill_logits` on dp group 0, which holds the scratch
        session's pages (the JAX dp program masks the other groups' writes
        and selects group 0's logits); None on the other groups."""
        if self.dp_rank != 0:
            return None
        return prefill_logits(params, cache, self._dev(page_row),
                              self._dev(ids), int(start_pos), int(length),
                              self.cfg, forward_fn=self.forward_fn)

    def install_slot(self, state, slot: int, *args) -> None:
        i = self._local(slot)
        if i is not None:
            install_slot(state, i, *args)

    def clear_slot(self, state, slot: int) -> None:
        i = self._local(slot)
        if i is not None:
            clear_slot(state, i)

    def set_finished(self, state, slot: int) -> None:
        i = self._local(slot)
        if i is not None:
            set_finished(state, i)

    def set_active(self, state, slot: int, value: bool) -> None:
        i = self._local(slot)
        if i is not None:
            set_active(state, i, value)

    def set_page_row(self, state, slot: int, page_row) -> None:
        i = self._local(slot)
        if i is not None:
            set_page_row(state, i, page_row)

    def slot_key(self, state, slot: int) -> np.ndarray:
        """The rng key (uint32 [2]) of global slot ``slot``, on rank 0 from
        the first rank of the slot's dp group."""
        i = self._local(slot)
        key = state.sampling.rng_key[i].cpu() if i is not None \
            else torch.zeros((2,), dtype=state.sampling.rng_key.dtype)
        if self.dp > 1:
            owner = self.ranks.global_rank(int(slot) // self.b_local, 0, 0)
            dist.broadcast(key, src=owner, group=self.ranks.host_group)
        return key.numpy().view(np.uint32)

    def collective_ms(self, iters: int = 64) -> Optional[float]:
        """Wall ms per activation all-reduce on this rank's device group:
        ``iters`` back-to-back calls on [b_local, hidden] in bf16 (f32 on
        the CPU), as the forward issues them, then one synchronise.  None
        with one tp rank."""
        if self.group is None:
            return None
        dtype = torch.bfloat16 if self.device.type == 'cuda' \
            else torch.float32
        x = torch.ones((self.b_local, self.cfg.hidden_size), dtype=dtype,
                       device=self.device)
        dist.all_reduce(x, group=self.group)        # connects, warms up
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        for _ in range(iters):
            dist.all_reduce(x, group=self.group)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        return (time.perf_counter() - t0) * 1e3 / iters

    def report(self) -> Dict[str, Any]:
        """This rank's kernel counters, readback digest, host seconds of
        the rounds (``host_s``), the jobs of each GPipe prefill pass
        (``prefill_jobs``) and peak memory."""
        r = self.ranks
        return {'rank': r.rank if r is not None else 0,
                'device': str(self.device),
                'backend': r.backend if r is not None else None,
                'launches': dict(LAUNCHES), 'plain_calls': dict(PLAIN_CALLS),
                'readback_sha256': self._hash.hexdigest(),
                'host_s': dict(self.host_s),
                'prefill_jobs': list(self.prefill_jobs),
                'peak_bytes': torch.cuda.max_memory_allocated(self.device)
                if self.device.type == 'cuda' else 0}

    def rank_report(self, reset: bool = False):
        """Every rank's :meth:`report` on rank 0 (a list by rank; None on
        the others); ``reset`` then sets each rank's counters, host
        seconds and prefill jobs to 0."""
        mine = self.report()
        if reset:
            LAUNCHES.clear()
            PLAIN_CALLS.clear()
            self.host_s = dict.fromkeys(self.host_s, 0.0)
            self.prefill_jobs = []
        r = self.ranks
        if r is None:
            return [mine]
        out = [None] * r.world if r.rank == 0 else None
        dist.gather_object(mine, out, dst=0, group=r.host_group)
        return out


__all__ = ['DecodeState', 'init_decode_state', 'decode_step', 'decode_steps',
           'spec_decode_round', 'spec_decode_rounds', 'prefill_chunks',
           'prefill_logits', 'install_slot', 'clear_slot', 'set_finished',
           'set_active', 'set_page_row', 'StepFns']
