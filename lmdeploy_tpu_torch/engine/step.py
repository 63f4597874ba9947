"""Device-side engine state and step functions.

Port of ``lmdeploy_tpu/engine/step.py``: the generation hot loop over
fixed [B] batch slots, in plain decode rounds (every sampling mode) and in
speculative prompt-lookup rounds.  Finished or empty slots keep running
masked (valid = False: their KV writes drop and their tokens are ignored),
as in the JAX package.  The jitted ``lax.scan`` over sub-steps or rounds
becomes a Python loop; nothing inside a dispatch waits for the device, and
the host reads one packed int32 tensor per dispatch ([5 + 2*topn, k, B]
for decode, [R, 3(K+1)+3 + 2(K+1)*topn, B] for speculative rounds).  The
JAX functions return new arrays; here the engine's :class:`DecodeState`
is one set of tensors for its whole life: the plain step
(:func:`decode_step_into`) and the slot-surgery helpers write into them,
and :class:`StepFns` copies a speculative round's result back into them.

Since the in-place step's shapes never change, :class:`StepFns` replays a
plain decode step on the card as two CUDA graphs captured from that same
step (:meth:`StepFns.graph_ok` says where): ``forward`` (:func:`step_logits`
into a static logits buffer) and ``sampler`` (:func:`sample_into`: the
vocabulary mask, ``sample_step``, the state update and the step's readback
plane).  The kernels and their order are the eager step's; only their
issue moves from Python to the graph.

Each decode step's host work sits in three spans (``utils/profiler.py::
span``): ``step.forward`` (the model, or the replay of its graph),
``step.sampler`` (the vocabulary mask and ``sample_step``, or the replay of
the sampler's graph) and ``step.update`` (the slots' state and the step's
plane; inside the sampler's graph when replayed); :class:`StepFns` sums
the first two into ``host_s['step.forward']`` / ``['step.sampler']`` and a
prefill dispatch into ``host_s['step.prefill_issue']``.
"""
from __future__ import annotations

import collections
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
from ..models.llama import (StepBatch, forward, fused_attn_enabled,
                            fused_rope_enabled, mask_vocab_padding)
from ..ops import prng
from ..ops.cuda.counts import LAUNCHES, PLAIN_CALLS
from ..ops.sampling import (SamplingState, check_stop, greedy_tops,
                            sample_step)
from ..ops.speculative import (ngram_propose, repeat_rows,
                               spec_verify_sample)
from ..utils import debug
from ..utils.logger import get_logger
from ..utils.profiler import recording, span

log = get_logger()


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


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32)


def _tensors(state: DecodeState):
    """Every tensor of ``state``, its sampling state's included, in field
    order."""
    for f in dataclasses.fields(state):
        if f.name != 'sampling':
            yield getattr(state, f.name)
    for f in dataclasses.fields(state.sampling):
        yield getattr(state.sampling, f.name)


def copy_state_(dst: DecodeState, src: DecodeState) -> None:
    """Write ``src``'s tensors into ``dst``'s, in place (a speculative
    round's result into the persistent state)."""
    for a, b in zip(_tensors(dst), _tensors(src)):
        if a is not b:
            a.copy_(b)


def step_logits(params: Dict[str, Any], cache: KVCache, state: DecodeState,
                cfg: ModelConfig, forward_fn: Callable = forward
                ) -> torch.Tensor:
    """The model half of one decode step: every slot's next-token logits
    [B, V] (f32); the pool gains each running slot's K/V."""
    run = state.active & ~state.finished
    batch = StepBatch(ids=state.tokens[:, None],
                      positions=state.context_len[:, None],
                      valid=run[:, None],
                      context_len=state.context_len + 1,
                      page_table=state.page_table)
    logits, _ = forward_fn(params, cache, batch, cfg)
    return logits


def sample_into(logits: torch.Tensor, state: DecodeState, cfg: ModelConfig,
                plane: torch.Tensor, *, sampling_mode: str = 'greedy',
                topn: int = 0, passes: Optional[Tuple[bool, bool]] = None,
                host_s: Optional[Dict[str, float]] = None) -> None:
    """The sampler half of one decode step, in place: sample from
    ``logits``, advance every running slot of ``state``, and write the
    step's readback plane ``plane`` int32 [5 + 2*topn, B] (the rows of
    :func:`decode_steps` at one step).  ``host_s``: as in
    :func:`decode_step_into`."""
    run = state.active & ~state.finished
    smp = state.sampling
    with span('step.sampler', host_s):
        logits = mask_vocab_padding(logits, cfg.vocab_size)
        sampled = sample_step(logits, smp, state.history, state.history_len,
                              state.generated, mode=sampling_mode, topn=topn,
                              passes=passes)
    with span('step.update'):
        tok = torch.where(run, sampled[0], state.tokens)
        keys = torch.where(run[:, None], sampled[1], smp.rng_key)
        inc = run.to(torch.int32)
        generated = state.generated + inc
        finished = state.finished | (check_stop(tok, smp, generated) & run)
        b, cap = state.history.shape
        rows = torch.arange(b, device=tok.device)
        cols = torch.clamp(state.history_len.long(), max=cap - 1)
        write = run & (state.history_len < cap)   # a full row drops it
        state.history[rows, cols] = torch.where(write, tok,
                                                state.history[rows, cols])
        state.tokens.copy_(tok)
        state.context_len.add_(inc)
        state.history_len.add_(inc)
        state.generated.copy_(generated)
        state.finished.copy_(finished)
        smp.rng_key.copy_(keys)
        planes = [tok[None], finished.to(torch.int32)[None],
                  _f32_bits(sampled[2])[None], keys.T]
        if topn > 0:
            tid, tlp = sampled[3]                      # [B, topn]
            planes += [tid.T, _f32_bits(tlp).T]
        plane.copy_(torch.cat(planes))


def decode_step_into(params: Dict[str, Any], cache: KVCache,
                     state: DecodeState, cfg: ModelConfig,
                     plane: torch.Tensor, *, sampling_mode: str = 'greedy',
                     topn: int = 0,
                     passes: Optional[Tuple[bool, bool]] = None,
                     forward_fn: Callable = forward,
                     host_s: Optional[Dict[str, float]] = None) -> None:
    """One generation step for every running slot, in place: the engine's
    eager step, and what :class:`StepFns` captures as CUDA graphs.
    ``state`` advances, the pool gains the step's K/V, ``plane`` int32
    [5 + 2*topn, B] receives the step's readback rows.

    ``forward_fn`` has the signature of ``models/llama.py::forward`` and
    gives full-vocab logits on every rank (``forward`` over a
    tensor-parallel group, or the pipeline relay), so every rank samples
    from the same logits with the same keys and the ranks' states stay
    identical without another collective.

    ``sampling_mode`` ('greedy' / 'candidates' / 'full'), ``topn`` and
    ``passes`` are chosen by the host (ops/sampling.py::sample_step).
    ``host_s``: a dict whose ``step.forward`` and ``step.sampler``
    entries gain the host seconds of the step's forward and sampler."""
    with span('step.forward', host_s):
        logits = step_logits(params, cache, state, cfg, forward_fn)
    sample_into(logits, state, cfg, plane, sampling_mode=sampling_mode,
                topn=topn, passes=passes, host_s=host_s)


def decode_steps(params, cache: KVCache, state: DecodeState,
                 cfg: ModelConfig, *, num_steps: int,
                 sampling_mode: str = 'greedy', topn: int = 0,
                 passes: Optional[Tuple[bool, bool]] = None,
                 forward_fn: Callable = forward,
                 host_s: Optional[Dict[str, float]] = None):
    """``num_steps`` generation steps in place (:func:`decode_step_into`);
    the host reads ONE packed tensor.

    Returns (state, packed int32 [5 + 2*topn, k, B]), ``state`` the object
    it was given; packed rows: tokens, finished, logprob f32 bits, rng
    word 0, rng word 1 (the key after each sub-step, so the host can save
    a slot's key as of the sub-step it stopped), then with ``topn`` > 0
    the top-N alternative ids and their logprob f32 bits, one row per
    rank.  Arguments as in :func:`decode_step_into`; ``host_s`` sums over
    the steps."""
    packed = torch.empty((5 + 2 * topn, num_steps, state.tokens.shape[0]),
                         dtype=torch.int32, device=state.tokens.device)
    for t in range(num_steps):
        decode_step_into(params, cache, state, cfg, packed[:, t],
                         sampling_mode=sampling_mode, topn=topn,
                         passes=passes, forward_fn=forward_fn,
                         host_s=host_s)
    return state, packed


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

@dataclasses.dataclass
class StepGraph:
    """A plain decode step of one key as two captured CUDA graphs."""
    forward: Any            # step_logits into ``logits``
    sampler: Any            # sample_into from ``logits``, into ``plane``
    logits: torch.Tensor    # f32 [B, V]
    plane: torch.Tensor     # int32 [5 + 2*topn, B]


_WARM = 'warm'      # a key's first dispatch ran eagerly: capture at its next
_EAGER = 'eager'    # its capture failed: eager from then on


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
    :func:`init_decode_state` arguments (local pages, KV heads, slots).

    Plain decode steps run in place (:func:`decode_step_into`), so
    :meth:`decode_steps` hands back the state object it was given.  Where
    :meth:`graph_ok` holds they run as CUDA graphs, keyed by (sampling
    mode, topn, passes, the decode-attention switches) at this rank's B:
    a key's first dispatch runs eagerly (which also makes the kernels'
    lazily made globals: ticket counters, occupancy, cuBLAS's workspace),
    its next captures the step (executing nothing) and replays it, every
    later one replays.  No capture while torch's profiler records on the
    thread or CUDA's sync debug mode is on (that dispatch runs eagerly);
    a key whose capture fails runs eagerly from then on.  The graphs go
    with the device state (:meth:`alloc_device_state`, :meth:`drop_graphs`).
    ``graph_steps`` / ``graph_captures`` count the steps replayed and the
    keys captured.  ``LAUNCHES`` counts what the kernel wrappers launch,
    so a replayed step adds nothing to it.

    A graph keeps the addresses of everything its kernels touch: the
    params, the pool and the state it was captured on (a new one drops
    the graphs), its static logits and plane, and the kernels' ticket
    counters (``ops/cuda``'s ``_counter`` / ``_ticket_counters``), which
    are never freed: a counter outgrown by a later call is kept alive
    beside its successor."""

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
        self._own_forward = self.forward_fn
        self._graphs: Dict[tuple, Any] = {}  # StepGraph / _WARM / _EAGER
        self._graphed = None     # the (params, cache, state) of the graphs
        self._graph_pool = None
        self.graph_steps = self.graph_captures = 0
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
        """A fresh zeroed pool and decode state for this rank (the graphs
        of the old ones are dropped first)."""
        self.drop_graphs()
        cache = init_cache(**self.pool, device=self.device)
        state = init_decode_state(**self.state_shape, device=self.device)
        return cache, state

    def graph_ok(self, cache) -> bool:
        """Whether a plain decode step here may run as CUDA graphs: on a
        card, with one tensor-parallel rank (gloo cannot be captured), on
        the step's own forward (not the pipeline's, nor one a caller put
        in its place), the debugger off, and a pool whose decode route
        reads nothing on the host (the dynamic int4 pool's does)."""
        return (self.device.type == 'cuda' and self.group is None
                and self.forward_fn is self._own_forward
                and not debug.enabled() and not cache.dynamic_scales)

    def drop_graphs(self) -> None:
        """Let every captured graph go (with the device state it ran on)."""
        self._graphs.clear()
        self._graphed = self._graph_pool = None

    def _step_graph(self, params, cache, state, key) -> Optional[StepGraph]:
        """The graphs of ``key`` on this device state, or None where the
        dispatch runs eagerly (see the class)."""
        if key[2] is None or not self.graph_ok(cache):
            return None
        held = self._graphed
        if held is None or any(a is not b for a, b in
                               zip(held, (params, cache, state))):
            self.drop_graphs()
            self._graphed = (params, cache, state)
        entry = self._graphs.get(key)
        if entry is None:
            self._graphs[key] = _WARM
            return None
        if entry is _WARM:
            if recording() or (self.device.type == 'cuda'
                               and torch.cuda.get_sync_debug_mode()):
                return None
            try:
                entry = self._capture(params, cache, state, key)
                self.graph_captures += 1
            except Exception:
                log.exception('decode step %s: capture failed; it runs '
                              'eagerly', key)
                entry = _EAGER
            self._graphs[key] = entry
        return entry if isinstance(entry, StepGraph) else None

    def _record(self, fn: Callable[[], Any]):
        """A CUDA graph of ``fn()``, captured on this thread into the
        graphs' memory pool; nothing runs."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._graph_pool,
                              capture_error_mode='thread_local'):
            fn()
        return graph

    def _capture(self, params, cache, state, key) -> StepGraph:
        """Capture the plain decode step of ``key`` on this device state:
        the forward into a static logits buffer, then the sampler from it
        into a static plane.  The capture launches nothing, so the kernel
        wrappers' LAUNCHES of it are taken back."""
        mode, topn, passes = key[:3]
        b = self.b_local
        head = params.get('lm_head')
        width = head.shape[-1] if head is not None \
            else params['tok_embedding'].shape[0]
        logits = torch.empty((b, width), dtype=torch.float32,
                             device=self.device)
        plane = torch.empty((5 + 2 * topn, b), dtype=torch.int32,
                            device=self.device)
        before = collections.Counter(LAUNCHES)
        try:
            fwd = self._record(lambda: logits.copy_(step_logits(
                params, cache, state, self.cfg, self.forward_fn)))
            smp = self._record(lambda: sample_into(
                logits, state, self.cfg, plane, sampling_mode=mode,
                topn=topn, passes=passes))
        finally:
            LAUNCHES.clear()
            LAUNCHES.update(before)
        return StepGraph(fwd, smp, logits, plane)

    def decode_steps(self, params, cache, state, num_steps: int,
                     sampling_mode: str = 'greedy', topn: int = 0,
                     passes=None):
        """:func:`decode_steps`, or the replay of its step's graphs;
        returns (state, packed [5 + 2*topn, k, B]) as a host array."""
        t0 = time.perf_counter()
        parts = {'step.forward': 0.0, 'step.sampler': 0.0}
        key = (sampling_mode, topn, None if passes is None
               else tuple(passes), fused_attn_enabled(), fused_rope_enabled())
        graph = self._step_graph(params, cache, state, key)
        if graph is None:
            _, packed = decode_steps(
                params, cache, state, self.cfg, num_steps=num_steps,
                sampling_mode=sampling_mode, topn=topn, passes=passes,
                forward_fn=self.forward_fn, host_s=parts)
        else:
            packed = torch.empty((5 + 2 * topn, num_steps, self.b_local),
                                 dtype=torch.int32, device=self.device)
            for t in range(num_steps):
                with span('step.forward', parts):
                    graph.forward.replay()
                with span('step.sampler', parts):
                    graph.sampler.replay()
                packed[:, t].copy_(graph.plane)
            self.graph_steps += num_steps
        # added with the dispatch's issue, so that a reader of host_s
        # between two dispatches finds the parts within the whole
        for name, s in parts.items():
            self.host_s[name] += s
        return state, self._readback(packed, t0)

    def spec_decode_rounds(self, params, cache, state, num_rounds: int,
                           k_draft: int, ngram: int = 3, ngram_min: int = 0,
                           sampling: str = 'greedy', topn: int = 0,
                           passes=None):
        """:func:`spec_decode_rounds`, its state copied back into
        ``state``; returns (state, packed [R, rows, B]) as a host
        array."""
        t0 = time.perf_counter()
        new, packed = spec_decode_rounds(
            params, cache, state, self.cfg, num_rounds=num_rounds,
            k_draft=k_draft, ngram=ngram, ngram_min=ngram_min,
            sampling=sampling, topn=topn, passes=passes,
            forward_fn=self.forward_fn)
        copy_state_(state, new)
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
                'graph_steps': self.graph_steps,
                'graph_captures': self.graph_captures,
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


__all__ = ['DecodeState', 'init_decode_state', 'copy_state_', 'step_logits',
           'sample_into', 'decode_step_into', 'decode_steps',
           'spec_decode_round', 'spec_decode_rounds', 'prefill_chunks',
           'prefill_logits', 'install_slot', 'clear_slot', 'set_finished',
           'set_active', 'set_page_row', 'StepGraph', 'StepFns']
