"""TorchEngine — the persistent-batch inference engine on one device.

Single-device port of ``lmdeploy_tpu/engine/engine.py::TPUEngine``: one
engine thread owns the device state; frontends enqueue EngineRequests and
read streamed EngineOutputs (:meth:`EngineInstance.stream_infer`).
Admission sorted by input length, batched chunked prefill bounded by a
token budget, decode rounds of ``step_length`` sub-steps with one packed
readback, every sampling mode (greedy, top-k / top-p / min-p, penalties,
bad words, min length, top-N logprobs), prompt-lookup speculative rounds
with their adaptive gate, stop criteria, retirement, per-slot keys saved
at the exact sub-step and interactive sessions follow the JAX engine.

The KV pool is bf16 (``quant_policy`` 0), int8 (``quant_policy`` 4, with
the workspace's calibrated per-layer ``kv_scales``, or scale 1 and zero
point 0 without them, as the JAX engine does) or nibble-packed int4
(``quant_policy`` 8 with calibrated per-layer ``kv_scales``).

Not in this slice (each raises NotImplementedError naming its ROADMAP.md
item): tp / pp / dp > 1, dynamic per-token int4 KV (``quant_policy`` 8
without ``kv_scales``) and per-head int4 qparams, cross-session prefix
caching and the prompt-logits path.  The JAX engine's fallback that turns
speculation off after a failed speculative dispatch (a TPU runtime
workaround) is not ported: such a failure takes the error path of any
failed round.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import EngineConfig, ModelConfig
from ..kvcache.manager import (GroupedSequenceManager, NoFreePages,
                               PageAllocator, SequenceManager)
from ..kvcache.paged import KV_WIDTHS, init_cache, kv_bits_named
from ..messages import (EngineOutput, EngineRequest, GenerationConfig,
                        ResponseType)
from ..ops import prng
from ..ops.sampling import MAX_STOP_BAD_WORDS
from ..utils.logger import get_logger
from . import step as S

log = get_logger()


def _bucket_for(length: int, buckets) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def _all_plain_greedy(cfgs) -> bool:
    """Every config is plain greedy: raw argmax == the full sampling stack
    (no penalties / banned words / min-length EOS masking), so the greedy
    fast paths (greedy decode, greedy speculative verify) stay exact."""
    return all((g.top_k or 0) == 1 and g.repetition_penalty == 1.0
               and g.presence_penalty == 0.0
               and g.frequency_penalty == 0.0 and not g.bad_words
               and g.min_new_tokens == 0 for g in cfgs)


def resolve_device(device) -> torch.device:
    """The port's device rule: CUDA unless the caller asks for the CPU;
    a CUDA device without CUDA raises (no quiet switch to the CPU)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('lmdeploy_tpu_torch: CUDA is not available; '
                           'pass device="cpu" to run the plain versions '
                           'on the CPU')
    return dev


@dataclasses.dataclass
class _Slot:
    """Host mirror of one running batch slot."""
    request: EngineRequest
    seq: Any
    out_q: queue.Queue
    context_len: int            # host shadow of device context_len
    prompt_len: int             # tokens in history when generation started
    generated: int = 0
    stop_sequences: List[List[int]] = dataclasses.field(default_factory=list)
    single_stops: frozenset = frozenset()
    host_single_stops: frozenset = frozenset()
    holdback: int = 0           # tokens withheld while a stop prefix may grow
    prefilling: bool = False    # admitted, prompt not fully in KV yet
    tail: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    # per generated token: {token_id: logprob} of the top-N alternatives
    top_lps: List[dict] = dataclasses.field(default_factory=list)
    done: bool = False
    saw_round: bool = False     # this slot appeared in >= 1 decode round
    max_new: int = 0


class TorchEngine:
    """Owns device state + the engine thread; frontends attach via
    :meth:`create_instance`."""

    def __init__(self, model_cfg: ModelConfig, engine_cfg: EngineConfig,
                 params: Dict[str, Any], device='cuda', start: bool = True,
                 kv_scales=None):
        self.device = resolve_device(device)
        if max(engine_cfg.tp, engine_cfg.pp, engine_cfg.dp) > 1:
            raise NotImplementedError(
                'tp/pp/dp > 1: parallelism is not ported yet '
                '(ROADMAP.md Queue 1 item 12)')
        kv_bits = kv_bits_named(engine_cfg.kv_dtype)
        kv_scales = kv_scales if kv_bits else None
        if kv_bits == 4 and kv_scales is None:
            raise NotImplementedError(
                'quant_policy 8 without kv_scales: dynamic per-token int4 '
                'KV is not ported yet (ROADMAP.md Queue 1 item 8)')
        self._kv_width = KV_WIDTHS[kv_bits]
        self._kv_scales = kv_scales
        if engine_cfg.enable_prefix_caching:
            raise NotImplementedError(
                'enable_prefix_caching: cross-session prefix caching is not '
                'ported yet (ROADMAP.md Queue 1 item 10)')
        self.cfg = model_cfg
        self.ecfg = engine_cfg
        self.params = params

        page = engine_cfg.page_size
        self.session_len = min(engine_cfg.session_len, model_cfg.session_len) \
            if model_cfg.session_len else engine_cfg.session_len
        self.max_pages_per_seq = -(-self.session_len // page)
        num_pages = engine_cfg.num_pages or self._derive_num_pages()
        if num_pages < self.max_pages_per_seq:
            raise ValueError(f'{num_pages} pages cannot hold one session '
                             f'of {self.max_pages_per_seq} pages')
        self.num_pages = num_pages
        self.cache, self.state = self._alloc_device_state()
        self.seqs = GroupedSequenceManager([SequenceManager(
            PageAllocator(num_pages), page,
            engine_cfg.cache_max_entry_count, enable_prefix_cache=False)])

        self.slots: List[Optional[_Slot]] = \
            [None] * engine_cfg.max_batch_size
        self._prefill_jobs: List = []  # (slot_idx, ids, start_pos)
        # decode_steps / spec_rounds / prefill_passes: forward passes of
        # each kind, so kernel launch counts can be read per pass
        self.stats = {'requests': 0, 'finished': 0, 'canceled': 0,
                      'errors': 0, 'rejected': 0, 'timeout': 0,
                      'generated_tokens': 0, 'interleaved_rounds': 0,
                      'decode_steps': 0, 'prefill_passes': 0,
                      'spec_rounds': 0, 'spec_emitted': 0,
                      'spec_fallbacks': 0}
        # adaptive speculative gating: an EMA of accepted tokens per round;
        # below break-even the engine runs plain rounds and re-probes after
        # a cooloff (the JAX engine's constants)
        self._spec_accept_ema: Optional[float] = None
        self._spec_cooloff = 0
        self.SPEC_MIN_ACCEPT = 1.15
        self.SPEC_COOLOFF_DISPATCHES = 4
        # occupancy gate: speculation while running * (K+1) <= this many
        # verify rows
        self.SPEC_MAX_VERIFY_ROWS = 32
        # top-N planes are quantised to {0, MAX_TOP_LOGPROBS}; _emit slices
        # each slot's own N
        self.MAX_TOP_LOGPROBS = 5
        self._fresh_admission = False
        self._ramp = 1
        self._rng_now: Optional[np.ndarray] = None
        self._requests: queue.Queue = queue.Queue()
        self._pending: List = []
        self._shutdown = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name='torch-engine')
        if start:
            self._thread.start()

    # -- construction helpers -------------------------------------------------
    def _alloc_device_state(self):
        """Fresh KV pool + decode state on the engine's device."""
        cache = init_cache(self.cfg.num_layer, self.num_pages,
                           self.ecfg.page_size, self.cfg.kv_head_num,
                           self.cfg.size_per_head, self._kv_width.dtype,
                           device=self.device, kv_scales=self._kv_scales)
        state = S.init_decode_state(self.ecfg.max_batch_size,
                                    self.max_pages_per_seq, self.session_len,
                                    eos_id=self.cfg.end_id,
                                    device=self.device)
        return cache, state

    def _recover_device_state(self):
        """Drop every session and reallocate after a device error (the
        pool's content can no longer be trusted)."""
        log.warning('resetting device state after a device error')
        self.seqs.clear()
        self.cache = self.state = None
        self.cache, self.state = self._alloc_device_state()
        self._rng_now = None
        self._prefill_jobs = []

    def _derive_num_pages(self) -> int:
        """Pool size from free device memory (CUDA) or enough pages for
        max_batch_size full sessions (CPU)."""
        if self.device.type != 'cuda':
            return self.ecfg.max_batch_size * self.max_pages_per_seq
        bytes_per_tok = int(self.cfg.num_layer * 2 * self.cfg.kv_head_num
                            * self.cfg.size_per_head
                            * self._kv_width.elem_bytes)
        free, _ = torch.cuda.mem_get_info(self.device)
        pages = int(free * self.ecfg.hbm_utilization
                    // (bytes_per_tok * self.ecfg.page_size))
        return max(pages, 2 * self.max_pages_per_seq)

    # -- public API ----------------------------------------------------------
    def create_instance(self) -> 'EngineInstance':
        return EngineInstance(self)

    def alive(self) -> bool:
        return self._thread.is_alive()

    def submit(self, request: EngineRequest) -> queue.Queue:
        if request.return_logits:
            raise NotImplementedError(
                'prompt logits are not ported yet (ROADMAP.md Queue 1 '
                'item 10)')
        out_q: queue.Queue = queue.Queue()
        if not self.alive():
            out_q.put(EngineOutput(ResponseType.INTERNAL_ERROR, [], 0,
                                   finished=True))
            return out_q
        cap = self.ecfg.max_pending_requests
        if cap and not request.stop \
                and self._requests.qsize() + len(self._pending) >= cap:
            self.stats['rejected'] += 1
            out_q.put(EngineOutput(ResponseType.QUEUE_FULL, [], 0,
                                   finished=True))
            return out_q
        self._requests.put((request, out_q, time.monotonic()))
        return out_q

    def shutdown(self):
        self._shutdown = True
        if self._thread.is_alive():
            self._thread.join(timeout=10)

    def end_session(self, session_id: int):
        """Free a session's cache (sequence_end)."""
        self.submit(EngineRequest(session_id=session_id, input_ids=[],
                                  gen_config=GenerationConfig(), stop=True,
                                  sequence_end=True))

    def cancel(self, session_id: int):
        self.submit(EngineRequest(session_id=session_id, input_ids=[],
                                  gen_config=GenerationConfig(), stop=True))

    # -- engine loop ----------------------------------------------------------
    def _loop(self):
        while not self._shutdown:
            busy = any(s is not None for s in self.slots) or self._pending
            try:
                batch = [self._requests.get(timeout=0.0 if busy else 0.05)]
                while True:
                    try:
                        batch.append(self._requests.get_nowait())
                    except queue.Empty:
                        break
                self._handle_batch(batch)
            except queue.Empty:
                pass
            except Exception:
                log.exception('request handling failed')
            if self._pending and self._free_slot_index() is not None:
                pending, self._pending = self._pending, []
                for item in pending:
                    self._handle_safe(*item)
            if self._prefill_jobs:
                try:
                    self._flush_prefills()
                except Exception:
                    log.exception('prefill flush failed')
                    self._fail_all()
            if any(s is not None and not s.done for s in self.slots):
                try:
                    self._decode_round(self.ecfg.step_length)
                except Exception:
                    log.exception('decode round failed')
                    self._fail_all()

    def _fail_all(self):
        """Answer every running request with INTERNAL_ERROR and rebuild
        the device state."""
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            slot.out_q.put(EngineOutput(ResponseType.INTERNAL_ERROR, [],
                                        slot.generated, finished=True))
            self.seqs.erase(slot.request.session_id)
            self.slots[i] = None
        self._recover_device_state()

    # -- request handling -----------------------------------------------------
    def _handle_batch(self, batch):
        """Stops first; duplicate session ids among queued requests are
        rejected; admissions sorted by input length, longest first."""
        for item in [it for it in batch if it[0].stop]:
            self._handle_safe(*item)
        seen = set()
        for req, out_q, t in sorted([it for it in batch if not it[0].stop],
                                    key=lambda it: -len(it[0].input_ids)):
            if req.session_id in seen:
                out_q.put(EngineOutput(ResponseType.SESSION_REPEAT, [], 0,
                                       finished=True))
                continue
            seen.add(req.session_id)
            self._handle_safe(req, out_q, t)

    def _handle_safe(self, req: EngineRequest, out_q: queue.Queue,
                     enq_t: Optional[float] = None):
        """One failing request answers ITS client only."""
        timeout = self.ecfg.request_timeout
        if timeout and enq_t is not None and not req.stop \
                and time.monotonic() - enq_t > timeout:
            self.stats['timeout'] += 1
            out_q.put(EngineOutput(ResponseType.TIMEOUT, [], 0,
                                   finished=True))
            return
        try:
            self._handle_request(req, out_q, enq_t)
        except Exception:
            log.exception('request handling failed (session %s)',
                          req.session_id)
            self.stats['errors'] += 1
            out_q.put(EngineOutput(ResponseType.INTERNAL_ERROR, [], 0,
                                   finished=True))

    def _handle_request(self, req: EngineRequest, out_q: queue.Queue,
                        enq_t: Optional[float] = None):
        if req.stop:
            self._handle_stop(req, out_q)
            return
        for slot in self.slots:
            if slot is not None and slot.request.session_id == req.session_id \
                    and not slot.done:
                out_q.put(EngineOutput(ResponseType.SESSION_BUSY, [], 0,
                                       finished=True))
                return
        if not req.sequence_start and req.session_id not in self.seqs:
            out_q.put(EngineOutput(ResponseType.SESSION_NOT_EXIST, [], 0,
                                   finished=True))
            return
        try:
            self._admit(req, out_q, enq_t)
        except NoFreePages:
            out_q.put(EngineOutput(ResponseType.INTERNAL_ERROR, [], 0,
                                   finished=True))

    def _handle_stop(self, req: EngineRequest, out_q: queue.Queue):
        kept = []
        for preq, pq, pt in self._pending:
            if preq.session_id == req.session_id:
                pq.put(EngineOutput(ResponseType.CANCELED, [], 0,
                                    finished=True))
            else:
                kept.append((preq, pq, pt))
        self._pending = kept
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.request.session_id == req.session_id:
                S.set_finished(self.state, i)
                slot.done = True
                slot.out_q.put(EngineOutput(
                    ResponseType.CANCELED,
                    slot.seq.token_ids[slot.prompt_len:],
                    slot.generated, finished=True))
                self._retire(i, ResponseType.CANCELED)
                break
        if req.sequence_end:
            self.seqs.erase(req.session_id)
        out_q.put(EngineOutput(ResponseType.SUCCESS, [], 0, finished=True))

    def _free_slot_index(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _admit(self, req: EngineRequest, out_q: queue.Queue,
               enq_t: Optional[float] = None):
        slot_idx = self._free_slot_index()
        if slot_idx is None:
            # busy engine: wait for a free slot (continuous batching)
            self._pending.append((req, out_q,
                                  enq_t if enq_t is not None
                                  else time.monotonic()))
            return
        self.stats['requests'] += 1
        if req.sequence_start:
            seq = self.seqs.create(req.session_id, 0)
        else:
            seq = self.seqs.fetch(req.session_id)
            if req.step and req.step < len(seq.token_ids):
                # rewind to an earlier step
                seq.token_ids = seq.token_ids[:req.step]
                seq.cache_len = self.seqs.prepare_rewrite(
                    seq, min(seq.cache_len, req.step))

        new_ids = list(map(int, req.input_ids))
        # cache-miss re-decode: an evicted sequence prefills again from
        # cache_len (LlamaBatch.cc:680-699)
        all_ids = seq.token_ids + new_ids
        total_len = len(all_ids)
        if total_len + 1 > self.session_len:
            out_q.put(EngineOutput(ResponseType.INPUT_TOO_LONG, [], 0,
                                   finished=True))
            return
        gen = req.gen_config.clip(self.cfg.vocab_size)
        max_new = min(gen.max_new_tokens, self.session_len - total_len)
        if max_new <= 0:
            out_q.put(EngineOutput(ResponseType.INPUT_TOO_LONG, [], 0,
                                   finished=True))
            return

        seq.active = True
        self.seqs.grow(seq, total_len)
        prefill_ids = all_ids[seq.cache_len:-1] if total_len > 1 else []
        start_pos = seq.cache_len
        hist = np.zeros((self.session_len,), np.int32)
        hist[:total_len] = all_ids
        S.install_slot(self.state, slot_idx, all_ids[-1], total_len - 1,
                       hist, total_len, self._page_row(seq),
                       self._sampling_row(gen, seq, max_new))

        stop_seqs = self._stop_sequences(gen)
        multi = [sw for sw in stop_seqs if len(sw) > 1]
        singles = [sw[0] for sw in stop_seqs if len(sw) == 1]
        slot = _Slot(request=req, seq=seq, out_q=out_q,
                     context_len=total_len - 1, prompt_len=total_len,
                     stop_sequences=multi,
                     single_stops=frozenset(singles[:MAX_STOP_BAD_WORDS]),
                     host_single_stops=frozenset(
                         singles[MAX_STOP_BAD_WORDS:]),
                     holdback=max((len(sw) for sw in multi), default=1) - 1,
                     max_new=max_new)
        self.slots[slot_idx] = slot
        self._fresh_admission = True
        seq.token_ids = all_ids
        if prefill_ids:
            # prefill deferred to one batched pass (_flush_prefills); the
            # slot sits inactive until its KV is written
            slot.prefilling = True
            S.set_active(self.state, slot_idx, False)
            self._prefill_jobs.append((slot_idx, prefill_ids, start_pos))

    def _page_row(self, seq) -> np.ndarray:
        row = np.full((self.max_pages_per_seq,), -1, np.int32)
        row[:len(seq.pages)] = seq.pages
        return row

    def _stop_sequences(self, gen: GenerationConfig) -> List[List[int]]:
        return [[int(x) for x in w] if isinstance(w, (list, tuple))
                else [int(w)]
                for w in (gen.stop_words or [])]

    def _sampling_row(self, gen: GenerationConfig, seq, max_new) -> dict:
        cap = MAX_STOP_BAD_WORDS
        stop_flat = [w[0] for w in self._stop_sequences(gen) if len(w) == 1]
        stop = np.full((cap,), -1, np.int32)
        stop[:min(cap, len(stop_flat))] = stop_flat[:cap]
        bad = np.full((cap,), -1, np.int32)
        bw = [int(x) for x in (gen.bad_words or [])]
        if len(bw) > cap:
            log.warning('truncating %d bad words to capacity %d', len(bw),
                        cap)
        bad[:min(cap, len(bw))] = bw[:cap]
        if seq.rng_key is not None and gen.random_seed is None:
            key = np.asarray(seq.rng_key, np.uint32)
        else:
            key = prng.key_from_seed(
                gen.random_seed if gen.random_seed is not None
                else np.random.randint(0, 2 ** 31 - 1))
        return dict(
            top_k=gen.top_k or 0, top_p=gen.top_p, min_p=gen.min_p,
            temperature=gen.temperature,
            repetition_penalty=gen.repetition_penalty,
            presence_penalty=gen.presence_penalty,
            frequency_penalty=gen.frequency_penalty,
            rng_key=torch.from_numpy(key.view(np.int32).copy()),
            bad_words=torch.from_numpy(bad), stop_words=torch.from_numpy(stop),
            eos_id=self.cfg.end_id, ignore_eos=bool(gen.ignore_eos),
            min_new_tokens=gen.min_new_tokens, max_new_tokens=max_new)

    # -- prefill --------------------------------------------------------------
    def _iter_chunks(self, ids: List[int], start_pos: int):
        """Yield (padded int32 [bucket], pos, length) chunks bounded by
        max_context_token_num and the largest prefill bucket."""
        buckets = list(self.ecfg.prefill_buckets)
        budget = min(self.ecfg.max_context_token_num, buckets[-1])
        pos = start_pos
        remaining = list(ids)
        while remaining:
            chunk, remaining = remaining[:budget], remaining[budget:]
            padded = np.zeros((_bucket_for(len(chunk), buckets),), np.int32)
            padded[:len(chunk)] = chunk
            yield padded, pos, len(chunk)
            pos += len(chunk)

    def _interleave_decode(self):
        """A short decode round between prefill passes so running sessions
        keep streaming during a long admission (SARATHI-style)."""
        k = self.ecfg.prefill_interleave
        if k <= 0 or not any(s is not None and not s.done
                             and not s.prefilling for s in self.slots):
            return
        self.stats['interleaved_rounds'] += 1
        self._decode_round(self.ecfg.step_length
                           if k >= self.ecfg.step_length else 1)

    def _dev(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr)).to(self.device)

    def _flush_prefills(self):
        """Prefill every queued admission in batched chunk passes: each
        pass appends ONE chunk for every unfinished job."""
        jobs = [(i, ids, start) for i, ids, start in self._prefill_jobs
                if self.slots[i] is not None and not self.slots[i].done]
        self._prefill_jobs = []
        if not jobs:
            return
        buckets = list(self.ecfg.prefill_buckets)
        budget = min(self.ecfg.max_context_token_num, buckets[-1])
        b = self.ecfg.max_batch_size
        bp_buckets = [x for x in (2, 4, 8, 16, 32, 64) if x < b] + [b]
        offs = [0] * len(jobs)
        while True:
            live = [(j, jobs[j][0]) for j in range(len(jobs))
                    if offs[j] < len(jobs[j][1])
                    and self.slots[jobs[j][0]] is not None]
            if not live:
                break
            if len(live) == 1:
                j, slot_idx = live[0]
                _, ids, start = jobs[j]
                chunk = ids[offs[j]:offs[j] + budget]
                for padded, pos, n in self._iter_chunks(chunk,
                                                        start + offs[j]):
                    S.prefill_chunks(self.params, self.cache, self.state,
                                     self._dev([slot_idx]),
                                     self._dev(padded[None]),
                                     self._dev(np.int32([pos])),
                                     self._dev(np.int32([n])), self.cfg)
                    self.stats['prefill_passes'] += 1
                offs[j] += len(chunk)
            else:
                # the aggregate tokens of one pass stay within the budget
                max_rows = max(2, budget // buckets[0])
                live = live[:max_rows]
                bp_cap = _bucket_for(len(live), bp_buckets)
                row_budget = max(buckets[0], budget // bp_cap)
                chunks = []
                for j, slot_idx in live:
                    _, ids, start = jobs[j]
                    chunk = ids[offs[j]:offs[j] + row_budget]
                    chunks.append((slot_idx, chunk, start + offs[j]))
                    offs[j] += len(chunk)
                t = _bucket_for(max(len(c) for _, c, _ in chunks), buckets)
                bp = _bucket_for(len(chunks), bp_buckets)
                ids_arr = np.zeros((bp, t), np.int32)
                slots_arr = np.zeros((bp,), np.int32)
                starts_arr = np.zeros((bp,), np.int32)
                lens_arr = np.zeros((bp,), np.int32)  # pad rows: length 0
                for r, (slot_idx, chunk, pos) in enumerate(chunks):
                    ids_arr[r, :len(chunk)] = chunk
                    slots_arr[r] = slot_idx
                    starts_arr[r] = pos
                    lens_arr[r] = len(chunk)
                S.prefill_chunks(self.params, self.cache, self.state,
                                 self._dev(slots_arr), self._dev(ids_arr),
                                 self._dev(starts_arr), self._dev(lens_arr),
                                 self.cfg)
                self.stats['prefill_passes'] += 1
            self._interleave_decode()
        for slot_idx, ids, start in jobs:
            slot = self.slots[slot_idx]
            if slot is None or slot.done:
                continue
            slot.seq.cache_len = start + len(ids)
            slot.prefilling = False
            S.set_active(self.state, slot_idx, True)
        self._fresh_admission = True

    # -- decode ---------------------------------------------------------------
    def _grow_pages(self, steps: int = 1):
        """Pages for the next ``steps`` tokens of every running slot."""
        page = self.ecfg.page_size
        for i, slot in enumerate(self.slots):
            if slot is None or slot.done or slot.prefilling:
                continue
            need = min(slot.context_len + steps, self.session_len)
            if need > len(slot.seq.pages) * page:
                self.seqs.grow(slot.seq, need)
                S.set_page_row(self.state, i, self._page_row(slot.seq))

    def _decode_round(self, steps: int):
        """One dispatch of ``steps`` decode steps (or speculative rounds)
        with a single packed readback; right after an admission it is one
        step long so the first token streams at once.  The host picks the
        static mode from the running slots' configs: plain rounds take
        'greedy' (every slot plain greedy), 'candidates' or 'full' (a slot
        with top_k <= 0); speculative rounds, while running * (K+1) <=
        SPEC_MAX_VERIFY_ROWS and the acceptance gate is open, take 'greedy'
        or, with ``speculative_sampled``, 'candidates' / 'full'."""
        cfgs = [s.request.gen_config for s in self.slots
                if s is not None and not s.done and not s.prefilling]
        if not cfgs:
            return
        if self._fresh_admission:
            self._ramp = 1
            self._fresh_admission = False
        k = max(1, min(steps, self._ramp))
        self._ramp = max(1, steps)
        self._grow_pages(k)
        topn = self.MAX_TOP_LOGPROBS if any(
            (g.top_logprobs or 0) > 0 for g in cfgs) else 0
        # the full-vocabulary passes run only when a running slot needs them
        passes = (any(bool(g.bad_words) for g in cfgs),
                  any(g.repetition_penalty != 1.0 or g.presence_penalty != 0.0
                      or g.frequency_penalty != 0.0 for g in cfgs))
        greedy = _all_plain_greedy(cfgs)
        sampled = 'full' if any((g.top_k or 0) <= 0 for g in cfgs) \
            else 'candidates'
        kd = self.ecfg.speculative_k
        if kd > 0 and len(cfgs) * (kd + 1) <= self.SPEC_MAX_VERIFY_ROWS \
                and (greedy or self.ecfg.speculative_sampled):
            if self._spec_cooloff <= 0:
                self._spec_round(k, 'greedy' if greedy else sampled, topn,
                                 passes)
                return
            # low recent acceptance: plain rounds, re-probe later
            self._spec_cooloff -= 1
            self.stats['spec_fallbacks'] += 1
            if self._spec_cooloff == 0:
                self._spec_accept_ema = None
        # Deliberate difference: the JAX engine sends plain greedy rounds
        # through its 'candidates' mode with top_k 1 (a TPU schedule
        # choice), whose token is the same argmax; the port calls
        # 'greedy'.  Keys split alike in both.
        self.state, packed, _ = S.decode_steps(
            self.params, self.cache, self.state, self.cfg, num_steps=k,
            sampling_mode='greedy' if greedy else sampled, topn=topn,
            passes=passes)
        self.stats['decode_steps'] += k
        arr = packed.cpu().numpy()        # [5 + 2*topn, k, B]
        logprobs = np.ascontiguousarray(arr[2]).view(np.float32)
        for t in range(k):
            # the key as of sub-step t: a slot retired at t saves it
            self._rng_now = np.ascontiguousarray(arr[3:5, t].T).view(
                np.uint32)
            tops = None
            if topn:
                tops = (arr[5:5 + topn, t].T, np.ascontiguousarray(
                    arr[5 + topn:5 + 2 * topn, t].T).view(np.float32))
            self._emit(arr[0, t], arr[1, t], logprobs[t], tops=tops)
            if not any(s is not None and not s.done for s in self.slots):
                return

    def _spec_round(self, rounds: int, sampling: str, topn: int,
                    passes):
        """One dispatch of ``rounds`` draft-verify-accept rounds; each
        emits 1 to K+1 tokens per running slot.  An EMA of accepted tokens
        per round over the dispatch gates speculation: below
        SPEC_MIN_ACCEPT the engine cools off to plain rounds.  Dispatches
        of fewer than 8 live rounds (the one-round burst after an
        admission, when the history is too short to match) are not
        evidence."""
        kp1 = self.ecfg.speculative_k + 1
        self._grow_pages(rounds * kp1)
        self.state, packed = S.spec_decode_rounds(
            self.params, self.cache, self.state, self.cfg,
            num_rounds=rounds, k_draft=kp1 - 1,
            ngram=self.ecfg.speculative_ngram,
            ngram_min=self.ecfg.speculative_ngram_min, sampling=sampling,
            topn=topn, passes=passes)
        arr = packed.cpu().numpy()   # [R, 3*kp1 + 3 + 2*kp1*topn, B]
        emitted = arr[:, 2 * kp1]                           # [R, B]
        if int((emitted.sum(axis=1) > 0).sum()) >= 8:
            acc = float(emitted.sum() / max((emitted > 0).sum(), 1))
            ema = self._spec_accept_ema
            self._spec_accept_ema = acc if ema is None \
                else 0.7 * ema + 0.3 * acc
            if self._spec_accept_ema < self.SPEC_MIN_ACCEPT:
                self._spec_cooloff = self.SPEC_COOLOFF_DISPATCHES
        # every round of the dispatch ran on the device, also those after
        # the last slot finished
        self.stats['spec_rounds'] += rounds
        base = 3 * kp1 + 3
        for r in range(arr.shape[0]):
            g, fin, n = arr[r, :kp1], arr[r, kp1:2 * kp1], arr[r, 2 * kp1]
            logp = np.ascontiguousarray(
                arr[r, 2 * kp1 + 1:3 * kp1 + 1]).view(np.float32)
            # keys advance once per round: a slot retired in round r saves
            # the key as of round r
            self._rng_now = np.ascontiguousarray(
                arr[r, 3 * kp1 + 1:3 * kp1 + 3].T).view(np.uint32)
            self.stats['spec_emitted'] += int(n.sum())
            for t in range(kp1):
                mask = t < n
                if not mask.any():
                    break
                tops = None
                if topn:
                    at = base + t * topn
                    tops = (arr[r, at:at + topn].T, np.ascontiguousarray(
                        arr[r, at + kp1 * topn:at + kp1 * topn + topn].T)
                        .view(np.float32))
                self._emit(g[t], fin[t], logp[t], mask=mask, tops=tops)
                if not any(s is not None and not s.done
                           for s in self.slots):
                    return

    def _emit(self, toks_np: np.ndarray, fin_np: np.ndarray,
              logprobs_np: np.ndarray, mask: Optional[np.ndarray] = None,
              tops: Optional[tuple] = None):
        """Stream one token to every running slot (those of ``mask``
        only): stop sequences and the holdback of a possible stop prefix
        on the host, logprobs and the top-N dicts where requested."""
        for i, slot in enumerate(self.slots):
            if slot is None or slot.done or slot.prefilling:
                continue
            if mask is not None and not mask[i]:
                continue
            slot.saw_round = True
            self.stats['generated_tokens'] += 1
            tok = int(toks_np[i])
            gcfg = slot.request.gen_config
            want_lp = gcfg.output_logprobs or gcfg.top_logprobs
            if want_lp:
                slot.logprobs.append(float(logprobs_np[i]))
            if tops is not None and gcfg.top_logprobs:
                n = min(gcfg.top_logprobs, tops[0].shape[1])
                slot.top_lps.append({
                    int(tid): float(tlp)
                    for tid, tlp in zip(tops[0][i, :n], tops[1][i, :n])})
            slot.generated += 1
            slot.context_len += 1
            slot.seq.token_ids.append(tok)
            slot.seq.cache_len = slot.context_len
            slot.tail.append(tok)
            finished = bool(fin_np[i])
            hit_stop = None
            if tok in slot.host_single_stops:
                hit_stop = [tok]
            else:
                for sw in slot.stop_sequences:
                    if slot.tail[-len(sw):] == sw:
                        hit_stop = sw
                        break
            if hit_stop and not finished:
                S.set_finished(self.state, i)
                finished = True
            new_tokens = slot.seq.token_ids[slot.prompt_len:]
            # stop text never reaches the client; while running, withhold
            # the tokens that may still grow into a stop sequence
            if finished:
                if hit_stop:
                    visible = new_tokens[:len(new_tokens) - len(hit_stop)]
                elif tok in slot.single_stops:
                    visible = new_tokens[:-1]
                else:
                    visible = new_tokens
            else:
                visible = new_tokens[:max(0, len(new_tokens)
                                          - slot.holdback)]
            slot.out_q.put(EngineOutput(
                ResponseType.FINISH if finished else ResponseType.SUCCESS,
                list(visible), len(visible), finished=finished,
                logprobs=list(slot.logprobs[:len(visible)])
                if want_lp else None,
                top_logprobs=list(slot.top_lps[:len(visible)])
                if gcfg.top_logprobs else None))
            if finished:
                slot.done = True
                self._retire(i, ResponseType.FINISH)

    def _retire(self, slot_idx: int, status: ResponseType):
        """Release the slot; keep or drop the session per sequence_end."""
        slot = self.slots[slot_idx]
        if slot is None:
            return
        self.stats['canceled' if status == ResponseType.CANCELED
                   else 'finished'] += 1
        if self._rng_now is not None and slot.saw_round:
            slot.seq.rng_key = self._rng_now[slot_idx]
        else:
            slot.seq.rng_key = self.state.sampling.rng_key[slot_idx] \
                .cpu().numpy().view(np.uint32)
        S.clear_slot(self.state, slot_idx)
        if slot.request.sequence_end:
            self.seqs.erase(slot.request.session_id)
        else:
            self.seqs.release(slot.seq)
        self.slots[slot_idx] = None


def _get_or_dead(out_q: queue.Queue, engine: TorchEngine) -> EngineOutput:
    """The next output frame, or INTERNAL_ERROR once the engine thread is
    gone (a client never hangs on a dead engine)."""
    while True:
        try:
            return out_q.get(timeout=1.0)
        except queue.Empty:
            if not engine.alive():
                return EngineOutput(ResponseType.INTERNAL_ERROR, [], 0,
                                    finished=True)


class EngineInstance:
    """Per-frontend handle (reference: TurboMindInstance)."""

    def __init__(self, engine: TorchEngine):
        self.engine = engine

    def stream_infer(self, session_id: int, input_ids,
                     gen_config: Optional[GenerationConfig] = None,
                     sequence_start: bool = True, sequence_end: bool = False,
                     step: int = 0):
        """Blocking generator of EngineOutput (incremental token lists)."""
        out_q = self.engine.submit(EngineRequest(
            session_id=session_id, input_ids=list(map(int, input_ids)),
            gen_config=gen_config or GenerationConfig(),
            sequence_start=sequence_start, sequence_end=sequence_end,
            step=step))
        while True:
            out = _get_or_dead(out_q, self.engine)
            yield out
            if out.finished:
                return

    def infer(self, session_id: int, input_ids, **kw) -> EngineOutput:
        last = None
        for last in self.stream_infer(session_id, input_ids, **kw):
            pass
        return last

    def cancel(self, session_id: int):
        self.engine.cancel(session_id)

    def end(self, session_id: int):
        self.engine.end_session(session_id)


__all__ = ['TorchEngine', 'EngineInstance', 'resolve_device']
