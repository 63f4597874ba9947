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
(``quant_policy`` 8): with calibrated per-layer or per-head ``[L, KH]``
``kv_scales``, or without them dynamic per-token-head-group qparams
written beside each token (the JAX engine's default int4 KV).

W4A16 weights handed over byte-per-int4 are nibble-packed at start
where they can pack, as the JAX engine packs them;
``LMDEPLOY_TPU_PACKED_INT4=0`` keeps the byte form, which
``ops/linear.py``'s products serve (``LMDEPLOY_TPU_W4A8=1``: W4A8).

The host session store is the native C++ cache manager
(``kvcache/native.py``, built with g++ at first use), as in the JAX
engine; ``LMDEPLOY_TPU_NATIVE=0`` chooses the Python one
(``kvcache/manager.py``).  Unlike the JAX engine, a failed build raises
with the compiler's message instead of switching to Python.

Also as in the JAX engine: cross-session prefix caching (on by default:
a fresh sequence attaches the published pages of its page-aligned prompt
prefix and skips their prefill; prompts publish after their prefill and
at retirement; off under dynamic-NTK rope), the prompt-logits path
(:meth:`EngineInstance.decode` on a scratch session), the template's
default stop words, :meth:`TorchEngine.metrics` / ``overloaded`` and
:meth:`EngineInstance.async_stream_infer` for a server, and recovery: a
failed rebuild of the device state after a device error is retried at
the top of every loop turn instead of ending the engine thread.

Parallelism (``parallel/``): ``EngineConfig.tp`` shards the weights and
the KV heads over tp ranks (an all-reduce after wo and w2, the vocab
gathered after lm_head); ``pp`` cuts the layers into pipeline stages
(``parallel/pp.py``): decode rounds ride the microbatch ring
(``pp_ring_decode``, on by default: every running slot advances up to
``step_length`` tokens in one dispatch, the stop criteria applied on the
host, :meth:`TorchEngine._ring_round`), speculative rounds keep priority
and relay through the stages, prefill passes ride the GPipe ring; ``dp``
runs dp independent continuous batches, each with ``max_batch_size / dp``
slots, its own page pool (pool-local ids) and its own session store,
sessions sticky to their group.  Rank 0 is this engine: it runs the
scheduler and frames every device dispatch to the other ranks
(``parallel/multihost.py``), which it spawns as processes unless
``torch.distributed`` is already initialised at world dp * pp * tp (one
process per rank, then rank 0 calls ``serve_leader`` and the others
``serve_follower``).  Under several ranks a failed dispatch is fatal: the
engine answers its requests with INTERNAL_ERROR, logs the ranks' exit
codes and stops; it never serves on with fewer ranks.

The JAX engine's fallback that turns speculation off after a failed
speculative dispatch (a TPU runtime workaround) is not ported: such a
failure takes the error path of any failed round.

What the engine thread does is named for the profiler
(``utils/profiler.py::span``, ranges opened only while a profiler records
on that thread): ``engine.requests`` (a turn's request handling),
``engine.admit <session id>`` (one admission; a range's arguments do not
reach an exported trace, so the id is in its name), ``engine.grow_pages``,
``engine.decode_dispatch`` and ``engine.emit``.  ``stats`` follows each
request on the host clock: ``admitted`` / ``queue_wait_s`` (submit to
admission, the wait for a slot included), ``prefilled`` / ``prefill_s``
(admission to the end of its prefill job, passes shared with other jobs
and interleaved decode rounds included), ``first_tokens`` /
``first_token_s`` (the prefill's end, or the admission without one, to
the first token emitted).
``no_free_pages`` counts page shortfalls answered INTERNAL_ERROR (each
logged), ``redecode_tokens`` the tokens of a session's earlier turns that
an admission prefills again (its pages evicted from the store).
``graph_steps`` counts the plain decode steps replayed from CUDA graphs
and ``graph_captures`` the keys captured (``engine/step.py::StepFns``).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..config import EngineConfig, ModelConfig
from ..kvcache.manager import (GroupedSequenceManager, NoFreePages,
                               PageAllocator, SequenceManager)
from ..kvcache.native import NativeSequenceManager
from ..kvcache.paged import KV_WIDTHS, kv_bits_named, kv_dyn_groups
from ..messages import (EngineOutput, EngineRequest, GenerationConfig,
                        ResponseType)
from ..ops import prng
from ..ops.sampling import MAX_STOP_BAD_WORDS
from ..parallel import multihost
from ..parallel import pp as PP
from ..parallel import tp as TP
from ..utils.logger import get_logger
from ..utils.profiler import span

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


def _is_device_error(e: BaseException) -> bool:
    """A failure of the device or its runtime (CUDA errors and out of
    memory are RuntimeErrors in PyTorch), after which the pool's content
    cannot be trusted; the JAX engine tests for its runtime's error type
    by name."""
    return isinstance(e, RuntimeError) and not isinstance(
        e, (NotImplementedError, RecursionError))


def _tree_bytes(tree) -> int:
    """Bytes of every tensor of a parameter tree."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(map(_tree_bytes, tree.values()))
    if dataclasses.is_dataclass(tree):
        return sum(_tree_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0


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
    admit_t: float = 0.0        # time.monotonic() of the admission
    prefill_end_t: Optional[float] = None   # of its prefill job's end


class TorchEngine:
    """Owns device state + the engine thread; frontends attach via
    :meth:`create_instance`."""

    def __init__(self, model_cfg: ModelConfig, engine_cfg: EngineConfig,
                 params: Dict[str, Any], device='cuda', start: bool = True,
                 kv_scales=None, tokenizer=None, stop_words=None,
                 rank_timeout: float = multihost.DEFAULT_TIMEOUT_S):
        """``rank_timeout``: seconds any collective among the ranks may
        wait (dp * pp * tp > 1) before the engine stops with
        RankFailure."""
        self.device = resolve_device(device)
        self.tp, self.dp = max(1, engine_cfg.tp), max(1, engine_cfg.dp)
        self.pp = max(1, engine_cfg.pp)
        if model_cfg.num_layer % self.pp:
            raise ValueError(f'num_layer {model_cfg.num_layer} not '
                             f'divisible by pp={self.pp}')
        b = engine_cfg.max_batch_size
        if b % self.dp:
            raise ValueError(f'max_batch_size {b} not divisible by '
                             f'dp={self.dp}')
        self.b_local = b // self.dp
        kv_bits = kv_bits_named(engine_cfg.kv_dtype)
        kv_scales = kv_scales if kv_bits else None
        self._kv_width = KV_WIDTHS[kv_bits]
        self._kv_scales = kv_scales
        # an int4 pool without calibrated qparams: dynamic per-token-head
        # qparams (the JAX engine's default int4 KV)
        self._dyn_kv = kv_bits == 4 and kv_scales is None
        if engine_cfg.enable_prefix_caching and (
                model_cfg.use_dynamic_ntk
                or model_cfg.rope_scaling_type == 'dynamic'):
            # dynamic-NTK K vectors depend on the TOTAL context length at
            # prefill time, so one session's pages do not fit another's
            log.info('prefix caching disabled: dynamic-NTK rope makes KV '
                     'pages context-length-dependent')
            engine_cfg = dataclasses.replace(engine_cfg,
                                             enable_prefix_caching=False)
        self.cfg = model_cfg
        self.ecfg = engine_cfg
        self.params = params
        self.tokenizer = tokenizer
        self.default_stop_words = list(stop_words or [])

        page = engine_cfg.page_size
        self.session_len = min(engine_cfg.session_len, model_cfg.session_len) \
            if model_cfg.session_len else engine_cfg.session_len
        self.max_pages_per_seq = -(-self.session_len // page)
        self._procs: List[Any] = []
        self.rank_exitcodes: List[Optional[int]] = []
        self.rank_reports: List[Dict[str, Any]] = []
        self.ranks = None
        self.fns = None
        self._own_group = False
        self._rank_timeout = rank_timeout
        world = self.tp * self.pp * self.dp
        # at tp = pp = 1 this packs the tree as the JAX engine packs it at
        # start, after padding inter with exact zeros to a multiple of 2 x
        # group (an odd group count of w2's K, Qwen-14B's 107, cannot
        # half-split; the JAX engine serves it byte-per-int4 with XLA,
        # which the card has no kernel for); on the card every weight is
        # checked against the kernels here, not in the first request
        shards = self._prepare_shards(params)
        rank = dist.get_rank() if world > 1 and dist.is_initialized() else 0
        self.params = shards[rank % (self.tp * self.pp)]
        num_pages = engine_cfg.num_pages or self._derive_num_pages(shards)
        num_pages -= num_pages % self.dp   # one pool of pages per dp group
        if num_pages // self.dp < self.max_pages_per_seq:
            raise ValueError(
                f'{num_pages} pages / dp={self.dp} cannot hold one '
                f'session of {self.max_pages_per_seq} pages')
        self.num_pages = num_pages
        if world > 1:
            self._start_ranks(shards)
        del shards
        try:
            pool, state_shape = self._rank_shapes(
                self.ranks.rank if self.ranks is not None else 0)
            fns = multihost.step_fns_class(self.pp)(
                model_cfg, self.device, pool, state_shape, self.ranks)
            self.cache, self.state = fns.alloc_device_state()
        except BaseException:
            self._stop_ranks()
            raise
        if self.ranks is not None and self.ranks.rank == 0:
            # every dispatch is framed to the other ranks before it runs
            fns = multihost.RecordingFns(
                fns, multihost.FrameChannel(self.ranks.host_group))
        self.fns = fns
        self.native_cache_manager = \
            os.environ.get('LMDEPLOY_TPU_NATIVE', '1') != '0'
        # one store per dp group, over its pool-local page ids
        pages_local = self.num_pages // self.dp
        if self.native_cache_manager:
            stores = [NativeSequenceManager(
                pages_local, page, engine_cfg.cache_max_entry_count,
                enable_prefix_cache=engine_cfg.enable_prefix_caching)
                for _ in range(self.dp)]
        else:
            stores = [SequenceManager(
                PageAllocator(pages_local), page,
                engine_cfg.cache_max_entry_count,
                enable_prefix_cache=engine_cfg.enable_prefix_caching)
                for _ in range(self.dp)]
        self.seqs = GroupedSequenceManager(stores)
        self._scratch_id = -(1 << 40)  # prompt-logits scratch session ids

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
                      'spec_fallbacks': 0, 'prefix_hit_tokens': 0,
                      'ring_rounds': 0, 'admitted': 0, 'queue_wait_s': 0.0,
                      'prefilled': 0, 'prefill_s': 0.0, 'first_tokens': 0,
                      'first_token_s': 0.0, 'no_free_pages': 0,
                      'redecode_tokens': 0, 'graph_steps': 0,
                      'graph_captures': 0}
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
        self._needs_recovery = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name='torch-engine')
        if start:
            self._thread.start()

    def start(self):
        """Start the scheduler thread of a ``start=False`` engine."""
        if not self._thread.is_alive():
            self._thread.start()

    @property
    def _ring_ok(self) -> bool:
        """Decode rounds ride the pipeline's microbatch ring."""
        return self.pp > 1 and self.ecfg.pp_ring_decode

    # -- construction helpers -------------------------------------------------
    def _rank_shapes(self, rank: int):
        """Global rank ``rank``'s ``init_cache`` / ``init_decode_state``
        arguments: its stage's layers, its dp group's pages and slots, its
        KV heads and their qparams."""
        tp_rank, stage = rank % self.tp, rank // self.tp % self.pp
        pool = dict(num_layers=self.cfg.num_layer // self.pp,
                    num_pages=self.num_pages // self.dp,
                    page_size=self.ecfg.page_size,
                    kv_heads=self.cfg.kv_head_num // self.tp,
                    head_dim=self.cfg.size_per_head,
                    dtype=self._kv_width.dtype,
                    kv_scales=TP.shard_kv_scales(self._kv_scales, self.tp,
                                                 tp_rank, self.pp, stage),
                    dynamic_scales=self._dyn_kv)
        state_shape = dict(batch=self.b_local,
                           max_pages=self.max_pages_per_seq,
                           hist_len=self.session_len, eos_id=self.cfg.end_id)
        return pool, state_shape

    def _prepare_shards(self, params) -> List[Dict[str, Any]]:
        """The weight blocks of one dp group's ranks, indexed by ``stage *
        tp + tp_rank`` (``parallel/pp.py::rank_shards``), each checked
        against the card's kernels when the engine runs on CUDA."""
        shards = PP.rank_shards(params, self.cfg, self.tp, self.pp)
        if self.device.type == 'cuda':
            for r, shard in enumerate(shards):
                TP.check_kernel_shapes(shard, r)
        return shards

    def _rank_devices(self) -> List[torch.device]:
        """Rank r on card r when there is a card per rank, else every rank
        on the engine's device (ranks sharing one card, or the CPU)."""
        world = self.tp * self.pp * self.dp
        if self.device.type == 'cuda' and torch.cuda.device_count() >= world:
            return [torch.device('cuda', r) for r in range(world)]
        dev = self.device
        if dev.type == 'cuda' and dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
        return [dev] * world

    def _start_ranks(self, shards) -> None:
        """Join the ranks: the caller's ``torch.distributed`` group of
        world dp * pp * tp, or follower processes spawned here, each handed
        its weight block as CPU shared-memory tensors.  A rank that does not
        come up raises, with the exit codes of those that died."""
        world = self.tp * self.pp * self.dp
        blocks = self.tp * self.pp
        if dist.is_initialized():
            if dist.get_world_size() != world:
                raise ValueError(
                    f'torch.distributed world {dist.get_world_size()} != '
                    f'dp {self.dp} x pp {self.pp} x tp {self.tp}')
            self.ranks = TP.make_ranks(self.tp, self.dp, self.device,
                                       self._rank_timeout, self.pp)
            # every rank sized its pool from its own device: take the least
            pages = torch.tensor([self.num_pages])
            dist.all_reduce(pages, dist.ReduceOp.MIN,
                            group=self.ranks.host_group)
            self.num_pages = int(pages)
            return
        devices = self._rank_devices()
        if self.device.type == 'cuda':
            # built once, here: every rank loads the same library
            from ..ops.cuda import build
            build.load()
        self.device = devices[0]
        self.params = multihost.to_device(self.params, self.device)
        timeout = datetime.timedelta(seconds=self._rank_timeout)
        store = dist.TCPStore('127.0.0.1', 0, world, True, timeout=timeout,
                              wait_for_workers=False)
        ctx = mp.get_context('spawn')
        try:
            for rank in range(1, world):
                pool, state_shape = self._rank_shapes(rank)
                p = ctx.Process(
                    target=multihost.run_rank, daemon=True,
                    name=f'lmdeploy-rank{rank}',
                    args=(rank, self.tp, self.dp, '127.0.0.1', store.port,
                          self._rank_timeout, str(devices[rank]),
                          torch.get_num_threads(), self.cfg, pool,
                          state_shape,
                          multihost.to_device(shards[rank % blocks],
                                               torch.device('cpu')),
                          self.pp))
                p.start()
                self._procs.append(p)
            deadline = time.monotonic() + self._rank_timeout
            keys = [f'ready/{r}' for r in range(1, world)]
            while not store.check(keys):
                if any(p.exitcode is not None for p in self._procs) \
                        or time.monotonic() > deadline:
                    raise multihost.RankFailure(
                        'ranks did not start: exit codes '
                        f'{[p.exitcode for p in self._procs]}')
                time.sleep(0.05)
            dist.init_process_group('gloo', store=store, rank=0,
                                    world_size=world, timeout=timeout)
            self._own_group = True
            self.ranks = TP.make_ranks(self.tp, self.dp, self.device,
                                       self._rank_timeout, self.pp)
        except BaseException:
            self._stop_ranks()
            raise

    def _stop_ranks(self) -> None:
        """Stop the followers (the stop frame; their final reports land in
        ``rank_reports``) and join the spawned ones within 30 s; a rank
        that has not exited by then, or any rank when the stop frame could
        not go out (the ranks are down, or never served), is killed.  Ends
        the group this engine made: after a stop frame at once, since the
        followers end theirs then and NCCL tears a communicator down on
        all its ranks together."""
        stopped = False
        if isinstance(self.fns, multihost.RecordingFns):
            try:
                self.rank_reports = self.fns.stop()
                stopped = self.fns.failure is None
            except Exception:
                log.exception('stopping the ranks failed')
        if stopped:
            self._end_group()
        deadline = time.monotonic() + (30.0 if stopped else 0.0)
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(5.0)
        self.rank_exitcodes = [p.exitcode for p in self._procs]
        self._end_group()

    def _end_group(self) -> None:
        if self._own_group and dist.is_initialized():
            dist.destroy_process_group()
        self._own_group = False

    def _alloc_device_state(self):
        """Fresh KV pool + decode state on every rank."""
        return self.fns.alloc_device_state()

    def _recover_device_state(self):
        """Drop every session and reallocate after a device error (the
        pool's content can no longer be trusted).  The old pool is let go
        first, so that the new one fits."""
        log.warning('resetting device state after a device error')
        try:
            self.seqs.clear()
        except Exception:
            log.exception('session clear failed during recovery')
        self.cache = self.state = None
        self.cache, self.state = self._alloc_device_state()
        self._rng_now = None
        self._prefill_jobs = []

    def _derive_num_pages(self, shards) -> int:
        """Pool size from free device memory (CUDA) or enough pages for
        max_batch_size full sessions (CPU).  A rank holds kv_head_num / tp
        heads of num_layer / pp layers; ranks that share the card split its
        budget, after the weights of the followers still to come."""
        if self.device.type != 'cuda':
            return self.ecfg.max_batch_size * self.max_pages_per_seq
        blocks = self.tp * self.pp
        bytes_per_tok = int(self.cfg.num_layer * 2 * self.cfg.kv_head_num
                            * self.cfg.size_per_head
                            * self._kv_width.elem_bytes) // blocks
        if self._dyn_kv:
            # the dynamic qparams: 4 f32 per token-head-group and layer
            bytes_per_tok += (self.cfg.num_layer * 4 * 4 * self.cfg.kv_head_num
                              * kv_dyn_groups(self.cfg.size_per_head)
                              ) // blocks
        world = blocks * self.dp
        sharing = world if len(set(self._rank_devices())) == 1 else 1
        to_come = 0
        if sharing > 1 and not dist.is_initialized():
            to_come = sum(_tree_bytes(shards[r % blocks])
                          for r in range(1, world))
        free, _ = torch.cuda.mem_get_info(self.device)
        budget = (free - to_come) * self.ecfg.hbm_utilization / sharing
        pages = int(budget // (bytes_per_tok * self.ecfg.page_size)) * self.dp
        return max(pages, 2 * self.max_pages_per_seq * self.dp)

    # -- public API ----------------------------------------------------------
    def create_instance(self) -> 'EngineInstance':
        return EngineInstance(self)

    def alive(self) -> bool:
        return self._thread.is_alive()

    def submit(self, request: EngineRequest) -> queue.Queue:
        out_q: queue.Queue = queue.Queue()
        if not self.alive():
            out_q.put(EngineOutput(ResponseType.INTERNAL_ERROR, [], 0,
                                   finished=True))
            return out_q
        cap = self.ecfg.max_pending_requests
        if cap and not (request.stop or request.return_logits) \
                and self._requests.qsize() + len(self._pending) >= cap:
            self.stats['rejected'] += 1
            out_q.put(EngineOutput(ResponseType.QUEUE_FULL, [], 0,
                                   finished=True))
            return out_q
        self._requests.put((request, out_q, time.monotonic()))
        return out_q

    def overloaded(self) -> bool:
        """Whether a new request would be refused with QUEUE_FULL (a
        server answers 429 before it tokenizes)."""
        cap = self.ecfg.max_pending_requests
        return bool(cap) and \
            self._requests.qsize() + len(self._pending) >= cap

    def metrics(self) -> Dict[str, float]:
        """Counters and gauges for a server's /metrics endpoint."""
        out = dict(self.stats)
        out['queue_depth'] = self._requests.qsize()
        out['pending_requests'] = len(self._pending)
        out['slots_busy'] = sum(1 for s in self.slots if s is not None)
        out['slots_total'] = len(self.slots)
        for g in range(self.dp):
            out[f'free_pages_group{g}'] = self.seqs.free_count(g)
        out['native_cache_manager'] = int(self.native_cache_manager)
        out['tp'], out['pp'], out['dp'] = self.tp, self.pp, self.dp
        out['device_group_nccl'] = int(self.ranks is not None
                                       and self.ranks.backend == 'nccl')
        return out

    def shutdown(self):
        """Stop the engine thread, then the other ranks (joined within
        30 s; ``rank_exitcodes`` and ``rank_reports`` hold how they
        ended)."""
        self._shutdown = True
        if self._thread.is_alive():
            self._thread.join(timeout=10)
        if not self._thread.is_alive():
            self.fns.drop_graphs()
        if self.ranks is not None:
            self._stop_ranks()

    def end_session(self, session_id: int):
        """Free a session's cache (sequence_end)."""
        self.submit(EngineRequest(session_id=session_id, input_ids=[],
                                  gen_config=GenerationConfig(), stop=True,
                                  sequence_end=True))

    def cancel(self, session_id: int):
        self.submit(EngineRequest(session_id=session_id, input_ids=[],
                                  gen_config=GenerationConfig(), stop=True))

    # -- engine loop ----------------------------------------------------------
    def _fail_all_safe(self):
        """:meth:`_fail_all`, but a failed rebuild (the device still out of
        memory, say) arms a retry at the top of each loop turn instead of
        ending the engine thread.  With several ranks a failure is final
        (:meth:`_ranks_down`)."""
        try:
            self._fail_all()
            self._needs_recovery = False
        except multihost.RankFailure as e:
            self._ranks_down(e)
        except Exception:
            log.exception('device-state recovery failed; will retry each '
                          'loop turn')
            self._needs_recovery = True
            time.sleep(0.5)

    def _ranks_down(self, e: BaseException):
        """The ranks fell out of step (one died, timed out or failed a
        dispatch): the engine thread ends; every request already answered
        or still waiting gets INTERNAL_ERROR (:func:`_get_or_dead`)."""
        log.error('the engine\'s ranks are down (%s); spawned ranks\' exit '
                  'codes %s; the engine stops', e,
                  [p.exitcode for p in self._procs])
        self._shutdown = True

    def _ping_ranks(self):
        """Keep the followers' wait for the next frame inside the group's
        timeout while the leader is idle."""
        fns = self.fns
        if isinstance(fns, multihost.RecordingFns) and \
                time.monotonic() - fns.last_frame > self._rank_timeout / 4:
            try:
                fns.ping()
            except multihost.RankFailure as e:
                self._ranks_down(e)

    def _loop(self):
        while not self._shutdown:
            if self._needs_recovery:
                try:
                    self._recover_device_state()
                    self._needs_recovery = False
                except multihost.RankFailure as e:
                    self._ranks_down(e)
                    break
                except Exception:
                    log.exception('device-state recovery failed; will '
                                  'retry each loop turn')
                    time.sleep(0.5)
            busy = any(s is not None for s in self.slots) or self._pending
            if not busy:
                self._ping_ranks()
            try:
                batch = [self._requests.get(timeout=0.0 if busy else 0.05)]
                while True:
                    try:
                        batch.append(self._requests.get_nowait())
                    except queue.Empty:
                        break
                with span('engine.requests'):
                    self._handle_batch(batch)
            except queue.Empty:
                pass
            except Exception:
                log.exception('request handling failed')
            if self._pending and self._free_slot_index() is not None:
                with span('engine.requests'):
                    pending, self._pending = self._pending, []
                    for item in pending:
                        self._handle_safe(*item)
            if self._prefill_jobs:
                try:
                    self._flush_prefills()
                except Exception:
                    log.exception('prefill flush failed')
                    self._fail_all_safe()
            if any(s is not None and not s.done for s in self.slots):
                try:
                    self._decode_round(self.ecfg.step_length)
                except Exception:
                    log.exception('decode round failed')
                    self._fail_all_safe()

    def _fail_all(self):
        """Answer every running request with INTERNAL_ERROR and rebuild
        the device state."""
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            slot.out_q.put(EngineOutput(ResponseType.INTERNAL_ERROR, [],
                                        slot.generated, finished=True))
            try:
                self.seqs.erase(slot.request.session_id)
            except Exception:
                log.exception('session release failed during _fail_all')
            self.slots[i] = None
        self._recover_device_state()

    # -- request handling -----------------------------------------------------
    def _handle_batch(self, batch):
        """Stops and prompt-logits requests first; duplicate session ids
        among queued requests are rejected; admissions sorted by input
        length, longest first."""
        def first(it):
            return it[0].stop or it[0].return_logits
        for item in filter(first, batch):
            self._handle_safe(*item)
        seen = set()
        for req, out_q, t in sorted([it for it in batch if not first(it)],
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
        except Exception as e:
            log.exception('request handling failed (session %s)',
                          req.session_id)
            self.stats['errors'] += 1
            out_q.put(EngineOutput(ResponseType.INTERNAL_ERROR, [], 0,
                                   finished=True))
            # a device error (the logits path's pass, say) leaves the pool
            # untrusted: rebuild
            if _is_device_error(e):
                self._fail_all_safe()

    def _handle_request(self, req: EngineRequest, out_q: queue.Queue,
                        enq_t: Optional[float] = None):
        if req.stop:
            self._handle_stop(req, out_q)
            return
        if req.return_logits:
            self._handle_logits(req, out_q)
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
                self.fns.set_finished(self.state, i)
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

    def _handle_logits(self, req: EngineRequest, out_q: queue.Queue):
        """Prompt logits (:meth:`EngineInstance.decode`): the prompt's
        chunks through ``step.prefill_logits`` on a scratch session that
        never enters the decode batch, erased before the answer is put
        (a caller that reads the store after the answer finds the scratch
        pages free).  Runs on the engine thread, between rounds."""
        ids = list(map(int, req.input_ids))
        if not ids or len(ids) > self.session_len:
            out_q.put(EngineOutput(ResponseType.INPUT_TOO_LONG, [], 0,
                                   finished=True))
            return
        self._scratch_id -= 1          # a unique negative session id
        scratch_id = self._scratch_id
        # dp group 0 holds scratch sessions (StepFns.prefill_logits)
        seq = self.seqs.create(scratch_id, 0)
        seq.active = True              # shielded from eviction
        try:
            self._grow(seq, len(ids), 0)
            row = self._page_row(seq)
            out = []
            for padded, pos, n in self._iter_chunks(ids, 0):
                logits = self.fns.prefill_logits(self.params, self.cache,
                                                 row, padded, pos, n)
                out.append(logits[:n, :self.cfg.vocab_size].float())
            status, logits = (ResponseType.FINISH,
                              torch.cat(out).cpu().numpy())
        except NoFreePages:
            status, logits = ResponseType.INTERNAL_ERROR, None
        finally:
            self.seqs.erase(scratch_id)
        out_q.put(EngineOutput(status, [], 0, finished=True, logits=logits))

    def _free_slot_index(self, group: Optional[int] = None) -> Optional[int]:
        """First free slot, in ``group``'s slot range when a session is
        sticky to a dp group (its pages live in that group's pool)."""
        rng = range(len(self.slots)) if group is None else \
            range(group * self.b_local, (group + 1) * self.b_local)
        for i in rng:
            if self.slots[i] is None:
                return i
        return None

    def _pick_group(self) -> Optional[int]:
        """Least-loaded dp group with a free slot (running slots first,
        then free pages)."""
        best, best_key = None, None
        for g in range(self.dp):
            if self._free_slot_index(g) is None:
                continue
            running = sum(1 for i in range(g * self.b_local,
                                           (g + 1) * self.b_local)
                          if self.slots[i] is not None)
            key = (running, -self.seqs.free_count(g))
            if best_key is None or key < best_key:
                best, best_key = g, key
        return best

    def _admit(self, req: EngineRequest, out_q: queue.Queue,
               enq_t: Optional[float] = None):
        # dp groups: a continued session is sticky to the group holding
        # its pages; a new one goes to the least-loaded group
        if not req.sequence_start and req.session_id in self.seqs:
            group = self.seqs.group_of(req.session_id)
            slot_idx = self._free_slot_index(group)
        else:
            group = self._pick_group()
            slot_idx = None if group is None \
                else self._free_slot_index(group)
        if enq_t is None:
            enq_t = time.monotonic()
        if slot_idx is None:
            # busy engine: wait for a free slot (continuous batching)
            self._pending.append((req, out_q, enq_t))
            return
        with span(f'engine.admit {req.session_id}'):
            self._install(req, out_q, enq_t, group, slot_idx)

    def _shortfall(self, seq, tokens: int, group: int) -> None:
        """Count and log a page shortfall that the engine answers with
        INTERNAL_ERROR: the session, the pages its ``tokens`` need (of
        which it holds some) and the pages free in its pool."""
        self.stats['no_free_pages'] += 1
        log.warning('no free pages: session %s asks for %d pages (%d '
                    'tokens; it holds %d), %d free in its pool', seq.seq_id,
                    -(-tokens // self.ecfg.page_size), tokens,
                    len(seq.pages), self.seqs.free_count(group))

    def _grow(self, seq, tokens: int, group: int) -> None:
        """``seqs.grow``; a shortfall is counted and logged
        (:meth:`_shortfall`), then raised."""
        try:
            self.seqs.grow(seq, tokens)
        except NoFreePages:
            self._shortfall(seq, tokens, group)
            raise

    def _install(self, req: EngineRequest, out_q: queue.Queue, enq_t: float,
                 group: int, slot_idx: int):
        """Admit ``req`` into free slot ``slot_idx`` of dp group
        ``group``."""
        admit_t = time.monotonic()
        self.stats['requests'] += 1
        if req.sequence_start:
            seq = self.seqs.create(req.session_id, group)
        else:
            seq = self.seqs.fetch(req.session_id)
            if req.step and req.step < len(seq.token_ids):
                # rewind to an earlier step
                seq.token_ids = seq.token_ids[:req.step]
                try:
                    seq.cache_len = self.seqs.prepare_rewrite(
                        seq, min(seq.cache_len, req.step))
                except NoFreePages:
                    self._shortfall(seq, req.step, group)
                    raise

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

        # cross-session prefix caching: a pageless sequence (fresh, or
        # evicted and about to re-decode) attaches the published pages of
        # its page-aligned prompt prefix and skips their prefill
        if self.ecfg.enable_prefix_caching and not seq.pages \
                and seq.cache_len == 0:
            hit = self.seqs.match_prefix(seq, all_ids)
            if hit:
                self.stats['prefix_hit_tokens'] += hit

        # the earlier turns' tokens that this admission prefills again (all
        # but their last, which was never in the pool)
        redecode = max(0, total_len - len(new_ids) - 1 - seq.cache_len)
        seq.active = True
        self._grow(seq, total_len, group)
        prefill_ids = all_ids[seq.cache_len:-1] if total_len > 1 else []
        start_pos = seq.cache_len
        hist = np.zeros((self.session_len,), np.int32)
        hist[:total_len] = all_ids
        self.fns.install_slot(self.state, slot_idx, all_ids[-1],
                              total_len - 1, hist, total_len,
                              self._page_row(seq),
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
                     max_new=max_new, admit_t=admit_t)
        self.slots[slot_idx] = slot
        self.stats['admitted'] += 1
        self.stats['queue_wait_s'] += admit_t - enq_t
        self.stats['redecode_tokens'] += redecode
        self._fresh_admission = True
        seq.token_ids = all_ids
        if prefill_ids:
            # prefill deferred to one batched pass (_flush_prefills); the
            # slot sits inactive until its KV is written
            slot.prefilling = True
            self.fns.set_active(self.state, slot_idx, False)
            self._prefill_jobs.append((slot_idx, prefill_ids, start_pos))

    def _page_row(self, seq) -> np.ndarray:
        row = np.full((self.max_pages_per_seq,), -1, np.int32)
        row[:len(seq.pages)] = seq.pages
        return row

    def _stop_sequences(self, gen: GenerationConfig) -> List[List[int]]:
        """The request's stop words, else the template's defaults."""
        return [[int(x) for x in w] if isinstance(w, (list, tuple))
                else [int(w)]
                for w in (gen.stop_words or self.default_stop_words)]

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
            rng_key=key.view(np.int32).copy(), bad_words=bad, stop_words=stop,
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
                    self.fns.prefill_chunks(
                        self.params, self.cache, self.state,
                        np.int32([slot_idx]), padded[None], np.int32([pos]),
                        np.int32([n]))
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
                self.fns.prefill_chunks(self.params, self.cache, self.state,
                                        slots_arr, ids_arr, starts_arr,
                                        lens_arr)
                self.stats['prefill_passes'] += 1
            self._interleave_decode()
        now = time.monotonic()
        for slot_idx, ids, start in jobs:
            slot = self.slots[slot_idx]
            if slot is None or slot.done:
                continue
            slot.prefill_end_t = now
            self.stats['prefilled'] += 1
            self.stats['prefill_s'] += now - slot.admit_t
            slot.seq.cache_len = start + len(ids)
            slot.prefilling = False
            self.fns.set_active(self.state, slot_idx, True)
            if self.ecfg.enable_prefix_caching:
                # insert-only publish: the prompt is shareable now, not
                # only at retirement
                self.seqs.publish(slot.seq)
        self._fresh_admission = True

    # -- decode ---------------------------------------------------------------
    def _grow_pages(self, steps: int = 1):
        """Pages for the next ``steps`` tokens of every running slot."""
        page = self.ecfg.page_size
        with span('engine.grow_pages'):
            for i, slot in enumerate(self.slots):
                if slot is None or slot.done or slot.prefilling:
                    continue
                need = min(slot.context_len + steps, self.session_len)
                if need > len(slot.seq.pages) * page:
                    self._grow(slot.seq, need, i // self.b_local)
                    self.fns.set_page_row(self.state, i,
                                          self._page_row(slot.seq))

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
        # (and ring rounds) through its 'candidates' mode with top_k 1 (a
        # TPU schedule choice), whose token is the same argmax; the port
        # calls 'greedy'.  Keys split alike in both.
        mode = 'greedy' if greedy else sampled
        if self._ring_ok:
            self._ring_round(k, mode, topn, passes)
            return
        with span('engine.decode_dispatch'):
            self.state, arr = self.fns.decode_steps(
                self.params, self.cache, self.state, num_steps=k,
                sampling_mode=mode, topn=topn,
                passes=passes)            # arr: [5 + 2*topn, k, B]
        self.stats['decode_steps'] += k
        self.stats['graph_steps'] = self.fns.graph_steps
        self.stats['graph_captures'] = self.fns.graph_captures
        logprobs = np.ascontiguousarray(arr[2]).view(np.float32)
        with span('engine.emit'):
            for t in range(k):
                # the key as of sub-step t: a slot retired at t saves it
                self._rng_now = np.ascontiguousarray(arr[3:5, t].T).view(
                    np.uint32)
                tops = None
                if topn:
                    tops = (arr[5:5 + topn, t].T, np.ascontiguousarray(
                        arr[5 + topn:5 + 2 * topn, t].T).view(np.float32))
                self._emit(arr[0, t], arr[1, t], logprobs[t], tops=tops)
                if not any(s is not None and not s.done
                           for s in self.slots):
                    return

    def _ring_round(self, k: int, mode: str, topn: int, passes):
        """One dispatch of up to ``k`` rounds on the pipeline's microbatch
        ring (``parallel/pp.py::pp_decode_sampled``), every running slot
        advancing one token a round.  The ring runs ungated, so ``k`` is
        clamped to every running slot's remaining allowance (max_new
        already folds in the session cap, so no slot writes past its
        pages) and rounded down to a power of two, the pages for ``k``
        tokens are grown first, and the stop criteria (EOS, a single-token
        stop word, the length) apply here to the [k, B] readback.  A slot
        that stops mid-dispatch retires on the spot; its device state
        overshoots by the rest of the dispatch, dead until the next
        install_slot (the host counts emitted tokens only)."""
        run = [(i, s) for i, s in enumerate(self.slots)
               if s is not None and not s.done and not s.prefilling]
        k = max(1, min([k] + [s.max_new - s.generated for _, s in run]))
        k = 1 << (k.bit_length() - 1)
        self._grow_pages(k)
        with span('engine.decode_dispatch'):
            self.state, pk = self.fns.decode_rounds_sampled(
                self.params, self.cache, self.state, rounds=k,
                sampling_mode=mode, topn=topn, passes=passes)
        # pk: [4 + 2*topn, k, B]
        lps = np.ascontiguousarray(pk[1]).view(np.float32)
        self.stats['ring_rounds'] += k
        with span('engine.emit'):
            fin = np.zeros((pk.shape[2],), np.int32)
            eos = self.cfg.end_id
            for t in range(k):
                # the key as of round t: a slot retired at t saves it
                self._rng_now = np.ascontiguousarray(pk[2:4, t].T).view(
                    np.uint32)
                fin[:] = 0
                for i, s in run:
                    if s.done:
                        continue
                    tok = int(pk[0, t, i])
                    if (tok == eos and not s.request.gen_config.ignore_eos) \
                            or tok in s.single_stops \
                            or s.generated + 1 >= s.max_new:
                        fin[i] = 1
                tops = None
                if topn:
                    tops = (pk[4:4 + topn, t].T, np.ascontiguousarray(
                        pk[4 + topn:4 + 2 * topn, t].T).view(np.float32))
                self._emit(pk[0, t], fin, lps[t], tops=tops)
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
        # arr: [R, 3*kp1 + 3 + 2*kp1*topn, B]
        with span('engine.decode_dispatch'):
            self.state, arr = self.fns.spec_decode_rounds(
                self.params, self.cache, self.state, num_rounds=rounds,
                k_draft=kp1 - 1, ngram=self.ecfg.speculative_ngram,
                ngram_min=self.ecfg.speculative_ngram_min, sampling=sampling,
                topn=topn, passes=passes)
        emitted = arr[:, 2 * kp1]                           # [R, B]
        if int((emitted.sum(axis=1) > 0).sum()) >= 8:
            acc = float(emitted.sum() / max((emitted > 0).sum(), 1))
            ema = self._spec_accept_ema
            self._spec_accept_ema = acc if ema is None \
                else 0.7 * ema + 0.3 * acc
            if self._spec_accept_ema < self.SPEC_MIN_ACCEPT:
                self._spec_cooloff = self.SPEC_COOLOFF_DISPATCHES
        with span('engine.emit'):
            base = 3 * kp1 + 3
            for r in range(arr.shape[0]):
                g, fin, n = arr[r, :kp1], arr[r, kp1:2 * kp1], arr[r, 2 * kp1]
                logp = np.ascontiguousarray(
                    arr[r, 2 * kp1 + 1:3 * kp1 + 1]).view(np.float32)
                # keys advance once per round: a slot retired in round r saves
                # the key as of round r
                self._rng_now = np.ascontiguousarray(
                    arr[r, 3 * kp1 + 1:3 * kp1 + 3].T).view(np.uint32)
                # rounds up to the one in which the last running slot finished
                # (the device runs the dispatch's rest masked)
                self.stats['spec_rounds'] += 1
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
        now = None
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
            if slot.generated == 1:
                now = time.monotonic() if now is None else now
                self.stats['first_tokens'] += 1
                self.stats['first_token_s'] += now - (
                    slot.admit_t if slot.prefill_end_t is None
                    else slot.prefill_end_t)
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
                self.fns.set_finished(self.state, i)
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
            slot.seq.rng_key = self.fns.slot_key(self.state, slot_idx)
        self.fns.clear_slot(self.state, slot_idx)
        if self.ecfg.enable_prefix_caching:
            # unbound from the slot first, then its full pages go into the
            # prefix index (safe even though erase may free the rest)
            self.seqs.release(slot.seq)
            self.seqs.publish(slot.seq)
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

    async def async_stream_infer(self, session_id: int, input_ids,
                                 gen_config: Optional[GenerationConfig] = None,
                                 sequence_start: bool = True,
                                 sequence_end: bool = False, step: int = 0):
        """Async generator of EngineOutput: the blocking wait for each
        frame runs in the loop's default executor."""
        import asyncio
        out_q = self.engine.submit(EngineRequest(
            session_id=session_id, input_ids=list(map(int, input_ids)),
            gen_config=gen_config or GenerationConfig(),
            sequence_start=sequence_start, sequence_end=sequence_end,
            step=step))
        loop = asyncio.get_running_loop()
        while True:
            out = await loop.run_in_executor(None, _get_or_dead, out_q,
                                             self.engine)
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

    def decode(self, input_ids) -> np.ndarray:
        """Prompt logits f32 [len(input_ids), vocab] (for perplexity): row
        t predicts token t + 1.  Runs on the engine thread, between
        rounds."""
        req = EngineRequest(session_id=-1,
                            input_ids=list(map(int, input_ids)),
                            gen_config=GenerationConfig(), return_logits=True)
        out = _get_or_dead(self.engine.submit(req), self.engine)
        if out.logits is None:
            raise RuntimeError(f'decode failed: {out.status!r}')
        return out.logits


__all__ = ['TorchEngine', 'EngineInstance', 'resolve_device']
