"""Drive the program under a traffic mix: the engine with the harness's
weights (the family's parameter tree), the warm-up, the ramp, the measured
window and its close.

The engine is ``lmdeploy_tpu_torch.engine.engine.TorchEngine``, driven
through ``create_instance().stream_infer`` from one client thread per
closed-loop client, the entry that the program's async front end and API
server sit on.  Each client sends its next request when its last one has
ended; the requests come in the mix's order from one shared sequence.

Around the engine's two dispatch calls (``StepFns.decode_steps`` and
``StepFns.prefill_chunks``) and the decode readback (``StepFns._readback``)
the harness puts wrappers of its own, on the engine's thread: they record
each dispatch's start and end, its shapes (live slots' contexts, prefill
rows), a sample of the pool's free pages, and, while a trace is taken, a
``record_function`` range, so that the device trace can tell decode
issue, readback wait and prefill issue apart.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from lmdeploy_tpu_torch.config import EngineConfig, ModelConfig
from lmdeploy_tpu_torch.engine.engine import TorchEngine
from lmdeploy_tpu_torch.messages import GenerationConfig, ResponseType
from lmdeploy_tpu_torch.ops.linear import PackedInt4Weight

from reference import PROJ
from traffic import Request, Traffic, sampling_of

FINISH = int(ResponseType.FINISH)


@dataclasses.dataclass
class Record:
    """One request as its client saw it (perf_counter seconds)."""
    req: Request
    t_send: float
    t_first: Optional[float] = None
    t_end: Optional[float] = None
    frames: List = dataclasses.field(default_factory=list)  # (t, tokens)
    tokens: List[int] = dataclasses.field(default_factory=list)
    status: Optional[int] = None


@dataclasses.dataclass
class Dispatch:
    """One engine dispatch: ``decode`` (``steps`` steps over live slots
    given as (context_len at issue, tokens still allowed)) or ``prefill``
    (rows as (start, length))."""
    kind: str
    t0: float
    t1: float = 0.0
    steps: int = 0
    live: List = dataclasses.field(default_factory=list)
    rows: List = dataclasses.field(default_factory=list)
    traced: bool = False


def engine_params(raw: Dict) -> Dict[str, Any]:
    """The Llama family's raw weights in the program's parameter layout
    (the same tensors, viewed)."""
    layers = {'attn_norm': raw['attn_norm'], 'ffn_norm': raw['ffn_norm']}
    for name in PROJ:
        w = raw[name]
        layers[name] = PackedInt4Weight(packed=w['packed'],
                                        scales=w['scales'][:, :, None, :],
                                        sz=w['sz'])
    for name in ('bqkv', 'bo'):
        if name in raw:
            layers[name] = raw[name]
    return {'tok_embedding': raw['embed'], 'norm': raw['norm'],
            'lm_head': raw['lm_head'], 'layers': layers}


def gen_config(req: Request, mix: dict) -> GenerationConfig:
    return GenerationConfig(max_new_tokens=req.max_new, ignore_eos=True,
                            random_seed=req.seed, **sampling_of(req, mix))


class Bench:
    """One run of one cell: builds the engine on ``params`` (the family's
    ``engine_params``) and ``kv_scales`` (the engine's part of the
    family's ``kv_qparams``, unopened), drives it, and keeps what the
    window produced."""

    def __init__(self, model: dict, mix: dict, params: Dict, seed: int,
                 device, kv_scales=None, trace=None):
        self.model, self.mix, self.seed = model, mix, seed
        self.traffic = Traffic(mix, seed, model['vocab_size'])
        ecfg = EngineConfig(**mix['engine'])
        self.engine = TorchEngine(ModelConfig(**model), ecfg, params,
                                  device=device, kv_scales=kv_scales)
        self.inst = self.engine.create_instance()
        self.num_pages = self.engine.num_pages
        self.batch = ecfg.max_batch_size
        self.kv_bits = {'int8': 8, 'int4': 4}.get(self.engine.ecfg.kv_dtype, 0)
        self.trace = trace
        self.records: List[Record] = []
        self.dispatches: List[Dispatch] = []
        self.pool_free: List[int] = []
        self._lock = threading.Lock()
        self._next = 0
        self._closing = threading.Event()
        self._in_window = False
        self.t0 = self.t1 = 0.0
        self.stats0 = self.stats1 = {}
        self.host0 = self.host1 = {}
        self._wrap()

    # -- the dispatch wrappers (engine thread) ---------------------------------
    def _range(self, name: str):
        if self.trace is not None and self.trace.active:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _begin(self, kind: str) -> Dispatch:
        if self.trace is not None:
            self.trace.tick()
        if self._in_window:
            self.pool_free.append(
                self.engine.metrics()['free_pages_group0'])
        return Dispatch(kind, time.perf_counter(),
                        traced=self.trace is not None and self.trace.active)

    def _wrap(self) -> None:
        fns, eng = self.engine.fns, self.engine
        decode, prefill, readback, logits = (
            fns.decode_steps, fns.prefill_chunks, fns._readback,
            fns.prefill_logits)

        def decode_steps(*args, **kw):
            d = self._begin('decode')
            d.steps = kw['num_steps']
            d.live = [(s.context_len, s.max_new - s.generated)
                      for s in eng.slots if s is not None and not s.done
                      and not s.prefilling]
            with self._range('portbench.decode'):
                out = decode(*args, **kw)
            d.t1 = time.perf_counter()
            self.dispatches.append(d)
            return out

        def prefill_chunks(params, cache, state, slots, ids, starts, lens):
            d = self._begin('prefill')
            d.rows = [(int(s), int(n)) for s, n in zip(starts, lens) if n > 0]
            with self._range('portbench.prefill'):
                out = prefill(params, cache, state, slots, ids, starts, lens)
            d.t1 = time.perf_counter()
            self.dispatches.append(d)
            return out

        def _readback(packed, t0):
            with self._range('portbench.readback'):
                return readback(packed, t0)

        def prefill_logits(*args, **kw):
            if self.trace is not None:
                self.trace.tick()
            return logits(*args, **kw)

        fns.decode_steps = decode_steps
        fns.prefill_chunks = prefill_chunks
        fns._readback = _readback
        fns.prefill_logits = prefill_logits

    # -- clients ----------------------------------------------------------------
    def serve_one(self, req: Request, session_id: int) -> Record:
        rec = Record(req, time.perf_counter())
        with self._lock:
            self.records.append(rec)
        seen = 0
        for out in self.inst.stream_infer(session_id, req.prompt.tolist(),
                                          gen_config(req, self.mix),
                                          sequence_start=True,
                                          sequence_end=True):
            t = time.perf_counter()
            if out.num_generated > seen:
                seen = out.num_generated
                if rec.t_first is None:
                    rec.t_first = t
                rec.frames.append((t, seen))
            if out.finished:
                rec.status, rec.t_end = int(out.status), t
                rec.tokens = list(out.token_ids)
        return rec

    def _client(self, first: Optional[Request]) -> None:
        if first is not None:
            self.serve_one(first, 1_000_000 + (-1 - first.index))
        while not self._closing.is_set():
            with self._lock:
                i, self._next = self._next, self._next + 1
            self.serve_one(self.traffic.request(i), i + 1)

    def warm_up(self) -> None:
        """The mix's warm-up groups, each sent at once and waited for."""
        for group in self.traffic.warmup_requests():
            threads = [threading.Thread(
                target=self.serve_one, args=(r, 2_000_000 - r.index),
                daemon=True) for r in group]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        with self._lock:
            self.records.clear()

    def open_window(self, ramp_timeout: float = 600.0) -> None:
        """Start the clients and bring the sessions in as the mix's
        ``ramp`` says: ``output`` sends one request a client, with outputs
        from that distribution so that they end at staggered times, and
        waits until each has streamed its first token; ``seconds`` lets
        the clients run that long first."""
        ramp = self.mix.get('ramp', {})
        firsts = self.traffic.ramp_requests() if 'output' in ramp \
            else [None] * self.traffic.clients
        self.clients = [threading.Thread(target=self._client, args=(f,),
                                         daemon=True) for f in firsts]
        for t in self.clients:
            t.start()
        deadline = time.perf_counter() + ramp_timeout
        while 'output' in ramp:
            with self._lock:
                ramp_recs = [r for r in self.records if r.req.index < 0]
            if len(ramp_recs) == len(firsts) and all(
                    r.t_first is not None or r.status is not None
                    for r in ramp_recs):
                break
            if time.perf_counter() > deadline or not self.engine.alive():
                raise RuntimeError('the ramp did not bring the sessions in')
            time.sleep(0.005)
        time.sleep(float(ramp.get('seconds', 0.0)))

    def window(self, seconds: float) -> None:
        """The measured window: ``seconds`` of the clients' load."""
        self.stats0 = dict(self.engine.stats)
        self.host0 = dict(self.engine.fns.host_s)
        self.t0 = time.perf_counter()
        if self.trace is not None:
            self.trace.arm(self.t0 + seconds - self.trace.seconds,
                           self.t0 + seconds)
        self._in_window = True
        time.sleep(max(0.0, self.t0 + seconds - time.perf_counter()))
        self.t1 = time.perf_counter()
        self._in_window = False
        self._closing.set()
        self.stats1 = dict(self.engine.stats)
        self.host1 = dict(self.engine.fns.host_s)

    def drain(self, drain: str, timeout: float = 60.0) -> None:
        """``cancel``: nothing (requests still streaming are cut when the
        engine stops); ``wait``: let every request sent finish first.  A
        trace that no dispatch has stopped two seconds after that (the
        engine went idle) is stopped on the engine's thread, where it
        started, by one short pass of ``EngineInstance.decode``."""
        if drain == 'wait':
            deadline = time.perf_counter() + timeout
            for t in self.clients:
                t.join(max(0.0, deadline - time.perf_counter()))
        if self.trace is not None and not self.trace.wait_stopped(2.0):
            self.inst.decode([0])
            self.trace.wait_stopped(10.0)

    def prompt_argmax(self, records) -> List:
        """For each record, the token the engine's prompt logits put first
        at every position of its prompt and served tokens but the last
        (``EngineInstance.decode``, the prefill path)."""
        out = []
        for r in records:
            ids = list(map(int, r.req.prompt)) + list(r.tokens[:-1])
            out.append(self.inst.decode(ids).argmax(-1))
        return out

    def stop(self) -> None:
        """Stop the engine, then the clients and the trace."""
        self.engine.shutdown()
        for t in self.clients:
            t.join(5.0)
        if self.trace is not None:
            self.trace.stop_if_running()

    def free(self) -> None:
        """Let the engine and its device state go."""
        self.engine = self.inst = None


__all__ = ['Bench', 'Record', 'Dispatch', 'engine_params', 'FINISH']
