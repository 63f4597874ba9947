"""Single-endpoint multi-host request router.

Port of ``lmdeploy_tpu/serve/router.py`` over :class:`TorchEngine`.  Every
host runs its own engine over its local card, and ONE host exposes the
HTTP front end: a :class:`RouterEngine` that forwards EngineRequests to
peer hosts over TCP and streams EngineOutputs back, so clients see a
single logical endpoint while sessions stay resident (KV pages and all)
on the host that owns them.  (The reference engine is single-node:
turbomind.py:81-83 binds node_id=0.)

Pieces:
- :func:`serve_engine` — engine-side worker: accepts router connections
  and pumps requests into the local engine, streaming outputs back.
- :class:`RemoteEngine` — client handle for one peer; submit() has the
  same contract as TorchEngine.submit (returns a Queue of EngineOutput).
- :class:`RouterEngine` — TorchEngine-compatible facade over the local
  engine + remote peers with session-sticky, least-loaded routing.
  ``AsyncEngine`` and the OpenAI server sit on top unchanged
  (EngineInstance only needs submit / cancel / end_session).

Transport is length-prefixed JSON frames, byte-compatible with the JAX
package's, so a router of either package can drive a worker of the other.
"""
from __future__ import annotations

import dataclasses
import json
import queue
import socket
import struct
import threading
from typing import Dict, List, Optional

import numpy as np

from ..messages import (EngineOutput, EngineRequest, GenerationConfig,
                        ResponseType)
from ..utils.logger import get_logger

log = get_logger()

_LEN = struct.Struct('>I')

# frame-size caps: a malformed/hostile peer must not make one recv
# allocate unbounded memory.  Requests (engine side) are token ids +
# gen config — 16 MB is orders of magnitude above any real request;
# outputs (router side) can carry base64 full-vocab logits for long
# prompt scoring, so the bound is looser but still finite.
MAX_REQ_FRAME = 16 << 20
MAX_OUT_FRAME = 1 << 30


def _send_frame(sock: socket.socket, obj: dict, lock: threading.Lock):
    data = json.dumps(obj).encode()
    with lock:
        sock.sendall(_LEN.pack(len(data)) + data)


def _recv_frame(sock: socket.socket,
                max_frame: int = MAX_OUT_FRAME) -> Optional[dict]:
    hdr = b''
    while len(hdr) < _LEN.size:
        chunk = sock.recv(_LEN.size - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    n = _LEN.unpack(hdr)[0]
    if n > max_frame:
        raise ValueError(f'frame of {n} bytes exceeds cap {max_frame}')
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 16, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return json.loads(bytes(buf))


def _req_to_wire(req: EngineRequest) -> dict:
    d = dataclasses.asdict(req)
    d['input_ids'] = list(map(int, req.input_ids))
    return d


def _req_from_wire(d: dict) -> EngineRequest:
    gc = GenerationConfig(**d.pop('gen_config'))
    return EngineRequest(gen_config=gc, **d)


def _out_to_wire(out: EngineOutput) -> dict:
    d = {'status': int(out.status), 'token_ids': list(map(int, out.token_ids)),
         'num_generated': int(out.num_generated), 'finished': out.finished}
    if out.logprobs is not None:
        d['logprobs'] = [float(x) for x in out.logprobs]
    if out.logits is not None:
        arr = np.asarray(out.logits, np.float32)
        d['logits_shape'] = list(arr.shape)
        import base64
        d['logits_b64'] = base64.b64encode(arr.tobytes()).decode()
    return d


def _out_from_wire(d: dict) -> EngineOutput:
    logits = None
    if 'logits_b64' in d:
        import base64
        logits = np.frombuffer(
            base64.b64decode(d['logits_b64']), np.float32).reshape(
            d['logits_shape'])
    return EngineOutput(
        status=ResponseType(d['status']), token_ids=d['token_ids'],
        num_generated=d['num_generated'], finished=d['finished'],
        logits=logits, logprobs=d.get('logprobs'))


# ---------------------------------------------------------------------------
# engine-side worker
# ---------------------------------------------------------------------------

def serve_engine(engine, host: str = '0.0.0.0', port: int = 0,
                 ready_event: Optional[threading.Event] = None):
    """Serve ``engine`` to routers.  Blocks; run on the peer host's main
    thread (or a dedicated thread).  Returns never; the listening port is
    published via ``serve_engine.port`` before ``ready_event`` is set."""
    srv = socket.create_server((host, port))
    serve_engine.port = srv.getsockname()[1]
    if ready_event is not None:
        ready_event.set()
    log.info('engine worker listening on %s:%d', host, serve_engine.port)
    while True:
        conn, addr = srv.accept()
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        threading.Thread(target=_serve_conn, args=(engine, conn),
                         daemon=True, name=f'router-conn-{addr}').start()


def _serve_conn(engine, conn: socket.socket):
    wlock = threading.Lock()
    try:
        while True:
            frame = _recv_frame(conn, max_frame=MAX_REQ_FRAME)
            if frame is None:
                return
            if frame.get('type') == 'metrics':
                _send_frame(conn, {'rid': frame['rid'],
                                   'metrics': engine.metrics()}, wlock)
                continue
            rid = frame['rid']
            req = _req_from_wire(frame['req'])
            out_q = engine.submit(req)

            def drain(rid=rid, out_q=out_q):
                from ..engine.engine import _get_or_dead
                while True:
                    # liveness-aware wait: a worker engine that dies
                    # mid-request must surface a final INTERNAL_ERROR
                    # frame instead of hanging this drain (and the
                    # router-side client) forever
                    out = _get_or_dead(out_q, engine)
                    msg = _out_to_wire(out)
                    msg['rid'] = rid
                    try:
                        _send_frame(conn, msg, wlock)
                    except OSError:
                        return
                    if out.finished:
                        return

            threading.Thread(target=drain, daemon=True,
                             name=f'router-drain-{rid}').start()
    except Exception:
        # per-connection isolation: ANY malformed frame (bad length
        # prefix, oversize, invalid JSON, missing/invalid fields) drops
        # THIS connection only — the engine pump and every other router
        # connection keep serving (tests/test_router.py)
        log.exception('router connection dropped')
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# router side
# ---------------------------------------------------------------------------

class RemoteEngine:
    """Client handle for one peer engine; TorchEngine-submit compatible."""

    # router-side cap on concurrently streaming requests per peer before
    # overloaded() reports backpressure (the peer enforces its own
    # max_pending_requests with QUEUE_FULL; this keeps the HTTP-level
    # 429 fast path alive behind the router)
    IN_FLIGHT_LIMIT = 256

    def __init__(self, address: str):
        host, port = address.rsplit(':', 1)
        self.address = address
        self._sock = socket.create_connection((host, int(port)))
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._wlock = threading.Lock()
        self._rid = 0
        self._rid_lock = threading.Lock()
        # _qlock serializes _queues/_dead between submit and the reader:
        # a submit racing the reader's fail-all would otherwise register a
        # queue nobody ever fills and hang its client forever
        self._qlock = threading.Lock()
        self._dead = False
        self._queues: Dict[int, queue.Queue] = {}
        self.in_flight = 0
        threading.Thread(target=self._reader, daemon=True,
                         name=f'router-reader-{address}').start()

    def _next_rid(self) -> int:
        with self._rid_lock:
            self._rid += 1
            return self._rid

    def _reader(self):
        while True:
            try:
                frame = _recv_frame(self._sock)
            except (OSError, ValueError):
                # a reset/abort must run the same fail-all path as a clean
                # EOF — an unhandled exception here would strand every
                # in-flight client forever
                frame = None
            if frame is None:
                # peer gone: fail every in-flight request and refuse new
                # ones (under _qlock so no submit can slip in between the
                # snapshot and the clear)
                with self._qlock:
                    self._dead = True
                    stale = list(self._queues.values())
                    self._queues.clear()
                for q in stale:
                    q.put(EngineOutput(ResponseType.INTERNAL_ERROR, [], 0,
                                       finished=True))
                return
            with self._qlock:
                q = self._queues.get(frame['rid'])
            if q is None:
                continue
            if 'metrics' in frame:
                q.put(frame['metrics'])
                with self._qlock:
                    self._queues.pop(frame['rid'], None)
                continue
            out = _out_from_wire(frame)
            q.put(out)
            if out.finished:
                with self._qlock:
                    self._queues.pop(frame['rid'], None)
                self.in_flight = max(0, self.in_flight - 1)

    def submit(self, req: EngineRequest) -> queue.Queue:
        rid = self._next_rid()
        out_q: queue.Queue = queue.Queue()
        with self._qlock:
            if self._dead:
                out_q.put(EngineOutput(ResponseType.INTERNAL_ERROR, [], 0,
                                       finished=True))
                return out_q
            self._queues[rid] = out_q
        self.in_flight += 1
        try:
            _send_frame(self._sock, {'rid': rid, 'req': _req_to_wire(req)},
                        self._wlock)
        except OSError:
            with self._qlock:
                self._queues.pop(rid, None)
            self.in_flight -= 1
            out_q.put(EngineOutput(ResponseType.INTERNAL_ERROR, [], 0,
                                   finished=True))
        return out_q

    def overloaded(self) -> bool:
        """Backpressure proxy for a peer we can't cheaply ask: dead peers
        and peers with a full router-side in-flight window count as
        overloaded so RouterEngine's pre-admission 429 can fire."""
        return self._dead or self.in_flight >= self.IN_FLIGHT_LIMIT

    def metrics(self, timeout: float = 5.0) -> dict:
        rid = self._next_rid()
        q: queue.Queue = queue.Queue()
        with self._qlock:
            if self._dead:
                return {}
            self._queues[rid] = q
        try:
            _send_frame(self._sock, {'rid': rid, 'type': 'metrics'},
                        self._wlock)
            return q.get(timeout=timeout)
        except (OSError, queue.Empty):
            with self._qlock:
                self._queues.pop(rid, None)
            return {}

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


class RouterEngine:
    """Session-sticky router over the local engine + remote peers.

    Implements the TorchEngine surface the serving layer uses (submit /
    cancel / end_session / create_instance / metrics / overloaded /
    session_len / tokenizer), so ``AsyncEngine`` and the OpenAI server
    run on top unchanged — one HTTP endpoint, sessions resident on any
    host.  New sessions go to the backend with the fewest in-flight
    requests; continuations stay where their KV pages live.
    """

    def __init__(self, local_engine, peer_addresses: List[str]):
        self.local = local_engine
        self.remotes = [RemoteEngine(a) for a in peer_addresses]
        self.backends = [local_engine] + list(self.remotes)
        self.tokenizer = getattr(local_engine, 'tokenizer', None)
        self.chat_template = getattr(local_engine, 'chat_template', None)
        self.session_len = local_engine.session_len
        self.cfg = local_engine.cfg
        self.ecfg = local_engine.ecfg
        self._sticky: Dict[int, int] = {}
        self._lock = threading.Lock()

    # -- routing ---------------------------------------------------------
    def _in_flight(self, idx: int) -> int:
        b = self.backends[idx]
        if isinstance(b, RemoteEngine):
            # dead peers sort last so new sessions route around them
            return (1 << 30) if b._dead else b.in_flight
        return (sum(1 for s in b.slots if s is not None)
                + b._requests.qsize() + len(b._pending))

    def _route(self, req: EngineRequest) -> int:
        with self._lock:
            idx = self._sticky.get(req.session_id)
            if idx is None:
                idx = min(range(len(self.backends)), key=self._in_flight)
                self._sticky[req.session_id] = idx
            return idx

    def _unstick(self, session_id: int):
        with self._lock:
            self._sticky.pop(session_id, None)

    # -- TorchEngine surface -----------------------------------------------
    def alive(self) -> bool:
        """Router liveness = the local engine's (remote-peer death is
        handled by the transport's dead-peer fail-fast, not here)."""
        local_alive = getattr(self.local, 'alive', None)
        return local_alive() if local_alive is not None else True

    def submit(self, req: EngineRequest) -> queue.Queue:
        idx = self._route(req)
        out_q = self.backends[idx].submit(req)
        if req.sequence_end:
            # session leaves its host when it ends; re-route next time
            wrapped: queue.Queue = queue.Queue()

            def relay():
                while True:
                    out: EngineOutput = out_q.get()
                    wrapped.put(out)
                    if out.finished:
                        self._unstick(req.session_id)
                        return

            threading.Thread(target=relay, daemon=True).start()
            return wrapped
        return out_q

    def create_instance(self):
        from ..engine.engine import EngineInstance
        return EngineInstance(self)

    def cancel(self, session_id: int):
        req = EngineRequest(session_id=session_id, input_ids=[],
                            gen_config=GenerationConfig(), stop=True)
        self.submit(req)

    def end_session(self, session_id: int):
        req = EngineRequest(session_id=session_id, input_ids=[],
                            gen_config=GenerationConfig(), stop=True,
                            sequence_end=True)
        self.submit(req)

    def overloaded(self) -> bool:
        return all(getattr(b, 'overloaded', lambda: False)()
                   for b in self.backends) if self.backends else False

    def metrics(self) -> dict:
        out = dict(self.local.metrics())
        out['router_backends'] = len(self.backends)
        for i, r in enumerate(self.remotes):
            for k, v in r.metrics().items():
                out[f'peer{i}_{k}'] = v
        return out

    @property
    def stats(self):
        return self.local.stats

    def shutdown(self):
        for r in self.remotes:
            r.close()
        self.local.shutdown()


__all__ = ['serve_engine', 'RemoteEngine', 'RouterEngine']
