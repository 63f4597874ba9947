"""Ranks of one engine across processes: rank-0 scheduling, follower replay.

Port of ``lmdeploy_tpu/parallel/multihost.py`` over ``torch.distributed``.
The engine's scheduler is dynamic (admission timing, readback-driven
retirement), so rank 0 (the leader) runs the real scheduler, and every
device dispatch it makes is serialised as a control frame that the other
ranks (followers) replay against their own device state: each holds its
block of the weights and of the KV pool (``parallel/tp.py``) and its dp
group's slots, and issues the same collectives in the same order.  Frames
carry host arguments only (slot ids, token arrays, sampling rows), never a
tensor; the port updates the pool and the state in place, and
:data:`_DEV_OUT` says which outputs replace a rank's state.

Two launches:

- One process: ``TorchEngine(cfg, EngineConfig(tp=2))`` (or ``pp=``,
  ``dp=``) spawns the followers itself (:func:`run_rank`) and stops them at
  ``shutdown()``.
- One process per rank, on one host or several: every process calls
  :func:`init_multihost` (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``) and builds the engine from the same checkpoint
  with ``start=False``; rank 0 calls :func:`serve_leader`, the others
  :func:`serve_follower`.  ``python -m lmdeploy_tpu_torch.parallel.multihost
  <workspace> --tp 2 [--pp 2] [--dp 2]`` is such a follower.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import pickle
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..engine.step import StepFns
from .pp import PPStepFns
from .tp import make_ranks

# seconds every process group waits in a collective before it raises; a
# leader idle for a quarter of it sends a ping frame (engine/engine.py)
DEFAULT_TIMEOUT_S = 300.0


def init_multihost(init_method: Optional[str] = None,
                   world_size: Optional[int] = None,
                   rank: Optional[int] = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Initialise ``torch.distributed``'s default (gloo) group from the
    arguments or the standard env vars (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  Returns this rank."""
    kw = {}
    if world_size is not None:
        kw['world_size'] = world_size
    if rank is not None:
        kw['rank'] = rank
    dist.init_process_group(
        'gloo', init_method=init_method or 'env://',
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dist.get_rank()


def broadcast_control(payload: np.ndarray, group=None) -> np.ndarray:
    """Broadcast a small host array from rank 0 to every rank of
    ``group``; the other ranks pass an array of the same shape and dtype."""
    t = torch.from_numpy(np.ascontiguousarray(payload))
    dist.broadcast(t, src=0, group=group)
    return t.numpy()


def sync_hosts(group=None) -> None:
    dist.barrier(group=group)


_FRAME_CHUNK = 1 << 15          # bytes per broadcast_control payload


class FrameChannel:
    """Ordered rank-0 -> all-ranks control-frame channel built on
    broadcast_control.  Each frame is (length int64) + fixed-size uint8
    chunks.  COLLECTIVE: every rank must pump send()/recv() in matching
    order — exactly what the follower replay loop does.  Frames are
    pickles that only the leader of this engine writes."""

    def __init__(self, group=None):
        self.group = group

    def send(self, obj) -> None:
        buf = np.frombuffer(pickle.dumps(obj), np.uint8)
        broadcast_control(np.array([len(buf)], np.int64), self.group)
        for i in range(0, len(buf), _FRAME_CHUNK):
            chunk = np.zeros(_FRAME_CHUNK, np.uint8)
            part = buf[i:i + _FRAME_CHUNK]
            chunk[:len(part)] = part
            broadcast_control(chunk, self.group)

    def recv(self):
        n = int(broadcast_control(np.zeros(1, np.int64), self.group)[0])
        parts = [broadcast_control(np.zeros(_FRAME_CHUNK, np.uint8),
                                   self.group)
                 for _ in range(-(-n // _FRAME_CHUNK))]
        buf = np.concatenate(parts)[:n] if parts else np.zeros(0, np.uint8)
        return pickle.loads(buf.tobytes())


# Per dispatch method of engine/step.py::StepFns: which leading args are
# the rank's device state (P=params, C=cache, S=state) and which outputs
# replace it (None = a readback the follower discards).  Mirrors every
# engine.py `self.fns.X(...)` call site; the port updates the pool and
# the state in place, so most outputs are empty.
_DEV_IN = {
    'decode_steps': 'PCS', 'spec_decode_rounds': 'PCS',
    'prefill_chunks': 'PCS', 'prefill_logits': 'PC',
    'decode_rounds_sampled': 'PCS',
    'install_slot': 'S', 'clear_slot': 'S', 'set_finished': 'S',
    'set_active': 'S', 'set_page_row': 'S', 'slot_key': 'S',
    'alloc_device_state': '', 'rank_report': '', 'collective_ms': '',
    'ping': '',
}
_DEV_OUT = {
    'decode_steps': ('S', None), 'spec_decode_rounds': ('S', None),
    'prefill_chunks': (), 'prefill_logits': (None,),
    'decode_rounds_sampled': ('S', None),
    'install_slot': (), 'clear_slot': (), 'set_finished': (),
    'set_active': (), 'set_page_row': (), 'slot_key': (None,),
    'alloc_device_state': ('C', 'S'), 'rank_report': (None,),
    'collective_ms': (None,), 'ping': (),
}

_STOP = '__stop__'


class RankFailure(RuntimeError):
    """A frame or a collective failed: a rank died, timed out or fell out
    of step.  The ranks cannot continue; the engine fails its requests and
    stops."""


class RecordingFns:
    """Wraps the leader's step functions: every dispatch is framed to the
    followers BEFORE the leader issues it, so all ranks hit the collective
    in lockstep.  A lock keeps frame and call together, so that a call
    from another thread than the engine's (``rank_report``) cannot slip
    between them.  After one failure every call raises."""

    def __init__(self, inner, channel: FrameChannel):
        self._inner = inner
        self._channel = channel
        self._lock = threading.Lock()
        self.failure: Optional[BaseException] = None
        self.stopped = False
        self.reports: List[Dict[str, Any]] = []
        self.last_frame = time.monotonic()

    def __getattr__(self, name):
        if name not in _DEV_IN:
            return getattr(self._inner, name)
        ndev = len(_DEV_IN[name])
        inner = getattr(self._inner, name, None)

        def call(*args, **kwargs):
            with self._lock:
                if self.failure is not None or self.stopped:
                    raise RankFailure(f'{name}: the ranks are down') \
                        from self.failure
                try:
                    self._channel.send((name, args[ndev:], kwargs))
                    self.last_frame = time.monotonic()
                    return inner(*args, **kwargs) if inner else None
                except Exception as e:
                    self.failure = e
                    raise RankFailure(f'{name} failed on the leader: '
                                      f'{e}') from e
        return call

    def stop(self) -> List[Dict[str, Any]]:
        """Send the stop frame once; returns every follower's final
        report (frames replayed, counters, digest), by rank."""
        with self._lock:
            if self.stopped or self.failure is not None:
                return self.reports
            self.stopped = True
            self._channel.send((_STOP,))
            out = [None] * dist.get_world_size(self._channel.group)
            dist.gather_object(None, out, dst=0, group=self._channel.group)
            self.reports = out[1:]
            return self.reports


def serve_leader(engine) -> 'RecordingFns':
    """Start the scheduler of a ``start=False`` engine on rank 0 of its
    ranks: its dispatches are already framed to the followers.  Returns
    the recording step functions (pass them to :func:`stop_followers`)."""
    if not isinstance(engine.fns, RecordingFns):
        raise ValueError('serve_leader: the engine is not rank 0 of a '
                         'dp * pp * tp > 1 group of ranks')
    engine.start()
    return engine.fns


def stop_followers(fns: 'RecordingFns') -> List[Dict[str, Any]]:
    """Release the follower replay loops and collect their reports.  Call
    AFTER the leader's scheduler is quiet (``engine.shutdown()`` does both,
    and a second stop is a no-op): every dispatch needs followers still
    pumping frames."""
    return fns.stop()


def serve_follower(engine, channel: Optional[FrameChannel] = None) -> int:
    """Replay the leader's dispatch frames against this rank's device
    state (``engine.params`` / ``cache`` / ``state`` / ``fns``; an engine
    built with ``start=False``, or a spawned rank's replica).  Blocks until
    the stop frame, sends this rank's report to the leader, and returns
    the number of frames replayed."""
    channel = channel or FrameChannel(engine.fns.ranks.host_group)
    n = 0
    while True:
        frame = channel.recv()
        if frame[0] == _STOP:
            report = engine.fns.report()
            report['frames'] = n
            dist.gather_object(report, None, dst=0, group=channel.group)
            return n
        name, args, kwargs = frame
        n += 1
        if name == 'ping':
            continue
        if name == 'alloc_device_state':
            # the old pool goes first, so that the new one fits
            engine.cache = engine.state = None
        dev = {'P': engine.params, 'C': engine.cache, 'S': engine.state}
        out = getattr(engine.fns, name)(
            *[dev[c] for c in _DEV_IN[name]], *args, **kwargs)
        if not isinstance(out, tuple):
            out = (out,)
        for slot, val in zip(_DEV_OUT[name], out):
            if slot == 'C':
                engine.cache = val
            elif slot == 'S':
                engine.state = val


# ---------------------------------------------------------------------------
# a rank that the engine spawns
# ---------------------------------------------------------------------------

class _Replica:
    """A spawned follower's device state: what serve_follower replays
    into."""

    def __init__(self, params, fns):
        self.params = params
        self.fns = fns
        self.cache, self.state = fns.alloc_device_state()


def step_fns_class(pp: int):
    """The step functions of a rank: :class:`PPStepFns` over pipeline
    stages, else ``StepFns``."""
    return PPStepFns if pp > 1 else StepFns


def run_rank(rank: int, tp: int, dp: int, host: str, port: int,
             timeout_s: float, device: str, threads: int, cfg, pool,
             state_shape, params, pp: int = 1) -> None:
    """Body of one follower rank that ``TorchEngine`` spawns: join the
    leader's store, take this rank's weight shard (CPU shared memory) onto
    its device, and replay frames until the stop frame.  It runs as many
    intra-op threads as the leader (ranks on one host's CPU would
    otherwise oversubscribe its cores).  Any failure ends the process with
    a nonzero exit, which the leader reports."""
    torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    params = to_device(params, dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    world = tp * dp * pp
    store = dist.TCPStore(host, port, world, False, timeout=timeout)
    store.set(f'ready/{rank}', '1')
    dist.init_process_group('gloo', store=store, rank=rank,
                            world_size=world, timeout=timeout)
    try:
        ranks = make_ranks(tp, dp, dev, timeout_s, pp)
        replica = _Replica(params, step_fns_class(pp)(
            cfg, dev, pool, state_shape, ranks))
        serve_follower(replica, FrameChannel(ranks.host_group))
    finally:
        dist.destroy_process_group()


def to_device(tree, device: torch.device):
    """Every tensor of a parameter tree on ``device`` (dataclass weights
    field by field)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: to_device(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree)})
    return tree


def main(argv=None) -> int:
    """One follower rank of an engine whose ranks are separate processes
    (``env://`` rendezvous; rank 0 runs the scheduler and calls
    :func:`serve_leader` on the same workspace and settings)."""
    ap = argparse.ArgumentParser('lmdeploy_tpu_torch.parallel.multihost')
    ap.add_argument('model_path', help='workspace, HF or meta-llama dir '
                    '(the leader\'s)')
    ap.add_argument('--tp', type=int, default=1)
    ap.add_argument('--pp', type=int, default=1)
    ap.add_argument('--dp', type=int, default=1)
    ap.add_argument('--quant-policy', type=int, default=None)
    ap.add_argument('--device', default=None,
                    help='default: cuda:$LOCAL_RANK (cuda:0 without it)')
    ap.add_argument('--timeout', type=float, default=DEFAULT_TIMEOUT_S,
                    help='seconds a collective may wait')
    args = ap.parse_args(argv)
    device = args.device or f'cuda:{os.environ.get("LOCAL_RANK", "0")}'
    rank = init_multihost(timeout_s=args.timeout)
    if rank == 0:
        raise SystemExit('rank 0 is the leader: build the engine there '
                         'and call serve_leader')
    from ..api import build_engine
    eng = build_engine(args.model_path, tp=args.tp, pp=args.pp, dp=args.dp,
                       quant_policy=args.quant_policy, device=device,
                       start=False, rank_timeout=args.timeout)
    try:
        n = serve_follower(eng)
    finally:
        dist.destroy_process_group()
    print(f'rank {rank}: replayed {n} frames', flush=True)
    return 0


__all__ = ['init_multihost', 'broadcast_control', 'sync_hosts',
           'FrameChannel', 'RankFailure', 'RecordingFns', 'serve_leader',
           'stop_followers', 'serve_follower', 'step_fns_class', 'run_rank',
           'to_device',
           'DEFAULT_TIMEOUT_S']

if __name__ == '__main__':
    raise SystemExit(main())
