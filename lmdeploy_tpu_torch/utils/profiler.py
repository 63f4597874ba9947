"""Profiling helpers — named ranges, spans and phase timers.

Port of ``lmdeploy_tpu/utils/profiler.py`` (reference:
src/turbomind/utils/nvtx_utils.h PUSH_RANGE/POP_RANGE around hot regions
+ wall-clock phase logs, LlamaBatch.cc:776).  :func:`trace` records a
``torch.profiler`` trace (CPU, plus CUDA when the card is in use) and
writes it as a Chrome trace under ``log_dir``; :func:`span` names a region
in it: a range that opens only while the profiler records on the calling
thread, and, given a dict, a host-seconds sum kept always (:func:`annotate`
is its range-only form); :class:`PhaseTimer` (the JAX package's) runs on
it.

``torch.profiler.record_function`` costs microseconds even with no
profiler running; :func:`span` asks torch's profiler flag first (a tenth
of that), so the model's per-layer ranges cost one flag check a range
when nothing is traced.  The profiler records the thread that started it:
the engine's ranges appear in a trace started on the engine's thread."""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

# whether torch's profiler records on the calling thread
recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a torch.profiler trace around a region; on exit it is
    written to ``log_dir/trace_<pid>_<ns>.json`` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f'trace_{os.getpid()}_{time.time_ns()}.json'))


class _Span:
    """:func:`span` with a sink: adds its host seconds to ``into[name]``."""

    __slots__ = ('name', 'into', 't0', 'rf')

    def __init__(self, name: str, into: Dict[str, float]):
        self.name, self.into = name, into

    def __enter__(self):
        self.rf = None
        if recording():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.into[self.name] += time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, into: Optional[Dict[str, float]] = None):
    """A named region of the program: a ``record_function`` range of
    ``name`` while torch's profiler records on this thread (none
    otherwise), and, with ``into``, its ``time.perf_counter()`` seconds
    added to ``into[name]`` (the entry must exist, or ``into`` be a
    ``defaultdict``) whether traced or not."""
    if into is not None:
        return _Span(name, into)
    return torch.profiler.record_function(name) if recording() else _OFF


def annotate(name: str):
    """Named trace region (the PUSH_RANGE/POP_RANGE analogue):
    :func:`span` without a sink."""
    return span(name)


class PhaseTimer:
    """Accumulating host-side phase timer (engine loop phases)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        try:
            with span(name, self.totals):
                yield
        finally:
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            t, n = self.totals[name], self.counts[name]
            lines.append(f'{name}: {t:.3f}s over {n} '
                         f'({t / max(n, 1) * 1e3:.2f} ms each)')
        return '\n'.join(lines)


__all__ = ['trace', 'annotate', 'span', 'recording', 'PhaseTimer']
