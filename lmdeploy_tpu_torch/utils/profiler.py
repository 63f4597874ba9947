"""Profiling helpers — named ranges and phase timers.

Port of ``lmdeploy_tpu/utils/profiler.py`` (reference:
src/turbomind/utils/nvtx_utils.h PUSH_RANGE/POP_RANGE around hot regions
+ wall-clock phase logs, LlamaBatch.cc:776).  :func:`trace` records a
``torch.profiler`` trace (CPU, plus CUDA when the card is in use) and
writes it as a Chrome trace under ``log_dir``; :func:`annotate` names a
region in it; :class:`PhaseTimer` is the JAX package's, copied."""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


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


def annotate(name: str):
    """Named trace region (the PUSH_RANGE/POP_RANGE analogue)."""
    return torch.profiler.record_function(name)


class PhaseTimer:
    """Accumulating host-side phase timer (engine loop phases)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            t, n = self.totals[name], self.counts[name]
            lines.append(f'{name}: {t:.3f}s over {n} '
                         f'({t / max(n, 1) * 1e3:.2f} ms each)')
        return '\n'.join(lines)


__all__ = ['trace', 'annotate', 'PhaseTimer']
