"""The device trace of a run's last seconds, and its reduction.

``TraceWindow`` runs ``torch.profiler`` (CPU and CUDA activity, CUPTI)
over the last ``seconds`` of the measured window.  It is started and
stopped on the engine's own thread, at the start of a dispatch (the
harness's wrappers call :meth:`TraceWindow.tick`), so that the trace
begins and ends between dispatches and holds the engine thread's ranges
(``portbench.decode`` / ``portbench.prefill`` / ``portbench.readback``).
The profiler is stopped at the first dispatch after the window closes, so
that the cost of stopping it falls outside the window.

:func:`reduce` takes the exported Chrome trace and gives:

- the traced window (first to last event) and the union of the device's
  kernel, copy and set intervals in it (``busy_s``);
- each kernel's time and the host range its launch sat in (``decode``,
  ``prefill`` or neither), and its class: one of the model family's own
  (its ``KERNEL_CLASSES``, matched first), else kernel 1
  (``w4a16_wgmma``), kernel 2 (``paged_decode``), kernel 3
  (``paged_prefill``) or other;
- the idle gaps between busy intervals, each labelled with what the
  engine thread was doing at its midpoint: ``readback wait``, ``decode
  issue``, ``prefill issue`` or ``scheduler`` (none of those ranges).
"""
from __future__ import annotations

import bisect
import gzip
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

KERNEL_CLASSES = (('k1', 'w4a16_wgmma'), ('k2', 'paged_decode'),
                  ('k3', 'paged_prefill'))
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
RANGES = ('portbench.decode', 'portbench.prefill', 'portbench.readback')


def kernel_class(name: str, classes: Sequence = ()) -> str:
    """The class of the kernel ``name``: the first of ``classes`` (a
    family's ``(class, name substring)`` pairs), then of
    ``KERNEL_CLASSES``, whose substring it holds; else ``other``."""
    for cls, key in (*classes, *KERNEL_CLASSES):
        if key in name:
            return cls
    return 'other'


def short_name(name: str) -> str:
    """A kernel's name without its namespace prefix and arguments."""
    name = name.replace('(anonymous namespace)::', '')
    return name.split('(')[0][:120]


class TraceWindow:
    """A profiler over [start_at, stop_at) (perf_counter), toggled from the
    engine thread."""

    def __init__(self, seconds: float, path: str):
        self.seconds = float(seconds)
        self.path = path
        self.start_at = self.stop_at = float('inf')
        self.prof = None
        self.active = False
        self.t_start = self.t_stop = None
        self._stopped = threading.Event()

    @staticmethod
    def warm_up(cuda: bool = True) -> None:
        """Initialise the profiler (and its device tracing) once, on the
        main thread and outside the window."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts):
            torch.zeros(1, device='cuda' if cuda else 'cpu').add_(1)
            if cuda:
                torch.cuda.synchronize()

    def arm(self, start_at: float, stop_at: float) -> None:
        self.start_at, self.stop_at = start_at, stop_at

    def tick(self) -> None:
        now = time.perf_counter()
        if self.prof is None and now >= self.start_at:
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
            self.t_start = time.perf_counter()
            self.active = True
        elif self.active and now >= self.stop_at:
            self._stop()

    def _stop(self) -> None:
        self.active = False
        self.t_stop = time.perf_counter()
        self.prof.stop()
        self._stopped.set()

    def wait_stopped(self, timeout: float) -> bool:
        """Whether the profiler has stopped (or never started), waiting up
        to ``timeout`` seconds for it."""
        return self.prof is None or self._stopped.wait(timeout)

    def stop_if_running(self) -> None:
        """Stop a profiler that no dispatch after the window stopped (the
        engine had gone idle)."""
        if self.active:
            self._stop()

    def export(self) -> Optional[dict]:
        """The trace as a dict (written to ``path`` and removed)."""
        if self.prof is None or self.t_stop is None:
            return None
        self.prof.export_chrome_trace(self.path)
        opener = gzip.open if self.path.endswith('.gz') else open
        with opener(self.path, 'rt') as f:
            data = json.load(f)
        os.remove(self.path)
        return data


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class _Ranges:
    """Non-overlapping host ranges of one name, for point lookups."""

    def __init__(self, spans: List[Tuple[float, float]]):
        self.spans = sorted(spans)
        self.starts = [a for a, _ in self.spans]

    def holds(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.spans[i][1]


def reduce(data: dict, classes: Sequence = ()) -> Optional[dict]:
    """The trace's window, busy time, kernels by class (``classes``: the
    family's own, matched first) and host range, and idle gaps (times in
    seconds).  None when the trace holds no device activity."""
    evs = [e for e in data.get('traceEvents', [])
           if e.get('ph') == 'X' and 'dur' in e and 'ts' in e]
    dev = [e for e in evs if e.get('cat') in DEVICE_CATS]
    if not dev:
        return None
    ranges = {name: _Ranges([(e['ts'], e['ts'] + e['dur']) for e in evs
                             if e.get('cat') == 'user_annotation'
                             and e.get('name') == name])
              for name in RANGES}
    launch = {}
    for e in evs:
        if e.get('cat') in ('cuda_runtime', 'cuda_driver'):
            corr = e.get('args', {}).get('correlation')
            if corr is not None:
                launch[corr] = e['ts']
    host = [e for e in evs if e.get('cat') not in DEVICE_CATS
            and e.get('cat') != 'gpu_user_annotation']
    lo = min(e['ts'] for e in (host or evs))
    hi = max(e['ts'] + e['dur'] for e in evs)

    def host_kind(t: float) -> str:
        if ranges['portbench.decode'].holds(t):
            return 'decode'
        if ranges['portbench.prefill'].holds(t):
            return 'prefill'
        return 'none'

    def host_label(t: float) -> str:
        if ranges['portbench.readback'].holds(t):
            return 'readback wait'
        return {'decode': 'decode issue', 'prefill': 'prefill issue',
                'none': 'scheduler'}[host_kind(t)]

    time_by = defaultdict(float)          # (class, kind) -> s
    count_by = defaultdict(int)           # (class, kind) -> kernels
    by_name = defaultdict(float)
    for e in dev:
        if e.get('cat') != 'kernel':
            by_name[e.get('cat')] += e['dur'] * 1e-6
            continue
        t = launch.get(e.get('args', {}).get('correlation'))
        kind = host_kind(t) if t is not None else 'none'
        cls = kernel_class(e.get('name', ''), classes)
        time_by[(cls, kind)] += e['dur'] * 1e-6
        count_by[(cls, kind)] += 1
        by_name[short_name(e.get('name', ''))] += e['dur'] * 1e-6
    busy = _union([(max(e['ts'], lo), min(e['ts'] + e['dur'], hi))
                   for e in dev if e['ts'] + e['dur'] > lo and e['ts'] < hi])
    gaps = []
    edge = lo
    for a, b in busy + [(hi, hi)]:
        if a > edge:
            gaps.append((host_label((a + edge) / 2), (a - edge) * 1e-6))
        edge = max(edge, b)
    idle_by = defaultdict(float)
    for label, s in gaps:
        idle_by[label] += s
    return {
        'window_s': (hi - lo) * 1e-6,
        'busy_s': sum(b - a for a, b in busy) * 1e-6,
        'time_by': {f'{c}|{k}': v for (c, k), v in time_by.items()},
        'count_by': {f'{c}|{k}': v for (c, k), v in count_by.items()},
        'device_ops': sorted(by_name.items(), key=lambda x: -x[1])[:10],
        'idle_by': dict(idle_by),
        'longest_gaps': sorted(gaps, key=lambda x: -x[1])[:6],
    }


def kernel_time(summary: dict, cls: str, kind: str) -> float:
    return summary['time_by'].get(f'{cls}|{kind}', 0.0)


def kernel_count(summary: dict, kind: str) -> int:
    return sum(v for key, v in summary['count_by'].items()
               if key.endswith(f'|{kind}'))


def breakdown(summary: dict) -> Dict[str, list]:
    """The result line's ``breakdown``: the device operations that took
    most time, and idle time by what the engine thread was doing (totals,
    then the longest single gaps), at most ten entries each."""
    idle = [[f'total: {k}', v] for k, v in
            sorted(summary['idle_by'].items(), key=lambda x: -x[1])]
    idle += [[k, v] for k, v in summary['longest_gaps']]
    return {'device_ops': [[k, v] for k, v in summary['device_ops']][:10],
            'idle_gaps': idle[:10]}


__all__ = ['TraceWindow', 'reduce', 'kernel_time', 'kernel_count',
           'breakdown', 'kernel_class']
