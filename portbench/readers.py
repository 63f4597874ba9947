"""Helpers that the metric readers under ``metrics/`` share.

A reader is ``read(run) -> float | None`` (``run.py::Run``); it returns
None when its run holds nothing for it to read, and the harness then
leaves the metric out of the line.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Optional

import counting
import tracing


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The q-th percentile, interpolated linearly between order
    statistics; None of no values."""
    v = sorted(values)
    if not v:
        return None
    at = (len(v) - 1) * q / 100.0
    lo = math.floor(at)
    hi = min(lo + 1, len(v) - 1)
    if math.isinf(v[hi]) or math.isinf(v[lo]):
        return v[hi] if at > lo else v[lo]
    return v[lo] + (v[hi] - v[lo]) * (at - lo)


def in_window(run, kind: str) -> List:
    """Dispatches of ``kind`` issued inside the measured window."""
    return [d for d in run.dispatches if d.kind == kind
            and run.t0 <= d.t0 < run.t1]


def traced(run, kind: str) -> List:
    """Dispatches of ``kind`` inside the traced window."""
    return [d for d in run.dispatches if d.kind == kind and d.traced]


def step_contexts(d, j: int) -> List[int]:
    """Contexts attended by the live slots of decode dispatch ``d`` at its
    step j."""
    return [c + j + 1 for c, left in d.live if j < left]


def share(least: float, measured: float) -> Optional[float]:
    """A share of a roofline or a peak, in %; None when nothing ran."""
    if measured <= 0 or least <= 0:
        return None
    return 100.0 * least / measured


def roofline(run, cls: str, kind: str, least: float) -> Optional[float]:
    """``least`` seconds against kernel ``cls``'s device time in the
    traced ``kind`` dispatches."""
    if run.trace is None:
        return None
    return share(least, tracing.kernel_time(run.trace, cls, kind))


def idle_share(run) -> Optional[float]:
    t = run.trace
    if t is None or t['window_s'] <= 0:
        return None
    return 100.0 * (t['window_s'] - t['busy_s']) / t['window_s']


def mfu(run) -> Optional[float]:
    """The published model's operations (its family's ``model_flops``)
    for the window's tokens (decode steps and prefill rows issued in it)
    over the window at the bf16 peak, in %."""
    model_flops = run.family.model_flops
    flops = 0.0
    for d in in_window(run, 'decode'):
        ctx = counting.decode_contexts(d.live, d.steps)
        flops += model_flops(run.model, ctx, len(ctx))
    for d in in_window(run, 'prefill'):
        flops += model_flops(run.model, counting.prefill_contexts(d.rows), 0)
    return share(flops / counting.PEAK_FLOPS, run.window_s)
