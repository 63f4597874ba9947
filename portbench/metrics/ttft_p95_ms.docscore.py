"""95th percentile of time to first token, from send to the first streamed
token, over the requests sent in the window and answered before its traced
seconds (one that fails there counts as missing, past every other).

A tail is read where nothing slows the engine: a traced run's profiler
slows its host in the last seconds of the window and stops at the close,
and both would hold the requests then waiting.  A per-layer metric: the
cell's closed loop holds the engine at its capacity, where the tail moves
with which requests share a pass; read over every request sent in the
window, sets of six runs spread by up to 69% (40% with each set's
farthest run left out), more than any bound can hold."""
import readers


def read(run):
    v = []
    for r in run.records:
        if not run.in_quiet(r.t_send):
            continue
        if run.in_quiet(r.t_first):
            v.append((r.t_first - r.t_send) * 1e3)
        elif r.t_first is None and run.in_quiet(r.t_end):
            v.append(float('inf'))
    p = readers.percentile(v, 95)
    if p is None:
        return None
    return p if p != float('inf') else 1e9
