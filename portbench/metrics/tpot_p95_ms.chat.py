"""95th percentile of the time per output token after the first, (last -
first token) / (tokens - 1) from the clients' own stream times, over the
requests completed in the window before its traced seconds (a traced run's
profiler slows the host in the window's last seconds)."""
import readers


def read(run):
    v = []
    for r in run.records:
        if r.status == 1 and run.in_quiet(r.t_end) and len(r.frames) > 1:
            n = r.frames[-1][1]
            v.append((r.frames[-1][0] - r.t_first) * 1e3 / (n - 1))
    return readers.percentile(v, 95)
