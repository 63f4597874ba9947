"""Tokens streamed to the clients inside the window, over its seconds."""


def read(run):
    total = 0
    for r in run.records:
        prev = 0
        for t, n in r.frames:
            if run.in_window(t):
                total += n - prev
            prev = n
    return total / run.window_s if total else None
