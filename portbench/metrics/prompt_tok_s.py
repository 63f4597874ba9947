"""Prompt tokens of the requests whose first token arrived in the window,
over its seconds."""


def read(run):
    total = sum(len(r.req.prompt) for r in run.records
                if run.in_window(r.t_first))
    return total / run.window_s if total else None
