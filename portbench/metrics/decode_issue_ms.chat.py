"""Host milliseconds issuing a decode step: StepFns.host_s['issue'] over
decode_steps in the window."""


def read(run):
    steps = run.delta('decode_steps')
    issue = run.host1.get('issue', 0.0) - run.host0.get('issue', 0.0)
    return issue * 1e3 / steps if steps else None
