"""Host milliseconds issuing a decode step's model forward: the seconds of
the program's step.forward spans (StepFns.host_s['step.forward']) over
decode_steps in the window."""


def read(run):
    steps = run.delta('decode_steps')
    s = run.host1.get('step.forward', 0.0) - \
        run.host0.get('step.forward', 0.0)
    return s * 1e3 / steps if steps and s > 0 else None
