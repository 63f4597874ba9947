"""Host milliseconds issuing a decode step's sampler (the vocabulary mask
and sample_step): the seconds of the program's step.sampler spans
(StepFns.host_s['step.sampler']) over decode_steps in the window."""


def read(run):
    steps = run.delta('decode_steps')
    s = run.host1.get('step.sampler', 0.0) - \
        run.host0.get('step.sampler', 0.0)
    return s * 1e3 / steps if steps and s > 0 else None
