"""Host milliseconds issuing a prefill pass: the seconds of the program's
step.prefill_issue spans (StepFns.host_s['step.prefill_issue']) over
prefill_passes in the window."""


def read(run):
    passes = run.delta('prefill_passes')
    s = run.host1.get('step.prefill_issue', 0.0) - \
        run.host0.get('step.prefill_issue', 0.0)
    return s * 1e3 / passes if passes and s > 0 else None
