"""Mean milliseconds a request waits from its submission to its
admission into a batch slot: the engine's queue_wait_s over admitted,
for the admissions in the window."""


def read(run):
    n = run.delta('admitted')
    return run.delta('queue_wait_s') * 1e3 / n if n else None
