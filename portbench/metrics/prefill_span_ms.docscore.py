"""Mean milliseconds from a request's admission to the end of its prefill
job (passes shared with other jobs' rows and interleaved decode rounds
included): the engine's prefill_s over prefilled, for the jobs that ended
in the window."""


def read(run):
    n = run.delta('prefilled')
    return run.delta('prefill_s') * 1e3 / n if n else None
