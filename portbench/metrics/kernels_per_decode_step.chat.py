"""Device kernels launched inside the decode dispatches of the traced
window, per decode step."""
import readers
import tracing


def read(run):
    steps = sum(d.steps for d in readers.traced(run, 'decode'))
    if run.trace is None or not steps:
        return None
    n = tracing.kernel_count(run.trace, 'decode')
    return n / steps if n else None
