"""Tokens a decode step yields on average in the window: the scheduler's
counters generated_tokens over decode_steps."""


def read(run):
    steps = run.delta('decode_steps')
    return run.delta('generated_tokens') / steps if steps else None
