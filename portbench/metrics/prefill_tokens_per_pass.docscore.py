"""Prompt tokens a prefill pass carries in the window: the real tokens of
the passes issued in it over the scheduler's prefill_passes."""
import readers


def read(run):
    passes = run.delta('prefill_passes')
    tokens = sum(n for d in readers.in_window(run, 'prefill')
                 for _, n in d.rows)
    return tokens / passes if passes and tokens else None
