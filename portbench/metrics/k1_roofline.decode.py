"""Kernel 1 (W4A16 GEMM) in the traced decode steps: its least time at
the shapes it is handed (M = the engine's batch, the five projections of
every layer) over its device time."""
import counting
import readers


def read(run):
    steps = sum(d.steps for d in readers.traced(run, 'decode'))
    least = steps * run.model['num_layer'] * counting.layer_gemm_least_s(
        run.model, run.batch)
    return readers.roofline(run, 'k1', 'decode', least)
