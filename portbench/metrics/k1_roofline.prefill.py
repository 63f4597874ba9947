"""Kernel 1 (W4A16 GEMM) in the traced prefill passes: its least time at
each pass's real tokens (not the bucket's padding) over its device time."""
import counting
import readers


def read(run):
    least = sum(counting.layer_gemm_least_s(run.model,
                                            sum(n for _, n in d.rows))
                for d in readers.traced(run, 'prefill'))
    return readers.roofline(run, 'k1', 'prefill',
                            least * run.model['num_layer'])
