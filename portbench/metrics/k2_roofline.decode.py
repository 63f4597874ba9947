"""Kernel 2 (paged decode attention with the KV append) in the traced
decode steps: its least time over the K and V bytes of the live contexts,
each slot's length at each step, over its device time."""
import counting
import readers


def read(run):
    least = 0.0
    for d in readers.traced(run, 'decode'):
        for j in range(d.steps):
            ctx = readers.step_contexts(d, j)
            if ctx:
                least += counting.least_s(*counting.decode_attn_flops_bytes(
                    run.model, ctx, run.kv_bits))
    return readers.roofline(run, 'k2', 'decode',
                            least * run.model['num_layer'])
