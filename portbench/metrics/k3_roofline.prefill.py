"""Kernel 3 (paged prefill attention) in the traced prefill passes: its
least time over the causal operations and bytes of each row's chunk and
history, over its device time."""
import counting
import readers


def read(run):
    least = sum(counting.least_s(*counting.prefill_attn_flops_bytes(
        run.model, d.rows, run.kv_bits))
        for d in readers.traced(run, 'prefill'))
    return readers.roofline(run, 'k3', 'prefill',
                            least * run.model['num_layer'])
