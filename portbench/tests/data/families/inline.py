"""Tests only: a family that defines its reference in its own module,
beside the program, which the loader refuses."""
import family

LLAMA = family.load('llama')
make, engine_params, kv_qparams, model_flops, KERNEL_CLASSES, forward = (
    LLAMA.make, LLAMA.engine_params, LLAMA.kv_qparams, LLAMA.model_flops,
    LLAMA.KERNEL_CLASSES, LLAMA.forward)
