"""Tests only: the Llama family, with a reference that leaves out the
last layer (``short_reference.py``)."""
import family

LLAMA = family.load('llama')
make, engine_params, kv_qparams, model_flops, KERNEL_CLASSES = (
    LLAMA.make, LLAMA.engine_params, LLAMA.kv_qparams, LLAMA.model_flops,
    LLAMA.KERNEL_CLASSES)
