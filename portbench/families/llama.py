"""The Llama family: the block of ``lmdeploy_tpu_torch/models/llama.py``
(Llama; InternLM's qkv and o bias; Baichuan and Qwen's qkv bias, Qwen's
dynamic NTK and logn) at W4A16, one K and one V a layer.

Its pieces stay in the modules that the accepted cells' metric files and
tests read: the weights and the pool's qparams (``weights.py``), the
program's parameter tree (``serve.py``) and the published model's
operations (``counting.py``); its plain reference is ``reference.py``,
through ``llama_reference.py``."""
import counting
import serve
import weights

make = weights.make
engine_params = serve.engine_params
model_flops = counting.model_flops
KERNEL_CLASSES = ()


def kv_qparams(model: dict, seed: int, bits: int):
    """A ``bits`` pool's static qparams, one K and one V a layer: the
    engine's ``kv_scales`` and the reference's ``kv``."""
    q = weights.kv_qparams(model['num_layer'], seed, bits)
    return (q['k_scale'], q['k_zp'], q['v_scale'], q['v_zp']), q
