"""Tests only: the Llama family with each call of the contract counted
(its reference's ``forward`` is counted by the test), and kernel classes
of its own, matched before kernel 1's."""
import collections

import family

LLAMA = family.load('llama')
CALLS = collections.Counter()
KERNEL_CLASSES = (('kx', 'moe_grouped'), ('ky', 'w4a16_wgmma_grouped'))


def _counted(name):
    fn = getattr(LLAMA, name)

    def call(*args, **kw):
        CALLS[name] += 1
        return fn(*args, **kw)
    return call


make = _counted('make')
engine_params = _counted('engine_params')
kv_qparams = _counted('kv_qparams')
model_flops = _counted('model_flops')
