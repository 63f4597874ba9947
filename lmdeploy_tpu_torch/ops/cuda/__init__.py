"""Hand-written CUDA kernels for Hopper — the counterpart of
``lmdeploy_tpu/ops/pallas/``.

- quant_matmul.py      — W4A16 packed-int4 GEMM (csrc/w4a16_gemm.cu)
- paged_attention.py   — paged decode attention: attend only, fused
                         KV-append + attend, and rope + append + attend
                         (csrc/paged_decode_attention.cu)
- prefill_attention.py — paged prefill attention
                         (csrc/paged_prefill_attention.cu)
- counts.py            — launch and plain-version counters
- build.py             — nvcc build (sm_90a) and ctypes loader

The attention kernels run at three KV widths (bf16, int8, int4).  Each
wrapper runs its plain PyTorch version for CPU tensors and launches its
kernel (or raises) for CUDA tensors, and counts both per kernel and KV
width.
"""
from ...kvcache.paged import KV_WIDTHS
from . import paged_attention, prefill_attention, quant_matmul
from .counts import LAUNCHES, PLAIN_CALLS, variant
from .quant_matmul import ROUTE_NAMES as GEMM_ROUTE_NAMES
from .quant_matmul import WGMMA

ATTENTION_KERNELS = ('paged_decode_attention_write', 'paged_decode_attention',
                     'paged_decode_attention_rope_write',
                     'paged_prefill_attention')
KERNEL_NAMES = ('w4a16_gemm',) + tuple(
    variant(name, kv_bits) for name in ATTENTION_KERNELS
    for kv_bits in KV_WIDTHS)


# Launches of one regime of a kernel, also counted under the kernel's name.
REGIME_NAMES = (WGMMA,)
# Launches of each route of the W4A16 GEMM's wgmma regime
# (w4a16_gemm[wgmma]:splitk / :tiles) and of prefill attention
# (paged_prefill_attention[bf16]:split / :wgmma / :mma), also counted
# under the kernel's (and the regime's) name.
ROUTE_NAMES = GEMM_ROUTE_NAMES + tuple(
    f'{variant("paged_prefill_attention", kv_bits)}:{route}'
    for kv_bits in KV_WIDTHS for route in prefill_attention.ROUTES)


def launch_counts(regimes: bool = False) -> dict:
    """{kernel name: (kernel launches, plain-version calls)} for every
    kernel and, for the attention kernels, every KV width; with
    ``regimes``, also the launches of the W4A16 GEMM's wgmma regime."""
    names = KERNEL_NAMES + (REGIME_NAMES if regimes else ())
    return {name: (LAUNCHES[name], PLAIN_CALLS[name]) for name in names}


def route_counts() -> dict:
    """{route name: launches} of the GEMM's and prefill attention's
    routes."""
    return {name: LAUNCHES[name] for name in ROUTE_NAMES}


def reset_launch_counts() -> None:
    LAUNCHES.clear()
    PLAIN_CALLS.clear()


__all__ = ['ATTENTION_KERNELS', 'KERNEL_NAMES', 'REGIME_NAMES',
           'ROUTE_NAMES', 'launch_counts', 'route_counts',
           'reset_launch_counts', 'paged_attention',
           'prefill_attention', 'quant_matmul']
