"""W4A16 packed-int4 GEMM: the kernel's wrapper, its plain version and its
launch counter.

Replaces ``lmdeploy_tpu/ops/pallas/quant_matmul.py::packed_int4_matmul``
(``_mm_kernel``) with ``lmdeploy_tpu_torch/csrc/w4a16_gemm.cu`` (CUDA C++
for sm_90a).  It computes the UNSCALED-zero-point product
``y[M, N] f32 = sum_g (x_g @ nib_g) * s_g`` over layer ``layer`` of the
nibble-packed weight; the caller subtracts ``rowsum_g(x) @ (s*z)``
(``ops/linear.py``).  x is rounded to bf16 before the product, as in the
JAX kernel.

Bound on an H100 SXM (3.35 TB/s, 989 TF/s bf16): at decode (M <= 64) the
packed weight bytes K*N/2 (Llama-2-7B wqkv 25.2 MB ~ 7.5 us); at a
512-row prefill chunk the 2*M*K*N operations.  The decode kernel reads
every packed byte once, coalesced along N, split over K with f32 atomics
(run to run the sum order of the K-split partials changes: a few f32 ulps
of the output); the prefill kernel is a 64x64-tile mma.sync kernel with
in-register nibble dequant (see the source's header).

On a CPU tensor the wrapper runs :func:`w4a16_gemm_plain`; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import build
from .counts import LAUNCHES, PLAIN_CALLS

NAME = 'w4a16_gemm'


def unpack_nibbles(p: torch.Tensor) -> torch.Tensor:
    """[..., K/2, N] packed -> [..., K, N] uint8 values 0..15 (low nibbles
    are rows [0, K/2), high nibbles rows [K/2, K))."""
    return torch.cat([p & 0xF, p >> 4], dim=-2)


def w4a16_gemm_plain(x: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor, layer: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same arithmetic, f32."""
    PLAIN_CALLS[NAME] += 1
    m, k = x.shape
    n = packed.shape[-1]
    s = scales[layer].reshape(-1, n).float()            # [G, N]
    g = s.shape[0]
    q = unpack_nibbles(packed[layer]).float().reshape(g, k // g, n)
    xg = x.to(torch.bfloat16).float().reshape(m, g, k // g)
    part = torch.einsum('mgk,gkn->mgn', xg, q)           # exact nibbles
    return (part * s[None]).sum(dim=1)


def w4a16_gemm(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
               layer: int) -> torch.Tensor:
    """``x [M, K] @ unpacked(packed)[layer] * scales[layer]`` -> [M, N] f32.

    packed: uint8 [L, K/2, N] (half-split nibbles); scales: bf16
    [L, G, 1, N] (or [L, G, N]); layer: python int.
    """
    if x.device.type == 'cpu':
        return w4a16_gemm_plain(x, packed, scales, layer)
    m, k = x.shape
    l_dim, k2, n = packed.shape
    g = scales.shape[1]
    group = k // g
    if (k != 2 * k2 or m == 0 or packed.dtype != torch.uint8
            or scales.dtype != torch.bfloat16 or k2 % group
            or scales.numel() != l_dim * g * n):
        raise ValueError(f'w4a16_gemm: bad operands x{tuple(x.shape)} '
                         f'packed{tuple(packed.shape)}/{packed.dtype} '
                         f'scales{tuple(scales.shape)}/{scales.dtype}')
    if n % 16 or k % 16 or (m > 64 and group != 128):
        raise ValueError(f'w4a16_gemm: unsupported shape M={m} K={k} N={n} '
                         f'group={group}')
    if not (packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError('w4a16_gemm: packed/scales must be contiguous')
    if not 0 <= layer < l_dim:
        raise IndexError(f'w4a16_gemm: layer {layer} of {l_dim}')
    xb = x.to(torch.bfloat16).contiguous()
    y = (torch.zeros if m <= 64 else torch.empty)(
        (m, n), dtype=torch.float32, device=x.device)
    lib = build.load()
    rc = lib.lmd_w4a16_gemm(
        xb.data_ptr(), packed[layer].data_ptr(), scales[layer].data_ptr(),
        y.data_ptr(), m, k, n, group,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, 'w4a16_gemm')
    LAUNCHES[NAME] += 1
    return y


__all__ = ['w4a16_gemm', 'w4a16_gemm_plain', 'unpack_nibbles']
