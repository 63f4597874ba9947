"""W4A16 packed-int4 GEMM: the kernel's wrapper, its plain version and its
launch counter.

Replaces ``lmdeploy_tpu/ops/pallas/quant_matmul.py::packed_int4_matmul``
(``_mm_kernel``) with ``lmdeploy_tpu_torch/csrc/w4a16_gemm.cu`` (CUDA C++
for sm_90a).  It computes the UNSCALED-zero-point product
``y[M, N] f32 = sum_g (x_g @ nib_g) * s_g`` over layer ``layer`` of the
nibble-packed weight; the caller subtracts ``rowsum_g(x) @ (s*z)``
(``ops/linear.py``).  x is rounded to bf16 before the product, as in the
JAX kernel.

Bound on an H100 SXM (3.35 TB/s, 989 TF/s bf16): at decode the packed
weight bytes K*N/2 (Llama-2-7B wqkv 25.2 MB ~ 7.5 us); at a 512-row
prefill chunk the 2*M*K*N operations.  Two kernels, chosen by M at
:data:`DECODE_MAX_M` (the crossover measured on the H100):

- decode (M <= DECODE_MAX_M): tensor cores (mma.sync m16n8k16) with the
  weight as the A operand and x^T as B, so M = 8 fills one n8 tile; it
  reads every packed byte once, 16 bytes per load, turns nibbles into
  exact bf16 by a mantissa trick.  Its grid splits K; the splits' f32
  partials go to a workspace and the last block of each column tile sums
  them in index order (a ticket counter per tile, zeroed once, that every
  launch leaves at zero), so a call gives the same bits on every run.  It
  takes N % 16 == 0, K % 16 == 0 and any group that is a multiple of 16
  dividing K/2.
- prefill (M > DECODE_MAX_M): wgmma with the weight as the register
  operand (nibbles to bf16 in registers) and x tiles brought by TMA into
  a ring of shared-memory stages, one f32 partial per group folded with
  its scales (group 128, deterministic; see the source's header).  Its
  launches also count under ``w4a16_gemm[wgmma]``.

On a CPU tensor the wrapper runs :func:`w4a16_gemm_plain`; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import build
from .counts import LAUNCHES, PLAIN_CALLS

NAME = 'w4a16_gemm'
WGMMA = 'w4a16_gemm[wgmma]'      # the prefill regime's own launch count
# The largest M that takes the decode kernel; above it the wgmma kernel
# (one Llama-2-7B layer on an H100 80GB HBM3 at 700 W: decode 0.103 ms at
# M = 8 and 0.157 at M = 16, wgmma 0.143 and 0.140; chip_smoke.py phase 3).
DECODE_MAX_M = 8
REGIMES = ('decode', 'wgmma')

_counters: dict = {}      # device -> the decode regime's ticket counters
_splits: dict = {}        # (K, group) -> the decode regime's split of K


def _decode_workspace(m: int, k: int, n: int, group: int, device):
    """(partials f32 [S, M, N], ticket counters) of the decode regime, or
    (None, None) when its grid does not split K.  The counters are zeroed
    once when allocated; every launch leaves them at zero."""
    splits = _splits.get((k, group))
    if splits is None:
        splits = build.load().lmd_w4a16_decode_splits(k, group)
        build.check(min(splits, 0), 'w4a16_gemm: decode splits')
        _splits[(k, group)] = splits
    if splits <= 1:
        return None, None
    tiles = -(-n // 128) * -(-m // (8 if m <= 8 else 16))
    c = _counters.get(device)
    if c is None or c.numel() < tiles:
        c = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _counters[device] = c
    return torch.empty((splits, m, n), dtype=torch.float32,
                       device=device), c


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
    # the wgmma kernel takes group 128 only; another group keeps the decode
    # kernel up to M = 64 and raises above it
    wgmma = m > DECODE_MAX_M and (k == 128 * scales.shape[1] or m > 64)
    return w4a16_gemm_regime(x, packed, scales, layer,
                             'wgmma' if wgmma else 'decode')


def w4a16_gemm_regime(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor, layer: int,
                      regime: str) -> torch.Tensor:
    """Launch one regime's kernel ('decode' or 'wgmma') on CUDA tensors,
    whatever M is: :func:`w4a16_gemm` picks by M, a measurement of the
    crossover calls both."""
    m, k = x.shape
    l_dim, k2, n = packed.shape
    g = scales.shape[1]
    group = k // g
    if (k != 2 * k2 or m == 0 or packed.dtype != torch.uint8
            or scales.dtype != torch.bfloat16 or k2 % group
            or scales.numel() != l_dim * g * n or regime not in REGIMES):
        raise ValueError(f'w4a16_gemm: bad operands x{tuple(x.shape)} '
                         f'packed{tuple(packed.shape)}/{packed.dtype} '
                         f'scales{tuple(scales.shape)}/{scales.dtype} '
                         f'regime {regime!r}')
    if n % 16 or k % 16 or group % 16 or (regime == 'wgmma'
                                          and group != 128):
        raise ValueError(f'w4a16_gemm: unsupported shape M={m} K={k} N={n} '
                         f'group={group} ({regime})')
    if not (packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError('w4a16_gemm: packed/scales must be contiguous')
    if not 0 <= layer < l_dim:
        raise IndexError(f'w4a16_gemm: layer {layer} of {l_dim}')
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:                 # TMA takes 16-byte aligned rows
        xb = xb.clone()
    wgmma = regime == 'wgmma'
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    ws, counter = (None, None) if wgmma else _decode_workspace(
        m, k, n, group, x.device)
    rc = build.load().lmd_w4a16_gemm(
        xb.data_ptr(), packed[layer].data_ptr(), scales[layer].data_ptr(),
        y.data_ptr(), 0 if ws is None else ws.data_ptr(),
        0 if counter is None else counter.data_ptr(), m, k, n, group,
        int(wgmma), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, 'w4a16_gemm')
    LAUNCHES[NAME] += 1
    if wgmma:
        LAUNCHES[WGMMA] += 1
    return y


__all__ = ['w4a16_gemm', 'w4a16_gemm_plain', 'w4a16_gemm_regime',
           'unpack_nibbles', 'DECODE_MAX_M', 'WGMMA']
