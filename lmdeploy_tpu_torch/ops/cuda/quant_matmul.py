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
prefill chunk the 2*M*K*N operations.  One kernel at every group the JAX
kernel takes that is a multiple of 16, and every M: wgmma with the weight
as the register operand (nibbles to bf16 in registers) and x tiles of M
rows rounded up to 8 (at least 16, up to 64; else 128, :func:`wgmma_rows`)
brought by TMA into a ring of shared-memory stages of 64 packed rows, one
f32 partial per group folded with its scales, on a persistent grid of one
block per SM (its two consumer warpgroups issue their products in turn at
128-row tiles).  At a group that is a multiple of 64 a partial is whole
stages; at any other (16, 32, 48, 80, ...) it is group / 16 k16 steps,
which may straddle stages (the kernel's step form).  Two routes, picked by
:func:`gemm_route` from shapes alone (no host sync):

- ``splitk`` (the plan :func:`splitk_splits` cuts the half groups into S >
  1 splits where the output tiles fill at most half the SMs: wo and w2 of
  Llama-2-7B up to M = 128, a tp = 2 rank's projections at decode and at
  the verify): each split writes an f32 partial to a workspace and the
  last of a tile's splits to arrive (a self-resetting ticket per tile)
  sums them in split order: deterministic.
- ``tiles`` (S = 1: tiles that fill the card, and the 512-row bucket): one
  item per output tile, walked persistently in an order that keeps x and
  the weight's column tiles in L2.

Its launches count under ``w4a16_gemm``, ``w4a16_gemm[wgmma]`` and
``w4a16_gemm[wgmma]:<route>``.  It takes N % 16 == 0, K % 16 == 0 and any
group that is a multiple of 16 dividing K/2.

On a CPU tensor the wrapper runs :func:`w4a16_gemm_plain`; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import build
from .counts import LAUNCHES, PLAIN_CALLS

NAME = 'w4a16_gemm'
WGMMA = 'w4a16_gemm[wgmma]'      # the wgmma kernel's own count
ROUTES = ('splitk', 'tiles')
ROUTE_NAMES = tuple(f'{WGMMA}:{r}' for r in ROUTES)
SPLITK_MAX = 8        # splits of K at most
TILE_N = 128          # output columns of a wgmma tile

_counters: dict = {}      # device -> the ticket counters
_sms: dict = {}           # device index -> streaming multiprocessors


def wgmma_rows(m: int) -> int:
    """Rows of x in a wgmma tile (wgmma's N): M rounded up to 8 (at least
    16) up to 64, else 128 (the kernel's ``wgmma_rows``)."""
    return 128 if m > 64 else max(16, -(-m // 8) * 8)


def split_range(split: int, splits: int, g_half: int):
    """Half groups ``[lo, hi)`` of split ``split`` of ``splits``: half group
    gb holds groups gb (low nibbles) and g_half + gb (high nibbles)."""
    return split * g_half // splits, (split + 1) * g_half // splits


def splitk_splits(m: int, k: int, n: int, sms: int, group: int) -> int:
    """The wgmma kernel's plan: the number S of splits of the K / (2
    group) half groups at this shape (S > 1 is route splitk).  Where the
    output tiles fill at most half the SMs, S is the most splits (<=
    SPLITK_MAX, <= the half groups) that keep the tiles' items in one
    wave; else 1.  Measured on an
    H100 (chip_smoke.py's breakdown sweep): each split's partial costs a
    write, a ticket and a sum, so a projection whose tiles already fill
    most of the card (wqkv, w1, w3: 96 / 86 tiles) runs fastest unsplit,
    and one with 32 tiles (wo, w2) fastest at S = 4."""
    g_half = k // (2 * group)
    tiles = -(-n // TILE_N) * -(-m // wgmma_rows(m))
    if 2 * tiles > sms:
        return 1
    return max(1, min(g_half, SPLITK_MAX, sms // tiles))


def gemm_route(m: int, k: int, n: int, sms: int, group: int) -> str:
    """The route a call of these shapes takes, at every M and every group
    that is a multiple of 16: ``splitk`` or ``tiles`` (the wgmma kernel).
    A pure function of shapes: no host sync."""
    return 'splitk' if splitk_splits(m, k, n, sms, group) > 1 else 'tiles'


def sm_count(device) -> int:
    """The card's streaming multiprocessors, cached per device."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    sms = _sms.get(idx)
    if sms is None:
        sms = _sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return sms


def _ticket_counters(tiles: int, device) -> torch.Tensor:
    """Int32 ticket counters, zeroed once when allocated; every launch
    leaves them at zero."""
    c = _counters.get(device)
    if c is None or c.numel() < tiles:
        c = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _counters[device] = c
    return c


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
    return w4a16_gemm_route(x, packed, scales, layer, gemm_route(
        m, k, packed.shape[-1], sm_count(x.device), k // scales.shape[1]))


def w4a16_gemm_route(x: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor, layer: int,
                     route: str) -> torch.Tensor:
    """Launch the kernel on route ``route`` ('splitk' or 'tiles') on CUDA
    tensors, whatever M is: :func:`w4a16_gemm` picks by shapes, a
    measurement or a test forces one.  A forced ``splitk`` whose plan is
    one split takes two."""
    m, k = x.shape
    l_dim, k2, n = packed.shape
    g = scales.shape[1]
    group = k // g
    if (k != 2 * k2 or m == 0 or packed.dtype != torch.uint8
            or scales.dtype != torch.bfloat16 or k2 % group
            or scales.numel() != l_dim * g * n or route not in ROUTES):
        raise ValueError(f'w4a16_gemm: bad operands x{tuple(x.shape)} '
                         f'packed{tuple(packed.shape)}/{packed.dtype} '
                         f'scales{tuple(scales.shape)}/{scales.dtype} '
                         f'route {route!r}')
    g_half = k2 // group
    if n % 16 or k % 16 or group % 16 or (
            route == 'splitk' and g_half < 2):
        raise ValueError(f'w4a16_gemm: unsupported shape M={m} K={k} N={n} '
                         f'group={group} ({route})')
    if not (packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError('w4a16_gemm: packed/scales must be contiguous')
    if not 0 <= layer < l_dim:
        raise IndexError(f'w4a16_gemm: layer {layer} of {l_dim}')
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:                 # TMA takes 16-byte aligned rows
        xb = xb.clone()
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    splits = 1
    if route == 'splitk':
        splits = max(2, splitk_splits(m, k, n, sm_count(x.device), group))
        if splits > g_half:
            raise ValueError(f'w4a16_gemm: {splits} splits of {g_half} '
                             'half groups')
    ws = counter = None
    if splits > 1:
        ws = torch.empty((splits, m, n), dtype=torch.float32,
                         device=x.device)
        counter = _ticket_counters(
            -(-n // TILE_N) * -(-m // wgmma_rows(m)), x.device)
    rc = build.load().lmd_w4a16_gemm(
        xb.data_ptr(), packed[layer].data_ptr(), scales[layer].data_ptr(),
        y.data_ptr(), 0 if ws is None else ws.data_ptr(),
        0 if counter is None else counter.data_ptr(), m, k, n, group,
        splits, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, 'w4a16_gemm')
    LAUNCHES[NAME] += 1
    LAUNCHES[WGMMA] += 1
    LAUNCHES[f'{WGMMA}:{route}'] += 1
    return y


__all__ = ['w4a16_gemm', 'w4a16_gemm_plain', 'w4a16_gemm_route',
           'gemm_route', 'splitk_splits', 'split_range', 'wgmma_rows',
           'unpack_nibbles', 'WGMMA', 'ROUTES',
           'ROUTE_NAMES']
