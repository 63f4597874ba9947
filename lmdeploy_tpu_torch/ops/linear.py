"""Linear layers: dense and W4A16 grouped-quantized.

Port of ``lmdeploy_tpu/ops/linear.py``.  W4A16 weights are per-group
asymmetric int4, ``w = (q - z) * s``; the zero point moves out of the
weight path algebraically:

    x @ w = sum_g (x_g @ q_g) * s_g  -  rowsum_g(x) @ (s * z)

The first term is the hand-written kernel (``ops/cuda/quant_matmul.py``,
x rounded to bf16); the second is one small f32 product on the UNROUNDED
x, with ``sz = s * z`` rounded to the scales' dtype at pack time — the
same two details as the JAX algebra (quant_matmul.py:220,
linear.py:254-255,329-332).

Residency: :class:`PackedInt4Weight` holds two int4 values per byte in
the JAX package's half-split ``pack_nibbles`` layout ([L, K/2, N]), so
weights carry across as a plain byte copy.  :class:`QuantizedWeight`
(one value per byte) is the load form, the form of shapes that cannot
pack (odd group count) and, with ``LMDEPLOY_TPU_PACKED_INT4=0``
(:func:`packed_int4_enabled`), the serving form.  The port packs by
default on every device; the JAX package packs by default on the TPU
only.

The byte form is served by the JAX package's XLA products, ported as
plain PyTorch on every device (no Pallas kernel reads this form):
:func:`quant_matmul` (small M), :func:`quant_matmul_dequant` (M at or
above ``LMDEPLOY_TPU_DEQUANT_MIN_M``, default 32) and, with
``LMDEPLOY_TPU_W4A8=1``, :func:`quant_matmul_a8` at every M.  Both
switches are read on each call, as the JAX package reads them.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .cuda.quant_matmul import unpack_nibbles, w4a16_gemm


def packed_int4_enabled() -> bool:
    """Nibble-packed W4A16 residency where ``models/llama.py::packable``
    allows: on unless ``LMDEPLOY_TPU_PACKED_INT4=0``, which keeps the byte
    form (the JAX engine's switch, ``engine/engine.py:374-390``; its CPU
    default is the byte form, the port's is packed)."""
    return os.environ.get('LMDEPLOY_TPU_PACKED_INT4', '') != '0'


def _w4a8_enabled() -> bool:
    """The opt-in W4A8 product for byte-form weights,
    ``LMDEPLOY_TPU_W4A8=1`` (off by default)."""
    return os.environ.get('LMDEPLOY_TPU_W4A8', '0') == '1'


def _dequant_min_m() -> int:
    """Rows from which a byte-form product dequantises the weight once
    (:func:`quant_matmul_dequant`), ``LMDEPLOY_TPU_DEQUANT_MIN_M``,
    default 32 (the JAX package's measured threshold)."""
    return int(os.environ.get('LMDEPLOY_TPU_DEQUANT_MIN_M', '32'))


@dataclasses.dataclass
class QuantizedWeight:
    """W4A16 weight: int4 values one per byte + per-group qparams."""
    qvals: torch.Tensor   # uint8 [(L,) K, N] values 0..15
    scales: torch.Tensor  # [(L,) K//group, N]
    zeros: torch.Tensor   # [(L,) K//group, N] (zero point, q domain)

    @property
    def k(self) -> int:
        return self.qvals.shape[-2]

    @property
    def n(self) -> int:
        return self.qvals.shape[-1]

    @property
    def group_size(self) -> int:
        return self.k // self.scales.shape[-2]


@dataclasses.dataclass
class PackedInt4Weight:
    """Nibble-packed W4A16 weight stacked over layers."""
    packed: torch.Tensor  # uint8 [L, K/2, N] (pack_nibbles layout)
    scales: torch.Tensor  # [L, G, 1, N]
    sz: torch.Tensor      # [L, G, N] = scales * zeros in the scales' dtype

    @property
    def k(self) -> int:
        return self.packed.shape[-2] * 2

    @property
    def n(self) -> int:
        return self.packed.shape[-1]


def unpack_int4(packed: np.ndarray) -> np.ndarray:
    """The on-disk workspace packing -> uint8 values 0..15, [K, N]: byte
    [k, n'] holds columns 2n' (low nibble) and 2n'+1 (high)."""
    packed = np.asarray(packed)
    out = np.empty((*packed.shape[:-1], packed.shape[-1] * 2), np.uint8)
    out[..., 0::2] = packed & 0xF
    out[..., 1::2] = packed >> 4
    return out


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """[..., K, N] uint8 values 0..15 -> [..., K/2, N]: low nibble = rows
    [0, K/2), high nibble = rows [K/2, K)."""
    k = q.shape[-2]
    assert k % 2 == 0, k
    lo = q[..., :k // 2, :].to(torch.int32)
    hi = q[..., k // 2:, :].to(torch.int32)
    return (lo | (hi << 4)).to(torch.uint8)


def quantize_weight_int4(w, group_size: int = 128) -> QuantizedWeight:
    """Per-group asymmetric min/max int4 quantization of a [K, N] weight
    (AWQ packing math): q = clamp(round(w/s) + z, 0, 15),
    s = (max-min)/15, z = round(-min/s)."""
    w = np.asarray(w, np.float32)
    k, n = w.shape
    assert k % group_size == 0, (k, group_size)
    g = w.reshape(k // group_size, group_size, n)
    scales = np.maximum((g.max(axis=1) - g.min(axis=1)) / 15.0, 1e-8)
    zeros = np.clip(np.round(-g.min(axis=1) / scales), 0, 15)
    q = np.clip(np.round(g / scales[:, None, :]) + zeros[:, None, :], 0, 15)
    return QuantizedWeight(
        qvals=torch.from_numpy(q.reshape(k, n).astype(np.uint8)),
        scales=torch.from_numpy(scales).to(torch.bfloat16),
        zeros=torch.from_numpy(zeros.astype(np.float32)).to(torch.bfloat16))


def dequantize(qw: QuantizedWeight, dtype=torch.bfloat16) -> torch.Tensor:
    """The dense [K, N] weight, (q - z) * s in f32, cast to ``dtype``."""
    k, n = qw.qvals.shape[-2:]
    g = qw.scales.shape[-2]
    q = qw.qvals.float().reshape(g, k // g, n)
    w = (q - qw.zeros.float()[:, None, :]) * qw.scales.float()[:, None, :]
    return w.reshape(k, n).to(dtype)


def pack_quantized(qw: QuantizedWeight) -> PackedInt4Weight:
    """Byte-per-int4 [L?, K, N] -> nibble-packed [L?, K/2, N] residency."""
    q, s, z = qw.qvals, qw.scales, qw.zeros
    if q.dim() == 2:
        q, s, z = q[None], s[None], z[None]
    return PackedInt4Weight(
        packed=pack_nibbles(q).contiguous(),
        scales=s[:, :, None, :].contiguous(),
        sz=(s.float() * z.float()).to(s.dtype).contiguous())


def quant_matmul_packed(x2: torch.Tensor, pw: PackedInt4Weight,
                        layer: int) -> torch.Tensor:
    """x2 [M, K] @ dequant(pw[layer]) -> [M, N] f32: the kernel's scaled
    product minus the zero-point rowsum term."""
    m, k = x2.shape
    g = pw.scales.shape[1]
    out = w4a16_gemm(x2, pw.packed, pw.scales, layer)
    sums = x2.float().reshape(m, g, k // g).sum(dim=2)
    return out - sums @ pw.sz[layer].float()


def quant_matmul(x2: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    """Small-M byte-per-int4 product (the JAX group-batched form, bf16
    partial sums): [M, K] -> [M, N] f32."""
    m, k = x2.shape
    g = qw.scales.shape[-2]
    xb = x2.to(torch.bfloat16).float()
    s = qw.scales.float()
    sz = s * qw.zeros.float()
    qb = qw.qvals.float().reshape(g, k // g, -1)
    xg = xb.reshape(m, g, k // g).transpose(0, 1)          # [G, M, group]
    dots = torch.bmm(xg, qb).to(torch.bfloat16).float()    # [G, M, N]
    out = torch.einsum('gmn,gn->mn', dots, s)
    sums = xb.reshape(m, g, k // g).sum(dim=2)
    return out - sums @ sz


def quant_matmul_a8(x2: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    """W4A8 byte-per-int4 product (JAX ``ops/linear.py:172-204``): x in
    f32 (not rounded to bf16 first), per-token int8 ``xq = clip(round(x /
    sx), -127, 127)`` with ``sx = max(max|x|, 1e-8) / 127`` (round half to
    even), the int group dots rounded to bf16 and scaled by the bf16
    scales with f32 sums over the groups, times ``sx``, minus the
    zero-point term of the unquantised x: [M, K] -> [M, N] f32.

    The group dots run as an f32 ``bmm`` over the integer values: every
    product and partial sum is an integer below 2^24 (128 * 127 * 15), so
    it is exact in any order, as XLA's int32 dot is."""
    m, k = x2.shape
    g = qw.scales.shape[-2]
    x2 = x2.float()
    amax = torch.clamp(x2.abs().amax(dim=1, keepdim=True), min=1e-8)
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python
    # scalar divisor, which moves sx by an ulp and then an int8 code
    sx = amax / torch.full_like(amax, 127.0)
    xq = torch.clamp(torch.round(x2 / sx), -127, 127)       # [M, K]
    s = qw.scales.float()
    sz = s * qw.zeros.float()
    qb = qw.qvals.float().reshape(g, k // g, -1)
    xg = xq.reshape(m, g, k // g).transpose(0, 1)          # [G, M, group]
    dots = torch.bmm(xg, qb).to(torch.bfloat16).float()    # [G, M, N]
    out = torch.einsum('gmn,gn->mn', dots, s.to(torch.bfloat16).float())
    out = out * sx
    sums = x2.reshape(m, g, k // g).sum(dim=2)
    return out - sums @ sz


def quant_matmul_dequant(x2: torch.Tensor,
                         qw: QuantizedWeight) -> torch.Tensor:
    """Large-M byte-per-int4 product: bf16 dequant, f32 accumulation."""
    w = dequantize(qw, torch.bfloat16)
    return x2.to(torch.bfloat16).float() @ w.float()


def linear(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Dense dispatch: ``w`` is a dense [K, N] tensor or one layer's
    :class:`QuantizedWeight`.  Output in x.dtype (+ bias).  The byte form
    picks its product in the JAX package's order: W4A8 when switched on,
    else dequant from ``_dequant_min_m()`` rows, else the group form."""
    lead = x.shape[:-1]
    if isinstance(w, QuantizedWeight):
        x2 = x.reshape(-1, x.shape[-1])
        if _w4a8_enabled():
            mm = quant_matmul_a8
        elif x2.shape[0] >= _dequant_min_m():
            mm = quant_matmul_dequant
        else:
            mm = quant_matmul
        out = mm(x2, w).reshape(*lead, -1)
    else:
        out = torch.matmul(x.to(w.dtype), w).float()
    out = out.to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


__all__ = ['packed_int4_enabled', 'QuantizedWeight', 'PackedInt4Weight',
           'unpack_int4', 'pack_nibbles', 'unpack_nibbles',
           'quantize_weight_int4', 'dequantize', 'pack_quantized',
           'quant_matmul', 'quant_matmul_a8', 'quant_matmul_dequant',
           'quant_matmul_packed', 'linear']
