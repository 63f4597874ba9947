#!/usr/bin/env python3
"""Chip smoke test of lmdeploy_tpu_torch, the PyTorch/CUDA port, on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases (any failure ends the run with a nonzero exit and no result line):
  1. probe   — card name and power limit, torch/CUDA versions, nvcc, triton
  2. build   — compile the CUDA kernels for sm_90a from csrc/*.cu (one nvcc
               per source, all at once) and print ptxas' register /
               shared-memory / spill lines
  3. kernels — each kernel, and each attention kernel at each KV width
               (bf16, int8, int4), against its plain PyTorch version on the
               card at Llama-2-7B main-path shapes, with its time, the plain
               version's time, one PyTorch library call's time and the bound;
               the kernels line reports the shapes the engine launches in
               decode (all 8 batch slots: GEMM M=8, attention B=8)
  4. model   — a 2-layer full-width W4A16 model: one 64-token prefill chunk
               + 4 decode steps through the kernels on the card against the
               same model on the CPU, where every wrapper runs its plain
               version; with a bf16 pool, an int8 and an int4 pool (qparams
               from the bf16 run's K/V), and an int8 pool under
               LMDEPLOY_TPU_FUSED_ATTN=0 and LMDEPLOY_TPU_FUSED_ROPE=1
  5. engine  — full Llama-2-7B width (32 layers, W4A16 group 128, KV in
               64-token pages) through TorchEngine.create_instance()
               .stream_infer: with a bf16 pool, then an int8 pool
               (quant_policy 4, per-layer qparams from the K/V the bf16 run
               wrote), 4 concurrent greedy requests, then one bs1 request of
               256 new tokens; launches per decode step and per prefill pass
               are solved from the counters and the engine's own step and
               pass counts over two windows, and must be 160/32/0 and
               160/0/32 (GEMM / fused decode attention / prefill attention)
               on that pool's width, with no plain-version call.  Then two
               short bs1 requests (32 and 8 new tokens, two windows) on each
               width (int4: quant_policy 8 with static qparams) under the
               defaults, LMDEPLOY_TPU_FUSED_ATTN=0 and
               LMDEPLOY_TPU_FUSED_ROPE=1 must solve to 32 / 0 launches per
               decode step / prefill pass of the selected decode kernel and
               0 / 32 of prefill attention.  Counters are set to 0 before
               each run and read after it.
The line before the last is the kernels JSON; the last line is the result.
Nothing here imports JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor cores
PHASES = ('probe', 'build', 'kernels', 'model', 'engine')
LLAMA2_7B_GEMMS = (('wqkv', 4096, 12288), ('wo', 4096, 4096),
                   ('w1', 4096, 11008), ('w3', 4096, 11008),
                   ('w2', 11008, 4096))
ENGINE_SLOTS = 8     # phase 5's max_batch_size: every decode step runs all
GEMM_ROWS = (1, ENGINE_SLOTS, 64, 512)   # 64: the smallest prefill bucket
REPLACES = {
    'w4a16_gemm': 'lmdeploy_tpu/ops/pallas/quant_matmul.py:177',
    'paged_decode_attention_write':
        'lmdeploy_tpu/ops/pallas/paged_attention.py:264',
    'paged_decode_attention':
        'lmdeploy_tpu/ops/pallas/paged_attention.py:435',
    'paged_decode_attention_rope_write':
        'lmdeploy_tpu/ops/pallas/paged_attention.py:352',
    'paged_prefill_attention':
        'lmdeploy_tpu/ops/pallas/prefill_attention.py:134',
}
SOURCES = {
    'w4a16_gemm': 'lmdeploy_tpu_torch/csrc/w4a16_gemm.cu',
    'paged_decode_attention_write':
        'lmdeploy_tpu_torch/csrc/paged_decode_attention.cu',
    'paged_decode_attention':
        'lmdeploy_tpu_torch/csrc/paged_decode_attention.cu',
    'paged_decode_attention_rope_write':
        'lmdeploy_tpu_torch/csrc/paged_decode_attention.cu',
    'paged_prefill_attention':
        'lmdeploy_tpu_torch/csrc/paged_prefill_attention.cu',
}
# kernel checks: (k_scale, k_zp, v_scale, v_zp) over random int8 / nibble
# bytes (dequantised K/V of about +-2.5)
KERNEL_QPARAMS = {8: (0.021, 1.5, 0.017, -2.0), 4: (0.31, 0.5, 0.27, -0.5)}
# model phase, card vs CPU with a quantised pool: (largest difference in
# quantised steps, share of values that differ).  Measured on an H100 at
# 700 W: the bf16 pools differ by one ulp on 0.44% of values, the int8
# pools by 2 steps on 0.12%, the int4 pools by 1 step on 0.004%.  A value
# can only flip where its bf16 input differs, so the share is held to the
# bf16 pools' 0.44% with a little headroom; it does not follow the run.
POOL_STEPS_TOL = (2, 5e-3)
DECODE_MODES = ('paged_decode_attention_write', 'paged_decode_attention',
                'paged_decode_attention_rope_write')


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, ops: float):
    """(least time in ms, 'bytes' | 'operations') on the published peaks."""
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_BF16_FLOPS
    return max(tb, to) * 1e3, ('bytes' if tb >= to else 'operations')


class Timer:
    """Device times in ms per call, measured with CUDA events."""

    def __init__(self, torch):
        self.torch = torch

    def events(self, fn, iters: int, warmup: int = 2) -> float:
        torch = self.torch
        for i in range(warmup):
            fn(i)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for i in range(iters):
            fn(i)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    def graph(self, fn, iters: int, replays: int = 5) -> float:
        """Capture ``iters`` calls in one CUDA graph and time its replays,
        so host launch overhead does not hide microsecond kernels."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for i in range(2):
                fn(i)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                fn(i)
        g.replay()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(replays):
            g.replay()
        e.record()
        torch.cuda.synchronize()
        del g
        return s.elapsed_time(e) / (iters * replays)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_probe(torch, ctx):
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f'nvidia-smi failed: {smi.stderr}')
    ctx['card'] = smi.stdout.strip().splitlines()[0]
    log(f'card: {ctx["card"]}')
    log(f'torch {torch.__version__}, torch.version.cuda '
        f'{torch.version.cuda}, device {torch.cuda.get_device_name(0)}, '
        f'capability {torch.cuda.get_device_capability(0)}, count '
        f'{torch.cuda.device_count()}')
    from lmdeploy_tpu_torch.ops.cuda import build
    nvcc = build.find_nvcc()
    ver = subprocess.run([nvcc, '--version'], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    log(f'nvcc: {nvcc}: {ver[-1] if ver else "?"}')
    try:
        import triton
        log(f'triton {triton.__version__} imports')
    except ImportError as e:
        log(f'triton does not import: {e}')


def phase_build(torch, ctx):
    from lmdeploy_tpu_torch.ops.cuda import build
    t0 = time.monotonic()
    build.load()
    log(f'build: {time.monotonic() - t0:.1f} s (sources {build.SOURCES})')
    for block in build.BUILD_LOG:
        for line in block.splitlines():
            if line.startswith('==') or 'ptxas' in line and (
                    'registers' in line or 'spill' in line
                    or 'Compiling entry' in line):
                log('  ' + line.strip())


def _rand_packed(torch, gen, shape):
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                         device='cuda')


def check_gemm(torch, ctx, timer):
    from lmdeploy_tpu_torch.ops.cuda.quant_matmul import (
        unpack_nibbles, w4a16_gemm, w4a16_gemm_plain)
    gen = torch.Generator(device='cuda').manual_seed(1)
    n_layers = 8          # timing cycles layers so weights come from HBM
    rows, worst = [], 0.0
    layer = {m: {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0,
                 'bytes': 0.0, 'ops': 0.0} for m in (1, ENGINE_SLOTS)}
    for name, k, n in LLAMA2_7B_GEMMS:
        g = k // 128
        packed = _rand_packed(torch, gen, (n_layers, k // 2, n))
        scales = (torch.rand((n_layers, g, 1, n), generator=gen,
                             device='cuda') * 0.01 + 0.001).to(torch.bfloat16)
        deq = [(unpack_nibbles(packed[i]).float().reshape(g, 128, n)
                * scales[i].float()).reshape(k, n).to(torch.bfloat16)
               for i in range(n_layers)]
        for m in GEMM_ROWS:
            x = torch.randn((m, k), generator=gen, device='cuda').to(
                torch.bfloat16)
            got = w4a16_gemm(x, packed, scales, 3)
            want = w4a16_gemm_plain(x, packed, scales, 3)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            tol = 1e-3 * scale + 1e-3
            if not err <= tol:
                raise AssertionError(f'w4a16_gemm {name} M={m}: max abs err '
                                     f'{err} > {tol}')
            worst = max(worst, err)
            ms = timer.graph(lambda i: w4a16_gemm(x, packed, scales,
                                                  i % n_layers), 16)
            lib = timer.graph(lambda i: torch.matmul(x, deq[i % n_layers]),
                              16)
            plain = timer.events(lambda i: w4a16_gemm_plain(
                x, packed, scales, i % n_layers), 3, warmup=1)
            nbytes = m * k * 2 + k * n // 2 + g * n * 2 + m * n * 4
            ops = 2.0 * m * k * n
            bms, by = bound_ms(nbytes, ops)
            rows.append((name, m, k, n, ms, plain, lib, bms, by, err))
            log(f'  w4a16_gemm {name:4s} M={m:3d} K={k:5d} N={n:5d}: '
                f'kernel {ms:.4f} ms, plain {plain:.3f} ms, torch.matmul '
                f'(bf16 dequantized) {lib:.4f} ms, bound {bms:.4f} ms '
                f'({by}), max abs err {err:.2e} (tol {tol:.2e}, scale '
                f'{scale:.1f})')
            if m in layer:
                for key, val in (('ms', ms), ('plain_ms', plain),
                                 ('library_ms', lib), ('bytes', nbytes),
                                 ('ops', ops)):
                    layer[m][key] += val
        del deq, packed, scales
        torch.cuda.empty_cache()
    for m in layer:
        layer[m]['bound_ms'], layer[m]['bound_by'] = bound_ms(
            layer[m].pop('bytes'), layer[m].pop('ops'))
    ctx['kernels']['w4a16_gemm'] = dict(
        shape=f'one Llama-2-7B layer in decode: wqkv+wo+w1+w3+w2, '
              f'M={ENGINE_SLOTS} (the engine runs all its slots)',
        **layer[ENGINE_SLOTS], m1=layer[1], max_abs_err=worst,
        tolerance='1e-3 * max|plain| + 1e-3 (f32 sums in another order)')
    ctx['gemm_rows'] = rows


def _pool(torch, gen, shape, kv_bits):
    """A random pool on the card: bf16 normals, int8 bytes, or nibble
    bytes (last dim halved)."""
    if kv_bits == 0:
        return torch.randn(shape, generator=gen, device='cuda').to(
            torch.bfloat16)
    if kv_bits == 8:
        return torch.randint(-128, 128, shape, generator=gen,
                             dtype=torch.int8, device='cuda')
    return torch.randint(0, 256, shape[:-1] + (shape[-1] // 2,),
                         generator=gen, dtype=torch.uint8, device='cuda')


def _paged_case(torch, gen, b, ctxs, n_layers, pages, kh, page=64,
                maxp=32, kv_bits=0):
    dh = 128
    shape = (n_layers, pages, page, kh, dh)
    kc = _pool(torch, gen, shape, kv_bits)
    vc = _pool(torch, gen, shape, kv_bits)
    pt = torch.full((b, maxp), -1, dtype=torch.int32)
    perm = torch.randperm(pages).tolist()     # scattered, disjoint pages
    for i, c in enumerate(ctxs):
        need = -(-c // page)
        pt[i, :need] = torch.tensor(perm[:need])
        perm = perm[need:]
    return kc, vc, pt.cuda()


def _dequant_gather(torch, kc, vc, pt, n_tok, qp):
    """Per layer, [B, KH, n_tok, Dh] bf16 K and V, dequantised, for the
    library call (SDPA), which has no quantised-KV input."""
    from lmdeploy_tpu_torch.ops.cuda.paged_attention import gather_plain
    out = []
    for layer in range(kc.shape[0]):
        kk, vv = gather_plain(kc, vc, layer, pt[:, :n_tok // kc.shape[2]],
                              qp)
        out.append(tuple(x.to(torch.bfloat16).transpose(1, 2).contiguous()
                         for x in (kk, vv)))
    return out


def check_decode(torch, ctx, timer):
    """Kernels 2, 4 and 5 at each KV width, B = 1 and 8, ctx ~ 512."""
    from lmdeploy_tpu_torch.kvcache.paged import KV_WIDTHS
    from lmdeploy_tpu_torch.ops.cuda import paged_attention as PA
    gen = torch.Generator(device='cuda').manual_seed(2)
    kh, h, dh, page, n_layers = 32, 32, 128, 64, 4
    for kv_bits, (width, _, elem_bytes) in KV_WIDTHS.items():
        qp = (torch.tensor(KERNEL_QPARAMS[kv_bits], device='cuda')
              if kv_bits else None)
        for mode in DECODE_MODES:
            worst, by_b = 0.0, {}
            for b in (1, ENGINE_SLOTS):
                ctxs = [512 - 7 * i for i in range(b)]
                kc, vc, pt = _paged_case(torch, gen, b, ctxs, n_layers,
                                         pages=9 * b + 8, kh=kh,
                                         kv_bits=kv_bits)
                cl = torch.tensor(ctxs, dtype=torch.int32, device='cuda')
                valid = torch.ones(b, dtype=torch.int32, device='cuda')
                if b > 1:
                    valid[3] = 0
                q, kn, vn = (torch.randn(shape, generator=gen,
                                         device='cuda').to(torch.bfloat16)
                             for shape in ((b, h, dh), (b, kh, dh),
                                           (b, kh, dh)))
                pos = (cl - 1).float()
                inv = 10000.0 ** (-torch.arange(64, device='cuda').float()
                                  / 64)
                cos_f, sin_f = PA.rope_full_tables(
                    torch.cos(pos[:, None] * inv),
                    torch.sin(pos[:, None] * inv), dh)
                qs = torch.ones(b, device='cuda')

                def call(fn_name, k, v, layer):
                    fn = getattr(PA, fn_name)
                    if mode == 'paged_decode_attention':
                        return fn(q, k, v, layer, pt, cl, qp)
                    if mode == 'paged_decode_attention_write':
                        return fn(q, kn, vn, k, v, layer, pt, cl, valid, qp)
                    return fn(q, kn, vn, cos_f, sin_f, qs, k, v, layer, pt,
                              cl, valid, qp, half=64)
                k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), \
                    vc.clone()
                got = call(mode, k1, v1, 2)
                want = call(mode + '_plain', k2, v2, 2)
                torch.cuda.synchronize()
                label = f'{mode}[{width}] B={b}'
                if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
                    raise AssertionError(f'{label}: pool differs from the '
                                         'plain version')
                if b > 1 and mode != 'paged_decode_attention':
                    p3 = ctxs[3] - 1
                    phys = int(pt[3, p3 // page])
                    if not torch.equal(k1[2, phys, p3 % page],
                                       kc[2, phys, p3 % page]):
                        raise AssertionError('valid=0 slot wrote its KV row')
                ok = (valid.bool() if mode != 'paged_decode_attention'
                      else torch.ones_like(valid, dtype=torch.bool))
                err = (got.float() - want.float())[ok].abs().max().item()
                if not err <= 1e-2:
                    raise AssertionError(f'{label}: max abs err {err} > '
                                         '1e-2')
                worst = max(worst, err)
                ms = timer.graph(lambda i: call(mode, kc, vc, i % n_layers),
                                 32)
                plain = timer.events(lambda i: call(
                    mode + '_plain', k2, v2, i % n_layers), 3, warmup=1)
                # yardstick: SDPA over K/V already gathered to [B, H, 512,
                # Dh] and dequantised (no store, no rope, no dequant)
                kvg = _dequant_gather(torch, kc, vc, pt, 512, qp)
                q4 = q[:, :, None]
                lib = timer.graph(lambda i: torch.nn.functional
                                  .scaled_dot_product_attention(
                                      q4, *kvg[i % n_layers]), 32)
                tok = sum(ctxs)
                nbytes = 2 * tok * kh * dh * elem_bytes + 2 * b * h * dh * 2
                if mode != 'paged_decode_attention':
                    nbytes += (2 * b * kh * dh * 2          # k_new, v_new
                               + 2 * int(valid.sum()) * kh * dh
                               * elem_bytes)
                if mode == 'paged_decode_attention_rope_write':
                    nbytes += 2 * b * dh * 4 + b * 4        # tables, qscale
                ops = 4.0 * tok * h * dh
                bms, by = bound_ms(nbytes, ops)
                log(f'  {label} ctx~512: kernel {ms:.4f} ms, plain '
                    f'{plain:.3f} ms, SDPA {lib:.4f} ms, bound {bms:.4f} ms '
                    f'({by}), max abs err {err:.2e} (tol 1e-2), pool '
                    f'identical')
                by_b[b] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                               bound_ms=bms, bound_by=by)
                del kvg, kc, vc, k1, v1, k2, v2
            ctx['kernels'][f'{mode}[{width}]'] = dict(
                shape=f'Llama-2-7B layer, {width} pool, B={ENGINE_SLOTS} '
                      f'(one valid=0 slot), ctx ~512',
                **by_b[ENGINE_SLOTS], b1=by_b[1], max_abs_err=worst,
                tolerance='1e-2 abs on bf16 outputs; pool bit-identical',
                library='SDPA on K/V gathered and dequantised beforehand '
                        '(no store, rope or dequant inside)')
            torch.cuda.empty_cache()


def check_prefill(torch, ctx, timer):
    from lmdeploy_tpu_torch.ops.cuda.prefill_attention import (
        paged_prefill_attention, paged_prefill_attention_plain)
    from lmdeploy_tpu_torch.kvcache.paged import KV_WIDTHS
    gen = torch.Generator(device='cuda').manual_seed(3)
    kh, h, dh, n_layers = 32, 32, 128, 4
    cases = [('512-token chunk from 0', [0], [512], 512),
             ('64-token chunk over 300 history', [300], [64], 64),
             ('a chunk and a padding row', [100, 40], [64, 0], 64)]
    for kv_bits, (width, _, elem_bytes) in KV_WIDTHS.items():
        qp = (torch.tensor(KERNEL_QPARAMS[kv_bits], device='cuda')
              if kv_bits else None)
        name = f'paged_prefill_attention[{width}]'
        worst = 0.0
        for label, starts, lens, t in cases:
            b = len(starts)
            ends = [s + n for s, n in zip(starts, lens)]
            kc, vc, pt = _paged_case(torch, gen, b,
                                     [max(e, 1) for e in ends], n_layers,
                                     pages=24, kh=kh, kv_bits=kv_bits)
            q = torch.randn((b, t, h, dh), generator=gen, device='cuda').to(
                torch.bfloat16)
            sp = torch.tensor(starts, dtype=torch.int32, device='cuda')
            ce = torch.tensor(ends, dtype=torch.int32, device='cuda')
            got = paged_prefill_attention(q, kc, vc, 1, pt, sp, ce, qp)
            want = paged_prefill_attention_plain(q, kc, vc, 1, pt, sp, ce,
                                                 qp)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f'{name} ({label}): not finite')
            err = max((got[i, :n].float() - want[i, :n].float()).abs()
                      .max().item() for i, n in enumerate(lens) if n)
            if not err <= 1e-2:
                raise AssertionError(f'{name} ({label}): max abs err {err} '
                                     '> 1e-2')
            worst = max(worst, err)
            ms = timer.graph(lambda i: paged_prefill_attention(
                q, kc, vc, i % n_layers, pt, sp, ce, qp), 8)
            plain = timer.events(lambda i: paged_prefill_attention_plain(
                q, kc, vc, i % n_layers, pt, sp, ce, qp), 3, warmup=1)
            msg = (f'  {name} ({label}): kernel {ms:.4f} ms, plain '
                   f'{plain:.3f} ms, max abs err {err:.2e} (tol 1e-2)')
            if t == lens[0] and b == 1:      # the two single-chunk cases
                ctx_len = ends[0]
                kvg = [(k[:, :, :ctx_len], v[:, :, :ctx_len]) for k, v in
                       _dequant_gather(torch, kc, vc, pt, 512, qp)]
                qt = q.transpose(1, 2)
                # from 0 the chunk is causal; over history SDPA takes the
                # mask kv_pos <= start + t explicitly
                causal = (dict(is_causal=True) if not starts[0] else dict(
                    attn_mask=torch.arange(ctx_len, device='cuda')[None]
                    <= starts[0] + torch.arange(t, device='cuda')[:, None]))
                lib = timer.graph(lambda i: torch.nn.functional
                                  .scaled_dot_product_attention(
                                      qt, *kvg[i % n_layers], **causal), 8)
                nbytes = (2 * t * h * dh * 2
                          + 2 * ctx_len * kh * dh * elem_bytes)
                ops = 4.0 * dh * h * t * (starts[0] + (t + 1) / 2)
                bms, by = bound_ms(nbytes, ops)
                msg += (f', SDPA (causal) {lib:.4f} ms, bound {bms:.4f} ms '
                        f'({by})')
                row = dict(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bms, bound_by=by)
                if t == 512:
                    ctx['kernels'][name] = dict(
                        shape=f'Llama-2-7B layer, {width} pool, one '
                              '512-token chunk from 0', **row)
                else:
                    ctx['kernels'][name]['chunk64_over300'] = row
                del kvg
            log(msg)
            del kc, vc
        ctx['kernels'][name].update(
            max_abs_err=worst,
            tolerance='1e-2 abs on bf16 outputs, valid rows; padding rows '
                      'finite',
            library='SDPA with a causal mask on K/V gathered and '
                    'dequantised beforehand')
        torch.cuda.empty_cache()


def phase_kernels(torch, ctx):
    timer = Timer(torch)
    check_gemm(torch, ctx, timer)
    check_decode(torch, ctx, timer)
    check_prefill(torch, ctx, timer)


def llama2_7b(num_layer: int = 32):
    from lmdeploy_tpu_torch.config import ModelConfig
    return ModelConfig(head_num=32, kv_head_num=32, size_per_head=128,
                       inter_size=11008, num_layer=num_layer,
                       vocab_size=32000, rotary_embedding=128,
                       max_position_embeddings=4096, session_len=2048,
                       weight_type='int4', group_size=128)


def random_int4_params(torch, cfg, seed: int, device='cuda'):
    """Random W4A16 parameters drawn directly as nibble-packed bytes from
    a seeded generator on ``device`` (group 128, constant scale 0.002 and
    zero point 8, as bench.py does for the JAX package)."""
    from lmdeploy_tpu_torch.models.llama import vocab_padded
    from lmdeploy_tpu_torch.ops.linear import PackedInt4Weight
    gen = torch.Generator(device=device).manual_seed(seed)
    d, dh, g = cfg.hidden_size, cfg.size_per_head, cfg.group_size or 128
    h, kh, inter, nl = (cfg.head_num, cfg.kv_head_num, cfg.inter_size,
                        cfg.num_layer)
    bf = torch.bfloat16

    def qw(k, n):
        return PackedInt4Weight(
            packed=torch.randint(0, 256, (nl, k // 2, n), generator=gen,
                                 dtype=torch.uint8, device=device),
            scales=torch.full((nl, k // g, 1, n), 0.002, dtype=bf,
                              device=device),
            sz=torch.full((nl, k // g, n), 0.002 * 8.0, dtype=bf,
                          device=device))

    def normal(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02
                ).to(bf)

    vp = vocab_padded(cfg)
    return {
        'tok_embedding': normal(vp, d),
        'norm': torch.ones((d,), dtype=bf, device=device),
        'lm_head': normal(d, vp),
        'layers': {
            'attn_norm': torch.ones((nl, d), dtype=bf, device=device),
            'ffn_norm': torch.ones((nl, d), dtype=bf, device=device),
            'wqkv': qw(d, (h + 2 * kh) * dh), 'wo': qw(h * dh, d),
            'w1': qw(d, inter), 'w3': qw(d, inter), 'w2': qw(inter, d),
        },
    }


def _to(tree, device):
    import dataclasses
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _to(getattr(tree, f.name), device)
                             for f in dataclasses.fields(tree)})
    return tree.to(device)


MODEL_RUNS = (('bf16', 0, {}), ('int8', 8, {}), ('int4', 4, {}),
              ('int8, LMDEPLOY_TPU_FUSED_ATTN=0', 8,
               {'LMDEPLOY_TPU_FUSED_ATTN': '0'}),
              ('int8, LMDEPLOY_TPU_FUSED_ROPE=1', 8,
               {'LMDEPLOY_TPU_FUSED_ROPE': '1'}))


@contextlib.contextmanager
def env_vars(env):
    """Set environment variables for the block (the decode switches)."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def decode_kernel_of(env) -> str:
    """The decode attention kernel the switches select."""
    if env.get('LMDEPLOY_TPU_FUSED_ATTN', '1') != '1':
        return 'paged_decode_attention'
    if env.get('LMDEPLOY_TPU_FUSED_ROPE', '0') == '1':
        return 'paged_decode_attention_rope_write'
    return 'paged_decode_attention_write'


def kv_scales_from_pool(torch, cache, kv_bits: int):
    """Per-layer static qparams from the K/V rows a bf16 run wrote (rows
    with any nonzero value): their min / max through the port's
    kv_qparams formula (asymmetric)."""
    from lmdeploy_tpu_torch.lite.apis.kv_qparams import qparams_from_stats
    keys, values = {}, {}
    for layer in range(cache.k.shape[0]):
        for pool, out in ((cache.k[layer], keys), (cache.v[layer], values)):
            rows = pool.reshape(-1, pool.shape[-2] * pool.shape[-1])
            rows = rows[(rows != 0).any(dim=-1)].float()
            lo, hi = rows.min().item(), rows.max().item()
            out[layer] = dict(min=np.float32(lo), max=np.float32(hi),
                              absmax=np.float32(max(-lo, hi)))
    return qparams_from_stats(keys, values, kv_bits)


def pool_steps_apart(torch, a, b, kv_bits: int):
    """(largest difference in quantised steps, share of values that
    differ) between two pools of one width; int4 is unpacked first."""
    from lmdeploy_tpu_torch.kvcache.paged import unpack_kv_int4
    a, b = a.cpu(), b.cpu()
    if kv_bits == 4:
        a, b = unpack_kv_int4(a), unpack_kv_int4(b)
    if kv_bits == 0:
        d = (a.float() != b.float()).float()
        return float(d.max()), float(d.mean())
    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    return int(d.max()), float((d != 0).float().mean())


def phase_model(torch, ctx):
    """2 layers at full width: kernels on the card vs plain on the CPU,
    with a bf16, an int8 and an int4 pool and under both decode switches.
    The quantised pools' qparams come from the K/V of the bf16 run."""
    from lmdeploy_tpu_torch.kvcache.paged import KV_WIDTHS, init_cache
    from lmdeploy_tpu_torch.models.llama import StepBatch, forward
    from lmdeploy_tpu_torch.ops import cuda as K
    cfg = llama2_7b(num_layer=2)
    params = random_int4_params(torch, cfg, seed=4)
    host = _to(params, 'cpu')
    torch.set_num_threads(8)
    page = 64
    pt = torch.tensor([[5, 2, 7, 1]], dtype=torch.int32)
    rng = np.random.default_rng(4)
    prompt = rng.integers(3, cfg.vocab_size, size=64).tolist()
    ps = {'cuda': params, 'cpu': host}
    scales, failures, summary = {}, [], {}
    for label, kv_bits, env in MODEL_RUNS:
        width, dtype, _ = KV_WIDTHS[kv_bits]
        caches = {dev: init_cache(cfg.num_layer, 8, page, cfg.kv_head_num,
                                  cfg.size_per_head, dtype, dev,
                                  kv_scales=scales.get(kv_bits))
                  for dev in ('cuda', 'cpu')}

        def step(dev, ids, start):
            t = len(ids)
            batch = StepBatch(
                ids=torch.tensor([ids], dtype=torch.int32, device=dev),
                positions=torch.arange(start, start + t, dtype=torch.int32,
                                       device=dev)[None],
                valid=torch.ones((1, t), dtype=torch.bool, device=dev),
                context_len=torch.tensor([start + t], dtype=torch.int32,
                                         device=dev),
                page_table=pt.to(dev))
            logits, _ = forward(ps[dev], caches[dev], batch, cfg)
            return logits[0, :cfg.vocab_size].float().cpu()

        log(f'  model run: {label} pool')
        feed, start, worst_rel, min_cos = prompt, 0, 0.0, 1.0
        K.reset_launch_counts()
        with env_vars(env):
            for s in range(5):           # the prefill chunk, then 4 decodes
                t0 = time.monotonic()
                got = step('cuda', feed, start)
                torch.cuda.synchronize()
                t1 = time.monotonic()
                want = step('cpu', feed, start)
                t2 = time.monotonic()
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                cos = float(torch.nn.functional.cosine_similarity(
                    got, want, dim=0))
                worst_rel = max(worst_rel, err / scale)
                min_cos = min(min_cos, cos)
                log(f'    step {s} (T={len(feed)}): max abs err {err:.3e} of '
                    f'max |logit| {scale:.3f}, cosine {cos:.6f}, argmax '
                    f'{int(got.argmax())}/{int(want.argmax())} (card '
                    f'{t1 - t0:.2f} s, cpu {t2 - t1:.2f} s)')
                start += len(feed)
                feed = [int(got.argmax())]
        launched = {n: c[0] for n, c in K.launch_counts().items() if c[0]}
        want_launch = {'w4a16_gemm': 5 * 5 * cfg.num_layer,
                       f'{decode_kernel_of(env)}[{width}]': 4 * cfg.num_layer,
                       f'paged_prefill_attention[{width}]': cfg.num_layer}
        if launched != want_launch:
            failures.append(f'{label}: launches {launched}, want '
                            f'{want_launch}')
        flips = [pool_steps_apart(torch, caches['cuda'].k, caches['cpu'].k,
                                  kv_bits),
                 pool_steps_apart(torch, caches['cuda'].v, caches['cpu'].v,
                                  kv_bits)]
        log(f'    {label}: worst logit err / max |logit| {worst_rel:.3e}, '
            f'min cosine {min_cos:.6f}; pool card vs cpu (K, V): largest '
            f'difference and share of differing values {flips}')
        if not (worst_rel <= 0.05 and min_cos >= 0.999):
            failures.append(f'{label}: logits max abs err / max |logit| '
                            f'{worst_rel:.3e} (tol 0.05), min cosine '
                            f'{min_cos:.6f} (tol 0.999)')
        # The store is bit-identical to its plain version on the same rows
        # (phase 3).  Here the rows themselves differ: the card's W4A16
        # sums run in another order, so the bf16 run's card and CPU pools
        # already differ by one bf16 ulp on some values.  Quantised, such a
        # value moves by one step, or two where a bf16 ulp (2^-5 at
        # |x| >= 4) exceeds an int8 step: see POOL_STEPS_TOL.
        steps_tol, share_tol = POOL_STEPS_TOL
        if kv_bits and not all(m <= steps_tol and share <= share_tol
                               for m, share in flips):
            failures.append(f'{label}: pools differ by {flips} (tol: '
                            f'{steps_tol} steps on at most {share_tol:.1e} '
                            'of values)')
        summary[label] = dict(max_rel_err=worst_rel, min_cosine=min_cos,
                              pool_diff=flips)
        if kv_bits == 0:
            scales = {b: kv_scales_from_pool(torch, caches['cuda'], b)
                      for b in (8, 4)}
            log(f'    qparams from the bf16 run\'s K/V: int8 k_scale '
                f'{scales[8][0].tolist()}, v_scale {scales[8][2].tolist()}')
        del caches
    K.reset_launch_counts()
    if failures:
        raise AssertionError('model phase: ' + '; '.join(failures))
    ctx['model'] = summary
    del params, host, ps
    torch.cuda.empty_cache()


def profile_bs1(torch, ctx, run_request, width='bf16'):
    """One bs1 request of 64 new tokens under torch.profiler: device busy
    share (kernel time over the request's wall time) and the kernels that
    take the device time, on a ``width`` KV pool."""
    from torch.profiler import ProfilerActivity, profile
    out = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run_request(out)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, 'self_device_time_total', None)
        if dev is None:
            dev = getattr(e, 'self_cuda_time_total', 0)
        if dev > 0:
            rows.append((dev / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    steps = 64
    log(f'  profile ({width} pool, bs1, 64 new tokens, '
        f'{ctx.get("card", "?")}): wall '
        f'{wall * 1e3:.1f} ms, device kernel time {busy:.1f} ms, busy share '
        f'{busy / (wall * 1e3):.3f}; per token: wall '
        f'{wall * 1e3 / steps:.2f} ms, device {busy / steps:.2f} ms')
    for ms, n, name in rows[:12]:
        log(f'    {ms:9.2f} ms  {n:7d}x  {name[:90]}')
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()), reverse=True)[:8]
    log('    host (self CPU time): ' + '; '.join(
        f'{name[:40]} {ms:.1f} ms / {n}x' for ms, n, name in host))
    ctx[f'profile_bs1_{width}'] = dict(
        wall_ms=wall * 1e3, device_ms=busy, busy_share=busy / (wall * 1e3),
        top=[(name[:90], ms, n) for ms, n, name in rows[:12]],
        host_top=[(name[:90], ms, n) for ms, n, name in host])


def launches_per_pass(marks):
    """Kernel launches per decode step and per prefill pass, solved from
    two windows between three marks (launch counts, decode steps, prefill
    passes): in each window launches = a * steps + b * passes."""
    windows = [(b[1] - a[1], b[2] - a[2]) for a, b in zip(marks, marks[1:])]
    m = np.array(windows, dtype=np.float64)
    if abs(np.linalg.det(m)) < 0.5:
        raise AssertionError(f'windows {windows} do not separate decode '
                             'steps from prefill passes')
    per_step, per_pass = {}, {}
    for name in marks[0][0]:
        y = [b[0][name] - a[0][name] for a, b in zip(marks, marks[1:])]
        per_step[name], per_pass[name] = (
            round(float(v), 6) + 0.0 for v in np.linalg.solve(m, y))
    return per_step, per_pass, windows


def check_route(counts, solved, want_step, want_pass, label):
    """Every kernel's launches per decode step and per prefill pass, as
    solved by :func:`launches_per_pass`, equal ``want_step`` /
    ``want_pass`` (absent names: none), and no plain version ran."""
    per_step, per_pass, windows = solved
    for name in counts:
        if (abs(per_step[name] - want_step.get(name, 0)) > 1e-6
                or abs(per_pass[name] - want_pass.get(name, 0)) > 1e-6):
            raise AssertionError(
                f'{label}: {name} {per_step[name]} launches per decode '
                f'step, {per_pass[name]} per prefill pass (want '
                f'{want_step.get(name, 0)}, {want_pass.get(name, 0)}); '
                f'(decode steps, prefill passes) of the windows {windows}')
    plain = {n: c[1] for n, c in counts.items() if c[1]}
    if plain:
        raise AssertionError(f'{label}: plain-version calls {plain} on the '
                             'main path')


def phase_engine(torch, ctx):
    """Full-width Llama-2-7B W4A16 engines on the card.  A bf16 pool and
    an int8 pool (quant_policy 4, qparams from the K/V the bf16 run wrote)
    each serve 4 concurrent greedy requests and then one bs1 request of
    256 new tokens; then short bs1 requests run each pool width (int4:
    quant_policy 8 with static qparams) under LMDEPLOY_TPU_FUSED_ATTN=0 and
    LMDEPLOY_TPU_FUSED_ROPE=1.  Every run starts from counters at 0 and
    must launch exactly the kernels of its route."""
    import dataclasses
    from lmdeploy_tpu_torch.config import EngineConfig
    from lmdeploy_tpu_torch.engine.engine import TorchEngine
    from lmdeploy_tpu_torch.messages import GenerationConfig, ResponseType
    from lmdeploy_tpu_torch.ops import cuda as K
    cfg = llama2_7b()
    nl = cfg.num_layer
    t0 = time.monotonic()
    params = random_int4_params(torch, cfg, seed=5)
    torch.cuda.synchronize()
    ecfg = EngineConfig(max_batch_size=8, session_len=2048, page_size=64,
                        num_pages=88, max_context_token_num=512,
                        prefill_buckets=(64, 512), step_length=16,
                        speculative_k=0, enable_prefix_caching=False)
    rng = np.random.default_rng(5)
    lens = (16, 100, 300, 500)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n in lens]
    bs1_prompt = rng.integers(3, cfg.vocab_size, size=16).tolist()
    card = ctx.get('card', '?')
    sid = iter(range(1, 10 ** 6))

    def engine(quant_policy=0, kv_scales=None):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = TorchEngine(cfg, dataclasses.replace(
            ecfg, quant_policy=quant_policy), params, kv_scales=kv_scales)
        return eng, eng.create_instance()

    def run(inst, prompt, n_new, out):
        t_sub = time.monotonic()
        first, n, status = None, 0, None
        for o in inst.stream_infer(next(sid), prompt, GenerationConfig(
                max_new_tokens=n_new, top_k=1, ignore_eos=True),
                sequence_end=True):
            if o.num_generated and first is None:
                first = time.monotonic()
            n, status = o.num_generated, o.status
        if n != n_new or status != ResponseType.FINISH:
            raise AssertionError(f'request of {len(prompt)} prompt tokens: '
                                 f'{n} tokens, {status}')
        out.append(dict(ttft=(first or time.monotonic()) - t_sub,
                        t_first=first, t_end=time.monotonic(), n=n))

    def mark(eng):
        """(launch counts, decode steps, prefill passes) so far."""
        return ({n: c[0] for n, c in K.launch_counts().items()},
                eng.stats['decode_steps'], eng.stats['prefill_passes'])

    def record(name, launches, per_step, per_pass):
        ctx['kernels'].setdefault(name, {}).update(
            launches=launches, launches_per_decode_step=per_step,
            launches_per_prefill_pass=per_pass)

    def main_traffic(eng, inst, width):
        """4 concurrent requests, then bs1 256: 160 / 32 / 0 launches per
        decode step and 160 / 0 / 32 per prefill pass on ``width``."""
        K.reset_launch_counts()
        start = mark(eng)
        results = [[] for _ in prompts]
        threads = [threading.Thread(target=run, args=(inst, p, 64, r))
                   for p, r in zip(prompts, results)]
        t_start = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if not all(len(r) == 1 for r in results):
            raise AssertionError(f'{width}: concurrent requests failed')
        results = [r[0] for r in results]
        conc = (sum(r['n'] - 1 for r in results)
                / (max(r['t_end'] for r in results)
                   - min(r['t_first'] for r in results)))
        mid = mark(eng)
        bs1 = []
        run(inst, bs1_prompt, 256, bs1)
        r = bs1[0]
        bs1_tps = (r['n'] - 1) / (r['t_end'] - r['t_first'])
        counts = K.launch_counts()
        end = mark(eng)
        wall = time.monotonic() - t_start
        solved = launches_per_pass([start, mid, end])
        per_step, per_pass, windows = solved
        decode, prefill = (f'paged_decode_attention_write[{width}]',
                           f'paged_prefill_attention[{width}]')
        check_route(counts, solved, {'w4a16_gemm': 5 * nl, decode: nl},
                    {'w4a16_gemm': 5 * nl, prefill: nl}, f'{width} engine')
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        ttfts = [round(x['ttft'], 3) for x in results]
        log(f'  engine, {width} KV pool [{card}]: TTFT {ttfts} s (prompts '
            f'{lens}), decode {conc:.1f} tok/s at 4 concurrent requests, '
            f'{bs1_tps:.1f} tok/s at bs1 (256 tokens), TTFT bs1 '
            f'{r["ttft"]:.3f} s, peak memory {mem:.2f} GiB, {wall:.1f} s')
        log(f'  launches: {({n: c for n, c in counts.items() if c[0]})}; '
            f'per decode step {({n: v for n, v in per_step.items() if v})}; '
            f'per prefill pass {({n: v for n, v in per_pass.items() if v})};'
            f' (decode steps, prefill passes) of the concurrent and bs1 '
            f'windows: {windows}')
        for name in (decode, prefill, 'w4a16_gemm'):
            if name == 'w4a16_gemm' and width != 'bf16':
                continue
            record(name, counts[name][0], per_step[name], per_pass[name])
        return dict(ttft_s=[x['ttft'] for x in results],
                    ttft_bs1_s=r['ttft'], tok_s_4_concurrent=conc,
                    tok_s_bs1=bs1_tps, peak_mem_gib=mem)

    def short_bs1(eng, inst, width, env, lens=(32, 8)):
        """Two bs1 requests under ``env``, of 32 and 8 new tokens, so that
        their two windows separate decode steps from prefill passes: the
        switches' decode kernel 32 launches per decode step and none per
        pass, prefill attention 32 per pass and none per step, the GEMM
        160 per each."""
        decode = f'{decode_kernel_of(env)}[{width}]'
        prefill = f'paged_prefill_attention[{width}]'
        K.reset_launch_counts()
        marks, out = [mark(eng)], []
        with env_vars(env):
            for n_new in lens:
                run(inst, bs1_prompt, n_new, out)
                marks.append(mark(eng))
        counts = K.launch_counts()
        solved = launches_per_pass(marks)
        per_step, per_pass, windows = solved
        label = f'{width} bs1 {env or "defaults"}'
        check_route(counts, solved, {'w4a16_gemm': 5 * nl, decode: nl},
                    {'w4a16_gemm': 5 * nl, prefill: nl}, label)
        tps = (out[0]['n'] - 1) / (out[0]['t_end'] - out[0]['t_first'])
        log(f'  {label}, requests of {lens} new tokens: {decode} '
            f'{counts[decode][0]} launches, {per_step[decode]} per decode '
            f'step and {per_pass[decode]} per prefill pass; {prefill} '
            f'{counts[prefill][0]}, {per_step[prefill]} per step and '
            f'{per_pass[prefill]} per pass; (decode steps, prefill passes) '
            f'of the windows {windows}; {tps:.1f} tok/s and TTFT '
            f'{out[0]["ttft"]:.3f} s at {lens[0]} tokens')
        record(decode, counts[decode][0], per_step[decode], per_pass[decode])
        if width == 'int4' and not env:
            record(prefill, counts[prefill][0], per_step[prefill],
                   per_pass[prefill])

    switches = ({'LMDEPLOY_TPU_FUSED_ATTN': '0'},
                {'LMDEPLOY_TPU_FUSED_ROPE': '1'})
    eng = None
    try:
        eng, inst = engine()
        log(f'  engine built in {time.monotonic() - t0:.1f} s')
        ctx['engine'] = main_traffic(eng, inst, 'bf16')
        if ctx.get('profile'):
            profile_bs1(torch, ctx, lambda out: run(inst, bs1_prompt, 64,
                                                    out))
        scales = {b: kv_scales_from_pool(torch, eng.cache, b) for b in (8, 4)}
        log(f'  int8 qparams from the bf16 run\'s K/V: k_scale '
            f'{[round(float(x), 5) for x in scales[8][0][:4]]}..., k_zp '
            f'{[round(float(x), 2) for x in scales[8][1][:4]]}...')
        for env in switches:
            short_bs1(eng, inst, 'bf16', env)
        eng.shutdown()
        del eng, inst
        eng, inst = engine(4, scales[8])
        ctx['engine_int8'] = main_traffic(eng, inst, 'int8')
        if ctx.get('profile'):
            profile_bs1(torch, ctx, lambda out: run(inst, bs1_prompt, 64,
                                                    out), 'int8')
        for env in switches:
            short_bs1(eng, inst, 'int8', env)
        eng.shutdown()
        del eng, inst
        eng, inst = engine(8, scales[4])
        for env in ({},) + switches:
            short_bs1(eng, inst, 'int4', env)
    finally:
        if eng is not None:
            eng.shutdown()
    del params
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--phases', default=','.join(PHASES),
                    help=f'comma-separated subset of {PHASES}')
    ap.add_argument('--profile', action='store_true',
                    help='engine phase: also profile one bs1 request on '
                         'the bf16 and on the int8 pool')
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    import lmdeploy_tpu_torch  # noqa: F401  (fails outside the repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = [p for p in args.phases.split(',') if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f'unknown phases {sorted(unknown)}')
    ctx = {'kernels': {}, 'profile': args.profile}
    t_all = time.monotonic()
    for name in PHASES:
        if name not in phases:
            continue
        log(f'== phase {name}')
        t0 = time.monotonic()
        globals()[f'phase_{name}'](torch, ctx)
        log(f'== phase {name} ok ({time.monotonic() - t0:.1f} s)')
    kernels = []
    for name, k in ctx['kernels'].items():
        base = name.split('[')[0]
        kernels.append(dict(
            name=name, route='cuda', source=SOURCES[base],
            replaces=REPLACES[base], launches=k.get('launches'),
            launches_per_decode_step=k.get('launches_per_decode_step'),
            launches_per_prefill_pass=k.get('launches_per_prefill_pass'),
            max_abs_err=k.get('max_abs_err'), tolerance=k.get('tolerance'),
            ms=k.get('ms'), kernel_ms=k.get('ms'), plain_ms=k.get('plain_ms'),
            bound_ms=k.get('bound_ms'), bound_by=k.get('bound_by'),
            library_ms=k.get('library_ms'), library=k.get('library'),
            shape=k.get('shape'), at_bs1=k.get('m1') or k.get('b1'),
            chunk64_over300=k.get('chunk64_over300'),
            card=ctx.get('card')))
    log(f'total {time.monotonic() - t_all:.1f} s')
    log(ctx.get('card', '?'))       # nvidia-smi name, power.limit
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
