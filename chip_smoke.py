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
               decode (all 8 batch slots: GEMM M=8, attention B=8); the GEMM
               also at the verify's M=40, prefill attention also at the
               verify's T=5 (B=8 all live, one live slot with 7 padding
               rows, B=1 at ctx 80 / 512 / 2048)
  4. model   — a 2-layer full-width W4A16 model: one 64-token prefill chunk
               + 4 decode steps + one T=5 speculative verify forward (every
               row's logits) through the kernels on the card against the
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
               0 / 32 of prefill attention.  Then speculative decoding
               (k=4, n-gram 3 down to 2) on the bf16 engine: greedy bs1 of
               256 tokens from prompt [1] (bench.py's headline path) and
               one of 32, whose windows solve 160 / 160 / 32 / 0 launches
               per verify round (GEMM / its wgmma regime / prefill / decode
               attention); the same 256-token request on plain rounds; the
               spec tokens against one teacher-forced forward (each within
               1% of max|logit| of its argmax; the two streams agree up to
               the first near-tie); seeded sampled requests (top-k/top-p,
               temperature, repetition penalty, min_new_tokens, a bad word,
               top_logprobs 5) on plain rounds and twice on speculative
               rounds, each pair identical in tokens, logprobs and top-5
               planes), a top_k=0 request ('full'); 4 concurrent
               speculative requests; then, on the stopped engine, kernel
               launches by part of a verify round and one greedy and one
               sampled speculative dispatch under
               torch.cuda.set_sync_debug_mode('error') (no host sync
               before the readback); and an int8 speculative pair with the
               same launch check.  Prefix caching on a bf16 and an int8
               engine: a follower of a 300-token prompt hits 256 tokens and
               prefills 43 in one pass of the 64 bucket, solved from its
               window's launches, with the stream of caching off up to
               near-ties; EngineInstance.decode of that prompt against a
               teacher-forced forward, with a request running alongside
               undisturbed; and the front door: save_workspace of a
               full-width 2-layer workspace, AsyncEngine serving 3
               concurrent streams, a second turn and a request ended by the
               template's stop word.  Counters are set to 0 before each run
               and read after it.
  6. doors   — a user's checkpoint through every door of the port, at
               Llama-2-7B width with 2 layers, in a temporary directory: an
               HF checkpoint (bf16, two safetensors shards) written here,
               convert_hf --quantize, an engine on that workspace serving 4
               concurrent requests and two bs1 requests of a 300-token prompt
               (launches per decode step 10 GEMM + 2 decode attention, per
               prefill pass 10 GEMM + 2 prefill attention, per 512-bucket
               pass 10 of them wgmma), an AWQ export of the same
               quantisation through convert_awq (every tensor bit-equal, an
               identical stream), build_engine on the HF directory (bf16
               dense weights; prompt logits against the CPU's), the OpenAI
               server's core over AsyncEngine without aiohttp (every route,
               a 404 and a 400), `cli.main chat` in a subprocess and
               cli/decode.py's perplexity, and a RouterEngine over the
               engine and a peer process on the same card.
The line before the last is the kernels JSON; the last line is the result.
Nothing here imports JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor cores
PHASES = ('probe', 'build', 'kernels', 'model', 'engine', 'doors')
LLAMA2_7B_GEMMS = (('wqkv', 4096, 12288), ('wo', 4096, 4096),
                   ('w1', 4096, 11008), ('w3', 4096, 11008),
                   ('w2', 11008, 4096))
ENGINE_SLOTS = 8     # phase 5's max_batch_size: every decode step runs all
# 64 and 512: the prefill buckets; 40: the speculative verify of all 8 slots
# (K+1 = 5 rows each); each M times both regimes (the crossover)
SPEC_K = 4           # phase 5's speculative_k, as bench.py's headline run
GEMM_ROWS = (1, ENGINE_SLOTS, 16, 32, ENGINE_SLOTS * (SPEC_K + 1), 64, 128,
             256, 512)
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
    """The W4A16 GEMM at every GEMM_ROWS M over one Llama-2-7B layer's five
    projections, both regimes (each against the plain version), with the
    library call (torch.matmul on the dequantised weight) and the bound;
    the kernel time is that of the regime the wrapper picks."""
    from lmdeploy_tpu_torch.ops.cuda import build
    from lmdeploy_tpu_torch.ops.cuda.quant_matmul import (
        DECODE_MAX_M, REGIMES, unpack_nibbles, w4a16_gemm_plain,
        w4a16_gemm_regime)
    gen = torch.Generator(device='cuda').manual_seed(1)
    n_layers = 8          # timing cycles layers so weights come from HBM
    rows, worst = [], 0.0
    zero = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0)
    layer = {m: dict(zero) for m in GEMM_ROWS}
    by_regime = {r: {m: 0.0 for m in GEMM_ROWS} for r in REGIMES}
    lib = build.load()
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
            want = w4a16_gemm_plain(x, packed, scales, 3)
            scale = want.abs().max().item()
            tol = 1e-3 * scale + 1e-3
            regime = 'decode' if m <= DECODE_MAX_M else 'wgmma'
            for r in REGIMES:
                got = w4a16_gemm_regime(x, packed, scales, 3, r)
                torch.cuda.synchronize()
                e = (got - want).abs().max().item()
                if not e <= tol:
                    raise AssertionError(f'w4a16_gemm[{r}] {name} M={m}: max '
                                         f'abs err {e} > {tol}')
                worst = max(worst, e)
                if r == regime:
                    err = e
                t = timer.graph(lambda i: w4a16_gemm_regime(
                    x, packed, scales, i % n_layers, r), 16)
                by_regime[r][m] += t
                if r == regime:
                    ms = t
            lib_ms = timer.graph(lambda i: torch.matmul(x, deq[i % n_layers]),
                                 16)
            plain = timer.events(lambda i: w4a16_gemm_plain(
                x, packed, scales, i % n_layers), 3, warmup=1)
            nbytes = m * k * 2 + k * n // 2 + g * n * 2 + m * n * 4
            ops = 2.0 * m * k * n
            bms, by = bound_ms(nbytes, ops)
            tile = ('' if regime == 'decode' else
                    f', tile {lib.lmd_w4a16_wgmma_tile(m, n)}')
            rows.append((name, m, k, n, ms, plain, lib_ms, bms, by, err))
            log(f'  w4a16_gemm {name:4s} M={m:3d} K={k:5d} N={n:5d} '
                f'({regime}{tile}): kernel {ms:.4f} ms, plain {plain:.3f} '
                f'ms, torch.matmul (bf16 dequantized) {lib_ms:.4f} ms, bound '
                f'{bms:.4f} ms ({by}), max abs err {err:.2e} (tol '
                f'{tol:.2e}, scale {scale:.1f})')
            for key, val in (('ms', ms), ('plain_ms', plain),
                             ('library_ms', lib_ms), ('bytes', nbytes),
                             ('ops', ops)):
                layer[m][key] += val
        del deq, packed, scales
        torch.cuda.empty_cache()
    for m in layer:
        layer[m]['bound_ms'], layer[m]['bound_by'] = bound_ms(
            layer[m].pop('bytes'), layer[m].pop('ops'))
        log(f'  w4a16_gemm one layer M={m}: kernel {layer[m]["ms"]:.4f} ms, '
            f'torch.matmul {layer[m]["library_ms"]:.4f} ms, bound '
            f'{layer[m]["bound_ms"]:.4f} ms ({layer[m]["bound_by"]})')
    log('  crossover, one layer (ms): ' + '; '.join(
        f'M={m} decode {by_regime["decode"][m]:.4f} wgmma '
        f'{by_regime["wgmma"][m]:.4f}' for m in GEMM_ROWS))
    enc = lib.lmd_tmap_encode_ns(10000)
    log(f'  host: one tensor-map encode {enc} ns (two per wgmma call)')
    ctx['kernels']['w4a16_gemm'] = dict(
        shape=f'one Llama-2-7B layer in decode: wqkv+wo+w1+w3+w2, '
              f'M={ENGINE_SLOTS} (the engine runs all its slots)',
        **layer[ENGINE_SLOTS], m1=layer[1], layer_by_m=layer,
        max_abs_err=worst,
        tolerance='1e-3 * max|plain| + 1e-3 (f32 sums in another order)')
    ctx['kernels']['w4a16_gemm[wgmma]'] = dict(
        shape='one Llama-2-7B layer in prefill: wqkv+wo+w1+w3+w2, M=512 '
              '(the 512-token bucket)',
        **layer[512], max_abs_err=worst,
        verify_m40=layer[ENGINE_SLOTS * (SPEC_K + 1)],
        crossover={r: by_regime[r] for r in REGIMES}, tmap_encode_ns=enc,
        tolerance='1e-3 * max|plain| + 1e-3')
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
    # scattered, disjoint pages (drawn from gen, so each case's inputs
    # depend on its seed only)
    perm = torch.randperm(pages, generator=gen, device='cuda').tolist()
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


# decode attention cases: (label, per-slot contexts, valid=0 slots); the
# first is the kernels line's row (the engine's decode shape), the second
# its bs1 row; the last is the engine's state during a bs1 request after
# longer ones: one live slot, the others masked with stale contexts
DECODE_CASES = (
    ('B=8 ctx~512, slot 3 valid=0', [512 - 7 * i for i in range(8)], (3,)),
    ('B=1 ctx 512', [512], ()),
    ('B=8 ctx~512, all valid', [512 - 7 * i for i in range(8)], ()),
    ('B=1 ctx 80', [80], ()),
    ('B=1 ctx 2048', [2048], ()),
    ('B=8, slot 0 ctx 80, slots 1-7 valid=0 at ctx ~500',
     [80] + [500 + 9 * i for i in range(7)], tuple(range(1, 8))),
)
# splits per slot timed against the automatic choice (None)
SPLIT_SWEEP = (1, 2, 4, 8, 16, None)


def _decode_inputs(torch, gen, ctxs, masked, kh, h, dh, n_layers, kv_bits):
    b = len(ctxs)
    kc, vc, pt = _paged_case(torch, gen, b, ctxs, n_layers,
                             pages=sum(-(-c // 64) for c in ctxs) + 8,
                             kh=kh, kv_bits=kv_bits)
    cl = torch.tensor(ctxs, dtype=torch.int32, device='cuda')
    valid = torch.ones(b, dtype=torch.int32, device='cuda')
    if masked:
        valid[list(masked)] = 0
    q, kn, vn = (torch.randn(shape, generator=gen, device='cuda').to(
        torch.bfloat16) for shape in ((b, h, dh), (b, kh, dh), (b, kh, dh)))
    pos = (cl - 1).float()
    inv = 10000.0 ** (-torch.arange(64, device='cuda').float() / 64)
    from lmdeploy_tpu_torch.ops.cuda import paged_attention as PA
    cos_f, sin_f = PA.rope_full_tables(torch.cos(pos[:, None] * inv),
                                       torch.sin(pos[:, None] * inv), dh)
    return dict(kc=kc, vc=vc, pt=pt, cl=cl, valid=valid, q=q, kn=kn, vn=vn,
                cos_f=cos_f, sin_f=sin_f, qs=torch.ones(b, device='cuda'))


def _decode_call(PA, mode, fn_name, d, k, v, layer, qp):
    fn = getattr(PA, fn_name)
    if mode == 'paged_decode_attention':
        return fn(d['q'], k, v, layer, d['pt'], d['cl'], qp)
    if mode == 'paged_decode_attention_write':
        return fn(d['q'], d['kn'], d['vn'], k, v, layer, d['pt'], d['cl'],
                  d['valid'], qp)
    return fn(d['q'], d['kn'], d['vn'], d['cos_f'], d['sin_f'], d['qs'], k,
              v, layer, d['pt'], d['cl'], d['valid'], qp, half=64)


def check_decode(torch, ctx, timer):
    """Kernels 2, 4 and 5 at each KV width over DECODE_CASES, against the
    plain version (pool bit-identical after the store, valid rows within
    1e-2), each called twice in a row (the ticket counter resets), with
    SDPA and the bound; then a sweep of tokens per split."""
    from lmdeploy_tpu_torch.kvcache.paged import KV_WIDTHS
    from lmdeploy_tpu_torch.ops.cuda import paged_attention as PA
    gen = torch.Generator(device='cuda').manual_seed(2)
    kh, h, dh, page, n_layers = 32, 32, 128, 64, 4
    for kv_bits, (width, _, elem_bytes) in KV_WIDTHS.items():
        qp = (torch.tensor(KERNEL_QPARAMS[kv_bits], device='cuda')
              if kv_bits else None)
        for mode in DECODE_MODES:
            worst, rows = 0.0, {}
            for label, ctxs, masked in DECODE_CASES:
                b = len(ctxs)
                d = _decode_inputs(torch, gen, ctxs, masked, kh, h, dh,
                                   n_layers, kv_bits)
                kc, vc = d['kc'], d['vc']
                k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), \
                    vc.clone()
                got = _decode_call(PA, mode, mode, d, k1, v1, 2, qp)
                again = _decode_call(PA, mode, mode, d, k1, v1, 2, qp)
                want = _decode_call(PA, mode, mode + '_plain', d, k2, v2, 2,
                                    qp)
                torch.cuda.synchronize()
                name = f'{mode}[{width}] {label}'
                if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
                    raise AssertionError(f'{name}: pool differs from the '
                                         'plain version')
                if not torch.equal(got, again):
                    raise AssertionError(f'{name}: a second call differs')
                for i in (masked if mode != 'paged_decode_attention'
                          else ()):
                    pm = ctxs[i] - 1
                    phys = int(d['pt'][i, pm // page])
                    if not torch.equal(k1[2, phys, pm % page],
                                       kc[2, phys, pm % page]):
                        raise AssertionError('valid=0 slot wrote its KV row')
                ok = (d['valid'].bool() if mode != 'paged_decode_attention'
                      else torch.ones_like(d['valid'], dtype=torch.bool))
                err = (got.float() - want.float())[ok].abs().max().item()
                if not err <= 1e-2:
                    raise AssertionError(f'{name}: max abs err {err} > 1e-2')
                worst = max(worst, err)
                ms = timer.graph(lambda i: _decode_call(
                    PA, mode, mode, d, kc, vc, i % n_layers, qp), 32)
                plain = timer.events(lambda i: _decode_call(
                    PA, mode, mode + '_plain', d, k2, v2, i % n_layers, qp),
                    3, warmup=1)
                # yardstick: SDPA over the K/V of the slots the kernel
                # attends (masked slots of the storing modes do no work),
                # gathered to [B, H, ctx, Dh] and dequantised beforehand (no
                # store, no rope, no dequant); for unequal contexts over the
                # longest
                live = [i for i in range(b)
                        if mode == 'paged_decode_attention' or i not in masked]
                att = [ctxs[i] for i in live]
                n_kv = max(att)
                kvg = [(kk[live, :, :n_kv], vv[live, :, :n_kv]) for kk, vv in
                       _dequant_gather(torch, kc, vc, d['pt'],
                                       -(-n_kv // page) * page, qp)]
                q4 = d['q'][live][:, :, None]
                lib = timer.graph(lambda i: torch.nn.functional
                                  .scaled_dot_product_attention(
                                      q4, *kvg[i % n_layers]), 32)
                # bytes this run needs: the attended slots read their
                # context
                tok = sum(att)
                nbytes = 2 * tok * kh * dh * elem_bytes + 2 * b * h * dh * 2
                if mode != 'paged_decode_attention':
                    nbytes += (2 * b * kh * dh * 2          # k_new, v_new
                               + 2 * len(att) * kh * dh * elem_bytes)
                if mode == 'paged_decode_attention_rope_write':
                    nbytes += 2 * b * dh * 4 + b * 4        # tables, qscale
                ops = 4.0 * tok * h * dh
                bms, by = bound_ms(nbytes, ops)
                want = PA.decode_want(mode, kv_bits, h // kh, b * kh)
                splits = PA.decode_splits(d['pt'].shape[1], page, want)
                log(f'  {name}: kernel {ms:.4f} ms (grid of {splits} splits,'
                    f' up to {want} a slot), plain {plain:.3f} ms, SDPA '
                    f'{lib:.4f} ms, '
                    f'bound {bms:.4f} ms ({by}), {bms / ms:.0%} of the bound, '
                    f'max abs err {err:.2e} (tol 1e-2), pool identical')
                rows[label] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                   bound_ms=bms, bound_by=by)
                del kvg, kc, vc, k1, v1, k2, v2, d
            first, second = DECODE_CASES[0][0], DECODE_CASES[1][0]
            ctx['kernels'][f'{mode}[{width}]'] = dict(
                shape=f'Llama-2-7B layer, {width} pool, B={ENGINE_SLOTS} '
                      f'(one valid=0 slot), ctx ~512',
                **rows[first], b1=rows[second],
                cases={k: v for k, v in rows.items() if k not in (first,
                                                                   second)},
                max_abs_err=worst,
                tolerance='1e-2 abs on bf16 outputs; pool bit-identical',
                library='SDPA on K/V gathered and dequantised beforehand '
                        '(no store, rope or dequant inside)')
            torch.cuda.empty_cache()
    sweep_splits(torch, timer, gen, kh, h, dh, n_layers)


def sweep_splits(torch, timer, gen, kh, h, dh, n_layers):
    """Kernel 2 at each width with a fixed number of splits per slot
    against the automatic choice, at bs1 ctx 80 / 512 / 2048 and B=8 ctx
    512 / 2048."""
    from lmdeploy_tpu_torch.ops.cuda import paged_attention as PA
    mode = 'paged_decode_attention_write'
    for kv_bits in (0, 8, 4):
        qp = (torch.tensor(KERNEL_QPARAMS[kv_bits], device='cuda')
              if kv_bits else None)
        for ctxs in ([80], [512], [2048], [512] * 8, [2048] * 8):
            d = _decode_inputs(torch, gen, ctxs, (), kh, h, dh, n_layers,
                               kv_bits)
            times = []
            for want in SPLIT_SWEEP:
                PA.SPLITS_WANTED = want
                try:
                    times.append(timer.graph(lambda i: _decode_call(
                        PA, mode, mode, d, d['kc'], d['vc'], i % n_layers,
                        qp), 32))
                finally:
                    PA.SPLITS_WANTED = None
            auto = PA.decode_want(mode, kv_bits, h // kh, len(ctxs) * kh)
            width = {0: 'bf16', 8: 'int8', 4: 'int4'}[kv_bits]
            log(f'  split sweep {mode}[{width}] B={len(ctxs)} ctx '
                f'{ctxs[0]}: ' + ', '.join(
                    f'{w or f"auto ({auto})"} a slot {ms:.4f} ms'
                    for w, ms in zip(SPLIT_SWEEP, times)))
            del d
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


# kernel 3 at the speculative verify's shape, T = K+1 rows a slot: (label,
# live slots' context ends, padding rows' stale contexts); the first is
# the engine's verify with every slot running, the second a bs1 request's
# verify after longer requests (the idle slots are padding rows)
VERIFY_CASES = (
    ('B=8 T=5 ctx~512', [512 - 7 * i for i in range(8)], []),
    ('B=8 T=5, slot 0 ctx 80, 7 padding rows', [80],
     [500 + 9 * i for i in range(7)]),
    ('B=1 T=5 ctx 80', [80], []),
    ('B=1 T=5 ctx 512', [512], []),
    ('B=1 T=5 ctx 2048', [2048], []),
)


def check_verify(torch, ctx, timer):
    """Kernel 3 at each KV width over VERIFY_CASES against its plain
    version (live rows within 1e-2, padding rows finite), with causal SDPA
    over the live slots and the bound."""
    from lmdeploy_tpu_torch.kvcache.paged import KV_WIDTHS
    from lmdeploy_tpu_torch.ops.cuda.prefill_attention import (
        paged_prefill_attention, paged_prefill_attention_plain)
    gen = torch.Generator(device='cuda').manual_seed(6)
    kh, h, dh, n_layers, t, page = 32, 32, 128, 4, SPEC_K + 1, 64
    for kv_bits, (width, _, elem_bytes) in KV_WIDTHS.items():
        qp = (torch.tensor(KERNEL_QPARAMS[kv_bits], device='cuda')
              if kv_bits else None)
        name = f'paged_prefill_attention[{width}]'
        rows, worst = {}, 0.0
        for label, live_ends, pads in VERIFY_CASES:
            nl = len(live_ends)
            ends = live_ends + pads
            starts = [e - t for e in live_ends] + pads
            b = len(ends)
            kc, vc, pt = _paged_case(
                torch, gen, b, ends, n_layers,
                pages=sum(-(-e // page) for e in ends) + 8, kh=kh,
                kv_bits=kv_bits)
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
            err = (got[:nl].float() - want[:nl].float()).abs().max().item()
            if not err <= 1e-2:
                raise AssertionError(f'{name} ({label}): max abs err {err} '
                                     '> 1e-2')
            worst = max(worst, err)
            ms = timer.graph(lambda i: paged_prefill_attention(
                q, kc, vc, i % n_layers, pt, sp, ce, qp), 32)
            plain = timer.events(lambda i: paged_prefill_attention_plain(
                q, kc, vc, i % n_layers, pt, sp, ce, qp), 3, warmup=1)
            # SDPA over the live slots, kv_pos <= start + t per row
            n_kv = max(live_ends)
            kvg = [(kk[:, :, :n_kv], vv[:, :, :n_kv]) for kk, vv in
                   _dequant_gather(torch, kc, vc, pt[:nl],
                                   -(-n_kv // page) * page, qp)]
            qt = q[:nl].transpose(1, 2)
            mask = (torch.arange(n_kv, device='cuda')[None, None, None]
                    <= sp[:nl, None, None, None]
                    + torch.arange(t, device='cuda')[None, None, :, None])
            lib = timer.graph(lambda i: torch.nn.functional
                              .scaled_dot_product_attention(
                                  qt, *kvg[i % n_layers], attn_mask=mask),
                              32)
            nbytes = (2 * nl * t * h * dh * 2
                      + 2 * sum(live_ends) * kh * dh * elem_bytes)
            ops = sum(4.0 * dh * h * (t * s + t * (t + 1) / 2)
                      for s in starts[:nl])
            bms, by = bound_ms(nbytes, ops)
            log(f'  {name} verify {label}: kernel {ms:.4f} ms, plain '
                f'{plain:.3f} ms, SDPA (masked) {lib:.4f} ms, bound '
                f'{bms:.4f} ms ({by}), {bms / ms:.0%} of the bound, max abs '
                f'err {err:.2e} (tol 1e-2)')
            rows[label] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                               bound_ms=bms, bound_by=by, max_abs_err=err)
            del kvg, kc, vc
        entry = ctx['kernels'][name]
        entry['verify'] = rows
        entry['max_abs_err'] = max(entry['max_abs_err'], worst)
        torch.cuda.empty_cache()


def phase_kernels(torch, ctx):
    timer = Timer(torch)
    check_gemm(torch, ctx, timer)
    check_decode(torch, ctx, timer)
    check_prefill(torch, ctx, timer)
    check_verify(torch, ctx, timer)


def llama2_7b(num_layer: int = 32):
    from lmdeploy_tpu_torch.config import ModelConfig
    return ModelConfig(head_num=32, kv_head_num=32, size_per_head=128,
                       inter_size=11008, num_layer=num_layer,
                       vocab_size=32000, rotary_embedding=128,
                       max_position_embeddings=4096, session_len=2048,
                       weight_type='int4', group_size=128)


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
    from lmdeploy_tpu_torch.models.llama import (StepBatch, forward,
                                                 random_packed_params)
    from lmdeploy_tpu_torch.ops import cuda as K
    cfg = llama2_7b(num_layer=2)
    params = random_packed_params(cfg, 4, 'cuda')
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

        def step(dev, ids, start, verify=False):
            t = len(ids)
            batch = StepBatch(
                ids=torch.tensor([ids], dtype=torch.int32, device=dev),
                positions=torch.arange(start, start + t, dtype=torch.int32,
                                       device=dev)[None],
                valid=torch.ones((1, t), dtype=torch.bool, device=dev),
                context_len=torch.tensor([start + t], dtype=torch.int32,
                                         device=dev),
                page_table=pt.to(dev))
            logits, _ = forward(ps[dev], caches[dev], batch, cfg,
                                return_all_logits=verify,
                                logits_count=t if verify else None)
            return logits[0, ..., :cfg.vocab_size].float().cpu().flatten()

        log(f'  model run: {label} pool')
        feed, start, worst_rel, min_cos = prompt, 0, 0.0, 1.0
        K.reset_launch_counts()
        with env_vars(env):
            # the prefill chunk, 4 decodes, then one speculative verify
            # (the current token and K drafts, every row's logits)
            for s in range(6):
                verify = s == 5
                if verify:
                    feed = feed + rng.integers(
                        3, cfg.vocab_size, size=SPEC_K).tolist()
                t0 = time.monotonic()
                got = step('cuda', feed, start, verify)
                torch.cuda.synchronize()
                t1 = time.monotonic()
                want = step('cpu', feed, start, verify)
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
        want_launch = {'w4a16_gemm': 6 * 5 * cfg.num_layer,
                       f'{decode_kernel_of(env)}[{width}]': 4 * cfg.num_layer,
                       f'paged_prefill_attention[{width}]':
                           2 * cfg.num_layer}
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


def profile_bs1(torch, ctx, run_request, eng, passes_of, width='bf16'):
    """One bs1 request of 64 new tokens under torch.profiler: device busy
    share (kernel time over the request's wall time), the kernels that
    take the device time and the kernel launches per forward pass (decode
    step or verify round), on a ``width`` KV pool (``width`` may name the
    speculative run).  The engine's slots are printed first: the slots the
    request does not use keep the context of their last request."""
    from torch.profiler import ProfilerActivity, profile
    out = []
    torch.cuda.synchronize()
    st = eng.state
    log(f'  before the profiled request: context_len '
        f'{st.context_len.tolist()}, running '
        f'{(st.active & ~st.finished).int().tolist()}')
    before = passes_of(eng)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run_request(out)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    after = passes_of(eng)
    passes = sum(after[k] - before[k] for k in PASS_KINDS)
    rounds = after['spec_rounds'] - before['spec_rounds']
    launches = sum(e.count for e in prof.key_averages()
                   if e.key.startswith('cudaLaunchKernel'))
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
        f'{wall * 1e3 / steps:.2f} ms, device {busy / steps:.2f} ms; '
        f'{passes} forward passes ({rounds} verify rounds), per pass: wall '
        f'{wall * 1e3 / passes:.2f} ms, device {busy / passes:.2f} ms, '
        f'{launches / passes:.0f} kernel launches')
    for ms, n, name in rows[:12]:
        log(f'    {ms:9.2f} ms  {n:7d}x  {name[:90]}')
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()), reverse=True)[:8]
    log('    host (self CPU time): ' + '; '.join(
        f'{name[:40]} {ms:.1f} ms / {n}x' for ms, n, name in host))
    ctx[f'profile_bs1_{width}'] = dict(
        wall_ms=wall * 1e3, device_ms=busy, busy_share=busy / (wall * 1e3),
        passes=passes, verify_rounds=rounds, launches=launches,
        top=[(name[:90], ms, n) for ms, n, name in rows[:12]],
        host_top=[(name[:90], ms, n) for ms, n, name in host])


# forward passes by kind: the engine's decode steps and prefill passes,
# and the verify rounds its speculative dispatches run on the device
# (``stats['spec_rounds']`` counts, as the JAX engine does, only rounds up
# to the one in which the last running slot finished)
PASS_KINDS = ('decode_steps', 'spec_rounds', 'prefill_passes')


class DevicePasses:
    """Forward passes by kind so far: wraps ``step.spec_decode_rounds`` to
    count the rounds each dispatch runs (restored by :meth:`close`)."""

    def __init__(self):
        from lmdeploy_tpu_torch.engine import step as S
        self.step, self.real, self.rounds = S, S.spec_decode_rounds, 0

        def counting(*a, **kw):
            self.rounds += kw['num_rounds']
            return self.real(*a, **kw)
        S.spec_decode_rounds = counting

    def __call__(self, eng) -> dict:
        return {'decode_steps': eng.stats['decode_steps'],
                'spec_rounds': self.rounds,
                'prefill_passes': eng.stats['prefill_passes']}

    def close(self):
        self.step.spec_decode_rounds = self.real


def launches_per_kind(marks, skip=()):
    """Kernel launches per forward pass of each kind that ran (decode step,
    verify round, prefill pass), solved from the windows between marks
    (launch counts, {kind: passes so far}): in each window launches =
    sum over kinds of per-pass launches * passes.  The windows must fix
    every kind that ran, and every kernel's launches (but those in
    ``skip``) must fit exactly."""
    kinds = [k for k in PASS_KINDS
             if any(b[1][k] != a[1][k] for a, b in zip(marks, marks[1:]))]
    m = np.array([[b[1][k] - a[1][k] for k in kinds]
                  for a, b in zip(marks, marks[1:])], dtype=np.float64)
    if not kinds or np.linalg.matrix_rank(m) < len(kinds):
        raise AssertionError(f'windows {m.tolist()} of {kinds} do not fix '
                             'launches per pass')
    per = {k: {} for k in kinds}
    for name in marks[0][0]:
        if name in skip:
            continue
        y = np.array([b[0][name] - a[0][name]
                      for a, b in zip(marks, marks[1:])], dtype=np.float64)
        sol = np.linalg.lstsq(m, y, rcond=None)[0]
        if np.abs(m @ sol - y).max() > 1e-6:
            raise AssertionError(f'{name}: launches {y.tolist()} fit no '
                                 f'fixed count per pass of {kinds} '
                                 f'{m.tolist()}')
        for k, v in zip(kinds, sol):
            per[k][name] = round(float(v), 6) + 0.0
    return per, kinds, m.tolist()


def teacher_forced_logits(torch, params, cfg, prompt, tokens):
    """f32 logits [len(tokens), V] of one forward over the prompt and the
    stream (each row predicts the stream's next token), through the
    kernels, in a pool of its own."""
    from lmdeploy_tpu_torch.kvcache.paged import init_cache
    from lmdeploy_tpu_torch.models.llama import StepBatch, forward
    ids = list(prompt) + list(tokens[:-1])
    t, page = len(ids), 64
    pages = -(-t // page)
    cache = init_cache(cfg.num_layer, pages, page, cfg.kv_head_num,
                       cfg.size_per_head, torch.bfloat16, 'cuda')
    dev = 'cuda'
    batch = StepBatch(
        ids=torch.tensor([ids], dtype=torch.int32, device=dev),
        positions=torch.arange(t, dtype=torch.int32, device=dev)[None],
        valid=torch.ones((1, t), dtype=torch.bool, device=dev),
        context_len=torch.tensor([t], dtype=torch.int32, device=dev),
        page_table=torch.arange(pages, dtype=torch.int32, device=dev)[None])
    logits, _ = forward(params, cache, batch, cfg, return_all_logits=True)
    return logits[0, len(prompt) - 1:, :cfg.vocab_size].float()


def count_kernels(torch, fn):
    """Kernels one call of ``fn`` launches (torch.profiler, CUDA)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = 0
    for e in prof.key_averages():
        dev = getattr(e, 'self_device_time_total', None)
        if dev is None:
            dev = getattr(e, 'self_cuda_time_total', 0)
        n += e.count if dev > 0 else 0
    return n


def check_route(counts, solved, want, label, need=()):
    """Every kernel's launches per pass of each kind, as solved by
    :func:`launches_per_kind`, equal ``want`` ({kind: {name: launches}};
    absent names: none), the kinds in ``need`` ran, and no plain version
    ran."""
    per, kinds, windows = solved
    if not set(need) <= set(kinds):
        raise AssertionError(f'{label}: passes of {kinds} ran, want {need}')
    for kind in kinds:
        for name, got in per[kind].items():
            if abs(got - want.get(kind, {}).get(name, 0)) > 1e-6:
                raise AssertionError(
                    f'{label}: {name} {got} launches per {kind} (want '
                    f'{want.get(kind, {}).get(name, 0)}); windows {windows} '
                    f'of {kinds}')
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
    LMDEPLOY_TPU_FUSED_ROPE=1.  The bf16 and int8 engines then serve
    speculative rounds (speculative_k toggled on the running engine, as
    bench.py does): spec_main and no_host_sync below.  Every run starts
    from counters at 0 and must launch exactly the kernels of its route."""
    import dataclasses
    from lmdeploy_tpu_torch.config import EngineConfig
    from lmdeploy_tpu_torch.engine.engine import TorchEngine
    from lmdeploy_tpu_torch.messages import GenerationConfig, ResponseType
    from lmdeploy_tpu_torch.models.llama import random_packed_params
    from lmdeploy_tpu_torch.ops import cuda as K
    from lmdeploy_tpu_torch.ops.cuda.quant_matmul import DECODE_MAX_M, WGMMA
    cfg = llama2_7b()
    nl = cfg.num_layer
    t0 = time.monotonic()
    params = random_packed_params(cfg, 5, 'cuda')
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
    long_prompt = rng.integers(3, cfg.vocab_size, size=300).tolist()
    card = ctx.get('card', '?')
    sid = iter(range(1, 10 ** 6))

    def engine(quant_policy=0, kv_scales=None, prefix=False):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = TorchEngine(cfg, dataclasses.replace(
            ecfg, quant_policy=quant_policy, enable_prefix_caching=prefix),
            params, kv_scales=kv_scales)
        return eng, eng.create_instance()

    def run(inst, prompt, n_new, out, gen=None):
        """One request (greedy unless ``gen``) of exactly ``n_new`` tokens
        (up to ``n_new`` with ``gen``, which may stop at EOS)."""
        t_sub = time.monotonic()
        first, last = None, None
        for last in inst.stream_infer(next(sid), prompt, gen or
                                      GenerationConfig(
                                          max_new_tokens=n_new, top_k=1,
                                          ignore_eos=True),
                                      sequence_end=True):
            if last.num_generated and first is None:
                first = time.monotonic()
        n, status = last.num_generated, last.status
        if not (n == n_new or gen and 0 < n < n_new) \
                or status != ResponseType.FINISH:
            raise AssertionError(f'request of {len(prompt)} prompt tokens: '
                                 f'{n} tokens, {status}')
        out.append(dict(ttft=(first or time.monotonic()) - t_sub,
                        t_first=first, t_end=time.monotonic(), n=n,
                        tokens=list(last.token_ids), logprobs=last.logprobs,
                        top_logprobs=last.top_logprobs))

    passes_of = DevicePasses()

    def mark(eng):
        """(launch counts, forward passes by kind) so far."""
        return ({n: c[0] for n, c in K.launch_counts(True).items()},
                passes_of(eng))

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
        counts = K.launch_counts(True)
        end = mark(eng)
        wall = time.monotonic() - t_start
        # the wgmma regime runs the passes of the 512 bucket only, whose
        # share of the passes the concurrent window does not fix
        solved = launches_per_kind([start, mid, end], skip=(WGMMA,))
        per, _, windows = solved
        decode, prefill = (f'paged_decode_attention_write[{width}]',
                           f'paged_prefill_attention[{width}]')
        check_route(counts, solved,
                    {'decode_steps': {'w4a16_gemm': 5 * nl, decode: nl},
                     'prefill_passes': {'w4a16_gemm': 5 * nl, prefill: nl}},
                    f'{width} engine', need=('decode_steps',
                                              'prefill_passes'))
        per_step, per_pass = per['decode_steps'], per['prefill_passes']
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

    def short_bs1(eng, inst, width, env, lens=(32, 8), prompt=None):
        """Two bs1 requests under ``env``, of 32 and 8 new tokens, so that
        their two windows separate decode steps from prefill passes: the
        switches' decode kernel 32 launches per decode step and none per
        pass, prefill attention 32 per pass and none per step, the GEMM
        160 per each, 160 of them per pass in the wgmma regime when the
        prompt's bucket has more rows than DECODE_MAX_M."""
        prompt = prompt or bs1_prompt
        decode = f'{decode_kernel_of(env)}[{width}]'
        prefill = f'paged_prefill_attention[{width}]'
        rows = min(b for b in ecfg.prefill_buckets if b >= len(prompt))
        K.reset_launch_counts()
        marks, out = [mark(eng)], []
        with env_vars(env):
            for n_new in lens:
                run(inst, prompt, n_new, out)
                marks.append(mark(eng))
        counts = K.launch_counts(True)
        solved = launches_per_kind(marks)
        per, _, windows = solved
        label = (f'{width} bs1 {env or "defaults"}, {len(prompt)}-token '
                 f'prompt')
        check_route(counts, solved,
                    {'decode_steps': {'w4a16_gemm': 5 * nl, decode: nl},
                     'prefill_passes': {
                         'w4a16_gemm': 5 * nl, prefill: nl,
                         WGMMA: 5 * nl if rows > DECODE_MAX_M else 0}},
                    label, need=('decode_steps', 'prefill_passes'))
        per_step, per_pass = per['decode_steps'], per['prefill_passes']
        tps = (out[0]['n'] - 1) / (out[0]['t_end'] - out[0]['t_first'])
        log(f'  {label}, requests of {lens} new tokens: {decode} '
            f'{counts[decode][0]} launches, {per_step[decode]} per decode '
            f'step and {per_pass[decode]} per prefill pass; {prefill} '
            f'{counts[prefill][0]}, {per_step[prefill]} per step and '
            f'{per_pass[prefill]} per pass; (decode steps, prefill passes) '
            f'of the windows {windows}; {tps:.1f} tok/s and TTFT '
            f'{out[0]["ttft"]:.3f} s at {lens[0]} tokens')
        log(f'    {WGMMA}: {counts[WGMMA][0]} launches, {per_step[WGMMA]} '
            f'per decode step, {per_pass[WGMMA]} per prefill pass of the '
            f'{rows}-row bucket')
        if prompt is long_prompt:
            record(WGMMA, counts[WGMMA][0], per_step[WGMMA], per_pass[WGMMA])
            return out
        record(decode, counts[decode][0], per_step[decode], per_pass[decode])
        if width == 'int4' and not env:
            record(prefill, counts[prefill][0], per_step[prefill],
                   per_pass[prefill])
        return out

    def spec_requests(eng, inst, width, lens):
        """Speculative greedy bs1 requests (prompt [1], as bench.py) of
        ``lens`` new tokens, counters from 0, whose windows solve launches
        per pass: a verify round 160 GEMMs, all of them wgmma (M = 40), 32
        prefill attention and no decode attention; a decode step the gate
        hands back 160 / 32 as plain decode; no plain-version call."""
        eng.ecfg.speculative_k = SPEC_K
        eng._spec_cooloff, eng._spec_accept_ema = 0, None   # gate open
        decode = f'paged_decode_attention_write[{width}]'
        prefill = f'paged_prefill_attention[{width}]'
        want = {'spec_rounds': {'w4a16_gemm': 5 * nl, WGMMA: 5 * nl,
                                prefill: nl},
                'decode_steps': {'w4a16_gemm': 5 * nl, decode: nl}}
        K.reset_launch_counts()
        marks, out, stats = [mark(eng)], [], []
        for n_new in lens:
            before = dict(eng.stats)
            run(inst, [1], n_new, out)
            marks.append(mark(eng))
            stats.append({k: eng.stats[k] - before[k] for k in (
                'spec_rounds', 'spec_emitted', 'spec_fallbacks',
                'decode_steps')})
        counts = K.launch_counts(True)
        solved = launches_per_kind(marks)
        per, kinds, windows = solved
        check_route(counts, solved, want, f'{width} spec',
                    need=('spec_rounds',))
        log(f'  {width} spec bs1 requests of {lens} new tokens: per verify '
            f'round {({n: v for n, v in per["spec_rounds"].items() if v})}'
            f'; windows {windows} of {kinds}; per request {stats}')
        for name in (('w4a16_gemm', WGMMA) if width == 'bf16' else ()) \
                + (prefill,):
            ctx['kernels'].setdefault(name, {}).update(
                spec_launches=counts[name][0],
                launches_per_verify_round=per['spec_rounds'][name])
        return out, stats

    def spec_main(eng, inst):
        """The JAX bench's headline path: greedy bs1, k = 4, 256 new
        tokens from prompt [1], then the same request on plain rounds; the
        spec stream against one teacher-forced forward; sampled and
        top_k = 0 requests; 4 concurrent speculative requests."""
        out, stats = spec_requests(eng, inst, 'bf16', (256, 32))
        spec = out[0]
        eng.ecfg.speculative_k = 0
        plain = []
        run(inst, [1], 256, plain)
        plain = plain[0]
        eng.ecfg.speculative_k = SPEC_K
        tps = {k: (r['n'] - 1) / (r['t_end'] - r['t_first'])
               for k, r in (('spec', spec), ('plain', plain))}
        per_round = stats[0]['spec_emitted'] / max(stats[0]['spec_rounds'], 1)
        lg = teacher_forced_logits(torch, params, cfg, [1], spec['tokens'])
        top = lg.max(dim=-1).values
        tol = 0.01 * lg.abs().max(dim=-1).values
        idx = torch.arange(len(spec['tokens']), device='cuda')
        chosen = lg[idx, torch.tensor(spec['tokens'], device='cuda')]
        off = (chosen < top - tol).nonzero().flatten().tolist()
        if off:
            raise AssertionError(f'spec tokens at steps {off[:8]} are not '
                                 'within 1% of max|logit| of the teacher-'
                                 'forced argmax')
        top2 = lg.topk(2, dim=-1).values
        near = ((top2[:, 0] - top2[:, 1]) < tol).nonzero().flatten()
        upto = int(near[0]) if len(near) else len(spec['tokens'])
        same = next((i for i, (a, b) in enumerate(zip(spec['tokens'],
                                                      plain['tokens']))
                     if a != b), len(spec['tokens']))
        if same < upto:
            raise AssertionError(f'spec and plain streams part at step '
                                 f'{same}, before the first near-tie {upto}')
        log(f'  engine, bf16 KV pool, greedy bs1 [{card}]: speculative '
            f'(k={SPEC_K}) {tps["spec"]:.1f} tok/s, TTFT {spec["ttft"]:.3f} '
            f's, {per_round:.2f} tokens per verify round '
            f'({stats[0]["spec_rounds"]} rounds, {stats[0]["spec_fallbacks"]}'
            f' fallbacks, {stats[0]["decode_steps"]} decode steps); plain '
            f'rounds {tps["plain"]:.1f} tok/s, TTFT {plain["ttft"]:.3f} s; '
            f'speedup {tps["spec"] / tps["plain"]:.2f}x; every spec token '
            f'within 1% of max|logit| of the teacher-forced argmax; streams '
            f'agree for {same} steps (first near-tie at {upto})')
        result = dict(tok_s_spec=tps['spec'], tok_s_plain=tps['plain'],
                      ttft_spec_s=spec['ttft'], ttft_plain_s=plain['ttft'],
                      tokens_per_round=per_round,
                      spec_fallbacks=stats[0]['spec_fallbacks'],
                      agree_steps=same, first_near_tie=upto)
        # sampled: plain rounds once, speculative 'candidates' twice
        banned = max(set(spec['tokens']), key=spec['tokens'].count)
        sgen = GenerationConfig(
            max_new_tokens=64, top_k=40, top_p=0.9, temperature=0.8,
            repetition_penalty=1.1, min_new_tokens=8, bad_words=[banned],
            random_seed=1234, top_logprobs=5)
        # plain rounds twice, then speculative rounds twice with the gate
        # held open (sampled text is rarely drafted right, and a closed
        # gate hands rounds to plain decode)
        samp = []
        for k in (0, 0, SPEC_K, SPEC_K):
            eng.ecfg.speculative_k = k
            eng._spec_cooloff, eng._spec_accept_ema = 0, None
            eng.SPEC_MIN_ACCEPT = 0.0
            before = dict(eng.stats)
            try:
                run(inst, [1], 64, samp, gen=sgen)
            finally:
                eng.SPEC_MIN_ACCEPT = 1.15
            rounds = eng.stats['spec_rounds'] - before['spec_rounds']
            steps = eng.stats['decode_steps'] - before['decode_steps']
            if (rounds > 0) != bool(k) or (k and steps):
                raise AssertionError(f'sampled request, speculative_k={k}: '
                                     f'{rounds} verify rounds, {steps} '
                                     'decode steps')
        # a seed gives one stream on plain rounds (the decode GEMM sums its
        # split of K in a fixed order) and on verify rounds: tokens,
        # logprobs and top-5 planes
        for a, b, kind in ((0, 1, 'plain'), (2, 3, 'speculative')):
            for key in ('tokens', 'logprobs', 'top_logprobs'):
                if samp[a][key] != samp[b][key]:
                    raise AssertionError(f'two seeded {kind}-round sampled '
                                         f'runs differ in {key}')
        samp = samp[1:]
        in_tops = 0
        for r in samp:
            toks = r['tokens']
            if banned in toks:
                raise AssertionError(f'banned id {banned} emitted')
            if cfg.end_id in toks[:8]:
                raise AssertionError('EOS before min_new_tokens')
            if len(r['top_logprobs']) != len(toks) or any(
                    len(t) != 5 for t in r['top_logprobs']):
                raise AssertionError('top_logprobs: not 5 per token')
            for tok, lp, tops in zip(toks, r['logprobs'],
                                     r['top_logprobs']):
                if tok in tops:
                    in_tops += 1
                    if abs(lp - tops[tok]) > 1e-4:
                        raise AssertionError(f'logprob {lp} of {tok} is not '
                                             f'its own entry {tops[tok]}')
        n_all = sum(len(r['tokens']) for r in samp)
        full = []
        eng._spec_cooloff, eng._spec_accept_ema = 0, None
        before = eng.stats['spec_rounds']
        run(inst, [1], 16, full, gen=GenerationConfig(
            max_new_tokens=16, top_k=0, temperature=1.0, random_seed=7,
            ignore_eos=True))
        if eng.stats['spec_rounds'] == before:
            raise AssertionError("top_k=0 request: no 'full' verify round")
        log(f'  sampled (top_k 40, top_p 0.9, T 0.8, repetition 1.1, '
            f'min_new 8, bad word {banned}, top_logprobs 5): plain rounds '
            f'twice {len(samp[0]["tokens"])} tokens, spec twice '
            f'{len(samp[1]["tokens"])} tokens, each pair identical in '
            'tokens, logprobs and top-5 planes; no banned id, no '
            f'early EOS; {in_tops} of {n_all} chosen tokens among their 5 '
            'alternatives, each with its own logprob; a top_k=0 request '
            'rode full-vocabulary verify rounds')
        result['sampled_plain_runs_identical'] = True
        # 4 concurrent greedy speculative requests
        before = dict(eng.stats)
        results = [[] for _ in prompts]
        threads = [threading.Thread(target=run, args=(inst, p, 64, r))
                   for p, r in zip(prompts, results)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if not all(len(r) == 1 for r in results):
            raise AssertionError('concurrent spec requests failed')
        results = [r[0] for r in results]
        conc = (sum(r['n'] - 1 for r in results)
                / (max(r['t_end'] for r in results)
                   - min(r['t_first'] for r in results)))
        d = {k: eng.stats[k] - before[k]
             for k in ('spec_rounds', 'spec_emitted', 'decode_steps')}
        log(f'  4 concurrent speculative requests (prompts {lens}, 64 new '
            f'each): {conc:.1f} tok/s aggregate, TTFT '
            f'{[round(r["ttft"], 3) for r in results]} s, {d}')
        result.update(tok_s_4_concurrent_spec=conc, concurrent_stats=d)
        return result

    def agree_up_to_near_tie(prompt, ref, got, label):
        """``got`` equals ``ref`` (a greedy stream of ``prompt``), or parts
        from it first at a step whose top-2 logit gap in the teacher-forced
        forward of ``ref`` is below 1% of that step's max|logit| (the
        criterion of test_greedy_streams_match_jax_engine); after such a
        part the streams may differ.  Returns the steps that agree."""
        same = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b),
                    None)
        if same is None:
            return min(len(ref), len(got))
        lg = teacher_forced_logits(torch, params, cfg, prompt, ref)[same]
        top2 = lg.topk(2).values
        if not float(top2[0] - top2[1]) < 0.01 * float(lg.abs().max()):
            raise AssertionError(f'{label}: streams part at step {same} '
                                 'with no near-tie there')
        return same

    def prefix_hit(width, quant_policy, kv_scales, ref):
        """Cross-session prefix caching at full depth: a bs1 greedy leader
        of long_prompt (300 tokens, 32 new) and then a follower sharing it
        (8 new) on an engine with caching on.  The follower hits 256
        tokens (4 pages) and prefills 43 (300 - 256 - the last token,
        which is decoded) in one pass of the 64 bucket: its windows solve
        to one pass (160 GEMM, all wgmma, and 32 prefill attention), and
        the pass's shape comes from the prefill calls.  Both streams equal
        ``ref`` (the same request with caching off) up to near-ties."""
        from lmdeploy_tpu_torch.engine import step as S
        eng, inst = engine(quant_policy, kv_scales, prefix=True)
        real, shapes = S.prefill_chunks, []

        def recording(*a):
            shapes.append((tuple(a[4].shape), a[6].tolist()))
            return real(*a)
        S.prefill_chunks = recording
        try:
            K.reset_launch_counts()
            marks, out, hits, passes = [mark(eng)], [], [], []
            for n_new in (32, 8):
                before, n_shapes = eng.stats['prefix_hit_tokens'], len(shapes)
                run(inst, long_prompt, n_new, out)
                marks.append(mark(eng))
                hits.append(eng.stats['prefix_hit_tokens'] - before)
                passes.append(shapes[n_shapes:])
            counts = K.launch_counts(True)
            solved = launches_per_kind(marks)
        finally:
            S.prefill_chunks = real
        decode = f'paged_decode_attention_write[{width}]'
        prefill = f'paged_prefill_attention[{width}]'
        check_route(counts, solved,
                    {'decode_steps': {'w4a16_gemm': 5 * nl, decode: nl},
                     'prefill_passes': {'w4a16_gemm': 5 * nl, WGMMA: 5 * nl,
                                        prefill: nl}},
                    f'{width} prefix hit', need=('decode_steps',
                                                 'prefill_passes'))
        if hits != [0, 256] or passes != [[((1, 512), [299])],
                                          [((1, 64), [43])]]:
            raise AssertionError(f'{width} prefix hit: hits {hits}, prefill '
                                 f'passes (ids shape, lengths) {passes}')
        agree = [agree_up_to_near_tie(long_prompt, ref[:len(r['tokens'])],
                                      r['tokens'], f'{width} prefix hit')
                 for r in out]
        log(f'  {width} prefix caching, 300-token prompt [{card}]: leader '
            f'(32 new) hit {hits[0]} tokens, prefill {passes[0]}, TTFT '
            f'{out[0]["ttft"]:.3f} s; follower (8 new) hit {hits[1]} '
            f'tokens, prefill {passes[1]} (ids shape, lengths), TTFT '
            f'{out[1]["ttft"]:.3f} s; per prefill pass '
            f'{({n: v for n, v in solved[0]["prefill_passes"].items() if v})}'
            f'; streams agree with caching off for {agree} steps')
        return eng, inst, dict(hit_tokens=hits, prefill_passes=passes,
                               ttft_leader_s=out[0]['ttft'],
                               ttft_follower_s=out[1]['ttft'],
                               agree_steps=agree)

    def prompt_logits(eng, inst):
        """EngineInstance.decode of long_prompt: one pass of the 512
        bucket through the kernels (160 GEMM, all wgmma, 32 prefill
        attention), [300, 32000] within 5% of max|logit| and cosine >=
        0.999 of a teacher-forced forward; a request running alongside
        finishes with its stream alone."""
        prefill = 'paged_prefill_attention[bf16]'
        K.reset_launch_counts()
        t0 = time.monotonic()
        lg = inst.decode(long_prompt)
        dt = time.monotonic() - t0
        counts = K.launch_counts(True)
        launched = {n: c[0] for n, c in counts.items() if c[0]}
        want = {'w4a16_gemm': 5 * nl, WGMMA: 5 * nl, prefill: nl}
        if launched != want or any(c[1] for c in counts.values()):
            raise AssertionError(f'decode(): launches {launched}, want '
                                 f'{want}; plain calls {counts}')
        ref = teacher_forced_logits(torch, params, cfg, long_prompt[:1],
                                    long_prompt[1:] + [0])
        got = torch.from_numpy(lg).cuda()
        rel = float((got - ref).abs().max() / ref.abs().max())
        cos = float(torch.nn.functional.cosine_similarity(got, ref,
                                                          dim=-1).min())
        if lg.shape != (300, cfg.vocab_size) or not (rel <= 0.05
                                                     and cos >= 0.999):
            raise AssertionError(f'decode(): shape {lg.shape}, max err / '
                                 f'max|logit| {rel:.3e} (tol 0.05), min '
                                 f'cosine {cos:.6f} (tol 0.999)')
        alone, along = [], []
        run(inst, bs1_prompt, 64, alone)
        th = threading.Thread(target=run, args=(inst, bs1_prompt, 64,
                                                along))
        th.start()
        t_end = time.monotonic() + 60
        while not any(x is not None and x.generated > 0
                      for x in eng.slots) and time.monotonic() < t_end:
            time.sleep(0.002)
        inst.decode(long_prompt)
        mid = th.is_alive()
        th.join(timeout=600)
        if not (mid and along and along[0]['tokens'] == alone[0]['tokens']):
            raise AssertionError('a request running alongside decode() '
                                 'changed its stream or was not running')
        log(f'  prompt logits (EngineInstance.decode, 300 tokens) [{card}]: '
            f'shape {tuple(lg.shape)}, {dt:.3f} s, launches {launched}, max '
            f'err / max|logit| {rel:.3e}, min cosine {cos:.6f} against a '
            'teacher-forced forward; a 64-token request running alongside '
            'kept its stream')
        return dict(seconds=dt, max_rel_err=rel, min_cosine=cos)

    def front_door():
        """save_workspace writes a full-width 2-layer W4A16 workspace of
        InternLM-chat-7B's shape (the internlm-7b preset: vocabulary
        103168, attention biases, here zero) and AsyncEngine serves it on
        the card: 3 concurrent generate streams, an interactive second
        turn, and a request that the template's default stop word (<eoa>,
        id 103028) ends, made the greedy choice at one step by swapping
        its lm_head column with that of the token the stream first chose
        there."""
        import asyncio
        import tempfile
        from lmdeploy_tpu_torch.convert.workspace import save_workspace
        from lmdeploy_tpu_torch.serve.async_engine import AsyncEngine
        fcfg = dataclasses.replace(
            llama2_7b(num_layer=2), vocab_size=103168, attn_bias=True,
            max_position_embeddings=2048, model_name='internlm-chat-7b')
        stop = 103028
        fparams = random_packed_params(fcfg, 6, 'cuda')
        qkv = (fcfg.head_num + 2 * fcfg.kv_head_num) * fcfg.size_per_head
        fparams['layers'].update(
            bqkv=torch.zeros((2, qkv), dtype=torch.bfloat16, device='cuda'),
            bo=torch.zeros((2, fcfg.hidden_size), dtype=torch.bfloat16,
                           device='cuda'))
        with tempfile.TemporaryDirectory() as ws:
            t0 = time.monotonic()
            save_workspace(ws, fcfg, fparams, dataclasses.replace(
                ecfg, enable_prefix_caching=True))
            t_save = time.monotonic() - t0
            del fparams
            t0 = time.monotonic()
            ae = AsyncEngine(ws, device='cuda')
            t_load = time.monotonic() - t0
        try:
            eng = ae.engine
            if (eng.template_name, eng.default_stop_words) != (
                    'internlm-chat-7b', [stop]):
                raise AssertionError(f'template {eng.template_name}, stop '
                                     f'words {eng.default_stop_words}')

            async def gen(sid, msg, n, start=True, end=False):
                return [o async for o in ae.generate(
                    msg, sid, sequence_start=start, sequence_end=end,
                    request_output_len=n, top_k=1, ignore_eos=True)]

            async def traffic():
                three = await asyncio.gather(*[gen(i + 1, f'hello {i}', 32)
                                               for i in range(3)])
                return three, await gen(1, 'and more', 16, start=False)
            t0 = time.monotonic()
            three, second = asyncio.run(traffic())
            t_traffic = time.monotonic() - t0
            got = [(o[-1].finish_reason, o[-1].generate_token_len)
                   for o in three + [second]]
            hist = len(eng.seqs.get(1).token_ids)
            if got != [('length', 32)] * 3 + [('length', 16)] \
                    or hist != ae.steps['1']:
                raise AssertionError(f'front door: {got}, session 1 holds '
                                     f'{hist} tokens, steps {ae.steps}')
            probe = sum((o.token_ids for o in asyncio.run(
                gen(20, 'stop here', 16, end=True))), [])
            # the last step that first chose its token (a random-weight
            # stream may repeat one token from step 0 on)
            k = max(i for i in range(len(probe))
                    if probe[i] not in probe[:i])
            if stop in probe:
                raise AssertionError(f'the stop word in the probe {probe}')
            head = eng.params['lm_head']
            col = head[:, probe[k]].clone()
            head[:, probe[k]] = head[:, stop]
            head[:, stop] = col
            outs = asyncio.run(gen(21, 'stop here', 16, end=True))
            ids = sum((o.token_ids for o in outs), [])
            if (ids, outs[-1].finish_reason, outs[-1].generate_token_len) \
                    != (probe[:k], 'stop', k):
                raise AssertionError(f'stop word: {ids} '
                                     f'{outs[-1].finish_reason} against '
                                     f'{probe[:k]}')
        finally:
            ae.shutdown()
        log(f'  front door [{card}]: save_workspace {t_save:.1f} s, '
            f'AsyncEngine load {t_load:.1f} s, template '
            f'{eng.template_name} (stop {eng.default_stop_words}); 3 '
            f'concurrent streams and a second turn {got} in '
            f'{t_traffic:.2f} s (session 1 holds {hist} tokens); the stop '
            f'word ended a request after {k} tokens (finish "stop")')
        return dict(save_s=t_save, load_s=t_load, traffic_s=t_traffic,
                    stop_after=k)

    def no_host_sync(eng):
        """On a stopped engine with one slot installed: kernel launches of
        a verify round's parts, then one greedy and one sampled speculative
        dispatch under torch.cuda.set_sync_debug_mode('error') (any host
        sync raises), each followed by its single readback."""
        import queue as queue_mod
        from lmdeploy_tpu_torch.engine import step as S
        from lmdeploy_tpu_torch.messages import EngineRequest
        from lmdeploy_tpu_torch.models.llama import StepBatch, forward
        from lmdeploy_tpu_torch.ops import prng
        from lmdeploy_tpu_torch.ops.speculative import ngram_propose
        req = EngineRequest(session_id=next(sid), input_ids=bs1_prompt,
                            gen_config=GenerationConfig(
                                max_new_tokens=64, top_k=1, ignore_eos=True))
        eng._handle_batch([(req, queue_mod.Queue(), time.monotonic())])
        eng._flush_prefills()
        rounds, kp1 = 4, SPEC_K + 1
        eng._grow_pages(3 * rounds * kp1)
        st = eng.state
        run_ = st.active & ~st.finished
        pos = st.context_len[:, None] + torch.arange(
            kp1, dtype=torch.int32, device='cuda')[None]
        batch = StepBatch(
            ids=torch.zeros((ENGINE_SLOTS, kp1), dtype=torch.int32,
                            device='cuda'),
            positions=pos, valid=torch.zeros_like(pos, dtype=torch.bool),
            context_len=st.context_len, page_table=st.page_table)
        parts = {
            'verify forward': lambda: forward(
                params, eng.cache, batch, cfg, return_all_logits=True,
                logits_count=kp1),
            'greedy round': lambda: S.spec_decode_rounds(
                params, eng.cache, st, cfg, num_rounds=1, k_draft=SPEC_K,
                ngram=3, ngram_min=2, sampling='greedy'),
            'sampled round (candidates, both passes, top-5)':
                lambda: S.spec_decode_rounds(
                    params, eng.cache, st, cfg, num_rounds=1,
                    k_draft=SPEC_K, ngram=3, ngram_min=2,
                    sampling='candidates', topn=5, passes=(True, True)),
            'ngram_propose': lambda: ngram_propose(
                st.history, st.history_len, SPEC_K, 3, 2),
            'threefry split': lambda: prng.split(st.sampling.rng_key),
        }
        launches = {k: count_kernels(torch, fn) for k, fn in parts.items()}
        log(f'  kernel launches per part (running {run_.int().tolist()}): '
            f'{launches}')
        for sampling, topn, passes in (('greedy', 0, (False, False)),
                                       ('candidates', 5, (True, True))):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode('error')
            try:
                eng.state, packed = S.spec_decode_rounds(
                    params, eng.cache, eng.state, cfg, num_rounds=rounds,
                    k_draft=SPEC_K, ngram=3, ngram_min=2, sampling=sampling,
                    topn=topn, passes=passes)
            except RuntimeError as e:
                raise AssertionError(f'{sampling} spec dispatch synced with '
                                     f'the host: {e}') from e
            finally:
                torch.cuda.set_sync_debug_mode(0)
            arr = packed.cpu().numpy()      # the dispatch's one readback
            log(f'  host syncs inside a {sampling} speculative dispatch of '
                f'{rounds} rounds: none (sync debug mode "error"); emitted '
                f'{arr[:, 2 * kp1].sum(axis=0).tolist()}')
        return launches

    switches = ({'LMDEPLOY_TPU_FUSED_ATTN': '0'},
                {'LMDEPLOY_TPU_FUSED_ROPE': '1'})
    eng = None
    try:
        eng, inst = engine()
        log(f'  engine built in {time.monotonic() - t0:.1f} s')
        ctx['engine'] = main_traffic(eng, inst, 'bf16')
        if ctx.get('profile'):
            profile_bs1(torch, ctx, lambda out: run(inst, bs1_prompt, 64,
                                                    out), eng, passes_of)
        scales = {b: kv_scales_from_pool(torch, eng.cache, b) for b in (8, 4)}
        log(f'  int8 qparams from the bf16 run\'s K/V: k_scale '
            f'{[round(float(x), 5) for x in scales[8][0][:4]]}..., k_zp '
            f'{[round(float(x), 2) for x in scales[8][1][:4]]}...')
        ref_bf16 = short_bs1(eng, inst, 'bf16', {}, prompt=long_prompt)[0]
        for env in switches:
            short_bs1(eng, inst, 'bf16', env)
        ctx['engine_spec'] = spec_main(eng, inst)
        if ctx.get('profile'):
            profile_bs1(torch, ctx, lambda out: run(inst, [1], 64, out), eng,
                        passes_of, 'bf16_spec')
        eng.shutdown()
        ctx['engine_spec']['launches_by_part'] = no_host_sync(eng)
        del eng, inst
        eng, inst, hit = prefix_hit('bf16', 0, None, ref_bf16['tokens'])
        ctx['engine_prefix'] = {'bf16': hit}
        ctx['prompt_logits'] = prompt_logits(eng, inst)
        eng.shutdown()
        del eng, inst
        eng, inst = engine(4, scales[8])
        ctx['engine_int8'] = main_traffic(eng, inst, 'int8')
        if ctx.get('profile'):
            profile_bs1(torch, ctx, lambda out: run(inst, bs1_prompt, 64,
                                                    out), eng, passes_of,
                        'int8')
        for env in switches:
            short_bs1(eng, inst, 'int8', env)
        spec_requests(eng, inst, 'int8', (32, 8))
        eng.ecfg.speculative_k = 0
        ref_int8 = []
        run(inst, long_prompt, 32, ref_int8)
        eng.shutdown()
        del eng, inst
        eng, inst, ctx['engine_prefix']['int8'] = prefix_hit(
            'int8', 4, scales[8], ref_int8[0]['tokens'])
        eng.shutdown()
        del eng, inst
        eng, inst = engine(8, scales[4])
        for env in ({},) + switches:
            short_bs1(eng, inst, 'int4', env)
        eng.shutdown()
        ctx['front_door'] = front_door()
    finally:
        passes_of.close()
        if eng is not None:
            eng.shutdown()
    del params
    torch.cuda.empty_cache()


DOORS_ROUTER_WORKER = '''
import sys
import torch
from lmdeploy_tpu_torch import build_engine
from lmdeploy_tpu_torch.config import EngineConfig
from lmdeploy_tpu_torch.messages import GenerationConfig
from lmdeploy_tpu_torch.serve.router import serve_engine
import json
ws, device, port = sys.argv[1], sys.argv[2], int(sys.argv[3])
ecfg = dict(json.loads(sys.argv[4]))
ecfg['prefill_buckets'] = tuple(ecfg['prefill_buckets'])
engine = build_engine(ws, engine_config=EngineConfig(**ecfg), device=device)
engine.create_instance().infer(-99, [1, 2, 3], gen_config=GenerationConfig(
    max_new_tokens=2, top_k=1, ignore_eos=True), sequence_end=True)
print('READY', flush=True)
serve_engine(engine, host='127.0.0.1', port=port)
'''


def awq_pack(q):
    """uint8 values 0..15 [..., N] -> AWQ int32 words [..., N/8] (nibble
    slot s holds logical column AWQ_ORDER[s])."""
    from lmdeploy_tpu_torch.convert.awq import AWQ_ORDER
    q = np.asarray(q).astype(np.uint32).reshape(*q.shape[:-1], -1, 8)
    words = np.zeros(q.shape[:-1], np.uint32)
    for slot, col in enumerate(AWQ_ORDER):
        words |= q[..., col] << np.uint32(4 * slot)
    return words.view(np.int32)


def write_hf_checkpoint(torch, path, cfg, seed):
    """An HF llama directory: config.json and bf16 normal(0, 0.02)
    weights (norms 1) from a seeded CPU generator, over two
    ``model-0000x-of-00002.safetensors`` shards.  Returns its bytes."""
    from lmdeploy_tpu_torch.convert.workspace import write_safetensors
    gen = torch.Generator().manual_seed(seed)
    d, dh, h, kh = (cfg.hidden_size, cfg.size_per_head, cfg.head_num,
                    cfg.kv_head_num)
    shapes = {'model.embed_tokens.weight': (cfg.vocab_size, d),
              'lm_head.weight': (cfg.vocab_size, d),
              'model.norm.weight': (d,)}
    for i in range(cfg.num_layer):
        p = f'model.layers.{i}'
        shapes.update({f'{p}.self_attn.q_proj.weight': (h * dh, d),
                       f'{p}.self_attn.k_proj.weight': (kh * dh, d),
                       f'{p}.self_attn.v_proj.weight': (kh * dh, d),
                       f'{p}.self_attn.o_proj.weight': (d, h * dh),
                       f'{p}.mlp.gate_proj.weight': (cfg.inter_size, d),
                       f'{p}.mlp.up_proj.weight': (cfg.inter_size, d),
                       f'{p}.mlp.down_proj.weight': (d, cfg.inter_size),
                       f'{p}.input_layernorm.weight': (d,),
                       f'{p}.post_attention_layernorm.weight': (d,)})
    os.makedirs(path)
    names = sorted(shapes)
    shards = (names[:len(names) // 2], names[len(names) // 2:])
    for n, part in enumerate(shards):
        tensors = {k: (torch.ones(shapes[k]) if k.endswith('norm.weight')
                       else torch.randn(shapes[k], generator=gen) * 0.02
                       ).to(torch.bfloat16) for k in part}
        write_safetensors(os.path.join(
            path, f'model-0000{n + 1}-of-00002.safetensors'), tensors)
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump({'architectures': ['LlamaForCausalLM'],
                   'num_attention_heads': h, 'num_key_value_heads': kh,
                   'hidden_size': d, 'intermediate_size': cfg.inter_size,
                   'num_hidden_layers': cfg.num_layer,
                   'vocab_size': cfg.vocab_size, 'rms_norm_eps': 1e-5,
                   'max_position_embeddings': cfg.max_position_embeddings,
                   'bos_token_id': 1, 'eos_token_id': 2,
                   'torch_dtype': 'bfloat16'}, f)
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def write_awq_checkpoint(torch, ws, path, cfg):
    """An AWQ directory holding the workspace ``ws``'s own quantisation:
    per linear qweight / qzeros as AWQ int32 words and fp16 scales (a
    bf16 scale in fp16's normal range is exact in fp16), the dense
    tensors in bf16, and the HF config."""
    from lmdeploy_tpu_torch.convert.workspace import (read_safetensors,
                                                      write_safetensors)
    from lmdeploy_tpu_torch.ops.linear import unpack_int4
    flat = read_safetensors(os.path.join(ws, 'weights.safetensors'))
    h, kh, dh = cfg.head_num, cfg.kv_head_num, cfg.size_per_head
    v = cfg.vocab_size
    sd = {'model.embed_tokens.weight': flat['tok_embedding'][:v],
          'lm_head.weight': flat['lm_head'].T[:v].contiguous(),
          'model.norm.weight': flat['norm']}
    splits = {'wqkv': (('self_attn.q_proj', 0, h * dh),
                       ('self_attn.k_proj', h * dh, (h + kh) * dh),
                       ('self_attn.v_proj', (h + kh) * dh, (h + 2 * kh) * dh)),
              'wo': (('self_attn.o_proj', 0, None),),
              'w1': (('mlp.gate_proj', 0, None),),
              'w3': (('mlp.up_proj', 0, None),),
              'w2': (('mlp.down_proj', 0, None),)}
    for name, parts in splits.items():
        q = unpack_int4(flat[f'layers/{name}.packed'].numpy())
        z = flat[f'layers/{name}.zeros'].float().numpy().astype(np.uint8)
        s = flat[f'layers/{name}.scales'].float()
        for i in range(cfg.num_layer):
            for hf_name, a, b in parts:
                p = f'model.layers.{i}.{hf_name}'
                sd[f'{p}.qweight'] = torch.from_numpy(awq_pack(q[i][:, a:b]))
                sd[f'{p}.qzeros'] = torch.from_numpy(awq_pack(z[i][:, a:b]))
                sd[f'{p}.scales'] = s[i][:, a:b].half().contiguous()
    for i in range(cfg.num_layer):
        p = f'model.layers.{i}'
        sd[f'{p}.input_layernorm.weight'] = flat['layers/attn_norm'][i]
        sd[f'{p}.post_attention_layernorm.weight'] = \
            flat['layers/ffn_norm'][i]
    os.makedirs(path)
    write_safetensors(os.path.join(path, 'model.safetensors'), sd)


def same_workspace(torch, a, b):
    """(config payloads equal, names of tensors whose bits differ)."""
    from lmdeploy_tpu_torch.convert.workspace import read_safetensors
    cfgs = []
    for ws in (a, b):
        with open(os.path.join(ws, 'config.json')) as f:
            cfgs.append(json.load(f))
    fa = read_safetensors(os.path.join(a, 'weights.safetensors'))
    fb = read_safetensors(os.path.join(b, 'weights.safetensors'))
    differ = sorted(set(fa) ^ set(fb)) + [
        k for k in sorted(set(fa) & set(fb))
        if fa[k].dtype != fb[k].dtype or fa[k].shape != fb[k].shape
        or not torch.equal(fa[k].view(torch.uint8) if fa[k].dim() else
                           fa[k], fb[k].view(torch.uint8) if fb[k].dim()
                           else fb[k])]
    return cfgs[0] == cfgs[1], differ, len(fa)


def phase_doors(torch, ctx):
    """The way in and out of the port at Llama-2-7B width, 2 layers (see
    :func:`doors`)."""
    doors(torch, ctx, llama2_7b(num_layer=2), 'cuda')


def doors(torch, ctx, cfg, device, lens=(16, 100, 300, 500), n_new=32):
    """An HF checkpoint of ``cfg``'s width, written here, goes through
    every door of the port on ``device``: ``convert_hf --quantize``, an
    engine on the workspace (launches per decode step and per prefill
    pass), an AWQ export of that quantisation through ``convert_awq``
    (bit-equal workspace, identical stream), ``build_engine`` on the HF
    directory (bf16 dense weights; prompt logits against the CPU's), the
    OpenAI server's core over ``AsyncEngine`` (every route, no aiohttp),
    the CLI (``chat`` in a subprocess, ``decode``'s perplexity), and the
    router with a peer process on the same card.  Everything lives in a
    temporary directory that is removed at the end."""
    import asyncio
    import shutil
    import tempfile

    from lmdeploy_tpu_torch import build_engine
    from lmdeploy_tpu_torch.cli import decode as cli_decode
    from lmdeploy_tpu_torch.config import EngineConfig
    from lmdeploy_tpu_torch.convert.awq import convert_awq
    from lmdeploy_tpu_torch.convert.converter import convert_hf
    from lmdeploy_tpu_torch.messages import (EngineRequest, GenerationConfig,
                                             ResponseType)
    from lmdeploy_tpu_torch.ops import cuda as K
    from lmdeploy_tpu_torch.ops.cuda.quant_matmul import WGMMA
    from lmdeploy_tpu_torch.pytorch.decode import perplexity
    from lmdeploy_tpu_torch.serve.async_engine import AsyncEngine
    from lmdeploy_tpu_torch.serve.openai import api_server as core
    from lmdeploy_tpu_torch.serve.router import RouterEngine
    on_card = device == 'cuda'
    card = ctx.get('card', '?')
    nl, name = cfg.num_layer, 'llama2'
    ecfg = dict(max_batch_size=8, session_len=2048, page_size=64,
                num_pages=88, max_context_token_num=512,
                prefill_buckets=(64, 512), step_length=16,
                enable_prefix_caching=False)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n in lens]
    long_prompt = prompts[2]
    sid = iter(range(1, 10 ** 6))
    times, out = {}, {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(key, fn, *a, **kw):
        t0 = time.monotonic()
        res = fn(*a, **kw)
        sync()
        times[key] = time.monotonic() - t0
        return res

    def greedy(n):
        return GenerationConfig(max_new_tokens=n, top_k=1, ignore_eos=True)

    def stream(inst, prompt, n, session=None, **kw):
        """One greedy request: (tokens, seconds to the first token, tok/s
        after it)."""
        t0, first = time.monotonic(), None
        for last in inst.stream_infer(session or next(sid), prompt,
                                      greedy(n), **kw):
            if last.num_generated and first is None:
                first = time.monotonic()
        if last.status != ResponseType.FINISH or last.num_generated != n:
            raise AssertionError(f'request of {len(prompt)} tokens: '
                                 f'{last.num_generated} tokens, '
                                 f'{last.status}')
        t1 = time.monotonic()
        return (list(last.token_ids), (first or t1) - t0,
                (n - 1) / max(t1 - (first or t1), 1e-9))

    def mark(eng):
        return ({n: c[0] for n, c in K.launch_counts(True).items()},
                {'decode_steps': eng.stats['decode_steps'], 'spec_rounds': 0,
                 'prefill_passes': eng.stats['prefill_passes']})

    tmp = tempfile.mkdtemp(prefix='lmdeploy-doors-')
    hf, ws_q, awq, ws_awq = (os.path.join(tmp, n) for n in (
        'llama2-hf', 'ws-int4', 'llama2-awq', 'ws-awq'))
    engines, proc = [], None
    try:
        # 1. an HF checkpoint, 2. convert_hf --quantize
        size = timed('hf_write_s', write_hf_checkpoint, torch, hf, cfg, 7)
        timed('convert_s', convert_hf, hf, ws_q, name, quantize=True,
              group_size=cfg.group_size or 128)
        eng = timed('load_int4_s', build_engine, ws_q,
                    engine_config=EngineConfig(**ecfg), device=device)
        engines.append(eng)
        inst = eng.create_instance()
        K.reset_launch_counts()
        marks = [mark(eng)]
        results = [None] * len(prompts)

        def worker(i):
            results[i] = stream(inst, prompts[i], n_new)
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(prompts))]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(r is None for r in results):
            raise AssertionError('doors: concurrent requests failed')
        conc_s = time.monotonic() - t0
        marks.append(mark(eng))
        bs1 = []
        for n in (n_new, 8):
            bs1.append(stream(inst, long_prompt, n))
            marks.append(mark(eng))
        counts = K.launch_counts(True)
        out['int4'] = dict(ttft_s=[r[1] for r in results],
                           tok_s_4_concurrent=len(prompts) * (n_new - 1)
                           / conc_s, ttft_bs1_s=bs1[0][1],
                           tok_s_bs1=bs1[0][2])
        if on_card:
            decode, prefill = ('paged_decode_attention_write[bf16]',
                               'paged_prefill_attention[bf16]')
            check_route(counts, launches_per_kind(marks, skip=(WGMMA,)),
                        {'decode_steps': {'w4a16_gemm': 5 * nl, decode: nl},
                         'prefill_passes': {'w4a16_gemm': 5 * nl,
                                            prefill: nl}},
                        'doors int4 engine',
                        need=('decode_steps', 'prefill_passes'))
            # the two bs1 windows: one pass of the 512 bucket each
            check_route(counts, launches_per_kind(marks[1:]),
                        {'decode_steps': {'w4a16_gemm': 5 * nl, decode: nl},
                         'prefill_passes': {'w4a16_gemm': 5 * nl,
                                            WGMMA: 5 * nl, prefill: nl}},
                        'doors int4 engine, 300-token prompts',
                        need=('decode_steps', 'prefill_passes'))
            out['int4']['launches'] = {n: c[0] for n, c in counts.items()
                                       if c[0]}
            for n in ('w4a16_gemm', decode, prefill):
                ctx['kernels'].setdefault(n, {})['doors_launches'] = \
                    counts[n][0]
        log(f'  doors [{card}]: HF checkpoint ({size / 2 ** 30:.2f} GiB, 2 '
            f'shards) written in {times["hf_write_s"]:.1f} s, convert_hf '
            f'--quantize {times["convert_s"]:.1f} s, engine load '
            f'{times["load_int4_s"]:.1f} s; 4 concurrent requests (prompts '
            f'{list(lens)}, {n_new} new): TTFT '
            f'{[round(r[1], 3) for r in results]} s, '
            f'{out["int4"]["tok_s_4_concurrent"]:.1f} tok/s; bs1 '
            f'{len(long_prompt)}-token prompt: TTFT {bs1[0][1]:.3f} s, '
            f'{bs1[0][2]:.1f} tok/s; launches {out["int4"].get("launches")}')

        # 3. AWQ: the workspace's own quantisation, exported and converted
        timed('awq_write_s', write_awq_checkpoint, torch, ws_q, awq, cfg)
        shutil.copy(os.path.join(hf, 'config.json'), awq)
        timed('awq_convert_s', convert_awq, awq, ws_awq, name,
              cfg.group_size or 128)
        same_cfg, differ, n_tensors = same_workspace(torch, ws_q, ws_awq)
        if not same_cfg or differ:
            raise AssertionError(f'AWQ workspace: config equal {same_cfg}, '
                                 f'tensors that differ {differ}')
        eng_awq = timed('load_awq_s', build_engine, ws_awq,
                        engine_config=EngineConfig(**ecfg), device=device)
        engines.append(eng_awq)
        int4_stream = stream(inst, prompts[0], n_new)[0]
        awq_stream, awq_ttft, awq_tps = stream(eng_awq.create_instance(),
                                               prompts[0], n_new)
        eng_awq.shutdown()
        if awq_stream != int4_stream:
            raise AssertionError(f'AWQ stream {awq_stream} != {int4_stream}')
        out['awq'] = dict(ttft_s=awq_ttft, tok_s_bs1=awq_tps)
        log(f'  AWQ [{card}]: export {times["awq_write_s"]:.1f} s, '
            f'convert_awq {times["awq_convert_s"]:.1f} s, load '
            f'{times["load_awq_s"]:.1f} s; {n_tensors} tensors bit-equal to '
            f'the --quantize workspace, config equal, a greedy bs1 stream '
            f'of {n_new} identical (TTFT {awq_ttft:.3f} s, {awq_tps:.1f} '
            f'tok/s)')

        # 4. build_engine on the HF directory: bf16 dense weights
        eng_hf = timed('load_hf_s', build_engine, hf,
                       engine_config=EngineConfig(**ecfg), device=device)
        engines.append(eng_hf)
        if eng_hf.params['layers']['wqkv'].dtype != torch.bfloat16:
            raise AssertionError('HF engine: weights not bf16')
        hf_inst = eng_hf.create_instance()
        t0 = time.monotonic()
        lg = hf_inst.decode(long_prompt)
        times['hf_decode_s'] = time.monotonic() - t0
        hf_stream = stream(hf_inst, prompts[0], n_new)
        eng_hf.shutdown()
        cpu = build_engine(hf, engine_config=EngineConfig(**dict(
            ecfg, max_batch_size=1, session_len=512)), device='cpu')
        try:
            ref = cpu.create_instance().decode(long_prompt)
        finally:
            cpu.shutdown()
        lg, ref = torch.from_numpy(lg), torch.from_numpy(ref)
        rel = float((lg - ref).abs().max() / ref.abs().max())
        cos = float(torch.nn.functional.cosine_similarity(lg, ref,
                                                          dim=-1).min())
        if lg.shape != (len(long_prompt), cfg.vocab_size) or not (
                rel <= 0.05 and cos >= 0.999):
            raise AssertionError(f'HF engine prompt logits: shape '
                                 f'{tuple(lg.shape)}, max err / max|logit| '
                                 f'{rel:.3e} (tol 0.05), min cosine '
                                 f'{cos:.6f} (tol 0.999)')
        out['hf'] = dict(load_s=times['load_hf_s'],
                         decode_s=times['hf_decode_s'], max_rel_err=rel,
                         min_cosine=cos, ttft_s=hf_stream[1],
                         tok_s_bs1=hf_stream[2])
        log(f'  HF directory engine, bf16 weights [{card}]: load '
            f'{times["load_hf_s"]:.1f} s; prompt logits of '
            f'{len(long_prompt)} tokens in {times["hf_decode_s"]:.3f} s, '
            f'max err / max|logit| {rel:.3e}, min cosine {cos:.6f} against '
            f'the CPU; bs1 TTFT {hf_stream[1]:.3f} s, {hf_stream[2]:.1f} '
            f'tok/s')

        # 5. the server's core over AsyncEngine, without aiohttp
        ae = timed('load_async_s', AsyncEngine, ws_q, device=device,
                   engine_config=EngineConfig(**ecfg))
        engines.append(ae)
        latency = {}

        async def call(method, path, body=None, session='s'):
            t0 = time.monotonic()
            status, payload = await core.ROUTES[method, path](
                ae, body, '127.0.0.1', {'X-Session-Id': session})
            if not isinstance(payload, (dict, str)):
                payload = [c async for c in payload]
            latency.setdefault(path, []).append(time.monotonic() - t0)
            return status, payload

        def frames(chunks):
            return [json.loads(c[len('data: '):]) for c in chunks
                    if c.startswith('data: {')]

        async def drive():
            chat = {'model': name, 'messages': 'hello there',
                    'max_tokens': 16, 'top_k': 1, 'ignore_eos': True,
                    'renew_session': True}
            r = {'models': await call('GET', '/v1/models'),
                 'chat': await call('POST', '/v1/chat/completions', chat),
                 'stream': await call('POST', '/v1/chat/completions',
                                      dict(chat, stream=True)),
                 'logprobs': await call('POST', '/v1/chat/completions',
                                        dict(chat, logprobs=True,
                                             top_logprobs=5)),
                 'echo': await call('POST', '/v1/completions', {
                     'model': name, 'prompt': 'once upon a time',
                     'max_tokens': 4, 'top_k': 1, 'ignore_eos': True,
                     'echo': True, 'logprobs': 1}),
                 'embeddings': await call('POST', '/v1/embeddings',
                                          {'input': 'abc'}),
                 'turn1': await call('POST', '/generate', {
                     'prompt': 'first turn', 'instance_id': 4242,
                     'request_output_len': 8, 'top_k': 1,
                     'ignore_eos': True}),
                 'turn2': await call('POST', '/generate', {
                     'prompt': 'second turn', 'instance_id': 4242,
                     'sequence_start': False, 'sequence_end': True,
                     'request_output_len': 8, 'top_k': 1,
                     'ignore_eos': True}),
                 'metrics': await call('GET', '/metrics'),
                 '404': await call('POST', '/v1/chat/completions',
                                   dict(chat, model='nope')),
                 '400': await call('POST', '/v1/chat/completions',
                                   {'model': name, 'messages': 5})}
            return r
        r = asyncio.run(drive())
        statuses = {k: v[0] for k, v in r.items()}
        want_status = dict.fromkeys(r, 200)
        want_status.update({'404': 404, '400': 400})
        text = r['chat'][1]['choices'][0]['message']['content']
        streamed = ''.join(f['choices'][0]['delta'].get('content') or ''
                           for f in frames(r['stream'][1]))
        content = r['logprobs'][1]['choices'][0]['logprobs']['content']
        echo = r['echo'][1]['choices'][0]['logprobs']
        n_echo = len(ae.tokenizer.encode('once upon a time')) + 4
        gen_tokens = float(next(
            ln.split()[1] for ln in r['metrics'][1].splitlines()
            if ln.startswith('lmdeploy_generated_tokens_total ')))
        checks = {
            'statuses': statuses == want_status,
            'model id': r['models'][1]['data'][0]['id'] == name,
            'stream text == text': streamed == text and text != '',
            'stream ends [DONE]': r['stream'][1][-1] == 'data: [DONE]\n\n',
            'top-5 logprobs': len(content) == 16 and all(
                len(e['top_logprobs']) == 5 and e['logprob'] <= 1e-5
                for e in content),
            'echo prompt logprobs': len(echo['tokens']) == n_echo
            and echo['token_logprobs'][0] is None and all(
                x <= 1e-5 for x in echo['token_logprobs'][1:]),
            'embeddings': isinstance(
                r['embeddings'][1]['data'][0]['embedding'], list),
            'two turns': r['turn1'][1]['tokens'] == 8
            and r['turn2'][1]['tokens'] == 8,
            'metrics': gen_tokens > 0,
            '404/400 codes': r['404'][1]['code'] == 404
            and r['400'][1]['code'] == 400}
        ae.shutdown()
        if not all(checks.values()):
            raise AssertionError(f'server core: {checks}; statuses '
                                 f'{statuses}')
        out['server_ms'] = {p: [round(x * 1e3, 1) for x in v]
                            for p, v in latency.items()}
        log(f'  OpenAI server core over AsyncEngine [{card}] (no aiohttp): '
            f'load {times["load_async_s"]:.1f} s; every check passed '
            f'({", ".join(checks)}); latency ms by route '
            f'{out["server_ms"]}')

        # 6. the CLI: chat in a subprocess, decode's perplexity
        t0 = time.monotonic()
        res = subprocess.run(
            [sys.executable, '-m', 'lmdeploy_tpu_torch.cli.main', 'chat',
             ws_q, '--max-new-tokens', '16', '--top-k', '1', '--device',
             device], input='hello\nhow are you\nexit\n', text=True,
            capture_output=True, timeout=300, cwd=os.path.dirname(
                os.path.abspath(__file__)))
        times['cli_chat_s'] = time.monotonic() - t0
        replies = res.stdout.split('double enter to end input >>> ')[1:]
        if res.returncode != 0 or len(replies) != 3 or not all(
                x.strip() for x in replies[:2]):
            raise AssertionError(f'cli chat: rc {res.returncode}, replies '
                                 f'{replies}\n{res.stderr[-2000:]}')
        texts = ['the quick brown fox', 'lmdeploy on one card']
        t0 = time.monotonic()
        all_logits = cli_decode.main(ws_q, texts, device=device,
                                     engine_config=EngineConfig(**ecfg))
        times['cli_decode_s'] = time.monotonic() - t0
        ids = [eng.tokenizer.encode(t) for t in texts]
        ppl_cli = perplexity(all_logits, ids)
        direct = np.zeros_like(all_logits)
        for i, x in enumerate(ids):
            direct[i, :len(x)] = inst.decode(x)
        ppl = perplexity(direct, ids)
        if not abs(ppl_cli - ppl) <= 1e-4 * ppl:
            raise AssertionError(f'cli decode ppl {ppl_cli} against '
                                 f'{ppl} in-process')
        out['cli'] = dict(chat_s=times['cli_chat_s'],
                          decode_s=times['cli_decode_s'], ppl=ppl)
        log(f'  CLI [{card}]: chat subprocess (2 turns, exit) '
            f'{times["cli_chat_s"]:.1f} s, rc 0; decode ppl {ppl_cli:.6f} '
            f'against {ppl:.6f} in-process ({times["cli_decode_s"]:.1f} s)')

        # 7. the router: a peer process on the same card
        with socket.socket() as s:
            s.bind(('127.0.0.1', 0))
            port = s.getsockname()[1]
        t0 = time.monotonic()
        proc = subprocess.Popen(
            [sys.executable, '-c', DOORS_ROUTER_WORKER, ws_q, device,
             str(port), json.dumps(ecfg)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        seen = []
        while True:
            line = proc.stdout.readline()
            seen.append(line)
            if 'READY' in line:
                break
            if not line or proc.poll() is not None:
                raise AssertionError('router worker failed:\n'
                                     + ''.join(seen[-40:]))
        times['peer_start_s'] = time.monotonic() - t0
        router = RouterEngine(eng, [f'127.0.0.1:{port}'])
        before = (eng.stats['requests'], router.remotes[0].metrics().get(
            'requests', 0))
        sessions = list(range(9001, 9005))
        # submitted one after another (each counts as in flight at once),
        # so least-loaded routing alternates local, peer, local, peer
        t0 = time.monotonic()
        queues = {s: router.submit(EngineRequest(
            session_id=s, input_ids=prompts[0], gen_config=greedy(n_new)))
            for s in sessions}
        got = {}
        for s, q in queues.items():
            while True:
                o = q.get(timeout=300)
                if o.finished:
                    break
            if o.status != ResponseType.FINISH:
                raise AssertionError(f'router session {s}: {o.status}')
            got[s] = (list(o.token_ids),)
        times['router_s'] = time.monotonic() - t0
        where = {s: router._sticky.get(s) for s in sessions}
        n_remote = sum(1 for w in where.values() if w == 1)
        after = (eng.stats['requests'], router.remotes[0].metrics().get(
            'requests', 0))
        remote_s = next((s for s in sessions if where[s] == 1), None)
        if remote_s is not None:
            stream(router.create_instance(), [5, 6, 7], 8, session=remote_s,
                   sequence_start=False, sequence_end=True)
        final = router.remotes[0].metrics().get('requests', 0)
        ok = (len(got) == 4
              and all(v[0] == int4_stream for v in got.values())
              and 0 < n_remote < 4
              and after[0] - before[0] == 4 - n_remote
              and after[1] - before[1] == n_remote
              and final - after[1] == 1 and remote_s not in router._sticky)
        router.remotes[0].close()
        if not ok:
            same = [v[0] == int4_stream for v in got.values()]
            raise AssertionError(f'router: routed {where}, local / remote '
                                 f'requests {before} -> {after} -> {final}, '
                                 f'streams equal the local one: {same}')
        out['router'] = dict(peer_start_s=times['peer_start_s'],
                             seconds=times['router_s'], routed=where)
        log(f'  router [{card}]: peer process ready in '
            f'{times["peer_start_s"]:.1f} s; 4 sessions routed {where} '
            f'(0 local, 1 the peer), every stream equal to the local '
            f'engine\'s, in {times["router_s"]:.2f} s; a continued session '
            f'stayed on the peer')
    finally:
        if proc is not None:
            proc.kill()
            proc.wait(timeout=60)
        for e in engines:
            e.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    out['times_s'] = times
    ctx['doors'] = out


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
            spec_launches=k.get('spec_launches'),
            doors_launches=k.get('doors_launches'),
            launches_per_verify_round=k.get('launches_per_verify_round'),
            max_abs_err=k.get('max_abs_err'), tolerance=k.get('tolerance'),
            ms=k.get('ms'), kernel_ms=k.get('ms'), plain_ms=k.get('plain_ms'),
            bound_ms=k.get('bound_ms'), bound_by=k.get('bound_by'),
            library_ms=k.get('library_ms'), library=k.get('library'),
            shape=k.get('shape'), at_bs1=k.get('m1') or k.get('b1'),
            chunk64_over300=k.get('chunk64_over300'),
            layer_by_m=k.get('layer_by_m'), crossover=k.get('crossover'),
            cases=k.get('cases'), verify=k.get('verify'),
            verify_m40=k.get('verify_m40'),
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
