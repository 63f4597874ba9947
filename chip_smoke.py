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
               decode (all 8 batch slots: GEMM M=8, which takes the wgmma
               routes as every M at group 128 does, attention B=8); every
               timing cycles enough layers that the timed weights or K/V
               (at least 100 MB between two reads of a layer: hbm_layers)
               come from HBM, not the 50 MB L2; the GEMM
               at every GEMM_ROWS M on both routes (splitk and tiles), each
               line naming the route
               gemm_route picks, with its split plan, and timing the parent
               (--parent TREE: that checkout's kernel 1 through its own
               wrapper and build), torch.matmul and the bound beside it;
               decode attention (kernels 2, 4, 5) per mode and width over
               DECODE_CASES (B = 8 with a masked slot, bs1 at 80 / 512 /
               2048 (80 and 2048 on the bf16 pool only), a bs1 request
               among masked slots, G = 8), each called
               twice (the same bits), with the parent's kernel (--parent)
               and SDPA; each wrapper's host us a call beside the parent's
               (eager calls, no synchronise); the
               kernels line has one entry per GEMM route (splitk with the
               launches of the verify's M=40, tiles with those of the 512
               bucket); prefill attention also at the verify's T=5 (B=8 all live, one live slot with 7 padding
               rows, B=1 at ctx 80 / 512 / 2048) and at the route boundary
               T = 8 / 9 with G = 8; every kernel-3 line names its route
               (split, wgmma or mma), and times the parent (this tree's
               route mma, or with --parent TREE that checkout's kernel 3
               through its own wrapper and build) and one SDPA call over
               the live slots beside it; and kernels 1-3 at one
               tp = 2 rank's shapes (the GEMM at K x N 4096 x 6144, 2048 x
               4096, 4096 x 5632, 5632 x 4096 and M = 1 / 8 / 40 / 512,
               attention at H = KH = 16); kernels 1 and 2 at the pp = 2
               ring's microbatch (the kernels line's pp2 key: the GEMM at
               M = 4 and 2 over one layer and one tp = 2 rank's, decode
               attention at B = 4, H = KH = 32 / 16, and B = 2, 16); and
               the GEMM over the rest of its TPU function's domain: groups
               64, 32, 256, 48 and 16 over one Llama-2-7B layer at M = 1 /
               8 / 40 / 64 / 512 and group 128 over Qwen-14B's projections
               at M = 1 / 8 / 40 / 512 (the kernels line's groups and
               qwen14b keys).  With --parent every GEMM case at a group
               that is a multiple of 64 must give the parent's bits
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
               0 / 32 of prefill attention, all of it on route wgmma by
               the route counters, and the GEMM's 160 a pass on the bucket's
               routes (the 512 bucket: all tiles) and 160 a decode step on
               the routes gemm_route picks at M = 8 (tiles for wqkv, w1,
               w3; splitk for wo, w2).  Then
               speculative decoding
               (k=4, n-gram 3 down to 2) on the bf16 engine: greedy bs1 of
               256 tokens from prompt [1] (bench.py's headline path) and
               one of 32, whose windows solve 160 / 160 / 32 / 0 launches
               per verify round (GEMM / its wgmma regime / prefill / decode
               attention), prefill attention's 32 all on route split and the
               GEMM's 160 on the routes gemm_route picks at M = 40 (route
               counters: splitk for wo and w2, tiles for wqkv, w1, w3); the
               same 256-token request on plain rounds; the
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
               engine and a peer process on the same card.  The checkpoint
               also goes through the converter's command line at
               --group-size 64 and at --group-size 32: an engine on each
               workspace serves 4 concurrent requests (the 512 bucket), a
               bs1 request and a speculative one, launches per decode step,
               prefill pass and verify round solved from those windows (10
               GEMM, all on the wgmma routes, and 2 attention), prompt
               logits within 5% (cosine 0.999) of the CPU's.
  7. quant   — a user quantises that checkpoint on the card and serves it:
               `lite calibrate` (16 x 512 synthetic ids, bf16 through the
               prefill-attention kernel: 32 launches; the first 2 samples'
               stats against a CPU f32 calibration, each within 2% of its
               max |value|), `lite auto_awq` from those stats, an engine on
               the workspace with a dynamic int4 pool (quant_policy 8, no
               scales; 4 concurrent requests and a bs1 one of 256, GEMM
               launches only; prompt logits of 300 tokens against the CPU's
               within 5% / cosine 0.999; one store's codes identical to the
               plain version's, qparams within 2 f32 steps on <= 0.5%),
               `lite kv_qparams --kv-bits 4 --per-head` (a per-head pool, the
               same checks) and `--kv-bits 4` per layer (kernels 2 and 3 at
               int4 launch as before); then the 32-layer model of phase 5 on
               a dynamic and a static int4 pool (4 concurrent requests of 32
               new, bs1 32, a bs1 request of 4 under a CUDA-only profile:
               tok/s, TTFT, peak memory, device ms per forward pass, which at
               bs1 is a token).  Phases 5 and 7 keep sessions in the native C++
               store; phase 5's prefix-hit follower also runs on the Python
               one (LMDEPLOY_TPU_NATIVE=0) and must prefill the same tokens.
  8. parallel — phase 5's model (its widths and seed) at PARALLEL_LAYERS
               (16) layers, tp = 1 and tp = 2 (a second rank
               process spawned by the engine on the same card; the device
               collectives go through gloo): bs1 32 new on plain and on
               speculative rounds, 4 concurrent requests, prompt logits of
               300 and a seeded sampled pair.  tp = 2's greedy streams equal
               tp = 1's up to near-ties, its logits lie within 5% of
               max|logit| (cosine >= 0.999), the seeded pair is identical,
               each rank launches 160 GEMM / 32 decode attention per decode
               step and 160 / 32 prefill attention per pass and verify
               round with no plain call, the ranks' readback digests agree
               and every rank exits 0 within 30 s.  Then dp = 2 (4
               concurrent, a continued session stays in its group) and
               dp x tp = 2 x 2 at 4 layers (four ranks) against 1 x 1.  It
               prints start / serve / stop seconds, tok/s of ranks sharing
               one card (not a tp speed), peak memory per rank and the
               device group's backend.
  9. pipeline — phase 8's model and requests at pp = 2 (two ranks, gloo
               stage and vocab groups on one card) against phase 8's tp = 1
               run (its own when phase 8 did not run): bs1 on relay rounds
               (pp_ring_decode off), verify rounds (k = SPEC_K) and ring
               rounds, 4 concurrent and a seeded pair on the ring, prompt
               logits (the relay).  Greedy streams equal tp = 1's up to
               near-ties, logits within 5% (cosine >= 0.999), the pair
               identical, ring rounds ran, digests equal, each rank launches
               5L/pp GEMM + L/pp decode attention a relay step, 5L + L a ring
               round, 5L/pp GEMM + L/pp prefill attention a verify round and
               a GPipe job (the kernels line's pp2_launches), ranks exit in
               30 s.  Then pp x tp = 2 x 2 (bs1, 4 concurrent) against tp = 1
               and dp x pp x tp = 2 x 2 x 2 at 4 layers against 1 x 1 x 1;
               rates of ranks sharing one card are not a pp speed.
 10. tools   — the last modules of the port at Llama-2-7B width: W4A8
               (quant_matmul_a8) at the five projections and M = 1 / 8 /
               40 / 512 on the card against the CPU (1e-3 of max|ref|),
               timed beside the byte form's product and kernel 1; phase
               5's weights cut to TOOLS_LAYERS layers served packed,
               byte-per-int4 (LMDEPLOY_TPU_PACKED_INT4=0) and byte +
               LMDEPLOY_TPU_W4A8=1 (bs1 32 new from 100 tokens, prompt
               logits of 300; the byte stream equals the packed one up to
               near-ties, logits within 5% / cosine 0.999; the byte and
               W4A8 engines launch no GEMM, L decode attention a step and
               L prefill attention a pass;
               tok/s, device ms a step, peak memory); the W4A8 witnesses
               (the first 2 layers of fresh draws of GATE_DRAW_LAYERS:
               seed 5 as bench.py draws, and codes centred on the zero
               point at each of --gate-seeds: every W4A8 product of a
               300-token prompt held card vs CPU on the card's inputs
               beside its own error there, the logits recorded with W4A8
               and without, card vs CPU and the CPU against itself with
               every product's input nudged by one f32 ulp, which gates
               the centred draws' card-vs-CPU logits) and the W4A8 gate:
               prompt logits of a 2-layer cut of gate_params' draw
               (embedding rows away from zero mean; --gate-seeds, default
               5), card against CPU (5% / 0.999); the debugger
               (LMDEPLOY_TPU_DEBUG=dump, then cmp on the card, then cmp of
               the CPU's run) on that cut; trace() and annotate() around a
               bs1 request.  Alone: --phases probe,build,tools.
 11. families — Qwen-14B's widths (hidden 5120, 40 heads = KV heads,
               inter 13696: w2 has 107 groups of 128, which the tp = 1
               engine pads to 108 and packs; vocab 152064, qkv bias,
               dynamic NTK and logn past seq_length 2048) cut to
               FAMILY_LAYERS of its 40 layers, random packed weights at
               group 128: 4 concurrent greedy requests and two bs1 ones
               (launches per decode step 5L GEMM + L decode attention, per
               prefill pass 5L + L prefill attention, no plain call, every
               W4A16 weight packed), a seeded sampled pair (identical), a
               speculative request (verify rounds ran, every GEMM on a
               wgmma route), a 2040-token prompt + 24 new under
               LMDEPLOY_TPU_FUSED_ROPE=1 (kernel 5's L launches a step,
               logn on) and the defaults (streams equal up to a near-tie),
               prefix caching off, and prompt logits of a 2-layer cut
               against the CPU (5%, cosine 0.999).  Alone: --phases
               probe,build,families.
Not run by default:
  breakdown — where kernels 1 and 3's time goes.  Kernel 1: one layer's
               projections at M = 40, 64 and 512 and at a tp = 2 rank's M =
               40 and 512, on the route gemm_route picks, against copies of
               csrc/w4a16_gemm.cu with one part of the wgmma regime taken
               out (no_products: no wgmma issued; no_abuild: A fragments
               are constants, so no weight byte is read from shared memory
               or converted; no_order: the consumer warpgroups issue
               without their ping-pong barriers; loads_only: each stage
               released as it lands), and the other route forced.  Kernel
               3: routes wgmma and split against copies of the checkout's csrc/paged_prefill_attention.cu with
               one part taken out (no_products: no Q K^T or P V wgmma;
               loads_only: each tile released as it lands; no_merge: route
               split's slots of several splits skip the partials, ticket
               and merge, so their output is wrong and only the time
               counts; one_term: P enters P V as one bf16 term, not two,
               with its largest error on valid rows beside the kernel's),
               each built with the port's nvcc flags into csrc/build/ and
               called through the port's wrapper, timed at Llama-2-7B
               heads (--phases probe,build,breakdown).  The variants are
               text edits of the source: an edit that no longer matches
               raises.
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
PHASES = ('probe', 'build', 'kernels', 'model', 'engine', 'doors', 'quant',
          'parallel', 'pipeline', 'tools', 'families')
OPTIONAL_PHASES = ('breakdown',)
LLAMA2_7B_GEMMS = (('wqkv', 4096, 12288), ('wo', 4096, 4096),
                   ('w1', 4096, 11008), ('w3', 4096, 11008),
                   ('w2', 11008, 4096))
ENGINE_SLOTS = 8     # phase 5's max_batch_size: every decode step runs all
# 64 and 512: the prefill buckets; 40: the speculative verify of all 8 slots
# (K+1 = 5 rows each)
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


HBM_SET_BYTES = 100e6   # a timed case's working set: 2 x the H100's L2


def hbm_layers(nbytes: float, least: int = 2) -> int:
    """Layers to cycle when timing a call that reads ``nbytes`` of one
    layer (a projection's weight, a pool's attended K/V), so that the
    calls between two reads of a layer read at least HBM_SET_BYTES and the
    timed data comes from HBM, not from the 50 MB L2.  Time with at least
    this many calls in the graph (``iters``)."""
    return max(least, -(-int(HBM_SET_BYTES) // max(int(nbytes), 1)))


def host_us(torch, fns: dict, calls: int = 50, rounds: int = 20) -> dict:
    """Host microseconds a call of each ``fns[key]`` takes to return (eager
    calls, no synchronise between them: the wrapper's and the launch's
    host cost): the least over ``rounds`` rounds of ``calls`` calls, the
    functions taking turns in every round, first and last by turns, so
    that host noise between calls does not decide a comparison."""
    best = {}
    for fn in fns.values():
        for i in range(3):
            fn(i)
    items = list(fns.items())
    for r in range(rounds):
        for key, fn in (items if r % 2 == 0 else items[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(calls):
                fn(i)
            t1 = time.perf_counter()
            best[key] = min(best.get(key, float('inf')),
                            (t1 - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


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
            if line.startswith('==') or 'spill' in line or (
                    'ptxas' in line and ('registers' in line
                                         or 'Compiling entry' in line
                                         or 'arning' in line
                                         or 'Performance' in line)):
                log('  ' + line.strip())


def _rand_packed(torch, gen, shape):
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                         device='cuda')


def _gemm_weights(torch, gen, k, n, n_layers, group=128):
    """A random packed weight [L, K/2, N], its bf16 scales (group
    ``group``) and each layer's dequantised bf16 weight (torch.matmul's
    operand)."""
    from lmdeploy_tpu_torch.ops.cuda.quant_matmul import unpack_nibbles
    g = k // group
    packed = _rand_packed(torch, gen, (n_layers, k // 2, n))
    scales = (torch.rand((n_layers, g, 1, n), generator=gen,
                         device='cuda') * 0.01 + 0.001).to(torch.bfloat16)
    deq = [(unpack_nibbles(packed[i]).float().reshape(g, group, n)
            * scales[i].float()).reshape(k, n).to(torch.bfloat16)
           for i in range(n_layers)]
    return packed, scales, deq


def gemm_bytes(m, k, n, group=128):
    """Kernel 1's bytes: x, the packed weight, the scales and y once."""
    return m * k * 2 + k * n // 2 + k // group * n * 2 + m * n * 4


def gemm_bound(m, k, n, group=128):
    """Kernel 1's bound: :func:`gemm_bytes` (bytes); 2 M K N
    (operations)."""
    return bound_ms(gemm_bytes(m, k, n, group), 2.0 * m * k * n)


def gemm_parent_ms(torch, ctx, timer, x, packed, scales, layer, want, tol,
                   label, n_layers, iters=16, mine=None):
    """The parent checkout's kernel 1 (--parent) through its own wrapper on
    these inputs, held to the plain version at ``layer`` (``want``) and,
    where ``mine`` (this tree's output at ``layer``) is given, to it bit
    for bit, timed cycling n_layers layers; None without --parent."""
    qm = ctx.get('parent_qm')
    if qm is None:
        return None
    theirs = qm.w4a16_gemm(x, packed, scales, layer)
    torch.cuda.synchronize()
    e = (theirs - want).abs().max().item()
    if not e <= tol:
        raise AssertionError(f'parent w4a16_gemm {label}: max abs err {e}')
    if mine is not None and not torch.equal(theirs, mine):
        raise AssertionError(
            f'w4a16_gemm {label}: not bit-identical to the parent\'s '
            f'(max abs difference '
            f'{(theirs - mine).abs().max().item():.3e})')
    return timer.graph(lambda i: qm.w4a16_gemm(x, packed, scales,
                                               i % n_layers),
                       max(iters, n_layers))


def check_gemm(torch, ctx, timer):
    """The W4A16 GEMM at every GEMM_ROWS M over one Llama-2-7B layer's five
    projections: both routes (splitk and tiles) against the plain
    version; the route that gemm_route picks timed beside the parent's
    kernel (--parent), the library call (torch.matmul on the dequantised
    weight) and the bound.  Every timing cycles enough layers that the
    weights come from HBM (hbm_layers)."""
    from lmdeploy_tpu_torch.ops.cuda import build
    from lmdeploy_tpu_torch.ops.cuda.quant_matmul import (
        ROUTES, gemm_route, sm_count, splitk_splits, w4a16_gemm,
        w4a16_gemm_plain, w4a16_gemm_route, wgmma_rows)
    gen = torch.Generator(device='cuda').manual_seed(1)
    sms = sm_count('cuda')
    rows, worst = [], 0.0
    zero = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0)
    if ctx.get('parent_qm') is not None:
        zero['parent_ms'] = 0.0
    layer = {m: dict(zero, routes={}) for m in GEMM_ROWS}
    by_route = {r: {} for r in ROUTES}
    lib = build.load()
    for name, k, n in LLAMA2_7B_GEMMS:
        # timing cycles layers so weights come from HBM
        n_layers = hbm_layers(k * n // 2)
        iters = max(16, n_layers)
        packed, scales, deq = _gemm_weights(torch, gen, k, n, n_layers)
        for m in GEMM_ROWS:
            x = torch.randn((m, k), generator=gen, device='cuda').to(
                torch.bfloat16)
            want = w4a16_gemm_plain(x, packed, scales, 3)
            scale = want.abs().max().item()
            tol = 1e-3 * scale + 1e-3
            route = gemm_route(m, k, n, sms, 128)
            errs, times, outs = {}, {}, {}
            for r in ROUTES:
                got = outs[r] = w4a16_gemm_route(x, packed, scales, 3, r)
                torch.cuda.synchronize()
                errs[r] = (got - want).abs().max().item()
                if not errs[r] <= tol:
                    raise AssertionError(f'w4a16_gemm[{r}] {name} M={m}: '
                                         f'max abs err {errs[r]} > {tol}')
                worst = max(worst, errs[r])
                if r == route:
                    ms = times[r] = timer.graph(lambda i: w4a16_gemm_route(
                        x, packed, scales, i % n_layers, r), iters)
                    by_route[r][m] = by_route[r].get(m, 0.0) + ms
            # at group 128 the parent's kernel 1 gives the same bits
            parent = gemm_parent_ms(torch, ctx, timer, x, packed, scales, 3,
                                    want, tol, f'{name} M={m}', n_layers,
                                    iters, mine=outs[route])
            lib_ms = timer.graph(lambda i: torch.matmul(x, deq[i % n_layers]),
                                 iters)
            plain = timer.events(lambda i: w4a16_gemm_plain(
                x, packed, scales, i % n_layers), 3, warmup=1)
            if m == ENGINE_SLOTS and name == 'wqkv':
                # each wrapper's host cost a call, eager, the parent's too
                qm = ctx.get('parent_qm')
                fns = {'host_us': lambda i: w4a16_gemm(
                    x, packed, scales, i % n_layers)}
                if qm is not None:
                    fns['parent_host_us'] = lambda i: qm.w4a16_gemm(
                        x, packed, scales, i % n_layers)
                layer[m].update(dict(parent_host_us=None),
                                **host_us(torch, fns))
                log(f'  w4a16_gemm host: {layer[m]["host_us"]:.1f} us a call'
                    + (f', parent {layer[m]["parent_host_us"]:.1f}'
                       if qm is not None else '') + f' (M={m}, {name})')
            bms, by = gemm_bound(m, k, n)
            shape = (f', S={splitk_splits(m, k, n, sms, 128)}, x tile '
                     f'{wgmma_rows(m)} rows')
            rows.append((name, m, k, n, route, ms, parent, plain, lib_ms, bms,
                         by, errs[route]))
            log(f'  w4a16_gemm {name:4s} M={m:3d} K={k:5d} N={n:5d} '
                f'(route {route}{shape}): kernel {ms:.4f} ms, '
                + (f'parent {parent:.4f} ms, ' if parent is not None else '')
                + f'plain {plain:.3f} ms, torch.matmul (bf16 dequantized) '
                f'{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), routes timed '
                + ', '.join(f'{r} {t:.4f}' for r, t in times.items())
                + ' ms, max abs err '
                + ', '.join(f'{r} {e:.2e}' for r, e in errs.items())
                + f' (tol {tol:.2e}, scale {scale:.1f})')
            layer[m]['routes'][name] = route
            for key, val in (('ms', ms), ('plain_ms', plain),
                             ('library_ms', lib_ms), ('parent_ms', parent),
                             ('bytes', gemm_bytes(m, k, n)),
                             ('ops', 2.0 * m * k * n)):
                if key in layer[m]:
                    layer[m][key] += val
        del deq, packed, scales
        torch.cuda.empty_cache()
    for m in layer:
        layer[m]['bound_ms'], layer[m]['bound_by'] = bound_ms(
            layer[m].pop('bytes'), layer[m].pop('ops'))
        par = layer[m].get('parent_ms')
        routes = sorted(set(layer[m]['routes'].values()))
        log(f'  w4a16_gemm one layer M={m} ({routes}): kernel '
            f'{layer[m]["ms"]:.4f} ms, '
            + (f'parent {par:.4f} ms, ' if par is not None else '')
            + f'torch.matmul {layer[m]["library_ms"]:.4f} ms, bound '
            f'{layer[m]["bound_ms"]:.4f} ms ({layer[m]["bound_by"]}), '
            f'{layer[m]["bound_ms"] / layer[m]["ms"]:.0%} of the bound')
    log('  routes, one layer (ms; a route summed over the projections timed '
        'on it): ' + '; '.join(
            f'M={m} ' + ' '.join(f'{r} {by_route[r][m]:.4f}' for r in ROUTES
                                 if m in by_route[r]) for m in GEMM_ROWS))
    enc = lib.lmd_tmap_encode_ns(10000)
    log(f'  host: one tensor-map encode {enc} ns (two per wgmma call)')
    verify_m = ENGINE_SLOTS * (SPEC_K + 1)
    tol = '1e-3 * max|plain| + 1e-3 (f32 sums in another order)'
    ctx['kernels']['w4a16_gemm'] = dict(
        shape=f'one Llama-2-7B layer in decode: wqkv+wo+w1+w3+w2, '
              f'M={ENGINE_SLOTS} (the engine runs all its slots)',
        **layer[ENGINE_SLOTS], m1=layer[1], layer_by_m=layer,
        max_abs_err=worst, tolerance=tol)
    ctx['kernels']['w4a16_gemm[wgmma]'] = dict(
        shape='one Llama-2-7B layer in prefill: wqkv+wo+w1+w3+w2, M=512 '
              '(the 512-token bucket)',
        **layer[512], max_abs_err=worst, verify_m40=layer[verify_m],
        tmap_encode_ns=enc, tolerance=tol)
    # one entry per route: the projections that take it at the verify's M
    # (splitk) and at the 512-token bucket (tiles), summed
    for route, m, what in (('splitk', verify_m, 'the verify of 8 slots x '
                            f'{SPEC_K + 1} rows'),
                           ('tiles', 512, 'the 512-token bucket')):
        mine = [r for r in rows if r[1] == m and r[4] == route]
        names = '+'.join(r[0] for r in mine)
        bms, by = bound_ms(sum(gemm_bytes(mm, k, n)
                               for _, mm, k, n, *_ in mine),
                           sum(2.0 * mm * k * n for _, mm, k, n, *_ in mine))
        parents = [r[6] for r in mine]
        ctx['kernels'][f'w4a16_gemm[wgmma]:{route}'] = dict(
            shape=f'Llama-2-7B {names} (the projections on route {route}), '
                  f'M={m} ({what})',
            ms=sum(r[5] for r in mine), plain_ms=sum(r[7] for r in mine),
            library_ms=sum(r[8] for r in mine),
            parent_ms=None if None in parents else sum(parents),
            bound_ms=bms, bound_by=by, routes={r[0]: route for r in mine},
            max_abs_err=max(r[11] for r in mine), tolerance=tol)
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


# decode attention cases: (label, per-slot contexts, valid=0 slots, kv
# heads of H = 32); the first is the kernels line's row (the engine's
# decode shape), the second its bs1 row; the sixth is the engine's state
# during a bs1 request after longer ones: one live slot, the others masked
# with stale contexts; the last is GQA at G = 8 (recorded, not on phase
# 5's path)
DECODE_CASES = (
    ('B=8 ctx~512, slot 3 valid=0', [512 - 7 * i for i in range(8)], (3,),
     32),
    ('B=1 ctx 512', [512], (), 32),
    ('B=8 ctx~512, all valid', [512 - 7 * i for i in range(8)], (), 32),
    ('B=1 ctx 80', [80], (), 32),
    ('B=1 ctx 2048', [2048], (), 32),
    ('B=8, slot 0 ctx 80, slots 1-7 valid=0 at ctx ~500',
     [80] + [500 + 9 * i for i in range(7)], tuple(range(1, 8)), 32),
    ('G=8 (KH=4 of H=32), B=8 ctx~512, slot 3 valid=0',
     [512 - 7 * i for i in range(8)], (3,), 4),
)
# cases timed on the bf16 pool only (the quantised pools' rows at these
# contexts add nothing the engine's shapes do not show)
DECODE_BF16_ONLY = ('B=1 ctx 80', 'B=1 ctx 2048')


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


def decode_parent(torch, ctx, timer, mode, d, qp, live, n_layers, iters,
                  ours, label):
    """The parent checkout's kernel ``mode`` (--parent) through its own
    wrapper on these inputs (its own copy of the pool), held to this
    tree's output ``ours`` within 1e-2 on the attended slots, then timed
    cycling n_layers layers: its ms, or None without --parent."""
    pa = ctx.get('parent_pa')
    if pa is None:
        return None
    k3, v3 = d['kc'].clone(), d['vc'].clone()
    theirs = _decode_call(pa, mode, mode, d, k3, v3, 2, qp)
    torch.cuda.synchronize()
    diff = (theirs[live].float() - ours[live].float()).abs().max().item()
    if not diff <= 1e-2:
        raise AssertionError(f'parent {label}: differs from this tree by '
                             f'{diff}')
    del k3, v3
    return timer.graph(lambda i: _decode_call(
        pa, mode, mode, d, d['kc'], d['vc'], i % n_layers, qp), iters)


def decode_bytes(mode, ctxs, live, b, h, kh, elem_bytes):
    """Kernels 2 / 4 / 5's bytes for this run's data: the attended slots'
    K/V once, q and out, and in the storing modes k_new / v_new and the
    stored rows (mode 2: the rope tables and qscale too)."""
    dh = 128
    tok = sum(ctxs[i] for i in live)
    nbytes = 2 * tok * kh * dh * elem_bytes + 2 * b * h * dh * 2
    if mode != 'paged_decode_attention':
        nbytes += 2 * b * kh * dh * 2 + 2 * len(live) * kh * dh * elem_bytes
    if mode == 'paged_decode_attention_rope_write':
        nbytes += 2 * b * dh * 4 + b * 4
    return nbytes, 4.0 * tok * h * dh


def check_decode(torch, ctx, timer):
    """Kernels 2, 4 and 5 at each KV width over DECODE_CASES, against the
    plain version (pool bit-identical after the store, valid rows within
    1e-2), each called twice in a row (the ticket counter resets, the
    same bits), with the parent's kernel (--parent, through its own
    wrapper), SDPA and the bound; every timing cycles enough layers that
    the attended K/V comes from HBM (hbm_layers).  At the first case on
    the bf16 pool also each wrapper's host us a call, beside the
    parent's."""
    from lmdeploy_tpu_torch.kvcache.paged import KV_WIDTHS
    from lmdeploy_tpu_torch.ops.cuda import paged_attention as PA
    gen = torch.Generator(device='cuda').manual_seed(2)
    h, dh, page = 32, 128, 64
    for kv_bits, (width, _, elem_bytes) in KV_WIDTHS.items():
        qp = (torch.tensor(KERNEL_QPARAMS[kv_bits], device='cuda')
              if kv_bits else None)
        for mode in DECODE_MODES:
            worst, rows = 0.0, {}
            for label, ctxs, masked, kh in DECODE_CASES:
                if kv_bits and label in DECODE_BF16_ONLY:
                    continue
                b = len(ctxs)
                live = [i for i in range(b)
                        if mode == 'paged_decode_attention' or i not in masked]
                nbytes, ops = decode_bytes(mode, ctxs, live, b, h, kh,
                                           elem_bytes)
                n_layers = hbm_layers(2 * sum(ctxs[i] for i in live) * kh * dh
                                      * elem_bytes, least=3)
                iters = max(32, n_layers)
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
                    if not (got[i] == 0).all():
                        raise AssertionError(f'{name}: a valid=0 slot is '
                                             'not zero')
                err = (got.float() - want.float())[live].abs().max().item()
                if not err <= 1e-2:
                    raise AssertionError(f'{name}: max abs err {err} > 1e-2')
                worst = max(worst, err)
                del k1, v1
                ms = timer.graph(lambda i: _decode_call(
                    PA, mode, mode, d, kc, vc, i % n_layers, qp), iters)
                parent = decode_parent(
                    torch, ctx, timer, mode, d, qp, live, n_layers, iters,
                    got, name)
                plain = timer.events(lambda i: _decode_call(
                    PA, mode, mode + '_plain', d, k2, v2, i % n_layers, qp),
                    3, warmup=1)
                del k2, v2
                # yardstick: SDPA over the K/V of the slots the kernel
                # attends (masked slots of the storing modes do no work),
                # gathered to [B, H, ctx, Dh] and dequantised beforehand (no
                # store, no rope, no dequant); for unequal contexts over the
                # longest; GQA through enable_gqa
                n_kv = max(ctxs[i] for i in live)
                kvg = [(kk[live, :, :n_kv], vv[live, :, :n_kv]) for kk, vv in
                       _dequant_gather(torch, kc, vc, d['pt'],
                                       -(-n_kv // page) * page, qp)]
                q4 = d['q'][live][:, :, None]
                gqa = dict(enable_gqa=True) if kh != h else {}
                lib = timer.graph(lambda i: torch.nn.functional
                                  .scaled_dot_product_attention(
                                      q4, *kvg[i % n_layers], **gqa), iters)
                bms, by = bound_ms(nbytes, ops)
                row = dict(ms=ms, parent_ms=parent, plain_ms=plain,
                           library_ms=lib, bound_ms=bms, bound_by=by,
                           hbm_layers=n_layers)
                if label == DECODE_CASES[0][0] and kv_bits == 0:
                    # each wrapper's host cost a call, eager, the parent's
                    # too (--parent), taking turns
                    pa = ctx.get('parent_pa')
                    fns = {'host_us': lambda i: _decode_call(
                        PA, mode, mode, d, kc, vc, i % n_layers, qp)}
                    if pa is not None:
                        fns['parent_host_us'] = lambda i: _decode_call(
                            pa, mode, mode, d, kc, vc, i % n_layers, qp)
                    row.update(dict(parent_host_us=None),
                               **host_us(torch, fns))
                want = PA.decode_want(mode, kv_bits, h // kh, b * kh)
                splits = PA.decode_splits(d['pt'].shape[1], page, want)
                log(f'  {name}: kernel {ms:.4f} ms (grid of {splits} splits,'
                    f' up to {want} a slot, {n_layers} layers cycled), '
                    + (f'parent {parent:.4f} ms, ' if parent else '')
                    + f'plain {plain:.3f} ms, SDPA {lib:.4f} ms, '
                    f'bound {bms:.4f} ms ({by}), {bms / ms:.0%} of the bound, '
                    f'max abs err {err:.2e} (tol 1e-2), pool identical'
                    + (f'; host {row["host_us"]:.1f} us a call'
                       + (f' (parent {row["parent_host_us"]:.1f})'
                          if row['parent_host_us'] else '')
                       if 'host_us' in row else ''))
                rows[label] = row
                del kvg, kc, vc, d
                torch.cuda.empty_cache()
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


def prefill_bound(starts, lens, h, kh, elem_bytes):
    """Kernel 3's bound on these chunks: q and out once, the visible K/V
    once (bytes); 4 Dh H per (row, visible key) (operations)."""
    dh = 128
    nbytes = sum(2 * n * h * dh * 2 + 2 * (s + n) * kh * dh * elem_bytes
                 for s, n in zip(starts, lens) if n)
    ops = sum(4.0 * dh * h * (n * s + n * (n + 1) / 2)
              for s, n in zip(starts, lens))
    return bound_ms(nbytes, ops)


def load_parent(ctx, tree):
    """Kernels 1-5 of another checkout (the parent commit's, say) through
    that checkout's own wrappers, for the parent column of every kernel
    line: its package is imported under another name, so its build.py
    builds its own sources into its own csrc/build/ and loads them with
    its own C signatures; ctx['parent_pf'] is its
    ops/cuda/prefill_attention module, ctx['parent_qm'] its
    ops/cuda/quant_matmul module and ctx['parent_pa'] its
    ops/cuda/paged_attention module, whose ``paged_prefill_attention``,
    ``w4a16_gemm`` and three decode wrappers take the same arguments in
    every version."""
    import importlib
    import importlib.util
    root = os.path.join(os.path.abspath(tree), 'lmdeploy_tpu_torch')
    name = 'parent_lmdeploy_tpu_torch'
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, '__init__.py'),
        submodule_search_locations=[root])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    t0 = time.monotonic()
    importlib.import_module(f'{name}.ops.cuda.build').load()
    ctx['parent_pf'] = importlib.import_module(
        f'{name}.ops.cuda.prefill_attention')
    ctx['parent_qm'] = importlib.import_module(
        f'{name}.ops.cuda.quant_matmul')
    ctx['parent_pa'] = importlib.import_module(
        f'{name}.ops.cuda.paged_attention')
    log(f'parent kernels from {root}: built in {time.monotonic() - t0:.1f} s')


def time_prefill(torch, ctx, timer, q, kc, vc, pt, sp, ce, qp, n_layers,
                 iters):
    """Kernel 3 on these inputs cycling n_layers layers: (route, kernel ms,
    parent ms, parent label).  The parent is the --parent tree's kernel 3
    when one was loaded (its output held to this tree's within 1e-2 on the
    live slots first), else this tree's route mma (FORCE_MMA: the body
    kernel 3 had before its routes)."""
    from lmdeploy_tpu_torch.kvcache.paged import kv_bits_of
    from lmdeploy_tpu_torch.ops.cuda import prefill_attention as PF
    b, t, h, dh = q.shape
    route = PF.prefill_route(b, t, h, kc.shape[3], kc.shape[2],
                             kv_bits_of(kc))
    ms = timer.graph(lambda i: PF.paged_prefill_attention(
        q, kc, vc, i % n_layers, pt, sp, ce, qp), iters)
    parent_pf = ctx.get('parent_pf')
    if parent_pf is None:
        PF.FORCE_MMA = True
        try:
            parent = timer.graph(lambda i: PF.paged_prefill_attention(
                q, kc, vc, i % n_layers, pt, sp, ce, qp), iters)
        finally:
            PF.FORCE_MMA = False
        return route, ms, parent, 'route mma'
    theirs = parent_pf.paged_prefill_attention(q, kc, vc, 1, pt, sp, ce, qp)
    ours = PF.paged_prefill_attention(q, kc, vc, 1, pt, sp, ce, qp)
    torch.cuda.synchronize()
    live = [i for i in range(b) if int(ce[i]) > int(sp[i])]
    diff = (theirs[live].float() - ours[live].float()).abs().max().item()
    if not diff <= 1e-2:
        raise AssertionError(f'parent kernel 3 and this tree differ by '
                             f'{diff}')
    parent = timer.graph(lambda i: parent_pf.paged_prefill_attention(
        q, kc, vc, i % n_layers, pt, sp, ce, qp), iters)
    return route, ms, parent, 'parent tree'


def sdpa_ms(torch, timer, q, kc, vc, pt, starts, ends, qp, n_layers, iters):
    """The library yardstick of kernel 3 on these inputs: one SDPA call over
    the live slots (context_end > start_pos), K/V gathered and dequantised
    beforehand, mask kv_pos <= start + t and kv_pos < context_end (is_causal
    for one chunk from 0, the same function), GQA through enable_gqa."""
    b, t, h, _ = q.shape
    page, kh = kc.shape[2], kc.shape[3]
    live = [i for i in range(b) if ends[i] > starts[i]]
    n_kv = max(ends[i] for i in live)
    kvg = [(kk[:, :, :n_kv], vv[:, :, :n_kv]) for kk, vv in
           _dequant_gather(torch, kc, vc, pt[live], -(-n_kv // page) * page,
                           qp)]
    qt = q[live].transpose(1, 2)
    kw = dict(enable_gqa=True) if h != kh else {}
    if len(live) == 1 and starts[live[0]] == 0 and ends[live[0]] == t:
        kw['is_causal'] = True
    else:
        kv = torch.arange(n_kv, device='cuda')
        q_pos = (torch.tensor([starts[i] for i in live], device='cuda')
                 [:, None] + torch.arange(t, device='cuda'))
        end = torch.tensor([ends[i] for i in live], device='cuda')
        kw['attn_mask'] = ((kv <= q_pos[:, :, None])
                           & (kv < end[:, None, None]))[:, None]
    return timer.graph(lambda i: torch.nn.functional
                       .scaled_dot_product_attention(
                           qt, *kvg[i % n_layers], **kw), iters)


# kernel 3's chunk cases (label, history per slot, chunk length per slot,
# T, KH, H): the two prefill buckets at Llama-2-7B heads, a padding row,
# and the route boundary at G = 8 (KH = 4 of H = 32): T = 8 puts 64 rows
# in one route-split block, T = 9 is a chunk
PREFILL_CASES = (
    ('512-token chunk from 0', [0], [512], 512, 32, 32),
    ('64-token chunk over 300 history', [300], [64], 64, 32, 32),
    ('a chunk and a padding row', [100, 40], [64, 0], 64, 32, 32),
    ('T=8 G=8 (KH=4), histories 0 / 70 / 1000', [0, 70, 1000], [8] * 3, 8,
     4, 32),
    ('T=9 G=8 (KH=4), histories 0 / 70 / 1000', [0, 70, 1000], [9] * 3, 9,
     4, 32),
)


def check_prefill(torch, ctx, timer):
    from lmdeploy_tpu_torch.ops.cuda.prefill_attention import (
        paged_prefill_attention, paged_prefill_attention_plain)
    from lmdeploy_tpu_torch.kvcache.paged import KV_WIDTHS
    gen = torch.Generator(device='cuda').manual_seed(3)
    dh, n_layers = 128, 4
    for kv_bits, (width, _, elem_bytes) in KV_WIDTHS.items():
        qp = (torch.tensor(KERNEL_QPARAMS[kv_bits], device='cuda')
              if kv_bits else None)
        name = f'paged_prefill_attention[{width}]'
        worst, routes = 0.0, {}
        for label, starts, lens, t, kh, h in PREFILL_CASES:
            b = len(starts)
            ends = [s + n for s, n in zip(starts, lens)]
            kc, vc, pt = _paged_case(torch, gen, b,
                                     [max(e, 1) for e in ends], n_layers,
                                     pages=sum(-(-e // 64) for e in ends)
                                     + 8, kh=kh, kv_bits=kv_bits)
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
            route, ms, parent, plabel = time_prefill(
                torch, ctx, timer, q, kc, vc, pt, sp, ce, qp, n_layers, 8)
            routes[label] = route
            plain = timer.events(lambda i: paged_prefill_attention_plain(
                q, kc, vc, i % n_layers, pt, sp, ce, qp), 3, warmup=1)
            lib = sdpa_ms(torch, timer, q, kc, vc, pt, starts, ends, qp,
                          n_layers, 8)
            bms, by = prefill_bound(starts, lens, h, kh, elem_bytes)
            row = dict(route=route, ms=ms, parent_ms=parent,
                       parent=plabel, plain_ms=plain, library_ms=lib,
                       bound_ms=bms, bound_by=by, max_abs_err=err)
            msg = (f'  {name} ({label}): route {route}, kernel {ms:.4f} ms, '
                   f'parent ({plabel}) {parent:.4f} ms, plain {plain:.3f} '
                   f'ms, SDPA {lib:.4f} ms, bound {bms:.4f} ms ({by}), '
                   f'{bms / ms:.0%} of the bound, max abs err {err:.2e} (tol '
                   f'1e-2)')
            if t == 512:
                ctx['kernels'][name] = dict(
                    shape=f'Llama-2-7B layer, {width} pool, one '
                          '512-token chunk from 0', cases={}, **row)
            elif t == 64 and b == 1:
                ctx['kernels'][name]['chunk64_over300'] = row
            else:
                ctx['kernels'][name]['cases'][label] = row
            log(msg)
            del kc, vc
        ctx['kernels'][name].update(
            max_abs_err=worst, routes=routes,
            tolerance='1e-2 abs on bf16 outputs, valid rows; padding rows '
                      'finite',
            library='SDPA (causal, or masked kv_pos <= start + t and < '
                    'context_end) over the live slots on K/V gathered and '
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
            route, ms, parent, plabel = time_prefill(
                torch, ctx, timer, q, kc, vc, pt, sp, ce, qp, n_layers, 32)
            plain = timer.events(lambda i: paged_prefill_attention_plain(
                q, kc, vc, i % n_layers, pt, sp, ce, qp), 3, warmup=1)
            lib = sdpa_ms(torch, timer, q, kc, vc, pt, starts, ends, qp,
                          n_layers, 32)
            nbytes = (2 * nl * t * h * dh * 2
                      + 2 * sum(live_ends) * kh * dh * elem_bytes)
            ops = sum(4.0 * dh * h * (t * s + t * (t + 1) / 2)
                      for s in starts[:nl])
            bms, by = bound_ms(nbytes, ops)
            log(f'  {name} verify {label}: route {route}, kernel {ms:.4f} '
                f'ms, parent ({plabel}) {parent:.4f} ms, plain {plain:.3f} '
                f'ms, SDPA (masked) {lib:.4f} ms, bound {bms:.4f} ms ({by}), '
                f'{bms / ms:.0%} of the bound, max abs err {err:.2e} (tol '
                f'1e-2)')
            rows[label] = dict(route=route, ms=ms, parent_ms=parent,
                               parent=plabel, plain_ms=plain, library_ms=lib,
                               bound_ms=bms, bound_by=by, max_abs_err=err)
            del kc, vc
        entry = ctx['kernels'][name]
        entry['verify'] = rows
        entry.setdefault('routes', {}).update(
            {f'verify {label}': r['route'] for label, r in rows.items()})
        entry['max_abs_err'] = max(entry['max_abs_err'], worst)
        torch.cuda.empty_cache()


# one tp rank's projections of Llama-2-7B at tp = 2 (K, N), w1 / w3 /
# w2 at the inter of 11264 that the preparation pads 11008 to
TP2_GEMMS = (('wqkv', 4096, 6144), ('wo', 2048, 4096), ('w1', 4096, 5632),
             ('w2', 5632, 4096))
TP2_ROWS = (1, ENGINE_SLOTS, ENGINE_SLOTS * (SPEC_K + 1), 512)
# the pp = 2 ring's microbatch, ceil(B / pp) rows: of the engine's 8 slots
# (pp = 2, pp x tp = 2 x 2) and of a dp group's 4 (dp x pp x tp = 2 x 2 x 2)
PP2_ROWS = (ENGINE_SLOTS // 2, ENGINE_SLOTS // 4)


def check_gemm_rows(torch, ctx, gen, timer, gemms, m_rows, label,
                    group=128):
    """The W4A16 GEMM at ``gemms`` x ``m_rows`` at quantisation group
    ``group`` (the route the wrapper picks) against its plain version,
    with the parent's kernel (--parent) at every M, held to the plain
    version too and, at the groups whose code is the parent's (the
    multiples of 64, the wgmma kernel's stage pieces), to its bits; at the
    other groups the parent's is its route decode.  Also torch.matmul on
    the dequantised weight and the bound; a row each, keyed by shape."""
    from lmdeploy_tpu_torch.ops.cuda.quant_matmul import (
        gemm_route, sm_count, w4a16_gemm, w4a16_gemm_plain)
    rows = {}
    for name, k, n in gemms:
        # timing cycles layers so weights come from HBM
        n_layers = hbm_layers(k * n // 2)
        iters = max(16, n_layers)
        packed, scales, deq = _gemm_weights(torch, gen, k, n, n_layers,
                                            group)
        for m in m_rows:
            x = torch.randn((m, k), generator=gen, device='cuda').to(
                torch.bfloat16)
            want = w4a16_gemm_plain(x, packed, scales, 1)
            got = w4a16_gemm(x, packed, scales, 1)
            torch.cuda.synchronize()
            tol = 1e-3 * want.abs().max().item() + 1e-3
            err = (got - want).abs().max().item()
            if not err <= tol:
                raise AssertionError(f'w4a16_gemm {label} {name} M={m}: max '
                                     f'abs err {err} > {tol}')
            route = gemm_route(m, k, n, sm_count('cuda'), group)
            ms = timer.graph(lambda i: w4a16_gemm(x, packed, scales,
                                                  i % n_layers), iters)
            again = w4a16_gemm(x, packed, scales, 1)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f'w4a16_gemm {label} {name} M={m}: a '
                                     'second call differs')
            parent = gemm_parent_ms(
                torch, ctx, timer, x, packed, scales, 1, want, tol,
                f'{label} {name} M={m}', n_layers, iters,
                mine=got if group % 64 == 0 else None)
            lib = timer.graph(lambda i: torch.matmul(x, deq[i % n_layers]),
                              iters)
            plain = timer.events(lambda i: w4a16_gemm_plain(
                x, packed, scales, i % n_layers), 2, warmup=1)
            bms, by = gemm_bound(m, k, n, group)
            rows[f'{name} K={k} N={n} M={m}'] = dict(
                route=route, ms=ms, parent_ms=parent, plain_ms=plain,
                library_ms=lib, bound_ms=bms, bound_by=by, max_abs_err=err)
            log(f'  w4a16_gemm {label} {name:4s} M={m:3d} K={k:5d} '
                f'N={n:5d} (route {route}): kernel {ms:.4f} ms, '
                + (f'parent {parent:.4f} ms, ' if parent is not None else '')
                + f'plain {plain:.3f} ms, torch.matmul {lib:.4f} ms, bound '
                f'{bms:.4f} ms ({by}), max abs err {err:.2e} (tol {tol:.2e})')
        del deq, packed, scales
        torch.cuda.empty_cache()
    # one layer: w1's shape stands for w3 too where ``gemms`` lists it once
    times = {name: 2 if name == 'w1' and len(gemms) == 4 else 1
             for name, _, _ in gemms}
    layers = {}
    for m in m_rows:
        mine = [(times[key.split()[0]], r) for key, r in rows.items()
                if key.endswith(f' M={m}')]
        layer = layers[f'M={m}'] = {
            key: (None if any(r[key] is None for _, r in mine) else
                  sum(c * r[key] for c, r in mine))
            for key in ('ms', 'parent_ms', 'library_ms', 'plain_ms')}
        layer['bound_ms'], layer['bound_by'] = bound_ms(
            sum(times[name] * gemm_bytes(m, k, n, group)
                for name, k, n in gemms),
            sum(times[name] * 2.0 * m * k * n for name, k, n in gemms))
        log(f'  w4a16_gemm {label}, one layer M={m} (w1 counted for w3 '
            'where w3 is not listed): ' + ', '.join(
                f'{key} {v:.4f}' for key, v in layer.items()
                if isinstance(v, float)))
    rows['one layer'] = layers
    return rows


# Kernel 1 over the rest of the JAX kernel's domain: the other groups it
# takes (a multiple of 64 in stage pieces, any other multiple of 16 in
# the step form, at every M) over one Llama-2-7B layer (w1 stands for
# w3; w2's K = 11008 is 43 groups of 256, an odd count, so at group 256
# it is the 11264 the engine pads it to; at group 48 K pads to a multiple
# of 96: 4128 and 11040), and Qwen-14B's projections at group 128 (inter
# 13696, 107 groups, padded to 13824).  Groups 16, 32 and 48 (the step
# form's commit groups of one, two and three k16 steps) run the parent's
# route decode in its column
GEMM_GROUPS = (64, 32, 256, 48, 16)
GROUP_ROWS = (1, ENGINE_SLOTS, ENGINE_SLOTS * (SPEC_K + 1), 64, 512)
QWEN14B_GEMMS = (('wqkv', 5120, 15360), ('wo', 5120, 5120),
                 ('w1', 5120, 13824), ('w2', 13824, 5120))
QWEN14B_ROWS = (1, ENGINE_SLOTS, ENGINE_SLOTS * (SPEC_K + 1), 512)


def check_gemm_groups(torch, ctx, timer):
    """Kernel 1 at GEMM_GROUPS over one Llama-2-7B layer at GROUP_ROWS,
    and at group 128 over Qwen-14B's projections at QWEN14B_ROWS, each on
    the route the wrapper picks against its plain version, with
    torch.matmul on the dequantised weight and the bound (the parent's
    kernel too where it took the shape, see check_gemm_rows), under the
    kernels line's ``groups`` and ``qwen14b`` keys."""
    gen = torch.Generator(device='cuda').manual_seed(13)
    entry = ctx['kernels'].setdefault('w4a16_gemm', {})
    groups = entry['groups'] = {}
    for group in GEMM_GROUPS:
        gemms = tuple((name, k + (-k) % (2 * group), n) for name, k, n in
                      LLAMA2_7B_GEMMS if name != 'w3')
        groups[group] = check_gemm_rows(torch, ctx, gen, timer, gemms,
                                        GROUP_ROWS, f'group {group}', group)
        torch.cuda.empty_cache()
    entry['qwen14b'] = check_gemm_rows(torch, ctx, gen, timer,
                                       QWEN14B_GEMMS, QWEN14B_ROWS,
                                       'Qwen-14B group 128')
    torch.cuda.empty_cache()


def check_decode_write(torch, ctx, gen, timer, kh, ctxs, masked, kv_bits,
                       label):
    """Kernel 2 (mode 1) at H = KH = ``kh`` over slots of contexts
    ``ctxs`` (``masked`` at valid = 0) against its plain version (pool
    bit-identical, valid rows within 1e-2, a second call identical), with
    the parent's kernel (--parent), SDPA on the live slots and the bound,
    cycling enough layers that the K/V comes from HBM; returns its row."""
    from lmdeploy_tpu_torch.kvcache.paged import KV_WIDTHS
    from lmdeploy_tpu_torch.ops.cuda import paged_attention as PA
    width, _, elem_bytes = KV_WIDTHS[kv_bits]
    h, dh, page = kh, 128, 64
    mode = 'paged_decode_attention_write'
    qp = (torch.tensor(KERNEL_QPARAMS[kv_bits], device='cuda')
          if kv_bits else None)
    live = [i for i in range(len(ctxs)) if i not in masked]
    b = len(ctxs)
    n_layers = hbm_layers(2 * sum(ctxs[i] for i in live) * kh * dh
                          * elem_bytes, least=3)
    iters = max(32, n_layers)
    d = _decode_inputs(torch, gen, ctxs, masked, kh, h, dh, n_layers,
                       kv_bits)
    k1, v1, k2, v2 = (x.clone() for x in (d['kc'], d['vc'], d['kc'],
                                          d['vc']))
    got = _decode_call(PA, mode, mode, d, k1, v1, 2, qp)
    again = _decode_call(PA, mode, mode, d, k1, v1, 2, qp)
    want = _decode_call(PA, mode, mode + '_plain', d, k2, v2, 2, qp)
    torch.cuda.synchronize()
    err = (got.float() - want.float())[live].abs().max().item()
    if not (torch.equal(k1, k2) and torch.equal(v1, v2) and err <= 1e-2
            and torch.equal(got, again)
            and all((got[i] == 0).all() for i in masked)):
        raise AssertionError(f'{mode}[{width}] {label}: err {err}, the '
                             'pool, a second call or a valid=0 slot differs')
    del k1, v1
    ms = timer.graph(lambda i: _decode_call(
        PA, mode, mode, d, d['kc'], d['vc'], i % n_layers, qp), iters)
    parent = decode_parent(torch, ctx, timer, mode, d, qp, live, n_layers,
                           iters, got, f'{mode}[{width}] {label}')
    plain = timer.events(lambda i: _decode_call(
        PA, mode, mode + '_plain', d, k2, v2, i % n_layers, qp), 2,
        warmup=1)
    del k2, v2
    n_kv = max(ctxs[i] for i in live)
    kvg = [(kk[live, :, :n_kv], vv[live, :, :n_kv]) for kk, vv in
           _dequant_gather(torch, d['kc'], d['vc'], d['pt'],
                           -(-n_kv // page) * page, qp)]
    q4 = d['q'][live][:, :, None]
    lib = timer.graph(lambda i: torch.nn.functional
                      .scaled_dot_product_attention(
                          q4, *kvg[i % n_layers]), iters)
    bms, by = bound_ms(*decode_bytes(mode, ctxs, live, b, h, kh, elem_bytes))
    log(f'  {mode}[{width}] {label}: kernel {ms:.4f} ms ({n_layers} layers '
        f'cycled), ' + (f'parent {parent:.4f} ms, ' if parent else '')
        + f'plain {plain:.3f} ms, SDPA {lib:.4f} ms, bound {bms:.4f} ms '
        f'({by}), {bms / ms:.0%} of the bound, max abs err {err:.2e} (tol '
        f'1e-2), pool identical')
    del kvg, d
    torch.cuda.empty_cache()
    return dict(ms=ms, parent_ms=parent, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by, max_abs_err=err, shape=label,
                hbm_layers=n_layers)


def check_rank_shapes(torch, ctx, timer):
    """Kernels 1-3 at the shapes one rank of a tp = 2 Llama-2-7B engine
    gives them: the GEMM at TP2_GEMMS x TP2_ROWS (the regime the wrapper
    picks), decode attention (mode 1) and prefill attention (a 512-token
    chunk, the T = 5 verify) at H = KH = 16, each KV width, against the
    plain versions, with times, SDPA / torch.matmul and the bound; every
    timing cycles enough layers that weights and K/V come from HBM."""
    from lmdeploy_tpu_torch.kvcache.paged import KV_WIDTHS
    from lmdeploy_tpu_torch.ops.cuda.prefill_attention import (
        paged_prefill_attention, paged_prefill_attention_plain)
    gen = torch.Generator(device='cuda').manual_seed(11)
    ctx['kernels'].setdefault('w4a16_gemm', {})['tp2'] = check_gemm_rows(
        torch, ctx, gen, timer, TP2_GEMMS, TP2_ROWS, 'tp=2 rank')
    kh = h = 16
    dh, page, mode = 128, 64, 'paged_decode_attention_write'
    label, ctxs, masked, _ = DECODE_CASES[0]
    for kv_bits, (width, _, elem_bytes) in KV_WIDTHS.items():
        qp = (torch.tensor(KERNEL_QPARAMS[kv_bits], device='cuda')
              if kv_bits else None)
        ctx['kernels'].setdefault(f'{mode}[{width}]', {})['tp2'] = \
            check_decode_write(torch, ctx, gen, timer, kh, ctxs, masked,
                               kv_bits, f'tp=2 rank H=KH=16, {label}')
        pre = {}
        for case, starts, ends, t in (
                ('512-token chunk from 0', [0], [512], 512),
                ('verify T=5 B=8 ctx~512',
                 [512 - 7 * i - 5 for i in range(8)],
                 [512 - 7 * i for i in range(8)], 5)):
            bb = len(starts)
            # layers cycled so the K/V comes from HBM
            n_layers = hbm_layers(2 * sum(ends) * kh * dh * elem_bytes,
                                  least=4)
            iters = max(8, n_layers)
            kc, vc, pt = _paged_case(torch, gen, bb, ends, n_layers,
                                     pages=sum(-(-e // page) for e in ends)
                                     + 8, kh=kh, kv_bits=kv_bits)
            q = torch.randn((bb, t, h, dh), generator=gen,
                            device='cuda').to(torch.bfloat16)
            sp = torch.tensor(starts, dtype=torch.int32, device='cuda')
            ce = torch.tensor(ends, dtype=torch.int32, device='cuda')
            got = paged_prefill_attention(q, kc, vc, 1, pt, sp, ce, qp)
            want = paged_prefill_attention_plain(q, kc, vc, 1, pt, sp, ce,
                                                 qp)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not err <= 1e-2:
                raise AssertionError(f'paged_prefill_attention[{width}] '
                                     f'tp=2 {case}: max abs err {err}')
            route, ms, parent, plabel = time_prefill(
                torch, ctx, timer, q, kc, vc, pt, sp, ce, qp, n_layers,
                iters)
            plain = timer.events(lambda i: paged_prefill_attention_plain(
                q, kc, vc, i % n_layers, pt, sp, ce, qp), 2, warmup=1)
            lib = sdpa_ms(torch, timer, q, kc, vc, pt, starts, ends, qp,
                          n_layers, iters)
            bms, by = bound_ms(
                2 * bb * t * h * dh * 2 + 2 * sum(ends) * kh * dh
                * elem_bytes,
                sum(4.0 * dh * h * (t * s + t * (t + 1) / 2)
                    for s in starts))
            pre[case] = dict(route=route, ms=ms, parent_ms=parent,
                             parent=plabel, plain_ms=plain, library_ms=lib,
                             bound_ms=bms, bound_by=by, max_abs_err=err)
            log(f'  paged_prefill_attention[{width}] tp=2 rank H=KH=16 '
                f'{case}: route {route}, kernel {ms:.4f} ms, parent '
                f'({plabel}) {parent:.4f} ms, plain {plain:.3f} ms, SDPA '
                f'(masked) {lib:.4f} ms, bound {bms:.4f} ms ({by}), '
                f'{bms / ms:.0%} of the bound, max abs err {err:.2e} (tol '
                f'1e-2)')
            del kc, vc
        entry = ctx['kernels'].setdefault(
            f'paged_prefill_attention[{width}]', {})
        entry['tp2'] = pre
        entry.setdefault('routes', {}).update(
            {f'tp=2 {case}': r['route'] for case, r in pre.items()})
        torch.cuda.empty_cache()


def check_pp_shapes(torch, ctx, timer):
    """Kernels 1 and 2 at the shapes the pp = 2 ring's microbatch gives
    them (PP2_ROWS rows): the GEMM over LLAMA2_7B_GEMMS (a stage of pp =
    2) and TP2_GEMMS (a rank of pp x tp = 2 x 2 and of 2 x 2 x 2), and
    decode attention (mode 1) on a microbatch of 4 slots at H = KH = 32
    and 16 and of 2 slots at 16 (the engine's B = 8 decode shape cut in
    microbatches, its last slot at valid = 0), each KV width, against the
    plain versions, under the kernels line's ``pp2`` key."""
    from lmdeploy_tpu_torch.kvcache.paged import KV_WIDTHS
    gen = torch.Generator(device='cuda').manual_seed(12)
    gemm = {f'tp=1 {k}': v for k, v in check_gemm_rows(
        torch, ctx, gen, timer, LLAMA2_7B_GEMMS, PP2_ROWS,
        'pp=2 rank').items()}
    gemm.update({f'tp=2 {k}': v for k, v in check_gemm_rows(
        torch, ctx, gen, timer, TP2_GEMMS, PP2_ROWS,
        'pp=2 x tp=2 rank').items()})
    ctx['kernels'].setdefault('w4a16_gemm', {})['pp2'] = gemm
    _, ctxs, _, _ = DECODE_CASES[0]
    for kv_bits, (width, _, _) in KV_WIDTHS.items():
        rows = {}
        for kh, b in ((32, 4), (16, 4), (16, 2)):
            label = (f'pp=2 microbatch B={b} H=KH={kh} ctx~512, slot '
                     f'{b - 1} valid=0')
            rows[label] = check_decode_write(torch, ctx, gen, timer, kh,
                                             ctxs[:b], (b - 1,), kv_bits,
                                             label)
        ctx['kernels'].setdefault(
            f'paged_decode_attention_write[{width}]', {})['pp2'] = rows
        torch.cuda.empty_cache()


def _cut(text, old, new=''):
    """``text`` with its one occurrence of ``old`` replaced; raises when
    ``old`` does not occur exactly once."""
    if text.count(old) != 1:
        raise RuntimeError(f'breakdown edit does not match: {old[:60]!r}')
    return text.replace(old, new)


def breakdown_variants(src: str) -> dict:
    """The kernel-3 source as it is and with one part taken out (see
    phase ``breakdown``)."""
    cut = _cut
    lo = '      wgmma_pv(o, pl[k2], dv);\n'
    no_products = cut(cut(cut(
        src, '      wgmma_pv(o, ph[k2], dv);\n'), lo),
        '      wgmma_qk(s, qa[kk],', '      if (kk < 0) wgmma_qk(s, qa[kk],')
    wait = '    mbar_wait(&full[st], (i / kWStages) & 1);\n'
    loads_only = cut(src, wait, wait + (
        '    if (BITS == 0) {\n'
        '      if (lane == 0) mbar_arrive(&empty[st]);\n'
        '      continue;\n'
        '    }\n'))
    a = src.index("    // write this split's (m, l, O); the last split")
    b = src.index('    __syncthreads();  // s_ticket is read by everyone')
    return {'full': src, 'no_products': no_products,
            'loads_only': loads_only, 'no_merge': src[:a] + src[b:],
            'one_term': cut(src, lo)}


def gemm_breakdown_variants(src: str) -> dict:
    """Kernel 1's source as it is and with one part of its wgmma regime
    taken out (see phase ``breakdown``)."""
    issue = 'wgmma_bm<BM>(d, a[kk],'
    fold = 'for (int j = 0; j < kD / 4; ++j) {  // fold'
    skip_fold = 'for (int j = 0; j < 0; ++j) {  // fold'
    # the A fragments become constants, so the packed bytes are neither
    # read from shared memory nor converted
    first = '        a[kk][0] = nib2_bf16(p);'
    i = src.index(first)
    j = src.index('\n', src.index('a[kk][3] = nib2_bf16(q >> 8);')) + 1

    def no_abuild(text):
        text = (text[:i] + '        a[kk][0] = a[kk][1] = a[kk][2] = '
                'a[kk][3] = 0x3F803F80u;\n' + text[j:])
        return _cut(text, '        ldsm_x4_trans(wt + p * 32 * kBN,',
                    '        if (p < 0) ldsm_x4_trans(wt + p * 32 * kBN,')
    pingpong = '  constexpr bool kPingPong = BM > 64;'
    no_order = _cut(src, pingpong, '  constexpr bool kPingPong = false;')
    # the ring and the epilogue alone: no products, no fold, no A build
    loads_only = no_abuild(_cut(_cut(src, issue, 'if (kk < 0) ' + issue),
                                fold, skip_fold))
    x_loads = (
        '            tma_load_2d(base + T::kWBytes, &tm_x, krow, it.m0, '
        '&full[st]);\n'
        '            tma_load_2d(base + T::kWBytes + T::kXBytes, &tm_x,\n'
        '                        half_k + krow, it.m0, &full[st]);\n')
    weight_only = _cut(_cut(loads_only, x_loads),
                       'T::kWBytes + 2 * T::kXBytes +',
                       'T::kWBytes + 0 * T::kXBytes +')
    # the step form (groups that are not multiples of 64): its products,
    # its A fragments (no weight byte read from shared memory) or its
    # folds taken out
    step_issue = ('wgmma_bm<BM>(part[hh], a[u],',)
    step_ldsm = ('ldsm_x2_trans(smem_u32(stage) + w_lane2 + (t & 3) * 16 '
                 '* kBN,\n' + ' ' * 28 + 'v[u][0], v[u][1]);',)
    step_fold = ('fold(acc, part[hh], sc[h0 + hh]);',)

    def cuts(text, olds, new):
        for old in olds:
            text = _cut(text, old, new(old))
        return text
    return {'full': src,
            'no_products': _cut(src, issue, 'if (kk < 0) ' + issue),
            'no_abuild': no_abuild(src), 'no_order': no_order,
            'all_order': _cut(src, pingpong,
                              '  constexpr bool kPingPong = true;'),
            'loads_only': loads_only, 'weight_only': weight_only,
            'steps_no_products': cuts(src, step_issue,
                                      lambda old: 'if (u < 0) ' + old),
            'steps_no_abuild': cuts(
                src, step_ldsm,
                lambda old: 'v[u][0] = v[u][1] = 0x00110011u;'),
            'steps_no_fold': cuts(src, step_fold,
                                  lambda old: 'if (gs < 0) ' + old),
            # every step group on the runtime step count (U = -1): what
            # a compile-time form gains at its group
            'steps_runtime': _cut(src, '  switch (group / 16) {',
                                  '  switch (0) {')}


def phase_breakdown(torch, ctx):
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    from lmdeploy_tpu_torch.ops.cuda import build
    from lmdeploy_tpu_torch.ops.cuda import prefill_attention as PF
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def one(item):
        (kernel, name), text = item
        stem = f'breakdown_{kernel}_{name}'
        cu = build.BUILD_DIR / f'{stem}.cu'
        cu.write_text(text)
        so = build.BUILD_DIR / f'{stem}.so'
        r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, '-I',
                            str(build.CSRC), '-shared', '-o', str(so),
                            str(cu)], capture_output=True, text=True,
                           timeout=900)
        if r.returncode:
            raise RuntimeError(f'{stem}: nvcc failed\n{r.stdout}{r.stderr}')
        lib = ctypes.CDLL(str(so))
        prefix = ('lmd_paged_prefill' if kernel == 'k3' else
                  ('lmd_w4a16', 'lmd_tmap'))
        for fn, argtypes in build._SIGNATURES.items():
            if fn.startswith(prefix):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        return (kernel, name), lib
    sources = {('k3', name): text for name, text in breakdown_variants(
        (build.CSRC / 'paged_prefill_attention.cu').read_text()).items()}
    sources.update({('k1', name): text for name, text in
                    gemm_breakdown_variants(
                        (build.CSRC / 'w4a16_gemm.cu').read_text()).items()})
    with ThreadPoolExecutor(len(sources)) as ex:
        built = dict(ex.map(one, sources.items()))
    libs = {name: lib for (kernel, name), lib in built.items()
            if kernel == 'k3'}
    gemm_libs = {name: lib for (kernel, name), lib in built.items()
                 if kernel == 'k1'}
    timer = Timer(torch)
    gen = torch.Generator(device='cuda').manual_seed(1)
    chunk = ('full', 'no_products', 'loads_only', 'one_term')
    cases = [  # (label, histories, chunk lengths, T, KH = H, kv_bits,
        #         variants)
        ('512-token chunk from 0', [0], [512], 512, 32, 0, chunk),
        ('512-token chunk from 0, int8', [0], [512], 512, 32, 8,
         ('full', 'one_term')),
        ('512-token chunk from 0, int4', [0], [512], 512, 32, 4,
         ('full', 'one_term')),
        ('tp=2 rank 512-token chunk', [0], [512], 512, 16, 0, chunk),
        ('64-token chunk over 300', [300], [64], 64, 32, 0, chunk),
        ('padding row only (launch floor)', [0], [0], 512, 32, 0,
         ('full',)),
        ('verify B=1 ctx 512', [507], [5], 5, 32, 0, ('full', 'no_merge')),
        ('verify B=1 ctx 2048', [2043], [5], 5, 32, 0, ('full', 'no_merge')),
        ('verify B=8 ctx~512', [507 - 7 * i for i in range(8)], [5] * 8, 5,
         32, 0, ('full', 'no_merge')),
    ]
    out = {}
    main_lib = build.load()
    try:
        for label, starts, lens, t, kh, kv_bits, names in cases:
            ends = [s + n for s, n in zip(starts, lens)]
            kc, vc, pt = _paged_case(
                torch, gen, len(starts), [max(e, 1) for e in ends], 4,
                pages=sum(-(-max(e, 1) // 64) for e in ends) + 8, kh=kh,
                kv_bits=kv_bits)
            qp = (torch.tensor(KERNEL_QPARAMS[kv_bits], device='cuda')
                  if kv_bits else None)
            q = torch.randn((len(starts), t, kh, 128), generator=gen,
                            device='cuda').to(torch.bfloat16)
            sp = torch.tensor(starts, dtype=torch.int32, device='cuda')
            ce = torch.tensor(ends, dtype=torch.int32, device='cuda')
            want = PF.paged_prefill_attention_plain(q, kc, vc, 1, pt, sp, ce,
                                                    qp)
            row = {'route': PF.prefill_route(len(starts), t, kh, kh, 64,
                                             kv_bits)}
            for name in names:
                build._lib = libs[name]
                row[name] = timer.graph(lambda i: PF.paged_prefill_attention(
                    q, kc, vc, i % 4, pt, sp, ce, qp), 16)
                if name in ('full', 'one_term') and any(lens):
                    # valid rows against the plain version (reported,
                    # not gated: one_term is not what the kernel runs)
                    got = PF.paged_prefill_attention(q, kc, vc, 1, pt, sp,
                                                     ce, qp)
                    row[f'{name} max abs err'] = max(
                        (got[i, :n].float() - want[i, :n].float()).abs()
                        .max().item() for i, n in enumerate(lens) if n)
            out[label] = row
            log(f'  {label}: ' + ', '.join(
                f'{k} {v:.2e}' if k.endswith('err') else
                f'{k} {v:.4f} ms' if isinstance(v, float) else f'{k} {v}'
                for k, v in row.items()) + f' [{ctx.get("card", "?")}]')
            del kc, vc
        out.update(gemm_breakdown(torch, ctx, timer, gemm_libs))
    finally:
        build._lib = main_lib
    ctx['breakdown'] = out


# kernel 1's breakdown cases: (label, projections, M)
GEMM_BREAKDOWN_CASES = (
    ('7B layer M=16', LLAMA2_7B_GEMMS, 16),
    ('7B layer M=40 (verify)', LLAMA2_7B_GEMMS, ENGINE_SLOTS * (SPEC_K + 1)),
    ('7B layer M=64 (bucket)', LLAMA2_7B_GEMMS, 64),
    ('7B layer M=512 (bucket)', LLAMA2_7B_GEMMS, 512),
    ('tp=2 rank layer M=40', None, ENGINE_SLOTS * (SPEC_K + 1)),
    ('tp=2 rank layer M=512', None, 512),
    # group 64 folds twice as often: whether ping-pong (on at 128-row
    # tiles: no_order turns it off; all_order on below) still pays
    ('7B layer M=40 group 64', LLAMA2_7B_GEMMS,
     ENGINE_SLOTS * (SPEC_K + 1), 64),
    ('7B layer M=128 group 64', LLAMA2_7B_GEMMS, 128, 64),
    ('7B layer M=512 group 64', LLAMA2_7B_GEMMS, 512, 64),
    # the step form: a fold pair every group / 16 k16 steps
    *((f'7B layer M={m} group {g}', LLAMA2_7B_GEMMS, m, g)
      for g in (16, 32, 48) for m in (ENGINE_SLOTS,
                                      ENGINE_SLOTS * (SPEC_K + 1), 512)),
)


# M at which the breakdown times every projection at every split count
GEMM_SPLIT_SWEEP_ROWS = (16, ENGINE_SLOTS * (SPEC_K + 1), 64, 128)


def gemm_breakdown(torch, ctx, timer, libs):
    """Kernel 1's wgmma regime on the route gemm_route picks, one layer's
    projections summed, with each variant of gemm_breakdown_variants
    swapped in as the kernels' library: where its time goes.  Also each
    projection on the other route (full source), and a sweep of the split
    count per projection (the plan's cost model against the card)."""
    from lmdeploy_tpu_torch.ops.cuda import build
    from lmdeploy_tpu_torch.ops.cuda import quant_matmul as QM
    from lmdeploy_tpu_torch.ops.cuda.quant_matmul import (
        gemm_route, sm_count, w4a16_gemm_route)
    gen = torch.Generator(device='cuda').manual_seed(2)
    out = {}
    for label, gemms, m, *group in GEMM_BREAKDOWN_CASES:
        gemms = gemms or TP2_GEMMS
        group = group[0] if group else 128
        row = {}
        for name, k, n in gemms:
            k += (-k) % (2 * group)   # group 48: K a multiple of 96
            packed, scales, _ = _gemm_weights(torch, gen, k, n, 4, group)
            x = torch.randn((m, k), generator=gen, device='cuda').to(
                torch.bfloat16)
            route = gemm_route(m, k, n, sm_count('cuda'), group)
            other = 'tiles' if route == 'splitk' else 'splitk'
            row.setdefault('routes', []).append(route)
            for variant, lib in libs.items():
                build._lib = lib
                row[variant] = row.get(variant, 0.0) + timer.graph(
                    lambda i: w4a16_gemm_route(x, packed, scales, i % 4,
                                               route), 16)
            build._lib = libs['full']
            row['full, the other route'] = row.get(
                'full, the other route', 0.0) + timer.graph(
                lambda i: w4a16_gemm_route(x, packed, scales, i % 4, other),
                16)
            del packed, scales
        out[f'kernel 1 {label}'] = row
        log(f'  kernel 1 {label}: ' + ', '.join(
            f'{k} {v:.4f} ms' if isinstance(v, float) else f'{k} {v}'
            for k, v in row.items()) + f' [{ctx.get("card", "?")}]')
    # the split plan's cost model against the card: each projection at
    # every split count (1 is route tiles)
    build._lib = libs['full']
    plan = QM.splitk_splits
    try:
        for m in GEMM_SPLIT_SWEEP_ROWS:
            for name, k, n in LLAMA2_7B_GEMMS:
                packed, scales, _ = _gemm_weights(torch, gen, k, n, 4)
                x = torch.randn((m, k), generator=gen, device='cuda').to(
                    torch.bfloat16)
                times = {}
                for s in (1, 2, 3, 4, 6, 8):
                    if s > k // 256:
                        continue
                    # a forced splitk launches the plan's split count
                    QM.splitk_splits = lambda *_, s=s: s
                    times[s] = timer.graph(lambda i: QM.w4a16_gemm_route(
                        x, packed, scales, i % 4,
                        'splitk' if s > 1 else 'tiles'), 16)
                QM.splitk_splits = plan
                out[f'kernel 1 split sweep {name} M={m}'] = times
                log(f'  kernel 1 split sweep {name} M={m} (plan S='
                    f'{plan(m, k, n, sm_count("cuda"), 128)}): ' + ', '.join(
                        f'S={s} {t:.4f} ms' for s, t in times.items()))
                del packed, scales
    finally:
        QM.splitk_splits = plan
    return out


def phase_kernels(torch, ctx):
    timer = Timer(torch)
    if ctx.get('parent'):
        load_parent(ctx, ctx['parent'])
    check_gemm(torch, ctx, timer)
    check_decode(torch, ctx, timer)
    check_prefill(torch, ctx, timer)
    check_verify(torch, ctx, timer)
    check_rank_shapes(torch, ctx, timer)
    check_pp_shapes(torch, ctx, timer)
    check_gemm_groups(torch, ctx, timer)


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
    k3 = sum(ms for ms, _, name in rows if 'paged_prefill' in name)
    log(f'    kernel 3 (prefill attention): {k3:.3f} ms, '
        f'{k3 / max(rounds, 1):.4f} ms a verify round' if rounds else
        f'    kernel 3 (prefill attention): {k3:.3f} ms')
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()), reverse=True)[:8]
    log('    host (self CPU time): ' + '; '.join(
        f'{name[:40]} {ms:.1f} ms / {n}x' for ms, n, name in host))
    ctx[f'profile_bs1_{width}'] = dict(
        wall_ms=wall * 1e3, device_ms=busy, busy_share=busy / (wall * 1e3),
        passes=passes, verify_rounds=rounds, launches=launches,
        device_ms_per_pass=busy / max(passes, 1), kernel3_ms=k3,
        top=[(name[:90], ms, n) for ms, n, name in rows[:12]],
        host_top=[(name[:90], ms, n) for ms, n, name in host])


def profile_prefill_pass(torch, ctx, run_request, eng, passes_of):
    """One request that is a single 512-row prefill pass (a 300-token
    prompt, one new token) under torch.profiler: the pass's device ms and
    kernel 3's part of it."""
    out = []
    before = passes_of(eng)
    rows = device_kernels(torch, lambda: run_request(out))
    after = passes_of(eng)
    passes = {k: after[k] - before[k] for k in PASS_KINDS
              if after[k] != before[k]}
    busy = sum(ms for ms, _, _ in rows)
    k3 = sum(ms for ms, _, name in rows if 'paged_prefill' in name)
    log(f'  profile, a request of one 512-row prefill pass (bf16 pool, '
        f'300-token prompt, 1 new token; passes {passes}; '
        f'{ctx.get("card", "?")}): device {busy:.3f} ms, kernel 3 '
        f'{k3:.4f} ms ({sum(n for _, n, name in rows if "paged_prefill" in name)} '
        f'launches); top: ' + '; '.join(f'{name[:40]} {ms:.3f} ms'
                                         for ms, _, name in rows[:4]))
    ctx['profile_prefill_pass_bf16'] = dict(device_ms=busy, kernel3_ms=k3,
                                            passes=passes)


# forward passes by kind: the engine's decode steps and prefill passes,
# and the verify rounds its speculative dispatches run on the device
# (``stats['spec_rounds']`` counts, as the JAX engine does, only rounds up
# to the one in which the last running slot finished)
PASS_KINDS = ('decode_steps', 'spec_rounds', 'prefill_passes', 'ring_rounds')


class DevicePasses:
    """Forward passes by kind so far: wraps ``step.spec_decode_rounds`` to
    count the rounds each dispatch runs (restored by :meth:`close`).  On a
    pipeline engine a prefill pass counts its jobs (rank 0's
    ``StepFns.prefill_jobs``, cleared with the launch counts by
    ``rank_report(reset=True)``), since each job runs every layer once; a
    ring round runs every layer on every microbatch."""

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
                'prefill_passes': sum(eng.fns.prefill_jobs) if eng.pp > 1
                else eng.stats['prefill_passes'],
                'ring_rounds': eng.stats['ring_rounds']}

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
             if any(b[1].get(k, 0) != a[1].get(k, 0)
                    for a, b in zip(marks, marks[1:]))]
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


def teacher_forced_logits(torch, params, cfg, prompt, tokens, dev='cuda'):
    """f32 logits [len(tokens), V] of one forward over the prompt and the
    stream (each row predicts the stream's next token), through the
    kernels, in a pool of its own."""
    from lmdeploy_tpu_torch.kvcache.paged import init_cache
    from lmdeploy_tpu_torch.models.llama import StepBatch, forward
    ids = list(prompt) + list(tokens[:-1])
    t, page = len(ids), 64
    pages = -(-t // page)
    cache = init_cache(cfg.num_layer, pages, page, cfg.kv_head_num,
                       cfg.size_per_head, torch.bfloat16, dev)
    batch = StepBatch(
        ids=torch.tensor([ids], dtype=torch.int32, device=dev),
        positions=torch.arange(t, dtype=torch.int32, device=dev)[None],
        valid=torch.ones((1, t), dtype=torch.bool, device=dev),
        context_len=torch.tensor([t], dtype=torch.int32, device=dev),
        page_table=torch.arange(pages, dtype=torch.int32, device=dev)[None])
    logits, _ = forward(params, cache, batch, cfg, return_all_logits=True)
    return logits[0, len(prompt) - 1:, :cfg.vocab_size].float()


def agree_up_to_near_tie(torch, params, cfg, prompt, ref, got, label,
                         dev='cuda'):
    """``got`` equals ``ref`` (a greedy stream of ``prompt``), or parts
    from it first at a step whose top-2 logit gap in the teacher-forced
    forward of ``ref`` is below 1% of that step's max|logit| (the
    criterion of test_greedy_streams_match_jax_engine); after such a part
    the streams may differ.  Returns the steps that agree."""
    same = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b),
                None)
    if same is None:
        return min(len(ref), len(got))
    lg = teacher_forced_logits(torch, params, cfg, prompt, ref, dev)[same]
    top2 = lg.topk(2).values
    if not float(top2[0] - top2[1]) < 0.01 * float(lg.abs().max()):
        raise AssertionError(f'{label}: streams part at step {same} '
                             'with no near-tie there')
    log(f'  {label}: parts at step {same} of {len(ref)}, a near-tie')
    return same


def device_kernels(torch, fn):
    """The kernels one call of ``fn`` runs, by name: [(device ms, launches,
    name)], most time first (torch.profiler, CUDA activity only, which
    keeps the trace small enough to read back quickly)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, 'self_device_time_total', None)
        if dev is None:
            dev = getattr(e, 'self_cuda_time_total', 0)
        if dev > 0:
            rows.append((dev / 1e3, e.count, e.key))
    return sorted(rows, reverse=True)


def count_kernels(torch, fn):
    """Kernels one call of ``fn`` launches."""
    return sum(n for _, n, _ in device_kernels(torch, fn))


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
    from lmdeploy_tpu_torch.ops.cuda.quant_matmul import (
        WGMMA, gemm_route, sm_count)
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

    def route_mark(eng):
        """(prefill attention's launches by route, passes by kind)."""
        return K.route_counts(), passes_of(eng)

    def check_routes(rmarks, want, label):
        """Kernels 1 and 3's launches by route per pass of each kind
        equal ``want``; returns them (nonzero ones only)."""
        solved = launches_per_kind(rmarks)
        check_route({}, solved, want, f'{label} routes')
        per = {kind: {n: v for n, v in d.items() if v}
               for kind, d in solved[0].items()}
        log(f'    kernel 1 and 3 routes per pass: {per}')
        return per

    def gemm_routes(rows):
        """{GEMM route counter: launches} of one pass of ``rows`` rows
        through the layers' five projections (every M at group 128 takes
        the wgmma regime)."""
        want = {}
        for _, k, n in LLAMA2_7B_GEMMS:
            key = f'{WGMMA}:{gemm_route(rows, k, n, sm_count("cuda"), 128)}'
            want[key] = want.get(key, 0) + nl
        return want

    def record_routes(per_kind, kind, key, owner=None):
        """Note the GEMM's route launches of one pass of ``kind`` on the
        kernels line under each route's ``route_launches``.  The entry of
        route ``owner`` (a route this run is the main-path run of: tiles
        the 512-row bucket's, splitk the verify's) also takes this run's
        launches (counters from 0) and its launches per pass."""
        total = K.route_counts()
        for name, v in per_kind.get(kind, {}).items():
            if name.startswith(WGMMA):
                entry = ctx['kernels'].setdefault(name, {})
                entry.setdefault('route_launches', {})[key] = v
                if name == f'{WGMMA}:{owner}':
                    entry['launches'] = total[name]
                    entry['launches_per_verify_round' if kind == 'spec_rounds'
                          else 'launches_per_prefill_pass'] = v

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
        160 per each, all of them in the wgmma regime."""
        prompt = prompt or bs1_prompt
        decode = f'{decode_kernel_of(env)}[{width}]'
        prefill = f'paged_prefill_attention[{width}]'
        rows = min(b for b in ecfg.prefill_buckets if b >= len(prompt))
        K.reset_launch_counts()
        marks, out = [mark(eng)], []
        rmarks = [route_mark(eng)]
        with env_vars(env):
            for n_new in lens:
                run(inst, prompt, n_new, out)
                marks.append(mark(eng))
                rmarks.append(route_mark(eng))
        counts = K.launch_counts(True)
        solved = launches_per_kind(marks)
        per, _, windows = solved
        label = (f'{width} bs1 {env or "defaults"}, {len(prompt)}-token '
                 f'prompt')
        check_route(counts, solved,
                    {'decode_steps': {'w4a16_gemm': 5 * nl, decode: nl,
                                      WGMMA: 5 * nl},
                     'prefill_passes': {
                         'w4a16_gemm': 5 * nl, prefill: nl,
                         WGMMA: 5 * nl}},
                    label, need=('decode_steps', 'prefill_passes'))
        per_step, per_pass = per['decode_steps'], per['prefill_passes']
        # chunks take route wgmma at every width; the bucket's GEMMs the
        # route gemm_route picks (splitk at 64 rows, tiles at 512)
        route = f'{prefill}:wgmma'
        routes = check_routes(
            rmarks, {'prefill_passes': {route: nl, **gemm_routes(rows)},
                     'decode_steps': gemm_routes(ENGINE_SLOTS)}, label)
        ctx['kernels'].setdefault(prefill, {}).setdefault(
            'route_launches', {})[f'per prefill pass, {rows}-row bucket'] = \
            {n: v for n, v in routes['prefill_passes'].items()
             if n.startswith(prefill)}
        record_routes(routes, 'prefill_passes',
                      f'per prefill pass, {rows}-row bucket',
                      'tiles' if prompt is long_prompt and width == 'bf16'
                      and not env else None)
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
                'decode_steps': {'w4a16_gemm': 5 * nl, decode: nl,
                                 WGMMA: 5 * nl}}
        K.reset_launch_counts()
        marks, out, stats = [mark(eng)], [], []
        rmarks = [route_mark(eng)]
        for n_new in lens:
            before = dict(eng.stats)
            run(inst, [1], n_new, out)
            marks.append(mark(eng))
            rmarks.append(route_mark(eng))
            stats.append({k: eng.stats[k] - before[k] for k in (
                'spec_rounds', 'spec_emitted', 'spec_fallbacks',
                'decode_steps')})
        counts = K.launch_counts(True)
        solved = launches_per_kind(marks)
        per, kinds, windows = solved
        check_route(counts, solved, want, f'{width} spec',
                    need=('spec_rounds',))
        # every verify round takes route split, and its M = 40 GEMMs route
        # splitk
        routes = check_routes(
            rmarks, {'spec_rounds': {f'{prefill}:split': nl, **gemm_routes(
                ENGINE_SLOTS * (SPEC_K + 1))},
                'decode_steps': gemm_routes(ENGINE_SLOTS)}, f'{width} spec')
        ctx['kernels'].setdefault(prefill, {}).setdefault(
            'route_launches', {})['per verify round'] = {
                n: v for n, v in routes['spec_rounds'].items()
                if n.startswith(prefill)}
        if width == 'bf16':
            record_routes(routes, 'spec_rounds', 'per verify round',
                          'splitk')
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

        def recording(*a, **kw):
            shapes.append((tuple(a[4].shape), a[6].tolist()))
            return real(*a, **kw)
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
                    {'decode_steps': {'w4a16_gemm': 5 * nl, decode: nl,
                                      WGMMA: 5 * nl},
                     'prefill_passes': {'w4a16_gemm': 5 * nl, WGMMA: 5 * nl,
                                        prefill: nl}},
                    f'{width} prefix hit', need=('decode_steps',
                                                 'prefill_passes'))
        if hits != [0, 256] or passes != [[((1, 512), [299])],
                                          [((1, 64), [43])]]:
            raise AssertionError(f'{width} prefix hit: hits {hits}, prefill '
                                 f'passes (ids shape, lengths) {passes}')
        agree = [agree_up_to_near_tie(torch, params, cfg, long_prompt,
                                      ref[:len(r['tokens'])], r['tokens'],
                                      f'{width} prefix hit')
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
            profile_prefill_pass(torch, ctx, lambda out: run(
                inst, long_prompt[::-1], 1, out), eng, passes_of)
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
        native = eng.metrics()['native_cache_manager']
        eng.shutdown()
        del eng, inst
        # the same leader and follower on the Python session store: the
        # follower prefills exactly as many tokens as on the native one
        os.environ['LMDEPLOY_TPU_NATIVE'] = '0'
        try:
            eng, inst, hit_py = prefix_hit('bf16', 0, None,
                                           ref_bf16['tokens'])
            python = eng.metrics()['native_cache_manager']
            eng.shutdown()
            del eng, inst
        finally:
            del os.environ['LMDEPLOY_TPU_NATIVE']
        if (native, python) != (1, 0) or any(
                hit_py[k] != hit[k] for k in ('hit_tokens',
                                              'prefill_passes')):
            raise AssertionError(
                f'prefix hit by store: native {native} {hit["hit_tokens"]} '
                f'{hit["prefill_passes"]}, python {python} '
                f'{hit_py["hit_tokens"]} {hit_py["prefill_passes"]}')
        ctx['engine_prefix']['bf16_python_store'] = hit_py
        log(f'  session stores: the follower hit {hit["hit_tokens"][1]} '
            f'tokens and prefilled {hit["prefill_passes"][1]} on the native '
            f'store (the default) and on the Python one '
            f'(LMDEPLOY_TPU_NATIVE=0); TTFT {hit["ttft_follower_s"]:.3f} / '
            f'{hit_py["ttft_follower_s"]:.3f} s')
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


def hf_checkpoint(torch, ctx, cfg) -> dict:
    """The HF checkpoint of phases doors and quant (``cfg``'s widths, seed
    7), written once into a temporary directory that :func:`main` removes
    at the end: {'path', 'bytes', 'write_s'}."""
    if 'hf' not in ctx:
        import tempfile
        root = tempfile.mkdtemp(prefix='lmdeploy-smoke-')
        ctx.setdefault('tmpdirs', []).append(root)
        path = os.path.join(root, 'llama2-hf')
        t0 = time.monotonic()
        size = write_hf_checkpoint(torch, path, cfg, 7)
        ctx['hf'] = dict(path=path, bytes=size,
                         write_s=time.monotonic() - t0)
    return ctx['hf']


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
    ws_q, awq, ws_awq = (os.path.join(tmp, n) for n in (
        'ws-int4', 'llama2-awq', 'ws-awq'))
    engines, proc, convs = [], None, {}
    try:
        # 1. an HF checkpoint (shared with phase quant), 2. convert_hf
        # --quantize
        hf_info = hf_checkpoint(torch, ctx, cfg)
        hf, size = hf_info['path'], hf_info['bytes']
        # the group-64 and group-32 conversions of step 2b, by the
        # converter's command line in processes of their own, run while
        # this one converts and serves at group 128 (numpy quantisation
        # takes one core)
        for group in DOOR_GROUPS:
            convs[group] = Conversion([
                sys.executable, '-m', 'lmdeploy_tpu_torch.convert.converter',
                hf, os.path.join(tmp, f'ws-int4-g{group}'), '--model-name',
                name, '--quantize', '--group-size', str(group)])
        times['hf_write_s'] = hf_info['write_s']
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
                        {'decode_steps': {
                            'w4a16_gemm': 5 * nl, decode: nl,
                            WGMMA: 5 * nl},
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

        # 2b. the same checkpoint quantised at groups 64 and 32 (the
        # converter's command line, --group-size): every GEMM of 4
        # concurrent requests (the 512 bucket), a bs1 request and a
        # speculative request on a kernel, prompt logits against the CPU's
        for group in DOOR_GROUPS:
            out[f'group{group}'] = doors_group(
                torch, ctx, group, convs[group],
                os.path.join(tmp, f'ws-int4-g{group}'), ecfg, prompts,
                long_prompt, n_new, device, stream)

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
        for p in (proc, *(c.proc for c in convs.values())):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        for e in engines:
            e.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    out['times_s'] = times
    ctx['doors'] = out


class Conversion:
    """A command run in a process of its own from the repo's root, and
    the seconds it took (a thread waits on it, so :meth:`wait` does not
    count time spent elsewhere)."""

    def __init__(self, argv):
        self.t0, self.seconds = time.monotonic(), None
        self.proc = subprocess.Popen(
            argv, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
        self._err = []
        self._waiter = threading.Thread(target=self._wait, daemon=True)
        self._waiter.start()

    def _wait(self):
        self._err.append(self.proc.communicate()[1])
        self.seconds = time.monotonic() - self.t0

    def wait(self, timeout=600):
        """Seconds the command took; raises unless it exited 0."""
        self._waiter.join(timeout)
        if self.proc.returncode != 0:
            raise RuntimeError(f'{self.proc.args}: rc {self.proc.returncode}'
                               f'\n{"".join(self._err)[-2000:]}')
        return self.seconds


# phase doors' other groups: 64 (stage pieces of the wgmma kernel) and
# 32 (its step form), each a checkpoint a user quantises with
# --group-size
DOOR_GROUPS = (64, 32)


def doors_group(torch, ctx, group, conversion, ws, ecfg, prompts,
                long_prompt, n_new, device, stream):
    """Phase doors' door at quantisation group ``group``: ``conversion``
    (``python -m lmdeploy_tpu_torch.convert.converter --quantize
    --group-size <group>`` of the phase's HF checkpoint into ``ws``)
    awaited, an engine on it serving ``prompts`` concurrently, a bs1
    request of ``long_prompt`` and one speculative request (k = SPEC_K,
    prompt [1]); launches per decode step, prefill pass and verify round
    solved from the three windows: 5L GEMM, all on kernel 1's wgmma
    routes (the kernels line's ``groups[group]['door_launches']``), 2L
    attention (L = the depth), no plain call; prompt logits of
    ``long_prompt`` within 5% of max|logit| (cosine >= 0.999) of a CPU
    engine's on the same workspace."""
    from lmdeploy_tpu_torch import build_engine
    from lmdeploy_tpu_torch.config import EngineConfig
    from lmdeploy_tpu_torch.ops import cuda as K
    from lmdeploy_tpu_torch.ops.cuda import ROUTE_NAMES
    from lmdeploy_tpu_torch.ops.cuda.quant_matmul import WGMMA
    from lmdeploy_tpu_torch.ops.linear import PackedInt4Weight
    convert_s = conversion.wait()
    t0 = time.monotonic()
    eng = build_engine(ws, engine_config=EngineConfig(**ecfg),
                       device=device)
    load_s = time.monotonic() - t0
    passes = DevicePasses()
    try:
        weights = {n: w for n, w in eng.params['layers'].items()
                   if n in ('wqkv', 'wo', 'w1', 'w3', 'w2')}
        if eng.cfg.group_size != group or not all(
                isinstance(w, PackedInt4Weight)
                and w.k // w.scales.shape[1] == group
                for w in weights.values()):
            raise AssertionError(f'group-{group} workspace: group '
                                 f'{eng.cfg.group_size}, weights {weights}')
        nl = eng.cfg.num_layer
        inst = eng.create_instance()
        K.reset_launch_counts()

        def mark():
            return ({**{n: c[0] for n, c in K.launch_counts(True).items()},
                     **K.route_counts()}, passes(eng))
        marks = [mark()]
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
            raise AssertionError(f'doors group {group}: concurrent requests '
                                 'failed')
        conc_s = time.monotonic() - t0
        marks.append(mark())
        bs1 = stream(inst, long_prompt, n_new)
        marks.append(mark())
        eng.ecfg.speculative_k = SPEC_K
        eng._spec_cooloff, eng._spec_accept_ema = 0, None   # gate open
        spec = stream(inst, [1], n_new)
        eng.ecfg.speculative_k = 0
        marks.append(mark())
        counts = K.launch_counts(True)
        solved = launches_per_kind(marks)
        per = {kind: {n: v for n, v in d.items() if v}
               for kind, d in solved[0].items()}
        if device == 'cuda':
            # 5L GEMM launches a pass of each kind, all on the wgmma
            # routes (their split between splitk and tiles is the plan's),
            # L of the kind's attention kernel, its routes as they come
            attn = {'decode_steps': 'paged_decode_attention_write[bf16]',
                    'prefill_passes': 'paged_prefill_attention[bf16]',
                    'spec_rounds': 'paged_prefill_attention[bf16]'}
            want = {kind: {'w4a16_gemm': 5 * nl, WGMMA: 5 * nl,
                           attn[kind]: nl,
                           **{n: v for n, v in per[kind].items()
                              if n in ROUTE_NAMES}} for kind in per}
            check_route(counts, solved, want, f'doors group {group}',
                        need=tuple(attn))
            for kind, d in per.items():
                gemm_routes = sum(v for n, v in d.items()
                                  if n.startswith(f'{WGMMA}:'))
                attn_routes = sum(v for n, v in d.items()
                                  if n.startswith(f'{attn[kind]}:'))
                if gemm_routes != 5 * nl or attn_routes not in (0, nl):
                    raise AssertionError(
                        f'doors group {group}: per {kind} {d}: GEMM routes '
                        f'{gemm_routes} (want {5 * nl}), {attn[kind]} '
                        f'routes {attn_routes}')
        gemm_n = counts['w4a16_gemm'][0]
        on_routes = {n: v for n, v in K.route_counts().items()
                     if n.startswith(f'{WGMMA}:') and v}
        lg = inst.decode(long_prompt)
    finally:
        passes.close()
        eng.shutdown()
    # the CPU's run in the smallest bucket that holds the prompt
    cpu = build_engine(ws, engine_config=EngineConfig(**dict(
        ecfg, max_batch_size=1, session_len=512, prefill_buckets=(
            64, -(-len(long_prompt) // 64) * 64))), device='cpu')
    try:
        ref = cpu.create_instance().decode(long_prompt)
    finally:
        cpu.shutdown()
    rel, cos = logits_gate(torch, lg, ref, f'doors group-{group} engine '
                           'prompt logits')
    out = dict(convert_s=convert_s, load_s=load_s,
               ttft_s=[r[1] for r in results],
               tok_s_4_concurrent=len(prompts) * (n_new - 1) / conc_s,
               bs1_ttft_s=bs1[1], bs1_tok_s=bs1[2],
               spec_rounds=marks[-1][1]['spec_rounds']
               - marks[-2][1]['spec_rounds'], spec_tok_s=spec[2],
               gemm_launches=gemm_n, route_launches=on_routes,
               launches_per_pass=per, max_rel_err=rel, min_cosine=cos)
    entry = ctx['kernels'].setdefault('w4a16_gemm', {})
    entry.setdefault('groups', {}).setdefault(group, {})['door_launches'] = \
        dict(total=gemm_n, by_route=on_routes, per_pass=per)
    log(f'  group {group} [{ctx.get("card", "?")}]: convert_hf --quantize '
        f'--group-size {group} {convert_s:.1f} s (its own process, beside '
        f'step 2), load {load_s:.1f} s; 4 '
        f'concurrent requests (prompts {[len(p) for p in prompts]}, {n_new} '
        f'new): TTFT {[round(r[1], 3) for r in results]} s, '
        f'{out["tok_s_4_concurrent"]:.1f} tok/s; bs1 {len(long_prompt)}-'
        f'token prompt: TTFT {bs1[1]:.3f} s, {bs1[2]:.1f} tok/s; a '
        f'speculative request: {out["spec_rounds"]} verify rounds, '
        f'{spec[2]:.1f} tok/s; GEMM launches {gemm_n}, by route '
        f'{on_routes}; per pass {per}; prompt logits of '
        f'{len(long_prompt)} tokens vs the CPU: max err / max|logit| '
        f'{rel:.3e}, min cosine {cos:.6f}')
    return out


def cast_tree(torch, tree, dtype, device):
    """A dense parameter tree with every floating tensor as ``dtype`` on
    ``device``."""
    return {k: cast_tree(torch, v, dtype, device) if isinstance(v, dict)
            else v.to(device=device, dtype=dtype) if v.is_floating_point()
            else v.to(device) for k, v in tree.items()}


def kv_scales_from_dynamic(torch, cache):
    """Per-layer static int4 qparams covering what a dynamic pool holds:
    each layer's written rows' (min, min + 15 * scale) envelope through
    the port's kv_qparams formula (asymmetric).  A row counts as written
    where its scale is not the pool's initial 1.0."""
    from lmdeploy_tpu_torch.lite.apis.kv_qparams import qparams_from_stats
    keys, values = {}, {}
    for layer in range(cache.dyn.shape[0]):
        d = cache.dyn[layer].float()
        for j, out in ((0, keys), (2, values)):
            scale, mn = d[..., j, :], d[..., j + 1, :]
            written = scale != 1.0
            lo = float(mn[written].min())
            hi = float((mn + 15 * scale)[written].max())
            out[layer] = dict(min=np.float32(lo), max=np.float32(hi),
                              absmax=np.float32(max(-lo, hi)))
    return qparams_from_stats(keys, values, 4)


def logits_gate(torch, got, want, label):
    """Prompt logits within 5% of max|logit| and cosine >= 0.999 of the
    reference (phase 4's gates); returns (rel, cos)."""
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    rel = float((got - want).abs().max() / want.abs().max())
    cos = float(torch.nn.functional.cosine_similarity(got, want,
                                                      dim=-1).min())
    if got.shape != want.shape or not (rel <= 0.05 and cos >= 0.999):
        raise AssertionError(f'{label}: shape {tuple(got.shape)} vs '
                             f'{tuple(want.shape)}, max err / max|logit| '
                             f'{rel:.3e} (tol 0.05), min cosine {cos:.6f} '
                             '(tol 0.999)')
    return rel, cos


def phase_quant(torch, ctx):
    """The quantisation toolkit and the int4 pools it feeds, at Llama-2-7B
    width (see :func:`quant`)."""
    quant(torch, ctx, llama2_7b(num_layer=2), 'cuda', deep_cfg=llama2_7b())


def quant(torch, ctx, cfg, device, deep_cfg=None, samples=16, seqlen=512,
          lens=(16, 100, 300, 500), n_new=64, bs1_new=256, deep_new=32,
          deep_conc_new=32, prompt_len=300, prof_new=4):
    """A user quantises the doors phase's HF checkpoint on ``device``
    through ``cli.main lite`` and serves it: ``lite calibrate``
    (``samples`` x ``seqlen`` synthetic ids; the first 2 samples' stats
    against a CPU f32 calibration, each stat within 2% of its max
    |value|), ``lite auto_awq`` from those stats and
    an engine on the workspace with a dynamic int4 pool (quant_policy 8,
    no scales: 4 concurrent requests and a bs1 one, prompt logits against
    the CPU's dynamic-int4 forward, and one store's bytes against the
    plain version's), ``lite kv_qparams --kv-bits 4 --per-head`` (a bs1
    request, logits against the CPU) and ``--kv-bits 4`` per layer
    (kernels 2 and 3 launch as before).  With ``deep_cfg`` (32 layers,
    random W4A16 weights) a dynamic and a static int4 pool serve the same
    traffic on the same engine configuration: tok/s, TTFT, peak memory
    and, on the card, device ms per token."""
    import shutil
    import tempfile

    from lmdeploy_tpu_torch import build_engine
    from lmdeploy_tpu_torch.config import EngineConfig
    from lmdeploy_tpu_torch.engine.engine import TorchEngine
    from lmdeploy_tpu_torch.kvcache import paged
    from lmdeploy_tpu_torch.cli.main import main as cli_main
    from lmdeploy_tpu_torch.lite.quantization.calibration import (
        CalibrationContext, load_model)
    from lmdeploy_tpu_torch.messages import GenerationConfig, ResponseType
    from lmdeploy_tpu_torch.models.llama import random_packed_params
    from lmdeploy_tpu_torch.ops import cuda as K
    from lmdeploy_tpu_torch.ops.cuda.quant_matmul import WGMMA
    on_card = device == 'cuda'
    card = ctx.get('card', '?')
    nl = cfg.num_layer
    hf = hf_checkpoint(torch, ctx, cfg)['path']
    ecfg = dict(max_batch_size=8, session_len=2048, page_size=64,
                num_pages=88, max_context_token_num=512,
                prefill_buckets=(64, 512), step_length=16,
                enable_prefix_caching=False, quant_policy=8)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n in lens]
    long_prompt = rng.integers(3, cfg.vocab_size, size=prompt_len).tolist()
    sid = iter(range(1, 10 ** 6))
    out, times, engines = {}, {}, []

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(key, fn, *a, **kw):
        t0 = time.monotonic()
        res = fn(*a, **kw)
        sync()
        times[key] = time.monotonic() - t0
        return res

    def stream(inst, prompt, n):
        """One greedy request of n tokens: (tokens, TTFT s, tok/s after
        the first token, (first, end) monotonic times)."""
        t0, first = time.monotonic(), None
        for last in inst.stream_infer(next(sid), prompt, GenerationConfig(
                max_new_tokens=n, top_k=1, ignore_eos=True),
                sequence_end=True):
            if last.num_generated and first is None:
                first = time.monotonic()
        if last.status != ResponseType.FINISH or last.num_generated != n:
            raise AssertionError(f'quant: request of {len(prompt)} tokens: '
                                 f'{last.num_generated} tokens, '
                                 f'{last.status}')
        t1 = time.monotonic()
        return (list(last.token_ids), (first or t1) - t0,
                (n - 1) / max(t1 - (first or t1), 1e-9), (first or t1, t1))

    def mark(eng):
        return ({n: c[0] for n, c in K.launch_counts(True).items()},
                {'decode_steps': eng.stats['decode_steps'], 'spec_rounds': 0,
                 'prefill_passes': eng.stats['prefill_passes']})

    def serve(eng, label, want, bs1=bs1_new, new=n_new):
        """4 concurrent requests, then a bs1 one; ``want`` is the route's
        launches ({kind: {kernel: per pass}}) on the card."""
        inst = eng.create_instance()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        marks, results = [mark(eng)], [None] * len(prompts)

        def worker(i):
            results[i] = stream(inst, prompts[i], new)
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if any(r is None for r in results):
            raise AssertionError(f'{label}: concurrent requests failed')
        marks.append(mark(eng))
        tokens, ttft, tps, _ = stream(inst, prompts[0][:16], bs1)
        marks.append(mark(eng))
        counts = K.launch_counts(True)
        conc = len(prompts) * (new - 1) / (
            max(r[3][1] for r in results) - min(r[3][0] for r in results))
        res = dict(ttft_s=[r[1] for r in results], tok_s_4_concurrent=conc,
                   ttft_bs1_s=ttft, tok_s_bs1=tps)
        if on_card:
            check_route(counts, launches_per_kind(marks, skip=(WGMMA,)),
                        want, label, need=('decode_steps', 'prefill_passes'))
            res['peak_mem_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
            res['launches'] = {n: c[0] for n, c in counts.items() if c[0]}
        log(f'  {label} [{card}]: 4 concurrent (prompts {list(lens)}, {new} '
            f'new): TTFT {[round(x, 3) for x in res["ttft_s"]]} s, '
            f'{conc:.1f} tok/s; bs1 ({bs1} new): TTFT {ttft:.3f} s, '
            f'{tps:.1f} tok/s; peak memory '
            f'{res.get("peak_mem_gib", float("nan")):.2f} GiB; launches '
            f'{res.get("launches")}')
        return inst, res

    def cpu_logits(extra=None):
        eng = build_engine(ws, engine_config=EngineConfig(**dict(
            ecfg, max_batch_size=1, session_len=512, **(extra or {}))),
            device='cpu')
        try:
            return eng.create_instance().decode(long_prompt)
        finally:
            eng.shutdown()

    def lite(key, *argv):
        """``cli.main lite <argv>``, timed as times[key]; raises unless it
        returns 0."""
        rc = timed(key, cli_main, ['lite'] + [str(a) for a in argv])
        if rc != 0:
            raise AssertionError(f'lite {argv}: rc {rc}')

    laps = [time.monotonic()]

    def lap(key):
        """Seconds since the previous lap, as times[key]."""
        laps.append(time.monotonic())
        times[key] = laps[-1] - laps[-2]

    gemm = {'w4a16_gemm': 5 * nl}
    tmp = tempfile.mkdtemp(prefix='lmdeploy-quant-')
    work, ws = os.path.join(tmp, 'work'), os.path.join(tmp, 'ws')
    try:
        # 1. lite calibrate on the device: kernel 3 in every layer of
        # every sample's pass (dense bf16 projections on torch.matmul)
        K.reset_launch_counts()
        lite('calibrate_s', 'calibrate', hf, '--calib-samples', samples,
             '--calib-seqlen', seqlen, '--work-dir', work, '--device',
             device)
        counts = K.launch_counts(True)
        if on_card:
            pre = 'paged_prefill_attention[bf16]'
            got = {n: c for n, c in counts.items() if c != (0, 0)}
            if got != {pre: (samples * nl, 0)}:
                raise AssertionError(f'calibrate: launches {got}, want '
                                     f'{samples * nl} of {pre} only')
            ctx['kernels'].setdefault(pre, {})['quant_launches'] = \
                samples * nl
        # the first 2 samples' stats on the device against the CPU's f32
        gen = torch.Generator().manual_seed(0)
        first2 = [torch.randint(0, cfg.vocab_size, (1, seqlen),
                                generator=gen) for _ in range(2)]
        t0 = time.monotonic()
        cpu_cfg, cpu_params = load_model(hf, 'cpu')
        stats = {}
        for side, params in (('cpu', cpu_params),
                             ('device', cast_tree(torch, cpu_params,
                                                  torch.bfloat16, device))):
            c = CalibrationContext(cpu_cfg, params, 'llama')
            for ids in first2:
                c.step(ids)
            stats[side] = c.export()
            del c, params
        del cpu_params
        times['compare_s'] = time.monotonic() - t0
        gaps = {k: float(np.abs(stats['device'][k] - want).max()
                         / max(float(np.abs(want).max()), 1e-30))
                for k, want in stats['cpu'].items()}
        worst = max(gaps, key=gaps.get)
        if sorted(stats['device']) != sorted(stats['cpu']) or \
                gaps[worst] > 0.02:
            raise AssertionError(f'calibration stats, device vs CPU: '
                                 f'largest gap {gaps[worst]:.3e} of max|stat|'
                                 f' at {worst} (tol 0.02)')
        out['calibration'] = dict(largest_gap=gaps[worst], at=worst,
                                  stats=len(gaps))
        log(f'  lite calibrate [{card}]: {samples} x {seqlen} synthetic ids '
            f'in {times["calibrate_s"]:.1f} s ({samples * nl} prefill '
            f'attention launches); first 2 samples, bf16 on the device vs f32 '
            f'on the CPU: largest stat gap {gaps[worst]:.3e} of that stat\'s '
            f'max |value| ({worst}; {len(gaps)} stats; tol 0.02), '
            f'{times["compare_s"]:.1f} s')

        lap('step1_s')
        # 2. lite auto_awq from the device's stats; a dynamic int4 pool
        lite('auto_awq_s', 'auto_awq', hf, '--work-dir', work, '--dst', ws,
             '--w-group-size', cfg.group_size or 128, '--device', device)
        eng = timed('load_dynamic_s', build_engine, ws,
                    engine_config=EngineConfig(**ecfg), device=device)
        engines.append(eng)
        if not eng.cache.dynamic_scales:
            raise AssertionError('quant_policy 8 without scales: not a '
                                 'dynamic pool')
        inst, out['dynamic'] = serve(eng, 'AWQ workspace, dynamic int4 pool',
                                     {'decode_steps': gemm,
                                      'prefill_passes': gemm})
        if on_card:
            ctx['kernels'].setdefault('w4a16_gemm', {})['quant_launches'] = \
                out['dynamic']['launches']['w4a16_gemm']
        t0 = time.monotonic()
        lg = inst.decode(long_prompt)
        times['dynamic_decode_s'] = time.monotonic() - t0
        eng.shutdown()
        out['dynamic']['logits'] = logits_gate(
            torch, lg, timed('cpu_logits_dynamic_s', cpu_logits),
            'dynamic pool prompt logits')
        # one store of the same K/V rows on the device and on the CPU
        g = torch.Generator().manual_seed(4)
        kh, dh = cfg.kv_head_num, cfg.size_per_head
        rows = [(torch.randn((8, 64, kh, dh), generator=g) * 2).to(
            torch.bfloat16) for _ in range(2)]
        pos = torch.arange(64, dtype=torch.int32).expand(8, 64)
        pt = torch.arange(16, dtype=torch.int32).reshape(8, 2)
        pools = {}
        for dev in ('cpu', device):
            c = paged.init_cache(nl, 16, 64, kh, dh, torch.uint8, dev,
                                 dynamic_scales=True)
            paged.write_kv_dynamic(c.k, c.v, c.dyn, nl - 1,
                                   rows[0].to(dev), rows[1].to(dev),
                                   pos.to(dev), pt.to(dev),
                                   torch.ones((8, 64), dtype=torch.bool,
                                              device=dev))
            pools[dev] = [x.cpu() for x in (c.k, c.v, c.dyn)]
        a, b = pools['cpu'], pools[device]
        steps = (a[2].view(torch.int32) - b[2].view(torch.int32)).abs()
        share = float((steps != 0).float().mean())
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])) or \
                int(steps.max()) > 2 or share > 5e-3:
            raise AssertionError(f'dynamic store, device vs plain: codes '
                                 f'equal {torch.equal(a[0], b[0])}/'
                                 f'{torch.equal(a[1], b[1])}, qparams '
                                 f'{int(steps.max())} steps on {share:.2e}')
        out['dynamic']['store'] = dict(max_steps=int(steps.max()),
                                       share=share)
        log(f'  dynamic pool [{card}]: prompt logits ({prompt_len}) vs the '
            f'CPU: max err / max|logit| {out["dynamic"]["logits"][0]:.3e}, '
            f'min cosine {out["dynamic"]["logits"][1]:.6f}; one store of '
            f'[8, 64, {kh}, {dh}] K/V rows: codes identical, qparams '
            f'{int(steps.max())} f32 steps apart on {share:.2e} of values; '
            f'auto_awq {times["auto_awq_s"]:.1f} s, load '
            f'{times["load_dynamic_s"]:.1f} s')

        lap('step2_s')
        # 3. lite kv_qparams --kv-bits 4 --per-head, then per layer
        lite('kv_qparams_per_head_s', 'kv_qparams', work, ws, '--kv-bits', 4,
             '--per-head')
        eng = build_engine(ws, engine_config=EngineConfig(**ecfg),
                           device=device)
        engines.append(eng)
        if not eng.cache.per_head:
            raise AssertionError('kv_qparams --per-head: not a per-head pool')
        inst = eng.create_instance()
        K.reset_launch_counts()
        marks = [mark(eng)]
        for n in (32, 8):
            stream(inst, prompts[1], n)
            marks.append(mark(eng))
        if on_card:
            check_route(K.launch_counts(True), launches_per_kind(
                marks, skip=(WGMMA,)), {'decode_steps': gemm,
                                        'prefill_passes': gemm},
                'per-head int4 pool', need=('decode_steps',
                                            'prefill_passes'))
        lg = inst.decode(long_prompt)
        eng.shutdown()
        out['per_head'] = dict(logits=logits_gate(
            torch, lg, timed('cpu_logits_per_head_s', cpu_logits),
            'per-head pool prompt logits'))
        lite('kv_qparams_s', 'kv_qparams', work, ws, '--kv-bits', 4)
        eng = build_engine(ws, engine_config=EngineConfig(**ecfg),
                           device=device)
        engines.append(eng)
        if eng.cache.per_head or eng.cache.dynamic_scales:
            raise AssertionError('kv_qparams --kv-bits 4: not a per-layer '
                                 'pool')
        inst = eng.create_instance()
        K.reset_launch_counts()
        marks = [mark(eng)]
        for n in (32, 8):
            stream(inst, prompts[1], n)
            marks.append(mark(eng))
        counts = K.launch_counts(True)
        if on_card:
            dec, pre = ('paged_decode_attention_write[int4]',
                        'paged_prefill_attention[int4]')
            check_route(counts, launches_per_kind(marks, skip=(WGMMA,)),
                        {'decode_steps': {**gemm, dec: nl},
                         'prefill_passes': {**gemm, pre: nl}},
                        'per-layer int4 pool from kv_qparams',
                        need=('decode_steps', 'prefill_passes'))
            for n in (dec, pre):
                ctx['kernels'].setdefault(n, {})['quant_launches'] = \
                    counts[n][0]
        eng.shutdown()
        log(f'  per-head pool [{card}]: prompt logits vs the CPU: max err / '
            f'max|logit| {out["per_head"]["logits"][0]:.3e}, min cosine '
            f'{out["per_head"]["logits"][1]:.6f}; kv_qparams '
            f'{times["kv_qparams_per_head_s"]:.2f} s (per head), '
            f'{times["kv_qparams_s"]:.2f} s (per layer, kernels 2 and 3 '
            'launch)')

        lap('step3_s')
        # 4. full depth: dynamic against static int4 on one engine config
        if deep_cfg is not None:
            dn = deep_cfg.num_layer
            params = random_packed_params(deep_cfg, 5, device)
            deep_ecfg = EngineConfig(**dict(ecfg, speculative_k=0))
            scales, deep = None, {}
            for label in ('dynamic', 'static'):
                if on_card:
                    torch.cuda.empty_cache()
                eng = TorchEngine(deep_cfg, deep_ecfg, params,
                                  device=device,
                                  kv_scales=scales)
                engines.append(eng)
                want = {'w4a16_gemm': 5 * dn}
                want_step, want_pass = dict(want), dict(want)
                if label == 'static':
                    want_step['paged_decode_attention_write[int4]'] = dn
                    want_pass['paged_prefill_attention[int4]'] = dn
                _, deep[label] = serve(
                    eng, f'{dn} layers, {label} int4 pool',
                    {'decode_steps': want_step,
                     'prefill_passes': want_pass},
                    bs1=deep_new, new=deep_conc_new)
                lap(f'deep_{label}_serve_s')
                if label == 'dynamic':
                    scales = kv_scales_from_dynamic(torch, eng.cache)
                if on_card:
                    # device time of a bs1 request of prof_new tokens, per
                    # forward pass (a decode round runs step_length steps
                    # whatever the request needs; at bs1 a step is a token)
                    inst = eng.create_instance()
                    t0, before = time.monotonic(), mark(eng)[1]
                    rows = device_kernels(torch, lambda: stream(
                        inst, prompts[0], prof_new))
                    wall, after = time.monotonic() - t0, mark(eng)[1]
                    passes = sum(after[k] - before[k] for k in after)
                    dev_ms = sum(r[0] for r in rows)
                    deep[label].update(
                        device_ms_per_token=dev_ms / passes,
                        launches_per_pass=sum(r[1] for r in rows) / passes,
                        top_kernels=[(n[:60], ms, c)
                                     for ms, c, n in rows[:6]])
                    log(f'    device time, bs1 {prof_new} new '
                        f'({label}): {dev_ms:.1f} ms over {passes} forward '
                        f'passes, {wall:.1f} s wall with the profiler; '
                        + '; '.join(
                            f'{n[:50]} {ms:.1f} ms / {c}x'
                            for ms, c, n in rows[:5]))
                    lap(f'deep_{label}_profile_s')
                eng.shutdown()
            del params
            out['deep'] = deep
            log(f'  {dn} layers [{card}]: dynamic vs static int4 pool: bs1 '
                f'{deep["dynamic"]["tok_s_bs1"]:.1f} vs '
                f'{deep["static"]["tok_s_bs1"]:.1f} tok/s, 4 concurrent '
                f'{deep["dynamic"]["tok_s_4_concurrent"]:.1f} vs '
                f'{deep["static"]["tok_s_4_concurrent"]:.1f} tok/s, TTFT bs1 '
                f'{deep["dynamic"]["ttft_bs1_s"]:.3f} vs '
                f'{deep["static"]["ttft_bs1_s"]:.3f} s, device ms / token '
                f'{deep["dynamic"].get("device_ms_per_token", float("nan")):.2f}'
                f' vs '
                f'{deep["static"].get("device_ms_per_token", float("nan")):.2f}'
                f', peak memory '
                f'{deep["dynamic"].get("peak_mem_gib", float("nan")):.2f} vs '
                f'{deep["static"].get("peak_mem_gib", float("nan")):.2f} GiB')
    finally:
        for e in engines:
            e.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    out['times_s'] = times
    ctx['quant'] = out
    log(f'  quant times (s) [{card}]: '
        + ', '.join(f'{k} {v:.1f}' for k, v in times.items()))


# ---------------------------------------------------------------------------
# phases parallel and pipeline: ranks sharing the card
# ---------------------------------------------------------------------------

RANK_ECFG = dict(max_batch_size=8, session_len=2048, page_size=64,
                 num_pages=88, max_context_token_num=512,
                 prefill_buckets=(64, 512), step_length=16, speculative_k=0,
                 enable_prefix_caching=False)


class Rig:
    """What the phases parallel and pipeline share: one model config, one
    EngineConfig (``ecfg_kw``, else RANK_ECFG) and its requests (seeded
    prompts of ``lens`` tokens, a ``bs1_len``-token bs1 prompt, a
    ``logits_len``-token logits prompt, a seeded sampled config of
    ``n_new``), engines started and stopped with their ranks, streams
    timed, launches solved per rank from windows between marks."""

    def __init__(self, torch, ctx, cfg, device, lens=(16, 100, 300, 500),
                 n_new=32, bs1_len=100, logits_len=300, ecfg_kw=None,
                 timeout=300.0):
        from lmdeploy_tpu_torch.config import EngineConfig
        from lmdeploy_tpu_torch.messages import GenerationConfig
        from lmdeploy_tpu_torch.ops import cuda as K
        self.torch, self.cfg, self.device = torch, cfg, device
        self.on_card = device == 'cuda'
        self.card = ctx.get('card', '?')
        self.timeout = timeout
        self.ecfg = EngineConfig(**(ecfg_kw or RANK_ECFG))
        rng = np.random.default_rng(9)
        v = cfg.vocab_size
        self.prompts = [rng.integers(3, v, size=n).tolist() for n in lens]
        self.bs1_prompt = rng.integers(3, v, size=bs1_len).tolist()
        self.logits_prompt = rng.integers(3, v, size=logits_len).tolist()
        self.n_new = n_new
        self.sampled = GenerationConfig(
            max_new_tokens=n_new, top_k=40, top_p=0.9, temperature=0.8,
            repetition_penalty=1.1, random_seed=7, ignore_eos=True)
        self.sid = iter(range(1, 10 ** 6))
        self.names = K.KERNEL_NAMES + K.REGIME_NAMES
        self.passes_of = DevicePasses()
        self.summary = {}

    @staticmethod
    def greedy(n):
        from lmdeploy_tpu_torch.messages import GenerationConfig
        return GenerationConfig(max_new_tokens=n, top_k=1, ignore_eos=True)

    def stream(self, inst, prompt, gen, session=None, **kw):
        from lmdeploy_tpu_torch.messages import ResponseType
        t0, first, last = time.monotonic(), None, None
        for last in inst.stream_infer(session or next(self.sid), prompt, gen,
                                      **kw):
            if last.num_generated and first is None:
                first = time.monotonic()
        if last.status != ResponseType.FINISH \
                or last.num_generated != gen.max_new_tokens:
            raise AssertionError(f'request of {len(prompt)} tokens: '
                                 f'{last.num_generated}, {last.status}')
        end = time.monotonic()
        return dict(tokens=list(last.token_ids), ttft=first - t0,
                    tok_s=(last.num_generated - 1) / max(end - first, 1e-9))

    def concurrent(self, inst, prompts, n, **kw):
        out = [None] * len(prompts)
        sids = [next(self.sid) for _ in prompts]

        def one(i):
            out[i] = self.stream(inst, prompts[i], self.greedy(n),
                                 session=sids[i], **kw)
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(o is None for o in out):
            raise AssertionError('a concurrent request failed')
        rate = len(prompts) * (n - 1) / (time.monotonic() - t0)
        return [o['tokens'] for o in out], rate, sids

    def mark(self, eng):
        """Every rank's (launch counts, passes so far), and the reports."""
        reports = eng.fns.rank_report()
        passes = self.passes_of(eng)
        return [({n: r['launches'].get(n, 0) for n in self.names}, passes)
                for r in reports], reports

    def check_ranks(self, label, marks, reports, want, need):
        """Each rank's launches per pass of each kind, solved from the
        windows between marks, equal ``want`` ({kind: {name: launches}}),
        the kinds in ``need`` ran, and no plain version ran (on the card).
        Returns each rank's solved launches."""
        from lmdeploy_tpu_torch.ops.cuda.quant_matmul import WGMMA
        per_rank = []
        for rank, rep in enumerate(reports):
            rank_marks = [m[rank] for m in marks]
            solved = launches_per_kind(rank_marks, skip=(WGMMA,))
            counts = {n: (rep['launches'].get(n, 0),
                          rep['plain_calls'].get(n, 0)) for n in self.names}
            if self.on_card:
                check_route(counts, solved, want, f'{label} rank {rank}',
                            need=need)
            per_rank.append({k: {n: x for n, x in solved[0][k].items() if x}
                             for k in solved[1]})
        return per_rank

    def logits_gate(self, ref, got, label):
        """Prompt logits within 5% of max|logit| with cosine >= 0.999."""
        torch = self.torch
        rel = float((ref - got).abs().max() / ref.abs().max())
        cos = float(torch.nn.functional.cosine_similarity(
            ref.flatten().double(), got.flatten().double(), dim=0))
        if not (rel <= 0.05 and cos >= 0.999):
            raise AssertionError(f'{label} prompt logits: {rel:.3e} of '
                                 f'max|logit|, cosine {cos:.6f}')
        return rel, cos

    def start(self, mcfg, params, **kw):
        """A started engine and its start time; rank 0's peak memory while
        it prepares the ranks' blocks goes to ``summary``, and the peak is
        reset for the serving that follows."""
        import dataclasses

        from lmdeploy_tpu_torch.engine.engine import TorchEngine
        torch = self.torch
        t0 = time.monotonic()
        if self.on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        eng = TorchEngine(mcfg, dataclasses.replace(self.ecfg, **kw), params,
                          device=self.device, rank_timeout=self.timeout)
        if self.on_card:
            self.summary.setdefault('start_peak_gib_rank0', {})[str(kw)] = \
                torch.cuda.max_memory_allocated() / 2 ** 30
            torch.cuda.reset_peak_memory_stats()
        return eng, time.monotonic() - t0

    def stop(self, eng, label):
        t0 = time.monotonic()
        eng.shutdown()
        took = time.monotonic() - t0
        if eng.rank_exitcodes != [0] * len(eng.rank_exitcodes) \
                or took > 30.0:
            raise AssertionError(f'{label}: ranks exited '
                                 f'{eng.rank_exitcodes} in {took:.1f} s')
        return took

    def placement(self, world):
        """How ``world`` ranks sit on this machine's cards; rates of ranks
        that share one card are not a tp / pp speed."""
        if self.on_card and self.torch.cuda.device_count() >= world:
            return 'a card per rank'
        return 'ranks sharing one card: not a tp / pp speed'

    def close(self):
        self.passes_of.close()


# phases parallel and pipeline: phase 5's model at 8 of its 32 layers
# (what the time limit leaves; ranks sharing one card serve host-bound, so
# their time follows the depth)
PARALLEL_LAYERS = 8


def phase_parallel(torch, ctx):
    parallel(torch, ctx, llama2_7b(num_layer=PARALLEL_LAYERS), 'cuda')


def ms_or_dash(ms):
    return '-' if ms is None else f'{ms:.4f}'


def parallel(torch, ctx, cfg, device, shallow=4, bs1_new=32, **rig_kw):
    """Tensor and data parallelism at ``cfg``'s width on ``device``: a
    tp = 1 engine, then tp = 2 (two ranks, the second a spawned process),
    each serving
    a bs1 greedy request from a ``bs1_len``-token prompt on plain and on
    speculative rounds (k = SPEC_K), 4 concurrent requests, prompt logits
    and a seeded sampled request twice.  tp = 2's greedy streams equal
    tp = 1's up to near-ties, its prompt logits lie within 5% of max|logit|
    (cosine >= 0.999), the seeded runs are identical, every rank launches
    5L GEMMs and L decode attentions per decode step and L prefill
    attentions per pass (and per verify round) with no plain call, the
    ranks' readback digests are equal and every rank exits 0 within 30 s.
    Then dp = 2 (4 concurrent requests over two groups, a continued
    session stays in its group) against tp = 1, and dp x tp = 2 x 2 (four
    ranks) at ``shallow`` layers against 1 x 1.  Ranks get a card each when
    the machine has enough, else they share the first over gloo, and then
    their rates are not a tp speed.  The tp = 1 and the shallow 1 x 1 runs
    stay in ``ctx`` for phase pipeline."""
    import dataclasses

    from lmdeploy_tpu_torch.models.llama import random_packed_params
    rig = Rig(torch, ctx, cfg, device, **rig_kw)
    on_card, card, ecfg, summary = rig.on_card, rig.card, rig.ecfg, \
        rig.summary
    prompts, bs1_prompt, n_new = rig.prompts, rig.bs1_prompt, rig.n_new
    greedy, stream, concurrent, mark = (rig.greedy, rig.stream,
                                        rig.concurrent, rig.mark)
    start, stop, placement = rig.start, rig.stop, rig.placement
    nl = cfg.num_layer
    gemm = {'w4a16_gemm': 5 * nl}
    want_launches = {
        'decode_steps': dict(gemm,
                             **{'paged_decode_attention_write[bf16]': nl}),
        'spec_rounds': dict(gemm, **{'paged_prefill_attention[bf16]': nl}),
        'prefill_passes': dict(gemm,
                               **{'paged_prefill_attention[bf16]': nl})}

    def serve(eng, label):
        """The tp script on one engine: windows for the launch solve, then
        prompt logits and the seeded sampled pair."""
        inst = eng.create_instance()
        eng.fns.rank_report(reset=True)
        t0 = time.monotonic()
        marks, reports = [], None
        m, first = mark(eng)
        marks.append(m)
        out = {'bs1': stream(inst, bs1_prompt, greedy(bs1_new),
                             sequence_end=True)}
        m, after = mark(eng)
        marks.append(m)
        # each rank's host ms a decode step of the bs1 request: issuing
        # the step's launches, and waiting for the readback
        steps = m[0][1]['decode_steps'] - marks[0][0][1]['decode_steps']
        out['host_ms_per_step'] = [
            {k: round((b['host_s'][k] - a['host_s'][k]) * 1e3 / steps, 2)
             for k in a['host_s']} for a, b in zip(first, after)]
        eng.ecfg.speculative_k = SPEC_K
        before = dict(eng.stats)
        try:
            out['bs1_spec'] = stream(inst, bs1_prompt, greedy(bs1_new),
                                     sequence_end=True)
        finally:
            eng.ecfg.speculative_k = 0
        out['spec_rounds'] = eng.stats['spec_rounds'] \
            - before['spec_rounds']
        marks.append(mark(eng)[0])
        out['concurrent'], out['conc_tok_s'], _ = concurrent(
            inst, prompts, n_new, sequence_end=True)
        m, reports = mark(eng)
        marks.append(m)
        out['launches'] = rig.check_ranks(
            label, marks, reports, want_launches,
            need=('decode_steps', 'spec_rounds', 'prefill_passes'))
        out['rank_launches'] = [
            {n: c for n, c in r['launches'].items() if c} for r in reports]
        out['logits'] = torch.from_numpy(inst.decode(rig.logits_prompt))
        out['sampled'] = [stream(inst, prompts[0], rig.sampled,
                                 sequence_end=True)['tokens']
                          for _ in range(2)]
        out['wall'] = time.monotonic() - t0
        out['reports'] = eng.fns.rank_report()
        out['collective_ms'] = eng.fns.collective_ms()
        return out

    def describe(label, eng, res, start_s, stop_s):
        peaks = [round(r['peak_bytes'] / 2 ** 30, 2)
                 for r in res['reports']]
        backend = eng.ranks.backend if eng.ranks is not None else '-'
        world = eng.tp * eng.dp
        log(f'  {label} [{card}]: start {start_s:.1f} s, serve '
            f'{res["wall"]:.1f} s, stop {stop_s:.1f} s; bs1 '
            f'{res["bs1"]["tok_s"]:.1f} tok/s plain, '
            f'{res["bs1_spec"]["tok_s"]:.1f} on verify rounds '
            f'({res["spec_rounds"]} rounds), 4 concurrent '
            f'{res["conc_tok_s"]:.1f} tok/s, TTFT bs1 '
            f'{res["bs1"]["ttft"]:.3f} s ({placement(world)}; device '
            f'collectives over {backend}); peak memory per '
            f'rank while serving {peaks} GiB; one activation all-reduce '
            f'[{ecfg.max_batch_size}, {cfg.hidden_size}] '
            f'{ms_or_dash(res["collective_ms"])} ms; host ms a bs1 decode '
            f'step by rank {res["host_ms_per_step"]}; launches per pass, '
            f'rank 0: '
            f'{res["launches"][0]}')
        summary[label] = dict(
            start_s=start_s, serve_s=res['wall'], stop_s=stop_s,
            tok_s_bs1=res['bs1']['tok_s'],
            tok_s_bs1_spec=res['bs1_spec']['tok_s'],
            tok_s_4_concurrent=res['conc_tok_s'],
            ttft_bs1_s=res['bs1']['ttft'], peak_gib_per_rank=peaks,
            backend=backend, launches_per_pass=res['launches'],
            collective_ms=res['collective_ms'],
            host_ms_per_step=res['host_ms_per_step'])

    t_phase = time.monotonic()
    params = random_packed_params(cfg, 5, device)
    eng, t_start = start(cfg, params)
    try:
        one = serve(eng, 'tp=1')
    finally:
        t_stop = stop(eng, 'tp=1')
    describe('tp=1', eng, one, t_start, t_stop)
    del eng
    eng, t_start = start(cfg, params, tp=2)
    try:
        if eng.ranks.backend != ('gloo' if torch.cuda.device_count() < 2
                                 or not on_card else 'nccl'):
            raise AssertionError(f'device group {eng.ranks.backend}')
        two = serve(eng, 'tp=2')
    finally:
        t_stop = stop(eng, 'tp=2')
    describe('tp=2', eng, two, t_start, t_stop)
    # followers' final reports: every frame replayed, same readback bytes
    digests = {r['readback_sha256'] for r in two['reports']}
    if len(digests) != 1 or len(eng.rank_reports) != 1:
        raise AssertionError(f'tp=2 readback digests {digests}, final '
                             f'reports {len(eng.rank_reports)}')
    frames = eng.rank_reports[0]['frames']
    del eng
    agreed = [agree_up_to_near_tie(torch, params, cfg, bs1_prompt,
                                   one['bs1']['tokens'], two['bs1']['tokens'],
                                   'tp=2 bs1', device),
              agree_up_to_near_tie(torch, params, cfg, bs1_prompt,
                                   one['bs1_spec']['tokens'],
                                   two['bs1_spec']['tokens'],
                                   'tp=2 bs1 speculative', device)]
    agreed += [agree_up_to_near_tie(torch, params, cfg, p, a, b,
                                    f'tp=2 concurrent {len(p)}', device)
               for p, a, b in zip(prompts, one['concurrent'],
                                  two['concurrent'])]
    if two['sampled'][0] != two['sampled'][1]:
        raise AssertionError('tp=2: the seeded sampled runs differ')
    rel, cos = rig.logits_gate(one['logits'], two['logits'], 'tp=2')
    log(f'  tp=2 against tp=1: greedy steps agreeing {agreed} (of '
        f'{[len(one["bs1"]["tokens"]), len(one["bs1_spec"]["tokens"])]} + '
        f'{n_new} each); prompt logits ({len(rig.logits_prompt)}) '
        f'{rel:.3e} of max|logit|, cosine {cos:.6f}; seeded sampled pair '
        f'identical; readback digests equal; follower replayed {frames} '
        'frames')
    summary['tp2_vs_tp1'] = dict(agreed=agreed, logits_rel=rel,
                                 logits_cos=cos, frames=frames)
    for name in ('w4a16_gemm', 'paged_decode_attention_write[bf16]',
                 'paged_prefill_attention[bf16]'):
        if on_card:
            ctx['kernels'].setdefault(name, {})['tp2_launches'] = [
                r.get(name, 0) for r in two['rank_launches']]

    # dp = 2: two groups of one rank each, 4 concurrent requests
    eng, t_start = start(cfg, params, dp=2)
    try:
        inst = eng.create_instance()
        t0 = time.monotonic()
        toks, rate, sids = concurrent(inst, prompts, n_new)
        groups = [eng.seqs.group_of(s) for s in sids]
        cont = stream(inst, [5], greedy(8), session=sids[0],
                      sequence_start=False)
        kept = eng.seqs.group_of(sids[0])
        for s in sids:
            inst.end(s)
        wall = time.monotonic() - t0
        free = [eng.metrics()[f'free_pages_group{g}'] for g in range(2)]
    finally:
        t_stop = stop(eng, 'dp=2')
    if sorted(set(groups)) != [0, 1] or kept != groups[0] \
            or len(cont['tokens']) != 8:
        raise AssertionError(f'dp=2 groups {groups}, continued in {kept}')
    dp_agreed = [agree_up_to_near_tie(torch, params, cfg, p, a, b,
                                      f'dp=2 concurrent {len(p)}', device)
                 for p, a, b in zip(prompts, one['concurrent'], toks)]
    del eng
    log(f'  dp=2 [{card}]: start {t_start:.1f} s, 4 concurrent '
        f'{rate:.1f} tok/s ({placement(2)}), {wall:.1f} s, '
        f'stop {t_stop:.1f} s; sessions in groups {groups}, the continued '
        f'one stayed in {kept}; free pages per group {free}; steps agreeing '
        f'with tp=1 {dp_agreed}')
    summary['dp=2'] = dict(start_s=t_start, serve_s=wall, stop_s=t_stop,
                           tok_s_4_concurrent=rate, groups=groups,
                           agreed=dp_agreed)
    ctx['tp1_ref'] = dict(key=(cfg, ecfg, bs1_new, rig_kw), params=params,
                          run=one)
    del params
    if on_card:
        torch.cuda.empty_cache()

    # dp x tp = 2 x 2 (four ranks) against 1 x 1, at `shallow` layers
    cfg4 = dataclasses.replace(cfg, num_layer=shallow)
    params4 = random_packed_params(cfg4, 6, device)
    res = {}
    for label, kw in (('1x1', {}), ('2x2', dict(dp=2, tp=2))):
        eng, t_start = start(cfg4, params4, **kw)
        try:
            t0 = time.monotonic()
            toks, rate, _ = concurrent(eng.create_instance(), prompts,
                                       n_new, sequence_end=True)
            res[label] = (toks, rate, time.monotonic() - t0, t_start,
                          eng.fns.collective_ms())
        finally:
            t_stop = stop(eng, label)
        del eng
    agreed4 = [agree_up_to_near_tie(torch, params4, cfg4, p, a, b,
                                    f'2x2 concurrent {len(p)}', device)
               for p, a, b in zip(prompts, res['1x1'][0], res['2x2'][0])]
    log(f'  dp x tp = 2 x 2 at {shallow} layers [{card}]: start '
        f'{res["2x2"][3]:.1f} s, 4 concurrent {res["2x2"][1]:.1f} tok/s '
        f'({placement(4)}) against {res["1x1"][1]:.1f} at '
        f'1 x 1; one activation all-reduce [{ecfg.max_batch_size // 2}, '
        f'{cfg.hidden_size}] {ms_or_dash(res["2x2"][4])} ms; steps agreeing '
        f'{agreed4}')
    summary['2x2'] = dict(start_s=res['2x2'][3], serve_s=res['2x2'][2],
                          tok_s_4_concurrent=res['2x2'][1],
                          tok_s_1x1=res['1x1'][1], agreed=agreed4)
    ctx['shallow_ref'] = dict(key=(cfg4, ecfg, rig_kw), params=params4,
                              toks=res['1x1'][0], rate=res['1x1'][1])
    rig.close()
    ctx['parallel'] = summary
    log(f'  rank 0 peak memory while starting (GiB, by config): '
        f'{summary.get("start_peak_gib_rank0")}')
    log(f'  parallel: {time.monotonic() - t_phase:.1f} s')


# ---------------------------------------------------------------------------
# phase pipeline: pipeline stages over ranks sharing the card
# ---------------------------------------------------------------------------

def phase_pipeline(torch, ctx):
    pipeline(torch, ctx, llama2_7b(num_layer=PARALLEL_LAYERS), 'cuda')


def pipeline(torch, ctx, cfg, device, shallow=4, bs1_new=32, **rig_kw):
    """Pipeline parallelism at ``cfg``'s width on ``device`` against tp = 1
    (phase parallel's run in this call when there is one, else its own).
    pp = 2 (two ranks, the second a spawned process) serves a bs1 greedy
    request of ``bs1_new`` on relay rounds (``pp_ring_decode`` off), the
    same on speculative rounds (k = SPEC_K, the relay verify) and on ring
    rounds, 4 concurrent requests on the ring, prompt logits (the relay)
    and a seeded sampled pair on the ring.  Its greedy streams equal
    tp = 1's up to near-ties, its prompt logits lie within 5% of
    max|logit| (cosine >= 0.999), the seeded pair is identical, ring
    rounds ran, every rank launches 5L/pp GEMMs and L/pp decode attentions
    per relay decode step, 5L and L per ring round (pp microbatch
    iterations of its L/pp layers), 5L/pp GEMMs and L/pp prefill
    attentions per verify round and per GPipe prefill job, with no plain
    call, the ranks' readback digests are equal and every rank exits 0
    within 30 s.  Then pp x tp = 2 x 2 (four ranks; bs1 and 4 concurrent)
    against tp = 1, and dp x pp x tp = 2 x 2 x 2 (eight ranks) at
    ``shallow`` layers against 1 x 1 x 1.  Rates of ranks that share one
    card are recorded, not a pp speed."""
    import dataclasses

    from lmdeploy_tpu_torch.models.llama import random_packed_params
    rig = Rig(torch, ctx, cfg, device, **rig_kw)
    card, summary, ecfg = rig.card, rig.summary, rig.ecfg
    prompts, bs1_prompt, n_new = rig.prompts, rig.bs1_prompt, rig.n_new
    greedy, stream, mark = rig.greedy, rig.stream, rig.mark
    t_phase = time.monotonic()
    nl, pp = cfg.num_layer, 2

    ref = ctx.get('tp1_ref')
    if ref is not None and ref['key'] == (cfg, ecfg, bs1_new, rig_kw):
        params, one = ref['params'], ref['run']
        log('  tp=1 reference: phase parallel\'s run in this call')
    else:
        params = random_packed_params(cfg, 5, device)
        eng, t_start = rig.start(cfg, params)
        try:
            inst = eng.create_instance()
            t0 = time.monotonic()
            one = {'bs1': stream(inst, bs1_prompt, greedy(bs1_new),
                                 sequence_end=True)}
            eng.ecfg.speculative_k = SPEC_K
            one['bs1_spec'] = stream(inst, bs1_prompt, greedy(bs1_new),
                                     sequence_end=True)
            eng.ecfg.speculative_k = 0
            one['concurrent'], one['conc_tok_s'], _ = rig.concurrent(
                inst, prompts, n_new, sequence_end=True)
            one['logits'] = torch.from_numpy(inst.decode(
                rig.logits_prompt))
            log(f'  tp=1 reference [{card}]: start {t_start:.1f} s, serve '
                f'{time.monotonic() - t0:.1f} s; bs1 '
                f'{one["bs1"]["tok_s"]:.1f} tok/s plain, '
                f'{one["bs1_spec"]["tok_s"]:.1f} on verify rounds, 4 '
                f'concurrent {one["conc_tok_s"]:.1f} tok/s')
        finally:
            rig.stop(eng, 'tp=1')
        del eng

    def launches_want(p, with_ring=True):
        """Per rank at p stages: GEMM / decode attention per relay decode
        step and per ring round, GEMM / prefill attention per verify
        round and per GPipe prefill job."""
        g, a = 5 * nl // p, nl // p
        dec, pre = ('paged_decode_attention_write[bf16]',
                    'paged_prefill_attention[bf16]')
        want = {'decode_steps': {'w4a16_gemm': g, dec: a},
                'spec_rounds': {'w4a16_gemm': g, pre: a},
                'prefill_passes': {'w4a16_gemm': g, pre: a}}
        if with_ring:
            want['ring_rounds'] = {'w4a16_gemm': 5 * nl, dec: nl}
        return want

    # ---- pp = 2: relay, speculative and ring rounds ----
    eng, t_start = rig.start(cfg, params, pp=pp)
    try:
        inst = eng.create_instance()
        eng.fns.rank_report(reset=True)
        t0 = time.monotonic()
        marks = [mark(eng)[0]]
        two = {}
        eng.ecfg.pp_ring_decode = False
        two['bs1_relay'] = stream(inst, bs1_prompt, greedy(bs1_new),
                                  sequence_end=True)
        marks.append(mark(eng)[0])
        eng.ecfg.speculative_k = SPEC_K
        before = dict(eng.stats)
        try:
            two['bs1_spec'] = stream(inst, bs1_prompt, greedy(bs1_new),
                                     sequence_end=True)
        finally:
            eng.ecfg.speculative_k = 0
            eng.ecfg.pp_ring_decode = True
        two['spec_rounds'] = eng.stats['spec_rounds'] \
            - before['spec_rounds']
        marks.append(mark(eng)[0])
        rings0 = eng.stats['ring_rounds']
        two['bs1'] = stream(inst, bs1_prompt, greedy(bs1_new),
                            sequence_end=True)
        marks.append(mark(eng)[0])
        two['concurrent'], two['conc_tok_s'], _ = rig.concurrent(
            inst, prompts, n_new, sequence_end=True)
        m, reports = mark(eng)
        marks.append(m)
        two['ring_rounds'] = eng.stats['ring_rounds'] - rings0
        two['launches'] = rig.check_ranks(
            'pp=2', marks, reports, launches_want(pp),
            need=('decode_steps', 'spec_rounds', 'prefill_passes',
                  'ring_rounds'))
        two['rank_launches'] = [
            {n: c for n, c in r['launches'].items() if c} for r in reports]
        two['logits'] = torch.from_numpy(inst.decode(rig.logits_prompt))
        two['sampled'] = [stream(inst, prompts[0], rig.sampled,
                                 sequence_end=True)['tokens']
                          for _ in range(2)]
        two['wall'] = time.monotonic() - t0
        two['reports'] = eng.fns.rank_report()
        two['backend'] = eng.ranks.backend
        if eng.stats['ring_rounds'] - rings0 <= two['ring_rounds']:
            raise AssertionError('pp=2: the sampled pair rode no ring round')
    finally:
        t_stop = rig.stop(eng, 'pp=2')
    digests = {r['readback_sha256'] for r in two['reports']}
    if len(digests) != 1 or len(eng.rank_reports) != 1:
        raise AssertionError(f'pp=2 readback digests {digests}, final '
                             f'reports {len(eng.rank_reports)}')
    frames = eng.rank_reports[0]['frames']
    del eng
    if two['ring_rounds'] <= 0:
        raise AssertionError('pp=2: no ring round')
    agreed = [agree_up_to_near_tie(torch, params, cfg, bs1_prompt,
                                   one['bs1']['tokens'], two[k]['tokens'],
                                   f'pp=2 {k}', device)
              for k in ('bs1_relay', 'bs1')]
    agreed.append(agree_up_to_near_tie(
        torch, params, cfg, bs1_prompt, one['bs1_spec']['tokens'],
        two['bs1_spec']['tokens'], 'pp=2 bs1_spec', device))
    agreed += [agree_up_to_near_tie(torch, params, cfg, p, a, b,
                                    f'pp=2 concurrent {len(p)}', device)
               for p, a, b in zip(prompts, one['concurrent'],
                                  two['concurrent'])]
    if two['sampled'][0] != two['sampled'][1]:
        raise AssertionError('pp=2: the seeded sampled runs differ')
    rel, cos = rig.logits_gate(one['logits'], two['logits'], 'pp=2')
    peaks = [round(r['peak_bytes'] / 2 ** 30, 2) for r in two['reports']]
    log(f'  pp=2 [{card}]: start {t_start:.1f} s, serve {two["wall"]:.1f} '
        f's, stop {t_stop:.1f} s; bs1 {two["bs1_relay"]["tok_s"]:.1f} tok/s '
        f'on relay rounds, {two["bs1"]["tok_s"]:.1f} on ring rounds, '
        f'{two["bs1_spec"]["tok_s"]:.1f} on verify rounds '
        f'({two["spec_rounds"]} rounds); 4 concurrent on the ring '
        f'{two["conc_tok_s"]:.1f} tok/s ({rig.placement(pp)}; stage '
        f'hops over {two["backend"]}); {two["ring_rounds"]} ring rounds; '
        f'TTFT bs1 {two["bs1"]["ttft"]:.3f} s; peak memory per rank while '
        f'serving {peaks} GiB; launches per pass, rank 0: '
        f'{two["launches"][0]}')
    log(f'  pp=2 against tp=1: greedy steps agreeing {agreed} (relay, '
        f'ring, verify of {bs1_new}; concurrent {n_new} each); prompt '
        f'logits ({len(rig.logits_prompt)}) {rel:.3e} of max|logit|, cosine '
        f'{cos:.6f}; seeded sampled pair identical; readback digests equal; '
        f'follower replayed {frames} frames')
    summary['pp=2'] = dict(
        start_s=t_start, serve_s=two['wall'], stop_s=t_stop,
        tok_s_bs1_relay=two['bs1_relay']['tok_s'],
        tok_s_bs1_ring=two['bs1']['tok_s'],
        tok_s_bs1_spec=two['bs1_spec']['tok_s'],
        tok_s_4_concurrent_ring=two['conc_tok_s'],
        ttft_bs1_s=two['bs1']['ttft'], ring_rounds=two['ring_rounds'],
        spec_rounds=two['spec_rounds'], peak_gib_per_rank=peaks,
        backend=two['backend'],
        launches_per_pass=two['launches'], agreed=agreed, logits_rel=rel,
        logits_cos=cos, frames=frames)
    if rig.on_card:
        for name in ('w4a16_gemm', 'paged_decode_attention_write[bf16]',
                     'paged_prefill_attention[bf16]'):
            ctx['kernels'].setdefault(name, {})['pp2_launches'] = [
                r.get(name, 0) for r in two['rank_launches']]

    # ---- pp x tp = 2 x 2: four ranks, on the ring ----
    eng, t_start = rig.start(cfg, params, pp=pp, tp=2)
    try:
        inst = eng.create_instance()
        t0 = time.monotonic()
        res = {'bs1': stream(inst, bs1_prompt, greedy(bs1_new),
                             sequence_end=True)}
        res['concurrent'], res['conc_tok_s'], _ = rig.concurrent(
            inst, prompts, n_new, sequence_end=True)
        wall = time.monotonic() - t0
        reports = eng.fns.rank_report()
        rings = eng.stats['ring_rounds']
    finally:
        t_stop = rig.stop(eng, 'pp=2 x tp=2')
    del eng
    if len({r['readback_sha256'] for r in reports}) != 1 or rings <= 0:
        raise AssertionError(f'pp=2 x tp=2: digests differ or {rings} ring '
                             'rounds')
    agreed22 = [agree_up_to_near_tie(torch, params, cfg, bs1_prompt,
                                     one['bs1']['tokens'],
                                     res['bs1']['tokens'], 'pp=2 x tp=2 bs1',
                                     device)]
    agreed22 += [agree_up_to_near_tie(torch, params, cfg, p, a, b,
                                      f'pp=2 x tp=2 concurrent {len(p)}',
                                      device)
                 for p, a, b in zip(prompts, one['concurrent'],
                                    res['concurrent'])]
    peaks22 = [round(r['peak_bytes'] / 2 ** 30, 2) for r in reports]
    log(f'  pp x tp = 2 x 2 [{card}]: start {t_start:.1f} s, serve '
        f'{wall:.1f} s, stop {t_stop:.1f} s; bs1 {res["bs1"]["tok_s"]:.1f} '
        f'tok/s, 4 concurrent {res["conc_tok_s"]:.1f} tok/s '
        f'({rig.placement(4)}); peak memory per rank {peaks22} GiB; steps '
        f'agreeing with tp=1 {agreed22}')
    summary['pp2xtp2'] = dict(start_s=t_start, serve_s=wall, stop_s=t_stop,
                              tok_s_bs1=res['bs1']['tok_s'],
                              tok_s_4_concurrent=res['conc_tok_s'],
                              peak_gib_per_rank=peaks22, agreed=agreed22)
    del params
    ctx.pop('tp1_ref', None)
    if rig.on_card:
        torch.cuda.empty_cache()

    # ---- dp x pp x tp = 2 x 2 x 2 (eight ranks) at `shallow` layers ----
    cfg4 = dataclasses.replace(cfg, num_layer=shallow)
    ref = ctx.get('shallow_ref')
    if ref is not None and ref['key'] == (cfg4, ecfg, rig_kw):
        params4, want4, rate1 = ref['params'], ref['toks'], ref['rate']
    else:
        params4 = random_packed_params(cfg4, 6, device)
        eng, _ = rig.start(cfg4, params4)
        try:
            want4, rate1, _ = rig.concurrent(eng.create_instance(), prompts,
                                             n_new, sequence_end=True)
        finally:
            rig.stop(eng, '1x1x1')
        del eng
    eng, t_start = rig.start(cfg4, params4, dp=2, pp=pp, tp=2)
    try:
        t0 = time.monotonic()
        toks, rate, _ = rig.concurrent(eng.create_instance(), prompts,
                                       n_new, sequence_end=True)
        wall = time.monotonic() - t0
        reports = eng.fns.rank_report()
        rings = eng.stats['ring_rounds']
    finally:
        t_stop = rig.stop(eng, '2x2x2')
    del eng
    # one readback digest in each dp group, whose ranks are g*4 .. g*4+3
    digests = [{r['readback_sha256'] for r in reports[g * 4:(g + 1) * 4]}
               for g in range(2)]
    if [len(d) for d in digests] != [1, 1] or rings <= 0:
        raise AssertionError(f'2x2x2: readback digests by group {digests},'
                             f' {rings} ring rounds')
    agreed8 = [agree_up_to_near_tie(torch, params4, cfg4, p, a, b,
                                    f'2x2x2 concurrent {len(p)}', device)
               for p, a, b in zip(prompts, want4, toks)]
    log(f'  dp x pp x tp = 2 x 2 x 2 at {shallow} layers [{card}]: start '
        f'{t_start:.1f} s, 4 concurrent {rate:.1f} tok/s ({rig.placement(8)})'
        f' against {rate1:.1f} at 1 x 1 x 1, {wall:.1f} s, stop '
        f'{t_stop:.1f} s; steps agreeing {agreed8}')
    summary['2x2x2'] = dict(start_s=t_start, serve_s=wall, stop_s=t_stop,
                            tok_s_4_concurrent=rate, tok_s_1x1x1=rate1,
                            agreed=agreed8)
    ctx.pop('shallow_ref', None)
    rig.close()
    ctx['pipeline'] = summary
    log(f'  rank 0 peak memory while starting (GiB, by config): '
        f'{summary.get("start_peak_gib_rank0")}')
    log(f'  pipeline: {time.monotonic() - t_phase:.1f} s')


# ---------------------------------------------------------------------------
# phase tools: the byte-per-int4 form, W4A8, the debugger and the profiler
# ---------------------------------------------------------------------------

TOOLS_LAYERS = 8      # of Llama-2-7B's 32: what the time limit leaves
# the W4A8 gate's draws (and the witness of the draw it failed on): 16
# layers, of which the gate runs the first 2
GATE_DRAW_LAYERS = 16


def phase_tools(torch, ctx):
    """The last modules of the port at Llama-2-7B width (see
    :func:`tools`)."""
    tools(torch, ctx, llama2_7b(num_layer=TOOLS_LAYERS),
          llama2_7b(num_layer=2), 'cuda', draw_layers=llama2_7b().num_layer,
          gate_seeds=ctx['gate_seeds'],
          gate_cfg=llama2_7b(num_layer=GATE_DRAW_LAYERS))


def byte_form(torch, params):
    """``random_packed_params``' W4A16 layers as byte-per-int4
    QuantizedWeight (zero point sz / scale, 8 there): the same function in
    the form ``LMDEPLOY_TPU_PACKED_INT4=0`` serves."""
    from lmdeploy_tpu_torch.ops.cuda.quant_matmul import unpack_nibbles
    from lmdeploy_tpu_torch.ops.linear import (PackedInt4Weight,
                                               QuantizedWeight)
    layers = dict(params['layers'])
    for name, w in layers.items():
        if isinstance(w, PackedInt4Weight):
            s = w.scales[:, :, 0]
            layers[name] = QuantizedWeight(
                qvals=unpack_nibbles(w.packed), scales=s,
                zeros=(w.sz.float() / s.float()).round().to(s.dtype))
    return dict(params, layers=layers)


# The W4A8 gate's draw: random_packed_params' weights with each token's
# embedding row shifted by GATE_EMBED_SHIFT times the sign of its own mean.
# That draw's codes (uniform on 0..15 against zero point 8, as bench.py
# draws them) lean every weight by -0.5 scale, which gives the layers an
# all-ones mode of gain ~K x 0.5 x scale (4 for a 4096-wide projection,
# 11 for w2): a row whose hidden mean sits near zero takes any
# perturbation into that mode and its logits swing.  W4A8's jumps (its
# int8 activation codes and bf16-rounded group dots move on a last-bit
# difference of their input) are such perturbations, so on that draw the
# card-vs-CPU logits gate passes or fails by how near zero the prompt
# tokens' embedding means happen to sit (on the H100 the CPU against
# itself, every product's input nudged by one f32 ulp, moved the seed-5
# cut's W4A8 logits by 1.9x max|logit|).  With every row's mean at least
# the shift away from zero (the rows' own means are ~3e-4), no row sits
# there, for every seed.  Codes centred on the zero point remove the mode
# but leave W4A8's own error, ~13% of max|logit| end to end, which such a
# nudge resamples: their gate is held to the nudged run (phase tools,
# step 3a).
GATE_EMBED_SHIFT = 0.02


def gate_params(torch, cfg, seed, device, shift=GATE_EMBED_SHIFT):
    """``random_packed_params(cfg, seed, device)`` with each embedding row
    shifted by ``shift`` times the sign of its mean."""
    from lmdeploy_tpu_torch.models.llama import random_packed_params
    params = random_packed_params(cfg, seed, device)
    e = params['tok_embedding'].float()
    params['tok_embedding'] = (e + shift * torch.sign(
        e.mean(dim=1, keepdim=True))).to(params['tok_embedding'].dtype)
    return params


def centred_params(torch, cfg, seed, device):
    """``random_packed_params(cfg, seed, device)`` with every W4A16 code
    drawn anew uniform on 1..15 (mean 8, the zero point) from a generator
    seeded ``seed``: mean-zero weights, the draw closest to a real
    checkpoint's (a witness of phase tools)."""
    from lmdeploy_tpu_torch.models.llama import random_packed_params
    from lmdeploy_tpu_torch.ops.linear import PackedInt4Weight
    params = random_packed_params(cfg, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for w in params['layers'].values():
        if isinstance(w, PackedInt4Weight):
            lo, hi = (torch.randint(1, 16, w.packed.shape, generator=gen,
                                    dtype=torch.uint8, device=device)
                      for _ in range(2))
            w.packed.copy_(lo | (hi << 4))
    return params


def a8_own_error(torch, x2, qw, got):
    """W4A8's own error on ``x2``: ``got`` (``quant_matmul_a8(x2, qw)``)
    against the exact product of the same weight codes, in f64, over
    max|exact|, as (total, int8, dots): int8 is the exact product of
    W4A8's own int8 activation codes (its f32 scale and rounding) less the
    exact product, dots the rest (its integer group dots of the raw codes
    rounded to bf16, which the zero-point term then cancels)."""
    k = x2.shape[1]
    g = qw.scales.shape[-2]
    xf = x2.float()
    amax = torch.clamp(xf.abs().amax(dim=1, keepdim=True), min=1e-8)
    sx = amax / torch.full_like(amax, 127.0)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).double()
    s = qw.scales.double()
    qs = (qw.qvals.double().reshape(g, k // g, -1) * s[:, None]).reshape(
        k, -1)
    zero_term = xf.double().reshape(-1, g, k // g).sum(dim=2) @ (
        s * qw.zeros.double())
    exact = xf.double() @ qs - zero_term
    codes = (xq @ qs) * sx.double() - zero_term
    top = exact.abs().max()
    return tuple(float((a - b).abs().max() / top) for a, b in (
        (got.double(), exact), (codes, exact), (got.double(), codes)))


def nudged_linear(torch, seed):
    """``ops.linear.linear`` with every byte-form product's input first
    moved by one f32 ulp, up or down at random (a generator seeded
    ``seed``): a perturbation of the CPU's own, of the size by which two
    devices' f32 sums differ."""
    from lmdeploy_tpu_torch.ops import linear as L
    gen = torch.Generator().manual_seed(seed)

    def linear(x, w, bias=None):
        if not isinstance(w, L.QuantizedWeight):
            return L.linear(x, w, bias)
        xn = x.float()
        up = torch.rand(xn.shape, generator=gen) < 0.5
        xn = torch.nextafter(xn, torch.where(
            up, torch.full_like(xn, float('inf')),
            torch.full_like(xn, float('-inf'))))
        return L.linear(xn, w, bias).to(x.dtype)
    return linear


def depth_cut(torch, params, n):
    """The first ``n`` layers of a parameter tree (copies)."""
    import dataclasses

    def cut(w):
        if dataclasses.is_dataclass(w):
            return type(w)(**{f.name: getattr(w, f.name)[:n].clone()
                              for f in dataclasses.fields(w)})
        return w[:n].clone()
    return dict(params, layers={k: cut(w)
                                for k, w in params['layers'].items()})


def tools(torch, ctx, cfg, cut_cfg, device, n_new=32, short_new=8,
          gemms=LLAMA2_7B_GEMMS, rows=(1, ENGINE_SLOTS, 40, 512),
          lens=(100, 300), trace_new=8, ecfg_kw=None, draw_layers=None,
          gate_seeds=(5,), gate_cfg=None):
    """On ``device`` (the card; the CPU for a rehearsal, where the card's
    side runs on the CPU too and nothing is timed):

    1. W4A8 per product: ``quant_matmul_a8`` at each of ``gemms`` and M in
       ``rows`` against the same function on the CPU on identical inputs
       (within 1e-3 of max|ref|), timed beside the byte form's group /
       dequant product and kernel 1 (not a main-path run).
    2. Engines on ``cfg`` (phase 5's weights, seed 5: the first
       ``cfg.num_layer`` layers of the draw of ``draw_layers``, by default
       ``cfg.num_layer``): packed (the reference), byte-per-int4
       (``LMDEPLOY_TPU_PACKED_INT4=0``) and byte + ``LMDEPLOY_TPU_W4A8=1``,
       each serving bs1 greedy ``n_new`` and
       then ``short_new`` from a ``lens[0]``-token prompt, whose two
       windows solve launches (packed: 5L GEMM + L decode attention a step,
       5L + L prefill attention a pass; byte and W4A8: no GEMM, L and L),
       and the prompt logits of a ``lens[1]``-token prompt (one pass of
       the same bucket); device ms a decode step is the profiled short
       request's less its pass, over its steps.  The byte stream equals the packed one up
       to near-ties and its logits are within 5% / cosine 0.999; W4A8's
       logits must be finite and its tokens in the vocabulary.
    3. W4A8 model gate, byte-form engines with W4A8 on ``device`` and
       on the CPU over 2-layer cuts (``cut_cfg``'s depth) of draws of
       ``cfg``'s depth.  First the witnesses of fault 10: a fresh seed-5
       ``random_packed_params`` draw, whose codes' mean sits half a step
       below the zero point, and a :func:`centred_params` draw (codes
       whose mean is the zero point) of each of ``gate_seeds``; every W4A8
       product of the ``lens[1]``-token prompt's run on the card held
       against the CPU's on the card's own inputs (1e-3 of max|ref|) with
       its own error there (:func:`a8_own_error`), then its prompt logits
       with W4A8 and without (the byte form) row by row against the CPU's,
       beside the CPU's W4A8 against itself with every product's input
       nudged by one f32 ulp (:func:`nudged_linear`) and against its byte
       form.  On the centred draws W4A8's card-vs-CPU logits are gated by
       the nudged run, as ``tests/test_torch_w4a8.py`` holds the port to
       the JAX engine: max err / max|logit| within max(5%, 1.5 times the
       nudged run's) and 1 - cosine within 1.5^2 times its; the rest is
       recorded.
       Then, for each of ``gate_seeds``, the gate on that seed's draw
       with its embedding rows shifted (:func:`gate_params`): prompt logits of
       the ``lens[1]``-token prompt within 5% / cosine 0.999, and for the
       first 64 tokens of the ``lens[0]``-token prompt every W4A8 product
       of the card's run against the CPU's on the card's inputs (1e-3 of
       max|ref|); its end-to-end gap is recorded row by row beside the
       byte form's (W4A8 turns last-bit differences into jumps).
    4. The debugger on that cut, packed: ``dump`` of a 16-token prompt
       and 2 decode steps (every layer_out and logits file, counts and
       shapes), ``cmp`` of the same run (every line OK), ``cmp`` of the
       CPU's run (rel recorded).
    5. The profiler: ``trace`` around a bs1 request of ``trace_new``
       tokens under ``annotate('tools.decode')``; the trace names it.

    Launch counters are set to 0 before each run of 2, 4 and 5 and read
    after it (kernels line: ``tools_launches``)."""
    import contextlib as cl
    import dataclasses
    import importlib
    import io
    import shutil
    import tempfile

    from lmdeploy_tpu_torch.config import EngineConfig
    from lmdeploy_tpu_torch.engine.engine import TorchEngine
    from lmdeploy_tpu_torch.kvcache.paged import init_cache
    from lmdeploy_tpu_torch.messages import GenerationConfig, ResponseType
    from lmdeploy_tpu_torch.models import llama as LM
    from lmdeploy_tpu_torch.models.llama import (StepBatch, forward,
                                                 random_packed_params)
    from lmdeploy_tpu_torch.ops import cuda as K
    from lmdeploy_tpu_torch.ops import linear as L
    from lmdeploy_tpu_torch.ops.cuda.quant_matmul import WGMMA, w4a16_gemm
    from lmdeploy_tpu_torch.utils import debug, profiler
    on_card = device == 'cuda'
    card = ctx.get('card', '?')
    nl, vocab = cfg.num_layer, cfg.vocab_size
    gate_cfg = gate_cfg or cfg
    t_phase = time.monotonic()
    torch.set_num_threads(8)
    ecfg = EngineConfig(**(ecfg_kw or dict(
        max_batch_size=ENGINE_SLOTS, session_len=2048, page_size=64,
        num_pages=88, max_context_token_num=512, prefill_buckets=(64, 512),
        step_length=16, speculative_k=0, enable_prefix_caching=False)))
    rng = np.random.default_rng(5)
    prompt, long_prompt = (rng.integers(3, vocab, size=n).tolist()
                           for n in lens)
    sid = iter(range(1, 10 ** 6))
    summary, timer = {}, Timer(torch) if on_card else None
    decode_k = 'paged_decode_attention_write[bf16]'
    prefill_k = 'paged_prefill_attention[bf16]'
    tmp = tempfile.mkdtemp(prefix='lmdeploy-tools-')

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def add_launches():
        """Add this run's launches to the kernels line's tools_launches
        (the run began with the counters at 0)."""
        for name, (n, _) in K.launch_counts(True).items():
            if n:
                k = ctx['kernels'].setdefault(name, {})
                k['tools_launches'] = k.get('tools_launches', 0) + n

    # 1. W4A8 per product, card against CPU, with the byte form's and
    # kernel 1's times at the same M
    gen = torch.Generator(device=device).manual_seed(11)
    per_product, worst = [], 0.0
    for name, k, n in gemms:
        g = k // 128
        qw = L.QuantizedWeight(
            qvals=torch.randint(0, 16, (k, n), generator=gen,
                                dtype=torch.uint8, device=device),
            scales=(torch.rand((g, n), generator=gen, device=device) * 0.003
                    + 0.001).to(torch.bfloat16),
            zeros=torch.randint(6, 10, (g, n), generator=gen, device=device
                                ).to(torch.bfloat16))
        host = L.QuantizedWeight(qw.qvals.cpu(), qw.scales.cpu(),
                                 qw.zeros.cpu())
        # kernel 1 cycles over 4 copies of the layer, so that its weight
        # is not L2-resident from the previous call (as phase 3 times it)
        pw = L.pack_quantized(qw)
        pk, ps = (t.expand(4, *t.shape[1:]).contiguous()
                  for t in (pw.packed, pw.scales))
        for m in rows:
            x = torch.randn((m, k), generator=gen, device=device
                            ).to(torch.bfloat16)
            got = L.quant_matmul_a8(x, qw).cpu()
            want = L.quant_matmul_a8(x.cpu(), host)
            err = float((got - want).abs().max() / want.abs().max())
            worst = max(worst, err)
            row = dict(proj=name, m=m, err=err)
            if on_card:
                byte = (L.quant_matmul if m < L._dequant_min_m()
                        else L.quant_matmul_dequant)
                row.update(
                    a8_ms=timer.events(lambda i: L.quant_matmul_a8(x, qw),
                                       5),
                    byte_ms=timer.events(lambda i: byte(x, qw), 5),
                    kernel1_ms=timer.graph(
                        lambda i: w4a16_gemm(x, pk, ps, i % 4), 20))
            per_product.append(row)
        del qw, host, pw, pk, ps
    if worst > 1e-3:
        raise AssertionError(f'W4A8 card vs CPU: max err / max|ref| '
                             f'{worst:.3e} (tol 1e-3): {per_product}')
    by_m = {}
    for r in per_product:
        t = by_m.setdefault(r['m'], {'a8_ms': 0.0, 'byte_ms': 0.0,
                                     'kernel1_ms': 0.0})
        for key in t:
            t[key] += r.get(key, 0.0)
    log(f'  W4A8 card vs CPU, the {len(gemms)} projections at M = {rows}: '
        f'worst max err / max|ref| {worst:.3e} (tol 1e-3) '
        f'({time.monotonic() - t_phase:.1f} s)')
    if on_card:
        for r in per_product:
            log(f'    {r["proj"]} M={r["m"]}: W4A8 {r["a8_ms"]:.4f} ms, '
                f'byte form {r["byte_ms"]:.4f} ms, kernel 1 '
                f'{r["kernel1_ms"]:.4f} ms [{card}]')
        log(f'    one layer (sum of the projections) by M: {by_m}')
    summary['per_product'] = per_product
    summary['layer_ms_by_m'] = by_m
    K.reset_launch_counts()

    # 2. the deep engines: packed, byte form, byte form + W4A8, on the
    # first nl layers of the seeded draw (a cut of its depth keeps the
    # layers, and the 2-layer cut of step 3, of the full draw)
    params = random_packed_params(dataclasses.replace(
        cfg, num_layer=draw_layers or nl), 5, device)
    if (draw_layers or nl) != nl:
        params = depth_cut(torch, params, nl)
    byte_params = byte_form(torch, params)
    sync()

    def request(inst, ids, n):
        """One bs1 greedy request of exactly ``n`` tokens: (tokens, tok/s
        after the first)."""
        t0, first = time.monotonic(), None
        for last in inst.stream_infer(next(sid), ids, GenerationConfig(
                max_new_tokens=n, top_k=1, ignore_eos=True),
                sequence_end=True):
            if last.num_generated and first is None:
                first = time.monotonic()
        if last.num_generated != n or last.status != ResponseType.FINISH:
            raise AssertionError(f'request: {last.num_generated} of {n} '
                                 f'tokens, {last.status}')
        t1 = time.monotonic()
        return list(last.token_ids), (n - 1) / max(t1 - (first or t1), 1e-9)

    def serve(label, tree, env, form):
        """One engine under ``env``: the stream, tok/s, launches and
        device ms per pass kind, prompt logits, peak memory."""
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        with env_vars(env):
            eng = TorchEngine(cfg, ecfg, tree, device=device)
            try:
                if not all(isinstance(eng.params['layers'][p], form)
                           for p, _, _ in gemms):
                    raise AssertionError(f'{label}: weights not {form}')
                inst = eng.create_instance()
                marks, dev_ms, held = [], [], []

                def mark():
                    marks.append((
                        {n: c[0] for n, c in K.launch_counts(True).items()},
                        {'decode_steps': eng.stats['decode_steps'],
                         'prefill_passes': eng.stats['prefill_passes']}))

                def profiled(fn):
                    """fn's result; its device ms appended to dev_ms."""
                    if not on_card:
                        return fn()
                    dev_ms.append(sum(ms for ms, _, _ in device_kernels(
                        torch, lambda: held.append(fn()))))
                    return held.pop()
                K.reset_launch_counts()
                mark()
                tokens, tps = request(inst, prompt, n_new)
                mark()
                profiled(lambda: request(inst, prompt, short_new))
                mark()
                t0 = time.monotonic()
                logits = profiled(lambda: inst.decode(long_prompt))
                logits_s = time.monotonic() - t0
                counts = K.launch_counts(True)
                add_launches()
                if label == 'packed' and trace_new:
                    summary['trace'] = trace_request(inst)
            finally:
                eng.shutdown()
        passes = np.array([[b[1][k] - a[1][k] for k in ('decode_steps',
                                                        'prefill_passes')]
                           for a, b in zip(marks, marks[1:])], np.float64)
        res = dict(tokens=tokens, tok_s=tps, logits=logits,
                   logits_s=logits_s, windows=passes.tolist(),
                   peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                             if on_card else None))
        if dev_ms:
            (steps, passes_), (req_ms, pass_ms) = passes[1], dev_ms
            res.update(device_ms_per_step=(req_ms - passes_ * pass_ms)
                       / steps, device_ms_per_pass=pass_ms)
        if on_card:
            gemm = 5 * nl if label == 'packed' else 0
            check_route(counts, launches_per_kind(marks, skip=(WGMMA,)),
                        {'decode_steps': {'w4a16_gemm': gemm, decode_k: nl},
                         'prefill_passes': {'w4a16_gemm': gemm,
                                            prefill_k: nl}},
                        f'tools, {label} engine',
                        need=('decode_steps', 'prefill_passes'))
        res['launches'] = {n: c[0] for n, c in counts.items() if c[0]}
        log(f'  {label} engine [{card}]: bs1 {tps:.1f} tok/s ({n_new} new '
            f'from {len(prompt)}), device ms a decode step '
            f'{res.get("device_ms_per_step")}, a prefill pass '
            f'{res.get("device_ms_per_pass")}, prompt logits of '
            f'{len(long_prompt)} in {logits_s:.3f} s, peak '
            f'{res["peak_gib"]} GiB; launches {res["launches"]} over '
            f'windows (decode steps, prefill passes) {res["windows"]}')
        return res

    def trace_request(inst):
        """A bs1 request of ``trace_new`` tokens under trace() and
        annotate('tools.decode'): the trace file names the annotation."""
        t0 = time.monotonic()
        log_dir = os.path.join(tmp, 'trace')
        with profiler.trace(log_dir):
            with profiler.annotate('tools.decode'):
                request(inst, prompt, trace_new)
        files = os.listdir(log_dir)
        size = os.path.getsize(os.path.join(log_dir, files[0]))
        with open(os.path.join(log_dir, files[0])) as f:
            named = '"tools.decode"' in f.read()
        if len(files) != 1 or not named:
            raise AssertionError(f'profiler trace: files {files}, names '
                                 f'the annotation: {named}')
        dt = time.monotonic() - t0
        log(f'  profiler: trace() of a bs1 request of {trace_new} tokens '
            f'under annotate("tools.decode"): {files[0]}, {size} bytes, '
            f'names the annotation; {dt:.1f} s with the write')
        return dict(bytes=size, seconds=dt)

    try:
        packed = serve('packed', params, {}, L.PackedInt4Weight)
        byte = serve('byte form', byte_params,
                     {'LMDEPLOY_TPU_PACKED_INT4': '0'}, L.QuantizedWeight)
        a8 = serve('W4A8', byte_params, {'LMDEPLOY_TPU_PACKED_INT4': '0',
                                         'LMDEPLOY_TPU_W4A8': '1'},
                   L.QuantizedWeight)
        same = agree_up_to_near_tie(torch, params, cfg, prompt,
                                    packed['tokens'], byte['tokens'],
                                    'byte form vs packed', device)
        rel, cos = logits_gate(torch, byte['logits'], packed['logits'],
                               'byte form vs packed prompt logits')
        lg = torch.from_numpy(a8['logits'])
        if not (bool(torch.isfinite(lg).all()) and all(
                0 <= t < vocab for t in a8['tokens'])):
            raise AssertionError(f'W4A8 engine: finite logits '
                                 f'{bool(torch.isfinite(lg).all())}, '
                                 f'tokens {a8["tokens"]}')
        ref = torch.from_numpy(packed['logits'])
        a8_rel = float((lg - ref).abs().max() / ref.abs().max())
        a8_cos = float(torch.nn.functional.cosine_similarity(
            lg, ref, dim=-1).min())
        a8_same = next((i for i, (a, b) in enumerate(
            zip(packed['tokens'], a8['tokens'])) if a != b), n_new)
        log(f'  byte form vs packed: {same} of {n_new} greedy steps equal '
            f'(the rest after a near-tie), prompt logits max err / '
            f'max|logit| {rel:.3e}, min cosine {cos:.6f}; W4A8 vs packed '
            f'(not gated): first {a8_same} steps equal, logits {a8_rel:.3e}'
            f', min cosine {a8_cos:.6f}')
        for key, res in (('packed', packed), ('byte', byte), ('w4a8', a8)):
            summary[key] = {k: v for k, v in res.items()
                            if k not in ('logits', 'tokens')}
        summary.update(byte_vs_packed=dict(steps_equal=same, rel=rel,
                                           cos=cos),
                       w4a8_vs_packed=dict(steps_equal=a8_same, rel=a8_rel,
                                           cos=a8_cos))
        cut = depth_cut(torch, params, cut_cfg.num_layer)
        del params, byte_params, packed, byte, a8, lg, ref
        if on_card:
            torch.cuda.empty_cache()
        log(f'    ({time.monotonic() - t_phase:.1f} s into the phase)')

        # 3. the W4A8 model gate, card against CPU, on 2-layer cuts of
        # its own draws: every W4A8 product of a prompt's run on the card
        # held against the CPU's on the card's own inputs, then prompt
        # logits end to end
        a8 = L.quant_matmul_a8
        forced = []
        own = []              # W4A8's own error on the held inputs
        held = {'own': False}

        def a8_forced(x2, qw):
            """The card's W4A8 product, held against the CPU's on the
            card's own inputs (teacher-forced: no drift between them)."""
            out = a8(x2, qw)
            want = a8(x2.cpu(), L.QuantizedWeight(
                *(t.cpu() for t in (qw.qvals, qw.scales, qw.zeros))))
            forced.append(float((out.cpu() - want).abs().max()
                                / want.abs().max()))
            if held['own']:
                own.append(a8_own_error(torch, x2, qw, out))
            return out

        def cut_logits(tree, dev, runs):
            """{key: prompt logits} of a byte-form engine of the cut
            ``tree`` on ``dev``, one per run (key, ids, W4A8 on, its
            products held against the CPU's, its products' inputs nudged
            by :func:`nudged_linear`)."""
            out = {}
            # the CPU's run in the smallest bucket that holds the long
            # prompt (rows are independent: the bucket's padding rows only
            # cost time there)
            cfg_dev = ecfg if dev != 'cpu' else dataclasses.replace(
                ecfg, prefill_buckets=(64, -(-len(long_prompt) // 64) * 64))
            with env_vars({'LMDEPLOY_TPU_PACKED_INT4': '0'}):
                eng = TorchEngine(cut_cfg, cfg_dev, tree, device=dev)
                try:
                    inst = eng.create_instance()
                    for key, ids, w4a8, forced_on, nudge in runs:
                        with env_vars({'LMDEPLOY_TPU_W4A8': '1'} if w4a8
                                      else {}):
                            if forced_on:
                                L.quant_matmul_a8 = a8_forced
                            if nudge:
                                LM.linear = nudged_linear(torch, 0)
                            try:
                                out[key] = torch.from_numpy(inst.decode(ids))
                            finally:
                                L.quant_matmul_a8 = a8
                                LM.linear = L.linear
                finally:
                    eng.shutdown()
            return out

        def rows_rel(a, b):
            return (a - b).abs().amax(-1) / b.abs().amax()

        def products_gate(label):
            """Every W4A8 product of the run just held within 1e-3 of
            max|ref|; returns (count, worst) and clears the record."""
            n, worst = len(forced), max(forced, default=None)
            forced.clear()
            if not n or worst > 1e-3:
                raise AssertionError(
                    f'{label}: {n} W4A8 products, card vs CPU on the '
                    f'card\'s inputs max err / max|ref| {worst} (tol 1e-3)')
            return n, worst

        # 3a. the witnesses of fault 10: 2-layer cuts of fresh draws of
        # cfg's depth, 'bench' (random_packed_params: codes uniform on
        # 0..15 against zero point 8, the draw whose logits gate failed
        # once) at seed 5 and 'centred' (centred_params: codes on 1..15,
        # mean at the zero point) at each of gate_seeds.  Every W4A8
        # product of the long prompt's run on the card against the CPU's
        # on the card's own inputs (1e-3 of max|ref|), with W4A8's own
        # error on those inputs (a8_own_error); the logits with W4A8 and
        # without (the byte form) card vs CPU row by row, beside each
        # row's |cosine| with ones @ lm_head (the direction the bench
        # draw's hidden states lean along); and on the CPU the W4A8 run
        # with every product's input nudged by one f32 ulp (nudged_linear):
        # how far the logits move on a perturbation of the CPU's own.
        # On the centred draws that witness gates W4A8's card-vs-CPU
        # logits; the rest is recorded
        summary['w4a8_witness'] = {}
        witness_runs = [('byte', long_prompt, False, False, False),
                        ('w4a8', long_prompt, True, on_card, False)]
        for rule, seed in [('bench', 5)] + [('centred', s)
                                            for s in gate_seeds]:
            draw = (random_packed_params(gate_cfg, seed, device)
                    if rule == 'bench' else
                    centred_params(torch, gate_cfg, seed, device))
            wit = byte_form(torch, depth_cut(torch, draw, cut_cfg.num_layer))
            del draw
            wit_host = _to(wit, 'cpu')
            held['own'] = on_card
            card_w = cut_logits(wit, device, witness_runs)
            held['own'] = False
            wit_products = products_gate(
                f'witness {rule} seed {seed}, the long prompt') \
                if on_card else (0, None)
            own_worst = [max(e[i] for e in own) if own else None
                         for i in range(3)]
            own.clear()
            host_w = cut_logits(wit_host, 'cpu', [
                r[:3] + (False, False) for r in witness_runs] + [
                    ('w4a8_nudged', long_prompt, True, False, True)])
            ones_dir = torch.ones(cut_cfg.hidden_size) @ wit_host[
                'lm_head'].float()
            witness = dict(products=wit_products[0],
                           products_worst=wit_products[1],
                           own_error=dict(zip(('total', 'int8', 'dots'),
                                              own_worst)))
            for key in ('byte', 'w4a8'):
                rel_rows = rows_rel(card_w[key], host_w[key])
                lean = torch.nn.functional.cosine_similarity(
                    host_w[key], ones_dir[:host_w[key].shape[-1]][None],
                    dim=-1).abs()
                over = (rel_rows > 0.05).nonzero().flatten().tolist()
                witness[key] = dict(
                    rel=float(rel_rows.max()), cos=float(
                        torch.nn.functional.cosine_similarity(
                            card_w[key], host_w[key], dim=-1).min()),
                    rows_over_5pct=len(over),
                    rows_over_5pct_lean={
                        r: [round(float(rel_rows[r]), 6),
                            round(float(lean[r]), 6)] for r in over[:8]},
                    lean_median=float(lean.median()))
            # the CPU against itself: the nudged run, and W4A8 against the
            # byte form (W4A8's own error end to end)
            for key, base in (('w4a8_nudged', 'w4a8'),
                              ('w4a8_vs_byte', 'byte')):
                other = host_w['w4a8' if key == 'w4a8_vs_byte' else key]
                rel_rows = rows_rel(other, host_w[base])
                witness[key] = dict(
                    rel=float(rel_rows.max()), cos=float(
                        torch.nn.functional.cosine_similarity(
                            other, host_w[base], dim=-1).min()),
                    rows_over_5pct=int((rel_rows > 0.05).sum()))
            gated = rule == 'centred'
            if gated:
                witness['tol'] = max(0.05,
                                     1.5 * witness['w4a8_nudged']['rel'])
                witness['tol_cos'] = 1.5 ** 2 * (
                    1 - witness['w4a8_nudged']['cos'])
            log(f'  W4A8 witness {rule} seed {seed} ('
                + (f'W4A8 card vs CPU gated: max err / max|logit| tol '
                   f'{witness["tol"]:.3e}, 1 - cosine tol '
                   f'{witness["tol_cos"]:.3e}' if gated else 'not gated')
                + '), '
                f'{cut_cfg.num_layer} layers of a fresh draw of '
                f'{gate_cfg.num_layer}, codes '
                f'{"0..15" if rule == "bench" else "1..15"} against zero '
                f'point 8, {len(long_prompt)}-token prompt: '
                f'{witness["products"]} W4A8 products card vs CPU on the '
                f'card\'s inputs, worst {witness["products_worst"]} (tol '
                f'1e-3); W4A8\'s own error there against the exact product '
                f'(f64) / max|exact|, worst: {witness["own_error"]} '
                f'(int8: its int8 activation codes alone; dots: its bf16 '
                f'group dots); logits [max err / max|logit|, min cosine, '
                f'rows over 5%]: ' + '; '.join(
                    f'{key} {witness[key]["rel"]:.3e}, '
                    f'{witness[key]["cos"]:.6f}, '
                    f'{witness[key]["rows_over_5pct"]}' for key in (
                        'w4a8', 'byte', 'w4a8_nudged', 'w4a8_vs_byte'))
                + ' (w4a8 / byte: card vs CPU; w4a8_nudged: the CPU '
                'against itself, every product\'s input moved one f32 ulp; '
                'w4a8_vs_byte: the CPU\'s W4A8 against its byte form); rows '
                'over 5% '
                f'[rel, |cosine| with ones @ lm_head]: W4A8 '
                f'{witness["w4a8"]["rows_over_5pct_lean"]}, median |cosine| '
                f'{witness["w4a8"]["lean_median"]:.4f} '
                f'({time.monotonic() - t_phase:.1f} s into the phase)')
            summary['w4a8_witness'][f'{rule} {seed}'] = witness
            if gated and not (
                    witness['w4a8']['rel'] <= witness['tol']
                    and 1 - witness['w4a8']['cos'] <= witness['tol_cos']):
                raise AssertionError(
                    f'W4A8 witness centred seed {seed}: card vs CPU past '
                    'the CPU\'s own nudged run (see the line above)')
            del wit, wit_host, card_w, host_w
            if on_card:
                torch.cuda.empty_cache()

        # 3b. the gate, on draws whose embedding rows' means sit away from
        # zero (gate_params)
        summary['w4a8_cut_gate'] = {}
        for seed in gate_seeds:
            tree = byte_form(torch, depth_cut(torch, gate_params(
                torch, gate_cfg, seed, device), cut_cfg.num_layer))
            host = _to(tree, 'cpu')
            short_ids = prompt[:64]
            runs = [('byte_short', short_ids, False, False, False),
                    ('long', long_prompt, True, False, False),
                    ('short', short_ids, True, on_card, False)]
            got = cut_logits(tree, device, runs)
            n_forced, worst_forced = products_gate(
                f'W4A8 2-layer, seed {seed}, first 64 tokens') \
                if on_card else (0, None)
            ref = cut_logits(host, 'cpu', [r[:3] + (False, False)
                                           for r in runs])
            rel8, cos8 = logits_gate(
                torch, got['long'], ref['long'],
                f'W4A8 2-layer prompt logits, seed {seed}, card vs CPU')
            # the short prompt: W4A8 is not continuous in its input, so
            # the card's last-bit differences can move a code or a rounded
            # group dot, and the logits jump.  Its gate is every W4A8
            # product the card ran for it, against the CPU's on the card's
            # inputs; the end-to-end gap is recorded row by row beside the
            # byte form's
            a8_rows = rows_rel(got['short'], ref['short'])
            byte_rows = rows_rel(got['byte_short'], ref['byte_short'])
            over = (a8_rows > 0.05).nonzero().flatten().tolist()
            short = dict(
                rel=float(a8_rows.max()), cos=float(
                    torch.nn.functional.cosine_similarity(
                        got['short'], ref['short'], dim=-1).min()),
                byte_rel=float(byte_rows.max()),
                rows_over_5pct={r: [float(a8_rows[r]), float(byte_rows[r])]
                                for r in over},
                forced_products=n_forced, forced_worst=worst_forced)
            log(f'  W4A8 model gate, {cut_cfg.num_layer} layers of the '
                f'seed-{seed} draw of {gate_cfg.num_layer}, embedding rows '
                f'shifted by {GATE_EMBED_SHIFT} x the sign of their mean, '
                f'prompt logits of {len(long_prompt)} tokens, card vs CPU: '
                f'max err / '
                f'max|logit| {rel8:.3e} (tol 0.05), min cosine {cos8:.6f} '
                f'(tol 0.999); first 64 tokens of the {len(prompt)}-token '
                f'prompt: {n_forced} W4A8 products against the CPU on the '
                f'card\'s inputs, worst {worst_forced} (tol 1e-3); end to '
                f'end (not gated) {short["rel"]:.3e}, min cosine '
                f'{short["cos"]:.6f}, the byte form\'s '
                f'{short["byte_rel"]:.3e}; rows over 5% (W4A8, byte form): '
                f'{short["rows_over_5pct"]} '
                f'({time.monotonic() - t_phase:.1f} s into the phase)')
            summary['w4a8_cut_gate'][seed] = dict(rel=rel8, cos=cos8,
                                                  short=short)
            del tree, host, got, ref

        # 4. the debugger on the 2-layer cut (packed: all three kernels)
        host = _to(cut, 'cpu')
        dbg_dir = os.path.join(tmp, 'cmp')
        feed = []

        def dbg_run(dev, tree):
            """A 16-token prompt and 2 decode steps (the card's argmax
            tokens are fed to every run)."""
            cache = init_cache(cut_cfg.num_layer, 4, 64, cut_cfg.kv_head_num,
                               cut_cfg.size_per_head, torch.bfloat16, dev)
            pt = torch.arange(4, dtype=torch.int32, device=dev)[None]
            ids, start = prompt[:16], 0
            for s in range(3):
                t = len(ids)
                batch = StepBatch(
                    ids=torch.tensor([ids], dtype=torch.int32, device=dev),
                    positions=torch.arange(start, start + t,
                                           dtype=torch.int32,
                                           device=dev)[None],
                    valid=torch.ones((1, t), dtype=torch.bool, device=dev),
                    context_len=torch.tensor([start + t], dtype=torch.int32,
                                             device=dev),
                    page_table=pt)
                logits, _ = forward(tree, cache, batch, cut_cfg)
                start += t
                if len(feed) <= s:
                    feed.append(int(logits[0, :cut_cfg.vocab_size].argmax()))
                ids = [feed[s]]

        def with_mode(mode, dev, tree):
            """Run under LMDEPLOY_TPU_DEBUG=``mode``; its [cmp] lines."""
            buf = io.StringIO()
            with env_vars({'LMDEPLOY_TPU_DEBUG': mode,
                           'LMDEPLOY_TPU_DEBUG_DIR': dbg_dir}):
                importlib.reload(debug)
                try:
                    K.reset_launch_counts()
                    with cl.redirect_stdout(buf):
                        dbg_run(dev, tree)
                    sync()
                    if dev == device:
                        add_launches()
                finally:
                    os.environ.pop('LMDEPLOY_TPU_DEBUG', None)
                    importlib.reload(debug)
            return [ln for ln in buf.getvalue().splitlines()
                    if ln.startswith('[cmp]')]

        t0 = time.monotonic()
        with_mode('dump', device, cut)
        files = sorted(os.listdir(dbg_dir))
        want_files = sorted([f'layer_out.{i}.npy'
                             for i in range(3 * cut_cfg.num_layer)]
                            + [f'logits.{i}.npy' for i in range(3)])
        shapes = {f: np.load(os.path.join(dbg_dir, f)).shape for f in files}
        d = cut_cfg.hidden_size
        want_shapes = {f: ((1, 16, d) if f.startswith('layer_out') and
                           int(f.split('.')[1]) < cut_cfg.num_layer else
                           (1, 1, d) if f.startswith('layer_out') else
                           (1, cut.get('lm_head').shape[-1]))
                       for f in want_files}
        if files != want_files or shapes != want_shapes:
            raise AssertionError(f'debug dump: files {files}, shapes '
                                 f'{shapes}; want {want_shapes}')
        same_dev = with_mode('cmp', device, cut)
        if len(same_dev) != len(files) or not all(
                ln.startswith('[cmp] OK ') for ln in same_dev):
            raise AssertionError(f'debug cmp on {device}: {same_dev}')
        cpu_lines = with_mode('cmp', 'cpu', host)
        rels = [float(ln.split(' rel ')[1]) for ln in cpu_lines
                if ' rel ' in ln]
        log(f'  debugger: dump of a 16-token prompt + 2 decode steps wrote '
            f'{len(files)} files ({shapes}); cmp on {device}: '
            f'{len(same_dev)} lines OK; cmp of the CPU run (not gated): '
            + '; '.join(ln[6:] for ln in cpu_lines)
            + f' ({time.monotonic() - t0:.1f} s)')
        summary['debug'] = dict(files=len(files), cpu_rel=rels)
        del cut, host
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        K.reset_launch_counts()
        if on_card:
            torch.cuda.empty_cache()
    summary['seconds'] = time.monotonic() - t_phase
    ctx['tools'] = summary
    log(f'  tools: {summary["seconds"]:.1f} s')


# ---------------------------------------------------------------------------
# phase families: a second model family at its published widths
# ---------------------------------------------------------------------------

FAMILY_LAYERS = 4     # of Qwen-14B's 40: what the time limit leaves


def qwen_14b(num_layer: int = 40):
    """Qwen-14B's published widths (hidden 5120, 40 heads = KV heads,
    Dh 128, intermediate_size 27392 halved to 13696 as convert/hf.py
    does, vocab 152064, qkv bias, dynamic NTK and logn attention past its
    seq_length 2048) at W4A16 group 128; sessions of 4096 tokens so that
    requests cross 2048."""
    from lmdeploy_tpu_torch.config import ModelConfig
    return ModelConfig(model_name='qwen-14b', head_num=40, kv_head_num=40,
                       size_per_head=128, inter_size=13696,
                       num_layer=num_layer, vocab_size=152064,
                       rotary_embedding=128, max_position_embeddings=2048,
                       session_len=4096, attn_bias=True, qkv_bias_only=True,
                       use_dynamic_ntk=True, use_logn_attn=True,
                       weight_type='int4', group_size=128)


def qwen_params(torch, cfg, seed, device):
    """Random packed W4A16 weights of ``cfg`` (random_packed_params, w2 at
    its 107 groups as a checkpoint holds it) with a seeded qkv bias."""
    from lmdeploy_tpu_torch.models.llama import random_packed_params
    params = random_packed_params(cfg, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    qkv = (cfg.head_num + 2 * cfg.kv_head_num) * cfg.size_per_head
    params['layers']['bqkv'] = (torch.randn(
        (cfg.num_layer, qkv), generator=gen, device=device) * 0.02).to(
            torch.bfloat16)
    return params


def phase_families(torch, ctx):
    """Qwen-14B's widths at FAMILY_LAYERS layers (see :func:`families`)."""
    families(torch, ctx, qwen_14b(FAMILY_LAYERS), qwen_14b(2), 'cuda')


def families(torch, ctx, cfg, cut_cfg, device, lens=(16, 100, 300, 500),
             n_new=32, long_len=2040, long_new=24, ecfg_kw=None):
    """A second model family on ``device``: Qwen-14B's widths (``cfg``,
    depth cut) from random packed weights at tp = 1, whose w2 (inter
    13696: 107 groups of 128) the engine pads with exact zeros to 13824
    and packs.  It serves 4 concurrent greedy requests (prompts ``lens``),
    two bs1 requests (``n_new`` and 8 new), a seeded sampled pair, a
    speculative request (k = SPEC_K) and one bs1 request of ``long_len``
    prompt tokens and ``long_new`` new ones, which crosses seq_length 2048
    (dynamic NTK and logn on), under LMDEPLOY_TPU_FUSED_ROPE=1 (kernel 5)
    and under the defaults.  Gates: launches per decode step 5L GEMM + L
    decode attention and per prefill pass 5L GEMM + L prefill attention,
    no plain call, every W4A16 weight nibble-packed (so no byte-form
    product), w2 at K = 13824, prefix caching off, the seeded pair
    identical, verify rounds ran, kernel 5's L launches a decode step,
    the long request's two streams equal up to a near-tie, and prompt
    logits of ``lens[1]`` tokens through a 2-layer cut (``cut_cfg``)
    within 5% of max|logit| (cosine >= 0.999) of the CPU's."""
    import dataclasses

    from lmdeploy_tpu_torch.config import EngineConfig
    from lmdeploy_tpu_torch.engine.engine import TorchEngine
    from lmdeploy_tpu_torch.messages import GenerationConfig, ResponseType
    from lmdeploy_tpu_torch.ops import cuda as K
    from lmdeploy_tpu_torch.ops.cuda.quant_matmul import WGMMA
    from lmdeploy_tpu_torch.ops.linear import PackedInt4Weight
    on_card = device == 'cuda'
    card = ctx.get('card', '?')
    nl = cfg.num_layer
    t_phase = time.monotonic()
    ecfg = EngineConfig(**(ecfg_kw or dict(
        max_batch_size=8, session_len=4096, page_size=64, num_pages=128,
        max_context_token_num=512, prefill_buckets=(64, 512),
        step_length=16, speculative_k=0, enable_prefix_caching=True)))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n in lens]
    long_prompt = rng.integers(3, cfg.vocab_size, size=long_len).tolist()
    sid = iter(range(1, 10 ** 6))
    out = {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def stream(inst, prompt, gen):
        """One request: (tokens, seconds to the first token, tok/s after
        it)."""
        t0, first = time.monotonic(), None
        for last in inst.stream_infer(next(sid), prompt, gen):
            if last.num_generated and first is None:
                first = time.monotonic()
        if last.status != ResponseType.FINISH or \
                last.num_generated != gen.max_new_tokens:
            raise AssertionError(f'families: request of {len(prompt)} '
                                 f'tokens: {last.num_generated} tokens, '
                                 f'{last.status}')
        t1 = time.monotonic()
        n = gen.max_new_tokens
        return (list(last.token_ids), (first or t1) - t0,
                (n - 1) / max(t1 - (first or t1), 1e-9))

    def greedy(n):
        return GenerationConfig(max_new_tokens=n, top_k=1, ignore_eos=True)

    def mark(eng):
        return ({n: c[0] for n, c in K.launch_counts(True).items()},
                {'decode_steps': eng.stats['decode_steps'], 'spec_rounds': 0,
                 'prefill_passes': eng.stats['prefill_passes']})

    params = qwen_params(torch, cfg, 8, device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.monotonic()
    eng = TorchEngine(cfg, ecfg, params, device=device)
    sync()
    start_s = time.monotonic() - t0
    try:
        layers = eng.params['layers']
        w2 = layers['w2']
        if not all(isinstance(layers[n], PackedInt4Weight)
                   for n in ('wqkv', 'wo', 'w1', 'w3', 'w2')) or \
                w2.k != cfg.inter_size + (-cfg.inter_size) % (
                    2 * cfg.group_size) or \
                layers['w1'].n != w2.k:
            raise AssertionError(f'families: weights not all packed at the '
                                 f'padded inter (w2 {type(w2).__name__} '
                                 f'K={w2.k})')
        if eng.ecfg.enable_prefix_caching:
            raise AssertionError('families: prefix caching stayed on under '
                                 'dynamic NTK')
        inst = eng.create_instance()
        # 4 concurrent greedy requests, then two bs1 windows
        K.reset_launch_counts()
        marks = [mark(eng)]
        results = [None] * len(prompts)

        def worker(i):
            results[i] = stream(inst, prompts[i], greedy(n_new))
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(prompts))]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(r is None for r in results):
            raise AssertionError('families: concurrent requests failed')
        conc_s = time.monotonic() - t0
        marks.append(mark(eng))
        bs1 = []
        for n in (n_new, 8):
            bs1.append(stream(inst, prompts[1], greedy(n)))
            marks.append(mark(eng))
        counts = K.launch_counts(True)
        decode, prefill = ('paged_decode_attention_write[bf16]',
                           'paged_prefill_attention[bf16]')
        if on_card:
            check_route(counts, launches_per_kind(marks, skip=(WGMMA,)),
                        {'decode_steps': {'w4a16_gemm': 5 * nl, decode: nl},
                         'prefill_passes': {'w4a16_gemm': 5 * nl,
                                            prefill: nl}},
                        'families Qwen-14B engine',
                        need=('decode_steps', 'prefill_passes'))
        if on_card:
            for n in ('w4a16_gemm', decode, prefill):
                ctx['kernels'].setdefault(n, {})['families_launches'] = \
                    counts[n][0]
        out['greedy'] = dict(
            ttft_s=[r[1] for r in results],
            tok_s_4_concurrent=len(prompts) * (n_new - 1) / conc_s,
            ttft_bs1_s=bs1[0][1], tok_s_bs1=bs1[0][2],
            launches={n: c[0] for n, c in counts.items() if c[0]})
        # a seeded sampled pair
        sampled = GenerationConfig(max_new_tokens=n_new, top_k=40,
                                   top_p=0.9, temperature=0.8,
                                   random_seed=99, ignore_eos=True)
        pair = [stream(inst, prompts[0], sampled)[0] for _ in range(2)]
        if pair[0] != pair[1]:
            raise AssertionError(f'families: seeded pair differs: {pair}')
        # speculative rounds
        K.reset_launch_counts()
        eng.ecfg.speculative_k = SPEC_K
        eng._spec_cooloff, eng._spec_accept_ema = 0, None   # gate open
        rounds = eng.stats['spec_rounds']
        spec = stream(inst, [1], greedy(n_new))
        rounds = eng.stats['spec_rounds'] - rounds
        eng.ecfg.speculative_k = 0
        counts = K.launch_counts(True)
        routes = {n: v for n, v in K.route_counts().items()
                  if n.startswith(f'{WGMMA}:') and v}
        if on_card and (not rounds or counts['w4a16_gemm'][1]
                        or sum(routes.values()) != counts['w4a16_gemm'][0]):
            raise AssertionError(f'families spec: {rounds} verify rounds, '
                                 f'GEMM {counts["w4a16_gemm"]}, routes '
                                 f'{routes}')
        out['spec'] = dict(rounds=rounds, tok_s=spec[2],
                           gemm_routes=routes)
        # the long request past seq_length, under both rope routes
        streams = {}
        for label, env in (('FUSED_ROPE=1',
                            {'LMDEPLOY_TPU_FUSED_ROPE': '1'}),
                           ('defaults', {})):
            with env_vars(env):
                K.reset_launch_counts()
                steps = eng.stats['decode_steps']
                streams[label] = stream(inst, long_prompt, greedy(long_new))
                steps = eng.stats['decode_steps'] - steps
                kernel = f'{decode_kernel_of(env)}[bf16]'
                got = K.launch_counts()[kernel]
                if on_card and (got != (steps * nl, 0) or not steps):
                    raise AssertionError(
                        f'families {label}: {kernel} {got} over {steps} '
                        f'decode steps of {nl} layers')
                if on_card and env:
                    ctx['kernels'].setdefault(kernel, {})[
                        'families_launches'] = got[0]
        agree = agree_up_to_near_tie(
            torch, eng.params, cfg, long_prompt, streams['defaults'][0],
            streams['FUSED_ROPE=1'][0], 'families long request, '
            'FUSED_ROPE=1 vs defaults', dev=device)
        out['long'] = dict(prompt=long_len, new=long_new, agree=agree,
                           ttft_s=streams['defaults'][1],
                           tok_s=streams['defaults'][2],
                           fused_rope_tok_s=streams['FUSED_ROPE=1'][2])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card \
            else None
    finally:
        eng.shutdown()
        K.reset_launch_counts()
    del params
    # prompt logits of a 2-layer cut, the card's against the CPU's
    cut = qwen_params(torch, cut_cfg, 8, device)
    logits = {}
    for dev in (device, 'cpu'):
        tree = cut if dev == device else _to(cut, 'cpu')
        e = TorchEngine(cut_cfg, dataclasses.replace(
            ecfg, max_batch_size=1, session_len=1024, num_pages=16,
            speculative_k=0), tree, device=dev)
        try:
            logits[dev] = e.create_instance().decode(prompts[1])
        finally:
            e.shutdown()
    rel, cos = logits_gate(torch, logits[device], logits['cpu'],
                           'families 2-layer cut prompt logits')
    del cut
    if on_card:
        torch.cuda.empty_cache()
    out.update(start_s=start_s, w2_k=w2.k, cut_rel=rel, cut_cos=cos,
               peak_gib=peak, seconds=time.monotonic() - t_phase)
    ctx['families'] = out
    log(f'  families [{card}]: Qwen-14B widths, {nl} of 40 layers, group '
        f'128, w2 packed at K = {w2.k}; start {start_s:.1f} s; 4 concurrent '
        f'(prompts {list(lens)}, {n_new} new): TTFT '
        f'{[round(t, 3) for t in out["greedy"]["ttft_s"]]} s, '
        f'{out["greedy"]["tok_s_4_concurrent"]:.1f} tok/s; bs1 TTFT '
        f'{bs1[0][1]:.3f} s, {bs1[0][2]:.1f} tok/s; seeded pair identical; '
        f'speculative: {rounds} verify rounds, {spec[2]:.1f} tok/s, GEMM '
        f'routes {routes}; {long_len}-token prompt + {long_new} new past '
        f'{cfg.max_position_embeddings}: {agree} steps agree (FUSED_ROPE=1 '
        f'vs defaults), '
        f'{streams["defaults"][2]:.1f} tok/s; 2-layer cut prompt logits '
        f'vs the CPU: max err / max|logit| {rel:.3e}, min cosine '
        f'{cos:.6f}; peak {peak} GiB; {out["seconds"]:.1f} s')


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--phases', default=','.join(PHASES),
                    help=f'comma-separated subset of {PHASES} and of '
                         f'{OPTIONAL_PHASES} (not run by default)')
    ap.add_argument('--parent', metavar='TREE',
                    help='kernels phase: time kernels 1-5 of the '
                         'checkout at TREE (through its own wrappers, built '
                         "by its own build.py) beside this tree's; without "
                         "it kernel 3's parent column is this tree's route "
                         "mma and kernels 1, 2, 4, 5 have none")
    ap.add_argument('--gate-seeds', default='5', metavar='S,S,...',
                    help="tools phase: the seeds of the W4A8 gate's draws "
                         "and of the centred witness's (default 5)")
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
    unknown = set(phases) - set(PHASES + OPTIONAL_PHASES)
    if unknown:
        raise SystemExit(f'unknown phases {sorted(unknown)}')
    ctx = {'kernels': {}, 'profile': args.profile, 'parent': args.parent,
           'gate_seeds': tuple(int(v) for v in args.gate_seeds.split(','))}
    t_all = time.monotonic()
    try:
        for name in PHASES + OPTIONAL_PHASES:
            if name not in phases:
                continue
            log(f'== phase {name}')
            t0 = time.monotonic()
            globals()[f'phase_{name}'](torch, ctx)
            log(f'== phase {name} ok ({time.monotonic() - t0:.1f} s)')
    finally:
        import shutil
        for root in ctx.get('tmpdirs', []):
            shutil.rmtree(root, ignore_errors=True)
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
            quant_launches=k.get('quant_launches'),
            tools_launches=k.get('tools_launches'),
            families_launches=k.get('families_launches'),
            launches_per_verify_round=k.get('launches_per_verify_round'),
            max_abs_err=k.get('max_abs_err'), tolerance=k.get('tolerance'),
            ms=k.get('ms'), kernel_ms=k.get('ms'), plain_ms=k.get('plain_ms'),
            parent_ms=k.get('parent_ms'), parent=k.get('parent'),
            routes=k.get('routes'), route_launches=k.get('route_launches'),
            bound_ms=k.get('bound_ms'), bound_by=k.get('bound_by'),
            library_ms=k.get('library_ms'), library=k.get('library'),
            host_us=k.get('host_us'), parent_host_us=k.get('parent_host_us'),
            shape=k.get('shape'), at_bs1=k.get('m1') or k.get('b1'),
            chunk64_over300=k.get('chunk64_over300'),
            layer_by_m=k.get('layer_by_m'),
            cases=k.get('cases'), verify=k.get('verify'),
            verify_m40=k.get('verify_m40'), tp2=k.get('tp2'),
            tp2_launches=k.get('tp2_launches'), pp2=k.get('pp2'),
            groups=k.get('groups'), qwen14b=k.get('qwen14b'),
            pp2_launches=k.get('pp2_launches'),
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
