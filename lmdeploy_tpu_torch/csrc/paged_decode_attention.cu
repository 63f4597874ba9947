// Paged decode attention for Hopper (sm_90a), plain C interface: one kernel
// template over the mode, the KV width and the GQA group.
//
// Replaces three TPU kernels of lmdeploy_tpu/ops/pallas/paged_attention.py,
// at kv_bits 0 (bf16 pool), 8 (int8 pool) and 4 (nibble-packed uint8 pool,
// last dim Dh/2, half-split: byte j holds feature j in its low nibble and
// feature j + Dh/2 in its high nibble):
//   mode 0  paged_decode_attention (_decode_kernel): attend only; the
//           caller has written this step's K/V.
//   mode 1  paged_decode_attention_write (_decode_write_kernel +
//           _online_attend): store k_new/v_new, then attend.
//   mode 2  paged_decode_attention_rope_write (_decode_rope_write_kernel +
//           _rope_full): rotate-half rope of q and k_new from full-width
//           f32 tables cos_f/sin_f [B, Dh] (sign folded in; cos 1 / sin 0
//           past 2*half), q times qscale[b] (logn), then as mode 1.
// Output [B, H, Dh] bf16: f32 online-softmax attention of the G = H/KH q
// heads of each kv head (q scaled by Dh^-0.5) over the ctx tokens of the
// slot, walked through the page table (entries clamped at 0).  In modes 1-2
// a slot with valid == 0 stores nothing and its output is zeros (it is
// discarded upstream); mode 0 attends every slot.  The new K/V row lands at
// position ctx-1, page page_table[b, pos / page], slot pos % page, IN PLACE
// in the layer's pool [P, page, KH, Dh(/2)], quantised as
// clip(rint(x / scale + zp)) in true f32 division (round half to even) to
// [-128, 127] or [-8, 7]; the attention reads it back from the pool, so the
// current token is attended in its stored form, as in the JAX kernels.
//
// Bound: the KV bytes of the context, 2 * ctx * KH * Dh * (2 | 1 | 0.5)
// bytes per slot (B = 8 at ctx 512: 19 / 9.6 / 4.8 us at 3.35 TB/s).  The
// previous design walked the context token by token (a 5-shuffle
// reduction and two exp per token and head) in one block per (slot, kv
// head), so fewer KV bytes bought no time and bs1 used 32 SMs.  Here:
//  * Split over the context: grid (KH, B, S).  The host fixes S from the
//    page table's width and passes `want`, the most splits per slot that
//    keep every live block resident at once (SMs x blocks per SM, from the
//    runtime's occupancy calculator, over B * KH: lmd_paged_decode_want);
//    never from context_len, so no host sync.
//    Each slot then cuts its own context into at most `want` splits of
//    whole 64-token tiles; splits past them exit at once, and as the split
//    is the grid's slowest index they are dispatched after the live ones.
//  * Tile-parallel inside a split, as the JAX page walk is: 64-token tiles
//    of K and V rows go to shared memory with cp.async, the next two tiles
//    in flight while this one is computed; the split's page-table entries are
//    read once into shared memory, so no table read sits in front of a
//    row's load.  Scores: two threads per token (interleaved 16-byte
//    chunks of the row, one shuffle to add them), q from shared memory.
//    One max and one rescale per tile and head, one exp per score.  P V:
//    one thread per feature, p broadcast from shared memory.
//  * Quantised pools stay integer codes in the sums and the qparams are
//    applied in f32 outside them, as the prefill kernel does: scores are
//    k_scale (q . codes) (the key zero point adds one constant per score
//    row, which softmax cancels) and the output is
//    v_scale (P codes / l - v_zp).  So int8 / int4 rows cost only their
//    bytes and a convert.
//  * One launch per layer: each split writes its (m, l, acc) to an f32
//    scratch; the last split of a (slot, kv head) to finish, found by an
//    atomicAdd ticket on an int32 [B, KH] counter after __threadfence(),
//    merges them (log-sum-exp) and writes the bf16 output, then resets the
//    counter to 0 for the next launch.  A slot whose context fits one split
//    writes its output directly.
//  * Store, then attend (modes 1-2): the block whose split holds ctx-1
//    stores the new row before it issues any load; no other block reads
//    that row.  Rope multiplies and adds with __fmul_rn / __fadd_rn so
//    that no FMA contraction changes the stored K against the plain
//    version.
//
// Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDh = 128;
constexpr int kThreads = 128;   // one per feature in P V
constexpr int kTile = 64;       // tokens per tile
constexpr int kStages = 3;      // tiles in shared memory: two in flight
constexpr int kMaxPages = 128;  // page-table entries one split may span
constexpr float kLog2e = 1.4426950408889634f;

struct DecodeArgs {
  const __nv_bfloat16* q;       // [B, H, Dh]
  const __nv_bfloat16* k_new;   // [B, KH, Dh] (modes 1-2)
  const __nv_bfloat16* v_new;
  const float* cos_f;           // [B, Dh] (mode 2)
  const float* sin_f;
  const float* qscale;          // [B] (mode 2)
  uint8_t* kp;                  // one layer of the pool
  uint8_t* vp;
  const int* page_table;        // [B, max_pages]
  const int* context_len;       // [B]
  const int* valid;             // [B] (modes 1-2)
  const float* qparams;         // [4] (kv_bits 8, 4)
  __nv_bfloat16* out;           // [B, H, Dh]
  float* part;                  // [B, KH, S, G, Dh] then [B, KH, S, G, 2]
  int* counter;                 // [B, KH], zero between launches
  int KH, page_size, max_pages, half, want, splits;
  float scale;
};

// Bytes of one token's row of one kv head, and the padded stride of the K
// rows in shared memory (two threads per token read interleaved 16-byte
// chunks of neighbouring rows without bank conflicts).
template <int BITS> struct Row {
  static constexpr int kBytes =
      BITS == 0 ? 2 * kDh : (BITS == 8 ? kDh : kDh / 2);
  static constexpr int kChunks = kBytes / 16;
  static constexpr int kKStride = kBytes + 16;
};

template <int G, int BITS>
struct Smem {
  static constexpr int kK = kStages * kTile * Row<BITS>::kKStride;
  static constexpr int kV = kStages * kTile * Row<BITS>::kBytes;
  static constexpr int kQ = G * kDh * 4;
  static constexpr int kP = G * kTile * 4;
  static constexpr int kBytes =
      kK + kV + kQ + kP + 3 * G * 4 + kMaxPages * 4 + 16;
};

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// clip(rint(x / scale + zp)) in f32, as torch.round / jnp.round do.
template <int BITS>
__device__ __forceinline__ int quantize(float x, float scale, float zp) {
  const float lo = BITS == 4 ? -8.f : -128.f;
  const float hi = BITS == 4 ? 7.f : 127.f;
  const float q = rintf(__fadd_rn(__fdiv_rn(x, scale), zp));
  return (int)fminf(fmaxf(q, lo), hi);
}

// Rotate-half rope of feature d of the bf16 row x, in f32.
__device__ __forceinline__ float rope_at(const __nv_bfloat16* x, int d,
                                         int half, float c, float s) {
  const int p = d < half ? d + half : (d < 2 * half ? d - half : d);
  return __fadd_rn(__fmul_rn(bf2f(x[d]), c), __fmul_rn(bf2f(x[p]), s));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Dot product of the f32 q row qg with 16 bytes of a K row (chunk ch):
// bf16 values (8 features), int8 codes (16) or int4 codes (32: bytes
// 16 ch .. 16 ch + 15, low nibbles features 16 ch + e, high 64 + 16 ch + e).
template <int BITS>
__device__ __forceinline__ float dot_chunk(const float* qg, uint4 raw,
                                           int ch) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  float s = 0.f;
  if constexpr (BITS == 0) {
    const float* qc = qg + 8 * ch;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s += qc[2 * i] * __uint_as_float(w[i] << 16);
      s += qc[2 * i + 1] * __uint_as_float(w[i] & 0xFFFF0000u);
    }
  } else if constexpr (BITS == 8) {
    const float* qc = qg + 16 * ch;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      s += qc[i] * (float)(int8_t)((w[i >> 2] >> (8 * (i & 3))) & 0xFFu);
  } else {
    const float* lo = qg + 16 * ch;
    const float* hi = qg + kDh / 2 + 16 * ch;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t byte = (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
      s += lo[i] * (float)((int)((byte & 0xFu) ^ 8u) - 8);
      s += hi[i] * (float)((int)((byte >> 4) ^ 8u) - 8);
    }
  }
  return s;
}

// Feature d of V row `row` in shared memory: a bf16 value or an int code.
template <int BITS>
__device__ __forceinline__ float v_at(const uint8_t* row, int d) {
  if constexpr (BITS == 0) {
    return bf2f(reinterpret_cast<const __nv_bfloat16*>(row)[d]);
  } else if constexpr (BITS == 8) {
    return (float)reinterpret_cast<const int8_t*>(row)[d];
  } else {
    const uint32_t byte = row[d & (kDh / 2 - 1)];
    const uint32_t nib = d < kDh / 2 ? (byte & 0xFu) : (byte >> 4);
    return (float)((int)(nib ^ 8u) - 8);
  }
}

template <int G, int BITS, int MODE>
__global__ void __launch_bounds__(kThreads)
paged_decode(const DecodeArgs a) {
  using R = Row<BITS>;
  using SM = Smem<G, BITS>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* kbuf = smem;                           // [kStages][64][kKStride]
  uint8_t* vbuf = smem + SM::kK;                  // [kStages][64][kBytes]
  float* qs = reinterpret_cast<float*>(vbuf + SM::kV);   // [G][Dh]
  float* sp = qs + G * kDh;                              // [G][64]
  float* ms = sp + G * kTile;                            // [G] running max
  float* ls = ms + G;                                    // [G] running sum
  float* al = ls + G;                                    // [G] tile rescale
  int* pg = reinterpret_cast<int*>(al + G);              // [kMaxPages]
  int* ticket = pg + kMaxPages;
  // the row to store, in the second K tile (free until tile 1 loads)
  float* st = reinterpret_cast<float*>(kbuf + kTile * R::kKStride);

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int KH = a.KH;
  const int H = KH * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int page = a.page_size;
  const int ctx = a.context_len[b];
  const int n_tok = max(0, min(ctx, a.max_pages * page));
  const bool masked = MODE != 0 && a.valid[b] == 0;
  // this slot's splits: up to `want`, whole tiles, none past 126 pages
  const int cap = (kMaxPages - 2) * page / kTile * kTile;
  int n_split = min(a.want, (n_tok + kTile - 1) / kTile);
  n_split = max(1, min(max(n_split, (n_tok + cap - 1) / cap), a.splits));
  const int tps = ((n_tok + n_split - 1) / n_split + kTile - 1) / kTile * kTile;
  const int n_active = masked || n_tok == 0 ? 0 : (n_tok + tps - 1) / tps;
  __nv_bfloat16* outb = a.out + ((size_t)b * H + kh * G) * kDh;

  if (n_active == 0) {        // masked slot or empty context: zeros
    if (split == 0)
      for (int i = tid; i < G * kDh; i += kThreads)
        outb[i] = __float2bfloat16_rn(0.f);
    return;
  }
  if (split >= n_active) return;

  const int t0 = split * tps;
  const int t1 = min(t0 + tps, n_tok);
  const int* ptb = a.page_table + (size_t)b * a.max_pages;
  const float* cos_b = MODE == 2 ? a.cos_f + (size_t)b * kDh : nullptr;
  const float* sin_b = MODE == 2 ? a.sin_f + (size_t)b * kDh : nullptr;
  float ks = 1.f, kz = 0.f, vs = 1.f, vz = 0.f;
  if (BITS != 0) {
    ks = a.qparams[0];
    kz = a.qparams[1];
    vs = a.qparams[2];
    vz = a.qparams[3];
  }

  // queries in f32 times Dh^-0.5 (mode 2: rope first, and times qscale),
  // then times k_scale and log2(e): scores come out in base 2
  const __nv_bfloat16* qb = a.q + ((size_t)b * H + kh * G) * kDh;
  const float qmul = MODE == 2 ? a.scale * a.qscale[b] : a.scale;
  for (int i = tid; i < G * kDh; i += kThreads) {
    const int g = i / kDh, d = i % kDh;
    const float x = MODE == 2
        ? rope_at(qb + g * kDh, d, a.half, cos_b[d], sin_b[d])
        : bf2f(qb[i]);
    qs[i] = (x * qmul) * (ks * kLog2e);
  }
  if (tid < G) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.f;
  }
  const int first_page = t0 / page;
  const int n_pages = (t1 - 1) / page - first_page + 1;
  for (int i = tid; i < n_pages; i += kThreads)
    pg[i] = max(ptb[first_page + i], 0);

  // store this step's K/V row, in the split that holds ctx-1, before any
  // tile is loaded
  const bool store = MODE != 0 && ctx >= 1 && ctx == n_tok &&
                     split == n_active - 1;
  if (store) {
    const size_t kv0 = ((size_t)b * KH + kh) * kDh;
    for (int i = tid; i < 2 * kDh; i += kThreads) {
      const int which = i / kDh, d = i % kDh;     // which 0: K, 1: V
      st[i] = (MODE == 2 && which == 0)
          ? rope_at(a.k_new + kv0, d, a.half, cos_b[d], sin_b[d])
          : bf2f((which ? a.v_new : a.k_new)[kv0 + d]);
    }
  }
  __syncthreads();
  if (store) {
    const int pos = ctx - 1;
    const int phys = max(ptb[pos / page], 0);
    const size_t dst =
        (((size_t)phys * page + pos % page) * KH + kh) * R::kBytes;
    if constexpr (BITS == 4) {
      // byte j: feature j in the low nibble, j + Dh/2 in the high one
      for (int i = tid; i < kDh; i += kThreads) {
        const int which = i / (kDh / 2), j = i % (kDh / 2);
        const float s = which ? vs : ks, z = which ? vz : kz;
        const int lo = quantize<4>(st[which * kDh + j], s, z) & 0xF;
        const int hi = quantize<4>(st[which * kDh + j + kDh / 2], s, z) & 0xF;
        (which ? a.vp : a.kp)[dst + j] = (uint8_t)(lo | (hi << 4));
      }
    } else {
      for (int i = tid; i < 2 * kDh; i += kThreads) {
        const int which = i / kDh, d = i % kDh;
        uint8_t* pool = which ? a.vp : a.kp;
        if constexpr (BITS == 0) {
          reinterpret_cast<__nv_bfloat16*>(pool + dst)[d] =
              __float2bfloat16_rn(st[i]);
        } else {
          pool[dst + d] = (uint8_t)(int8_t)quantize<8>(
              st[i], which ? vs : ks, which ? vz : kz);
        }
      }
    }
    __syncthreads();
  }

  // ---- tiles of 64 tokens, the next two in flight ----
  const int n_tiles = (t1 - t0 + kTile - 1) / kTile;
  auto load_tile = [&](int i, int buf) {
    for (int c = tid; c < kTile * R::kChunks; c += kThreads) {
      const int j = c / R::kChunks, ch = c % R::kChunks;
      const int tok = t0 + i * kTile + j;
      const bool ok = tok < t1;
      size_t off = 0;
      if (ok) {
        const int phys = pg[tok / page - first_page];
        off = (((size_t)phys * page + tok % page) * KH + kh) * R::kBytes +
              ch * 16;
      }
      cp_async16(kbuf + (buf * kTile + j) * R::kKStride + ch * 16,
                 a.kp + off, ok);
      cp_async16(vbuf + (buf * kTile + j) * R::kBytes + ch * 16, a.vp + off,
                 ok);
    }
  };

  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  const int tj = tid >> 1;        // this thread's token in a tile
  const int hf = tid & 1;         // and which interleaved half of its row

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i % kStages;
    const int next = i + kStages - 1;
    if (next < n_tiles) load_tile(next, next % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();

    // scores (base 2) of token tj for every head
    const int tile0 = t0 + i * kTile;
    const uint8_t* krow = kbuf + (buf * kTile + tj) * R::kKStride;
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = 0.f;
#pragma unroll
    for (int c = 0; c < R::kChunks / 2; ++c) {
      const int ch = 2 * c + hf;
      const uint4 raw = *reinterpret_cast<const uint4*>(krow + ch * 16);
#pragma unroll
      for (int g = 0; g < G; ++g)
        sc[g] += dot_chunk<BITS>(qs + g * kDh, raw, ch);
    }
    const bool tok_ok = tile0 + tj < t1;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float s = sc[g] + __shfl_xor_sync(0xFFFFFFFFu, sc[g], 1);
      if (hf == 0) sp[g * kTile + tj] = tok_ok ? s : -INFINITY;
    }
    __syncthreads();

    // one max, one rescale per tile and head; p = exp2(s - m)
    for (int g = warp; g < G; g += kThreads / 32) {
      const float s0 = sp[g * kTile + lane];
      const float s1 = sp[g * kTile + lane + 32];
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = exp2f(s0 - m_new);
      const float p1 = exp2f(s1 - m_new);
      sp[g * kTile + lane] = p0;
      sp[g * kTile + lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        ms[g] = m_new;
        ls[g] = ls[g] * alpha + psum;
        al[g] = alpha;
      }
    }
    __syncthreads();

    // P V: thread tid owns feature tid; rows past the split are zero-filled
    // and their p is 0, so every tile runs all 64 rows, p four at a time
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] *= al[g];
    const uint8_t* vrow = vbuf + buf * kTile * R::kBytes;
    for (int j = 0; j < kTile; j += 4) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = v_at<BITS>(vrow + (j + u) * R::kBytes, tid);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 p4 = *reinterpret_cast<const float4*>(sp + g * kTile + j);
        acc[g] += p4.x * v[0] + p4.y * v[1] + p4.z * v[2] + p4.w * v[3];
      }
    }
    __syncthreads();
  }

  auto finish = [&](float o) {          // o = P V / l, in codes for int
    return BITS != 0 ? (o - vz) * vs : o;
  };
  if (n_active == 1) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      outb[g * kDh + tid] =
          __float2bfloat16_rn(finish(acc[g] / fmaxf(ls[g], 1e-20f)));
    return;
  }

  // ---- several splits: write the partial, the last one merges ----
  const int bk = b * KH + kh;
  const size_t n_part = (size_t)gridDim.y * KH * a.splits * G;
  float* pacc = a.part + ((size_t)bk * a.splits) * G * kDh;
  float* pml = a.part + n_part * kDh + ((size_t)bk * a.splits) * G * 2;
#pragma unroll
  for (int g = 0; g < G; ++g)
    pacc[((size_t)split * G + g) * kDh + tid] = acc[g];
  if (tid < G) {
    pml[(split * G + tid) * 2] = ms[tid];
    pml[(split * G + tid) * 2 + 1] = ls[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *ticket = atomicAdd(a.counter + bk, 1);
  __syncthreads();
  if (*ticket != n_active - 1) return;
  __threadfence();
  // every split's (m, l) into shared memory (the K buffer is free now)
  float* mls = reinterpret_cast<float*>(kbuf);
  for (int i = tid; i < n_active * G * 2; i += kThreads)
    mls[i] = __ldcg(pml + i);
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = -INFINITY;
    for (int s = 0; s < n_active; ++s) mx = fmaxf(mx, mls[(s * G + g) * 2]);
    float lsum = 0.f, o = 0.f;
    for (int s = 0; s < n_active; ++s) {
      const float f = exp2f(mls[(s * G + g) * 2] - mx);
      lsum += mls[(s * G + g) * 2 + 1] * f;
      o += __ldcg(pacc + ((size_t)s * G + g) * kDh + tid) * f;
    }
    outb[g * kDh + tid] = __float2bfloat16_rn(finish(o / fmaxf(lsum, 1e-20f)));
  }
  if (tid == 0) a.counter[bk] = 0;      // ready for the next launch
}

// Launch one instantiation, or with `occ` set, write the blocks of it that
// fit on one SM at once instead.
template <int G, int BITS, int MODE>
cudaError_t launch_one(const DecodeArgs& a, dim3 grid, cudaStream_t st,
                       int* occ) {
  constexpr int kSmem = Smem<G, BITS>::kBytes;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode<G, BITS, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  if (occ != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, paged_decode<G, BITS, MODE>, kThreads, kSmem);
  paged_decode<G, BITS, MODE><<<grid, kThreads, kSmem, st>>>(a);
  return cudaGetLastError();
}

template <int G, int BITS>
cudaError_t launch_mode(int mode, const DecodeArgs& a, dim3 grid,
                        cudaStream_t st, int* occ) {
  switch (mode) {
    case 0: return launch_one<G, BITS, 0>(a, grid, st, occ);
    case 1: return launch_one<G, BITS, 1>(a, grid, st, occ);
    case 2: return launch_one<G, BITS, 2>(a, grid, st, occ);
    default: return cudaErrorInvalidValue;
  }
}

template <int G>
cudaError_t launch_bits(int kv_bits, int mode, const DecodeArgs& a,
                        dim3 grid, cudaStream_t st, int* occ) {
  switch (kv_bits) {
    case 0: return launch_mode<G, 0>(mode, a, grid, st, occ);
    case 8: return launch_mode<G, 8>(mode, a, grid, st, occ);
    case 4: return launch_mode<G, 4>(mode, a, grid, st, occ);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int g, int kv_bits, int mode, const DecodeArgs& a,
                     dim3 grid, cudaStream_t st, int* occ) {
  switch (g) {
    case 1: return launch_bits<1>(kv_bits, mode, a, grid, st, occ);
    case 2: return launch_bits<2>(kv_bits, mode, a, grid, st, occ);
    case 4: return launch_bits<4>(kv_bits, mode, a, grid, st, occ);
    case 8: return launch_bits<8>(kv_bits, mode, a, grid, st, occ);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// mode 0 attend, 1 store + attend, 2 rope + store + attend (see above).
// k_pool/v_pool point at ONE layer of the pool: [P, page, KH, Dh] bf16
// (kv_bits 0) or int8 (8), [P, page, KH, Dh/2] uint8 (4).  page_table
// [B, max_pages], context_len [B], valid [B] are int32; qparams f32 [4]
// (kv_bits 8, 4); cos_f/sin_f f32 [B, Dh], qscale f32 [B] (mode 2).
// Pointers a mode does not read may be null.  The grid has `splits`
// splits per (slot, kv head), enough for a split of at most 126 pages; a
// slot uses up to `want` of them.  With splits > 1, `part` is f32 scratch
// of B * KH * splits * G * (Dh + 2) and `counter` int32 [B, KH], zero
// before the first launch (each launch leaves it at zero).
int lmd_paged_decode_attention(
    int mode, const void* q, const void* k_new, const void* v_new,
    const void* cos_f, const void* sin_f, const void* qscale, void* k_pool,
    void* v_pool, const void* page_table, const void* context_len,
    const void* valid, const void* qparams, void* out, void* part,
    void* counter, int B, int H, int KH, int Dh, int page_size,
    int max_pages, int kv_bits, int half, int want, int splits, float scale,
    void* stream) {
  const long long cap = (kMaxPages - 2) * page_size / kTile * kTile;
  if (Dh != kDh || KH <= 0 || H % KH != 0 || mode < 0 || mode > 2 ||
      half < 0 || 2 * half > Dh || page_size <= 0 || want <= 0 ||
      splits <= 0 || cap < kTile ||
      (long long)splits * cap < (long long)max_pages * page_size)
    return (int)cudaErrorInvalidValue;
  if ((kv_bits != 0 && qparams == nullptr) ||
      (splits > 1 && (part == nullptr || counter == nullptr)) ||
      (mode >= 1 && (k_new == nullptr || v_new == nullptr ||
                     valid == nullptr)) ||
      (mode == 2 && (cos_f == nullptr || sin_f == nullptr ||
                     qscale == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  DecodeArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_new = static_cast<const __nv_bfloat16*>(k_new);
  a.v_new = static_cast<const __nv_bfloat16*>(v_new);
  a.cos_f = static_cast<const float*>(cos_f);
  a.sin_f = static_cast<const float*>(sin_f);
  a.qscale = static_cast<const float*>(qscale);
  a.kp = static_cast<uint8_t*>(k_pool);
  a.vp = static_cast<uint8_t*>(v_pool);
  a.page_table = static_cast<const int*>(page_table);
  a.context_len = static_cast<const int*>(context_len);
  a.valid = static_cast<const int*>(valid);
  a.qparams = static_cast<const float*>(qparams);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part = static_cast<float*>(part);
  a.counter = static_cast<int*>(counter);
  a.KH = KH;
  a.page_size = page_size;
  a.max_pages = max_pages;
  a.half = half;
  a.want = want;
  a.splits = splits;
  a.scale = scale;
  return (int)dispatch(H / KH, kv_bits, mode, a, dim3(KH, B, splits),
                       static_cast<cudaStream_t>(stream), nullptr);
}

// The most splits per slot that keep all B * KH * splits blocks of this
// mode, width and group resident on the card at once (at least 1); a
// negative value is a CUDA error.
int lmd_paged_decode_want(int mode, int kv_bits, int g, int pairs) {
  int dev = 0, sms = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = dispatch(g, kv_bits, mode, DecodeArgs(), dim3(), nullptr, &occ);
  if (e != cudaSuccess) return -(int)e;
  const int want = sms * occ / (pairs > 0 ? pairs : 1);
  return want > 1 ? want : 1;
}

}  // extern "C"
