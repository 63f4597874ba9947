// Paged decode attention for Hopper (sm_90a), plain C interface: one kernel
// template over the mode and the KV width.
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
// For every slot b and kv head kh (grid (B, KH)):
//   1. modes 1-2, if valid[b]: the new K/V row lands at position ctx-1,
//      i.e. page page_table[b, pos / page] (clamped at 0), slot pos % page,
//      IN PLACE in the layer's pool [P, page, KH, Dh(/2)], quantised as
//      clip(rint(x / scale + zp)) in true f32 division (round half to
//      even) to [-128, 127] or [-8, 7]; then __syncthreads().  No other
//      block reads that row (it belongs to slot b, head kh).  The attention
//      below reads it back from the pool, so the current token is attended
//      in its stored form, as in the JAX kernels.
//   2. fp32 online-softmax attention of the G = H/KH q heads of kv head kh
//      (q scaled by Dh^-0.5) over the ctx tokens, walked through the page
//      table (entries clamped at 0), K/V dequantised in registers as
//      (q - zp) * scale from the layer's qparams (k_scale, k_zp, v_scale,
//      v_zp).
// Output [B, H, Dh] bf16.
//
// Bound: the KV bytes of the context, 2 * ctx * KH * Dh * (2 | 1 | 0.5)
// bytes per slot.  Design: 8 warps split the context; a warp reads one
// token's K and V rows as one coalesced segment each (256 | 128 | 64
// bytes), 4 tokens per iteration so several loads are in flight, and keeps
// its own online-softmax state per q head; the 8 warp states merge through
// shared memory at the end.  A lane holds 4 features of a row: 4l..4l+3
// for bf16 and int8, and {2l, 2l+1, 64+2l, 65+2l} for int4 (the two bytes
// 2l, 2l+1); q is staged through shared memory and read in the same order.
// Rope multiplies and adds with __fmul_rn / __fadd_rn so that no FMA
// contraction changes the stored K against the plain version.
//
// Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDh = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

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
  int KH, page_size, max_pages, half;
  float scale;
};

template <int BITS> struct Lane;
template <> struct Lane<0> { using T = uint2; };      // 4 bf16
template <> struct Lane<8> { using T = uint32_t; };   // 4 int8
template <> struct Lane<4> { using T = uint16_t; };   // 2 bytes, 4 nibbles

// Feature index of a lane's i-th value (i < 4).
template <int BITS>
__device__ __forceinline__ int feat(int lane, int i) {
  if (BITS == 4) return (i < 2 ? 0 : kDh / 2) + 2 * lane + (i & 1);
  return lane * 4 + i;
}

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int BITS>
__device__ __forceinline__ void dequant(typename Lane<BITS>::T raw,
                                        float scale, float zp, float* f) {
  if constexpr (BITS == 0) {
    f[0] = __uint_as_float(raw.x << 16);
    f[1] = __uint_as_float(raw.x & 0xFFFF0000u);
    f[2] = __uint_as_float(raw.y << 16);
    f[3] = __uint_as_float(raw.y & 0xFFFF0000u);
  } else if constexpr (BITS == 8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = (int)(int8_t)((raw >> (8 * i)) & 0xFFu);
      f[i] = ((float)v - zp) * scale;
    }
  } else {
    const uint32_t b0 = raw & 0xFFu, b1 = (raw >> 8) & 0xFFu;
    const uint32_t n[4] = {b0 & 0xFu, b1 & 0xFu, b0 >> 4, b1 >> 4};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = (int)(n[i] ^ 8u) - 8;
      f[i] = ((float)v - zp) * scale;
    }
  }
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

template <int G, int BITS, int MODE>
__global__ void __launch_bounds__(kThreads)
paged_decode(const DecodeArgs a) {
  __shared__ float red_m[kWarps][G];
  __shared__ float red_l[kWarps][G];
  __shared__ float red_acc[kWarps][G][kDh];
  __shared__ float qs[G][kDh];          // scaled (and rope'd) queries
  __shared__ float st[2][kDh];          // the K and V rows to store, f32

  constexpr int kRow = BITS == 0 ? 2 * kDh : (BITS == 8 ? kDh : kDh / 2);
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int KH = a.KH;
  const int H = KH * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int* ptb = a.page_table + (size_t)b * a.max_pages;
  const int ctx = a.context_len[b];
  const float* cos_b = MODE == 2 ? a.cos_f + (size_t)b * kDh : nullptr;
  const float* sin_b = MODE == 2 ? a.sin_f + (size_t)b * kDh : nullptr;
  float ks = 1.f, kz = 0.f, vs = 1.f, vz = 0.f;
  if (BITS != 0) {
    ks = a.qparams[0];
    kz = a.qparams[1];
    vs = a.qparams[2];
    vz = a.qparams[3];
  }

  // queries in f32: times Dh^-0.5 (mode 2: rope first, and times qscale)
  const __nv_bfloat16* qb = a.q + ((size_t)b * H + kh * G) * kDh;
  const float qmul = MODE == 2 ? a.scale * a.qscale[b] : a.scale;
  for (int i = tid; i < G * kDh; i += kThreads) {
    const int g = i / kDh, d = i % kDh;
    const float x = MODE == 2
        ? rope_at(qb + g * kDh, d, a.half, cos_b[d], sin_b[d])
        : bf2f(qb[i]);
    qs[g][d] = x * qmul;
  }

  // 1. append this step's K/V row (pool updated in place)
  if (MODE != 0) {
    const size_t kv0 = ((size_t)b * KH + kh) * kDh;
    for (int i = tid; i < 2 * kDh; i += kThreads) {
      const int which = i / kDh, d = i % kDh;     // which 0: K, 1: V
      st[which][d] = (MODE == 2 && which == 0)
          ? rope_at(a.k_new + kv0, d, a.half, cos_b[d], sin_b[d])
          : bf2f((which ? a.v_new : a.k_new)[kv0 + d]);
    }
  }
  __syncthreads();
  const int pos = ctx - 1;
  if (MODE != 0 && a.valid[b] != 0 && ctx >= 1 &&
      pos / a.page_size < a.max_pages) {
    const int phys = max(ptb[pos / a.page_size], 0);
    const size_t dst =
        (((size_t)phys * a.page_size + pos % a.page_size) * KH + kh) * kRow;
    if constexpr (BITS == 4) {
      // byte j: feature j in the low nibble, j + Dh/2 in the high one
      for (int i = tid; i < kDh; i += kThreads) {
        const int which = i / (kDh / 2), j = i % (kDh / 2);
        const float s = which ? vs : ks, z = which ? vz : kz;
        const int lo = quantize<4>(st[which][j], s, z) & 0xF;
        const int hi = quantize<4>(st[which][j + kDh / 2], s, z) & 0xF;
        (which ? a.vp : a.kp)[dst + j] = (uint8_t)(lo | (hi << 4));
      }
    } else {
      for (int i = tid; i < 2 * kDh; i += kThreads) {
        const int which = i / kDh, d = i % kDh;
        uint8_t* pool = which ? a.vp : a.kp;
        if constexpr (BITS == 0) {
          reinterpret_cast<__nv_bfloat16*>(pool + dst)[d] =
              __float2bfloat16_rn(st[which][d]);
        } else {
          pool[dst + d] = (uint8_t)(int8_t)quantize<8>(
              st[which][d], which ? vs : ks, which ? vz : kz);
        }
      }
    }
  }
  __syncthreads();

  // 2. attend
  float qv[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[g][i] = qs[g][feat<BITS>(lane, i)];
  float m[G], l[G], acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -1e30f;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
  }

  using T = typename Lane<BITS>::T;
  const int n_tok = min(ctx, a.max_pages * a.page_size);
  for (int base = warp * kUnroll; base < n_tok; base += kWarps * kUnroll) {
    T kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u;
      if (t < n_tok) {
        const int phys = max(ptb[t / a.page_size], 0);
        const size_t off =
            (((size_t)phys * a.page_size + t % a.page_size) * KH + kh) *
                kRow + lane * sizeof(T);
        kr[u] = *reinterpret_cast<const T*>(a.kp + off);
        vr[u] = *reinterpret_cast<const T*>(a.vp + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u >= n_tok) break;
      float kf[4], vf[4];
      dequant<BITS>(kr[u], ks, kz, kf);
      dequant<BITS>(vr[u], vs, vz, vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float sc = qv[g][0] * kf[0] + qv[g][1] * kf[1] + qv[g][2] * kf[2] +
                   qv[g][3] * kf[3];
        sc = warp_sum(sc);
        const float m_new = fmaxf(m[g], sc);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(sc - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[g][i] = acc[g][i] * alpha + p * vf[i];
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      red_m[warp][g] = m[g];
      red_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red_acc[warp][g][feat<BITS>(lane, i)] = acc[g][i];
  }
  __syncthreads();

  for (int i = tid; i < G * kDh; i += kThreads) {
    const int g = i / kDh;
    const int d = i - g * kDh;
    float mx = -1e30f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w][g]);
    float lsum = 0.f, acc_d = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(red_m[w][g] - mx);
      lsum += red_l[w][g] * f;
      acc_d += red_acc[w][g][d] * f;
    }
    a.out[((size_t)b * H + kh * G + g) * kDh + d] =
        __float2bfloat16_rn(acc_d / fmaxf(lsum, 1e-20f));
  }
}

template <int G, int BITS>
cudaError_t launch_mode(int mode, const DecodeArgs& a, dim3 grid,
                        cudaStream_t st) {
  switch (mode) {
    case 0: paged_decode<G, BITS, 0><<<grid, kThreads, 0, st>>>(a); break;
    case 1: paged_decode<G, BITS, 1><<<grid, kThreads, 0, st>>>(a); break;
    case 2: paged_decode<G, BITS, 2><<<grid, kThreads, 0, st>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_bits(int kv_bits, int mode, const DecodeArgs& a,
                        dim3 grid, cudaStream_t st) {
  switch (kv_bits) {
    case 0: return launch_mode<G, 0>(mode, a, grid, st);
    case 8: return launch_mode<G, 8>(mode, a, grid, st);
    case 4: return launch_mode<G, 4>(mode, a, grid, st);
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
// Pointers a mode does not read may be null.
int lmd_paged_decode_attention(
    int mode, const void* q, const void* k_new, const void* v_new,
    const void* cos_f, const void* sin_f, const void* qscale, void* k_pool,
    void* v_pool, const void* page_table, const void* context_len,
    const void* valid, const void* qparams, void* out, int B, int H, int KH,
    int Dh, int page_size, int max_pages, int kv_bits, int half, float scale,
    void* stream) {
  if (Dh != kDh || KH <= 0 || H % KH != 0 || mode < 0 || mode > 2 ||
      half < 0 || 2 * half > Dh || page_size <= 0)
    return (int)cudaErrorInvalidValue;
  if ((kv_bits != 0 && qparams == nullptr) ||
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
  a.KH = KH;
  a.page_size = page_size;
  a.max_pages = max_pages;
  a.half = half;
  a.scale = scale;
  const dim3 grid(B, KH);
  auto st = static_cast<cudaStream_t>(stream);
  switch (H / KH) {
    case 1: return (int)launch_bits<1>(kv_bits, mode, a, grid, st);
    case 2: return (int)launch_bits<2>(kv_bits, mode, a, grid, st);
    case 4: return (int)launch_bits<4>(kv_bits, mode, a, grid, st);
    case 8: return (int)launch_bits<8>(kv_bits, mode, a, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
