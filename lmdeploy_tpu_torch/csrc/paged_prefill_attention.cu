// Paged prefill (chunked context) attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel lmdeploy_tpu/ops/pallas/prefill_attention.py::
// paged_prefill_attention_batched (_prefill_kernel) at kv_bits 0 (bf16
// pool), 8 (int8 pool) and 4 (nibble-packed uint8 pool, last dim Dh/2,
// half-split: byte j holds feature j low and j + Dh/2 high); the quantised
// widths are dequantised as (q - zp) * scale with the layer's qparams
// (k_scale, k_zp, v_scale, v_zp) while the KV tile is loaded.  Causal
// attention of a chunk q [B, T, H, Dh] at absolute positions
// start_pos[b] + t over the paged history plus the chunk (already written
// to the pool), mask kv_pos <= q_pos && kv_pos < context_end[b], fp32
// online softmax, scale Dh^-0.5.  Output [B, T, H, Dh] in q's dtype (bf16).
//
// Grid (B, ceil(T / QB), KH) with QB = 64 / G query tokens per block, so a
// block holds 64 q rows (QB tokens x the G heads of kv head kh) in shared
// memory.  It walks the KV in 64-token tiles up to the last tile causally
// visible to its last query, resolving each token's page through the page
// table (entries clamped at 0).  Tokens at or past context_end are not read
// (zero-filled and masked), so padding rows (context_end == start_pos)
// come out as zeros; the JAX kernel leaves a different finite value there,
// and both are discarded upstream.
//
// Bound: bytes (the chunk's q/out plus the visible KV at 2, 1 or 0.5
// bytes per element) at a 512-token chunk; 4*T*ctx*Dh*H operations (/2
// for the causal half).  This first version is SIMT fp32 (register tiles of 4x4 scores and 4x8 outputs per
// thread); tensor cores come with a later change.
//
// Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDh = 128;
constexpr int kRows = 64;            // q rows per block
constexpr int kTile = 64;            // kv tokens per tile
constexpr int kThreads = 256;        // 16 x 16
constexpr int kQStride = kDh + 4;    // f32, padded rows
constexpr int kKStride = kDh + 4;
constexpr int kVStride = kDh;
constexpr int kPStride = kTile;
constexpr size_t kSmemFloats = (size_t)kRows * kQStride +
                               (size_t)kTile * kKStride +
                               (size_t)kTile * kVStride +
                               (size_t)kRows * kPStride;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__device__ __forceinline__ void bf16x8_to_f32(uint4 v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// 8 features d..d+7 (d a multiple of 8) of one pool row -> f32.
template <int BITS>
__device__ __forceinline__ void load8(const uint8_t* row, int d, float scale,
                                      float zp, float* f) {
  if constexpr (BITS == 0) {
    bf16x8_to_f32(*reinterpret_cast<const uint4*>(row + 2 * d), f);
  } else if constexpr (BITS == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(row + d);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t w = e < 4 ? raw.x : raw.y;
      const int v = (int)(int8_t)((w >> (8 * (e & 3))) & 0xFFu);
      f[e] = ((float)v - zp) * scale;
    }
  } else {
    // features d..d+7 sit in bytes d % 64 .. +7, low nibbles below 64
    const uint2 raw =
        *reinterpret_cast<const uint2*>(row + (d & (kDh / 2 - 1)));
    const int shift = d < kDh / 2 ? 0 : 4;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t w = e < 4 ? raw.x : raw.y;
      const uint32_t n = (w >> (8 * (e & 3) + shift)) & 0xFu;
      f[e] = ((float)((int)(n ^ 8u) - 8) - zp) * scale;
    }
  }
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
paged_prefill(const __nv_bfloat16* __restrict__ q,
              const uint8_t* __restrict__ kp,
              const uint8_t* __restrict__ vp,
              const int* __restrict__ page_tables,
              const int* __restrict__ start_pos,
              const int* __restrict__ context_end,
              const float* __restrict__ qparams,
              __nv_bfloat16* __restrict__ out, int T, int H, int KH, int G,
              int page_size, int max_pages, float scale) {
  constexpr int kRow = BITS == 0 ? 2 * kDh : (BITS == 8 ? kDh : kDh / 2);
  extern __shared__ float smem[];
  float* qs = smem;                             // [kRows][kQStride]
  float* ks = qs + kRows * kQStride;            // [kTile][kKStride]
  float* vs = ks + kTile * kKStride;            // [kTile][kVStride]
  float* ps = vs + kTile * kVStride;            // [kRows][kPStride]

  const int b = blockIdx.x;
  const int qb = blockIdx.y;
  const int kh = blockIdx.z;
  const int QB = kRows / G;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int* ptb = page_tables + (size_t)b * max_pages;
  const int start = start_pos[b];
  const int ctx_end = context_end[b];
  const int t0 = qb * QB;                       // first chunk token
  const int t_last = min(t0 + QB, T) - 1;
  const int kv_cap = max_pages * page_size;
  float k_s = 1.f, k_z = 0.f, v_s = 1.f, v_z = 0.f;   // qparams
  if (BITS != 0) {
    k_s = qparams[0];
    k_z = qparams[1];
    v_s = qparams[2];
    v_z = qparams[3];
  }

  // q rows: r = t_local * G + g  ->  token t0 + t_local, head kh*G + g
  for (int i = tid; i < kRows * (kDh / 8); i += kThreads) {
    const int r = i / (kDh / 8);
    const int c = (i - r * (kDh / 8)) * 8;
    const int t = t0 + r / G;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (t < T) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * T + t) * H + kh * G + r % G) * kDh + c);
      bf16x8_to_f32(raw, f);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) qs[r * kQStride + c + e] = f[e] * scale;
  }

  // this thread's rows r = ty + 16*i and their absolute positions
  int q_pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q_pos[i] = start + t0 + (ty + 16 * i) / G;
  float m[4], l[4], o[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) o[i][e] = 0.f;
  }

  const int last_q_pos = min(start + t_last, ctx_end - 1);
  const int n_tiles = max(last_q_pos / kTile + 1, 1);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * kTile;
    __syncthreads();  // previous tile's readers are done with ks/vs/ps
    for (int i = tid; i < kTile * (kDh / 8); i += kThreads) {
      const int c_tok = i / (kDh / 8);
      const int d = (i - c_tok * (kDh / 8)) * 8;
      const int pos = kv0 + c_tok;
      float fk[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float fv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (pos < ctx_end && pos < kv_cap) {
        const int phys = max(ptb[pos / page_size], 0);
        const size_t off =
            (((size_t)phys * page_size + pos % page_size) * KH + kh) * kRow;
        load8<BITS>(kp + off, d, k_s, k_z, fk);
        load8<BITS>(vp + off, d, v_s, v_z, fv);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        ks[c_tok * kKStride + d + e] = fk[e];
        vs[c_tok * kVStride + d + e] = fv[e];
      }
    }
    __syncthreads();

    // scores for rows ty + 16*i, kv columns tx + 16*j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kDh; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(
            &qs[(ty + 16 * i) * kQStride + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(
            &ks[(tx + 16 * j) * kKStride + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[i][j] += qa[i].x * ka[j].x + qa[i].y * ka[j].y +
                      qa[i].z * ka[j].z + qa[i].w * ka[j].w;
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kv_pos = kv0 + tx + 16 * j;
        const bool ok = kv_pos <= q_pos[i] && kv_pos < ctx_end;
        sc[i][j] = ok ? sc[i][j] : -1e30f;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        rs += p;
      }
      rs = half_warp_sum(rs);
      l[i] = l[i] * alpha[i] + rs;
      m[i] = m_new;
    }
    __syncthreads();

    // o[rows ty + 16*i][cols tx*8 .. tx*8+7] = o * alpha + P @ V
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) o[i][e] *= alpha[i];
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      const float4 v0 =
          *reinterpret_cast<const float4*>(&vs[c * kVStride + tx * 8]);
      const float4 v1 =
          *reinterpret_cast<const float4*>(&vs[c * kVStride + tx * 8 + 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty + 16 * i) * kPStride + c];
        o[i][0] += p * v0.x;
        o[i][1] += p * v0.y;
        o[i][2] += p * v0.z;
        o[i][3] += p * v0.w;
        o[i][4] += p * v1.x;
        o[i][5] += p * v1.y;
        o[i][6] += p * v1.z;
        o[i][7] += p * v1.w;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int t = t0 + r / G;
    if (t >= T) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-20f);
    uint32_t packed[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat16 lo = __float2bfloat16_rn(o[i][2 * e] * inv);
      const __nv_bfloat16 hi = __float2bfloat16_rn(o[i][2 * e + 1] * inv);
      packed[e] = (uint32_t)__bfloat16_as_ushort(lo) |
                  ((uint32_t)__bfloat16_as_ushort(hi) << 16);
    }
    *reinterpret_cast<uint4*>(
        out + (((size_t)b * T + t) * H + kh * G + r % G) * kDh + tx * 8) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

template <int BITS>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* page_tables, const void* start_pos,
                   const void* context_end, const void* qparams, void* out,
                   int B, int T, int H, int KH, int page_size, int max_pages,
                   float scale, cudaStream_t st) {
  static bool smem_set = false;  // once, outside any graph capture
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_prefill<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int G = H / KH;
  const int QB = kRows / G;
  const dim3 grid(B, (T + QB - 1) / QB, KH);
  paged_prefill<BITS><<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const uint8_t*>(k_pool), static_cast<const uint8_t*>(v_pool),
      static_cast<const int*>(page_tables), static_cast<const int*>(start_pos),
      static_cast<const int*>(context_end),
      static_cast<const float*>(qparams), static_cast<__nv_bfloat16*>(out), T,
      H, KH, G, page_size, max_pages, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// k_pool/v_pool point at ONE layer of the pool: [P, page, KH, Dh] bf16
// (kv_bits 0) or int8 (8), [P, page, KH, Dh/2] uint8 (4); page_tables
// [B, max_pages], start_pos [B], context_end [B] are int32; qparams f32 [4]
// (kv_bits 8, 4; may be null for 0).
int lmd_paged_prefill_attention(const void* q, const void* k_pool,
                                const void* v_pool, const void* page_tables,
                                const void* start_pos, const void* context_end,
                                const void* qparams, void* out, int B, int T,
                                int H, int KH, int Dh, int page_size,
                                int max_pages, int kv_bits, float scale,
                                void* stream) {
  if (Dh != kDh || KH <= 0 || H % KH != 0) return (int)cudaErrorInvalidValue;
  const int G = H / KH;
  if (G > kRows || kRows % G != 0) return (int)cudaErrorInvalidValue;
  if (kv_bits != 0 && qparams == nullptr) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return (int)cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  switch (kv_bits) {
    case 0:
      return (int)launch<0>(q, k_pool, v_pool, page_tables, start_pos,
                            context_end, qparams, out, B, T, H, KH, page_size,
                            max_pages, scale, st);
    case 8:
      return (int)launch<8>(q, k_pool, v_pool, page_tables, start_pos,
                            context_end, qparams, out, B, T, H, KH, page_size,
                            max_pages, scale, st);
    case 4:
      return (int)launch<4>(q, k_pool, v_pool, page_tables, start_pos,
                            context_end, qparams, out, B, T, H, KH, page_size,
                            max_pages, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
