// W4A16 grouped-int4 GEMM for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel lmdeploy_tpu/ops/pallas/quant_matmul.py::
// packed_int4_matmul (_mm_kernel).  Computes the UNSCALED-zero-point product
//
//     y[M, N] (f32) = sum_g (x_g @ nib_g) * s_g
//
// over one layer's nibble-packed weight.  The caller subtracts the
// asymmetric zero-point term rowsum_g(x) @ (s*z) outside (ops/linear.py).
//
// Layout (kept from the JAX package, pack_nibbles): packed byte w[k', n]
// holds logical row k' in its low nibble and row K/2 + k' in its high
// nibble; scales s[g, n] (bf16), group size `group` along K.  x is bf16.
//
// Two regimes:
//  * decode (M <= 64): w4a16_decode.  Bound by the packed weight bytes
//    (K*N/2: Llama-2-7B wqkv 25.2 MB, ~7.5 us at 3.35 TB/s).  Tensor cores
//    on mma.sync.m16n8k16 bf16 -> f32 with A and B swapped: the weight is
//    the A operand (16 output columns x 16 k) and x^T the B operand (16 k x
//    8 rows of x), so M = 8, the engine's decode shape, fills one n8 tile;
//    M <= 8 takes one n8 tile, M <= 64 two per pass (grid z over 16-row
//    slabs).  The packed layout is kept: a lane builds its A fragments
//    from 16-byte loads along N of 4 packed rows, 8 lanes covering 128
//    contiguous bytes of a row, and the kernel owns the order of its
//    output columns (see w4a16_decode).  Nibbles become bf16 without cvt:
//    OR into the mantissa of bf16 128 and subtract 128 (exact, two per
//    32-bit op).  A byte's low and high nibbles belong to groups gb and
//    G/2 + gb and go to two partial sums, each scaled once by its group's
//    s.  A warp keeps all 16 of its 16-byte weight loads in flight; a
//    block's 4 warps split K, and the split is summed with f32 atomicAdd
//    into a zeroed y: run to run the sum order changes by a few f32 ulps.
//  * prefill (M > 64): w4a16_mma.  Bound by operations (2*M*K*N).  64x64
//    output tiles, 4 warps of 32x32, mma.sync m16n8k16 bf16 -> f32 with
//    the nibbles dequantised in registers to exact bf16 integers 0..15;
//    one f32 accumulator per group, scaled into the running sum at the
//    group's end.  No split over K: deterministic.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMmaBM = 64;
constexpr int kMmaBN = 64;
constexpr int kMmaThreads = 128;
constexpr int kMmaGroup = 128;
constexpr int kXStride = kMmaGroup + 8;  // bf16 elements, padded rows
constexpr int kWStride = kMmaBN + 16;    // bytes, padded rows (16B aligned)

__device__ __forceinline__ uint32_t nib_bf16(uint8_t byte, int high) {
  // the nibble as an exact bf16 integer 0..15 (upper half of its f32 bits)
  const uint32_t v = high ? (uint32_t)(byte >> 4) : (uint32_t)(byte & 0xFu);
  return __float_as_uint((float)v) >> 16;
}

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kMmaThreads)
w4a16_mma(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
          const __nv_bfloat16* __restrict__ s, float* __restrict__ y,
          int M, int K, int N) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][kMmaBM][kXStride];
  __shared__ __align__(16) uint8_t ws[kMmaGroup][kWStride];

  const int half_k = K >> 1;
  const int g_half = half_k / kMmaGroup;
  const int m0 = blockIdx.y * kMmaBM;
  const int n0 = blockIdx.x * kMmaBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32;  // warp tile origin in the block tile
  const int wn = (warp & 1) * 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int gb = 0; gb < g_half; ++gb) {
    // x tiles: [64 rows] x [128 cols] of the low (h=0) and high (h=1) halves
    constexpr int kVecPerRow = kMmaGroup / 8;
    for (int i = tid; i < 2 * kMmaBM * kVecPerRow; i += kMmaThreads) {
      const int h = i / (kMmaBM * kVecPerRow);
      const int rem = i - h * kMmaBM * kVecPerRow;
      const int r = rem / kVecPerRow;
      const int c = (rem - r * kVecPerRow) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M) {
        v = *reinterpret_cast<const uint4*>(
            x + (size_t)(m0 + r) * K + h * half_k + gb * kMmaGroup + c);
      }
      *reinterpret_cast<uint4*>(&xs[h][r][c]) = v;
    }
    // packed weight tile: [128 rows] x [64 bytes]
    constexpr int kWVecPerRow = kMmaBN / 16;
    for (int i = tid; i < kMmaGroup * kWVecPerRow; i += kMmaThreads) {
      const int r = i / kWVecPerRow;
      const int c = (i - r * kWVecPerRow) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + c < N) {  // N % 16 == 0 (checked by the wrapper)
        v = *reinterpret_cast<const uint4*>(
            w + (size_t)(gb * kMmaGroup + r) * N + n0 + c);
      }
      *reinterpret_cast<uint4*>(&ws[r][c]) = v;
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float part[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;

#pragma unroll 2
      for (int kk = 0; kk < kMmaGroup; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const __nv_bfloat16* base = &xs[h][wm + i * 16 + gid][kk + tig * 2];
          a[i][0] = *reinterpret_cast<const uint32_t*>(base);
          a[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kXStride);
          a[i][2] = *reinterpret_cast<const uint32_t*>(base + 8);
          a[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kXStride + 8);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = wn + j * 8 + gid;
          const int k0 = kk + tig * 2;
          const uint32_t b0 = nib_bf16(ws[k0][col], h) |
                              (nib_bf16(ws[k0 + 1][col], h) << 16);
          const uint32_t b1 = nib_bf16(ws[k0 + 8][col], h) |
                              (nib_bf16(ws[k0 + 9][col], h) << 16);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_bf16_16816(part[i][j], a[i], b0, b1);
        }
      }

      const int g = h ? g_half + gb : gb;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + tig * 2;
        const float s0 = n < N ? __bfloat162float(s[(size_t)g * N + n]) : 0.f;
        const float s1 =
            n + 1 < N ? __bfloat162float(s[(size_t)g * N + n + 1]) : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[i][j][0] += part[i][j][0] * s0;
          acc[i][j][1] += part[i][j][1] * s1;
          acc[i][j][2] += part[i][j][2] * s0;
          acc[i][j][3] += part[i][j][3] * s1;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + wm + i * 16 + gid;
      const int col = n0 + wn + j * 8 + tig * 2;
      if (col >= N) continue;
      if (row < M) {
        y[(size_t)row * N + col] = acc[i][j][0];
        y[(size_t)row * N + col + 1] = acc[i][j][1];
      }
      if (row + 8 < M) {
        y[(size_t)(row + 8) * N + col] = acc[i][j][2];
        y[(size_t)(row + 8) * N + col + 1] = acc[i][j][3];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// decode regime (M <= 64): swap AB on mma.sync.m16n8k16
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 128;          // 4 warps, each one task
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecCols = 128;             // output columns per block
constexpr int kDecMaxSteps = 4;           // k16 steps of packed rows per warp

// Two packed bytes' nibbles, in bits 0-3 and 16-19 of v, as exact bf16
// values 0..15: OR into the mantissa of bf16 128, then subtract 128.
__device__ __forceinline__ uint32_t nib2_bf16(uint32_t v) {
  uint32_t r = (v & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 c = __floats2bfloat162_rn(128.f, 128.f);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&r);
  b = __hsub2(b, c);
  return *reinterpret_cast<uint32_t*>(&b);
}

// One warp task: 128 output columns x `steps` k16 steps of packed rows
// (all inside one group), both nibble halves, MT n8 tiles of x rows.
// The weight is the A operand: A row i < 8 is column 16*i + 2t of the
// warp's 128, row i + 8 is column 16*i + 2t + 1 (tile t = 0..7), so lane
// (gid, tig) builds its A fragments from the 16-byte chunk of columns
// 16*gid .. 16*gid + 15 of packed rows 2tig, 2tig+1, 2tig+8 and 2tig+9 of
// a step: 8 lanes read 128 contiguous bytes of a row.  x^T is the B
// operand (k16 x 8 rows of x).  Partials are per group (the nibbles and x
// are exact in bf16, their products exact in f32) and scaled once.
template <int MT>
__global__ void __launch_bounds__(kDecThreads)
w4a16_decode(const __nv_bfloat16* __restrict__ x,
             const uint8_t* __restrict__ w,
             const __nv_bfloat16* __restrict__ s, float* __restrict__ y,
             int M, int K, int N, int group, int steps) {
  constexpr int kFrag = 8 * MT * 4;       // f32 partials per lane
  __shared__ float red[kDecWarps][kFrag][32];

  const int half_k = K >> 1;
  const int g_half = half_k / group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int n0 = blockIdx.x * kDecCols;
  const int m0 = blockIdx.z * 8 * MT;
  const int kr0 = (blockIdx.y * kDecWarps + warp) * steps * 16;  // packed row
  const int col = n0 + gid * 16;          // this lane's 16 columns
  const bool active = kr0 < half_k;
  const bool col_ok = col < N;            // N % 16 == 0

  // every load of the task in flight at once: weight chunks and x
  uint4 raw[kDecMaxSteps][4];
  uint32_t xb[2][kDecMaxSteps][MT][2];
#pragma unroll
  for (int st = 0; st < kDecMaxSteps; ++st) {
    const bool ok = active && st < steps;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = kr0 + st * 16 + 2 * tig + (r & 1) + ((r >> 1) << 3);
      raw[st][r] = ok && col_ok ? *reinterpret_cast<const uint4*>(
                                      w + (size_t)row * N + col)
                                : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = m0 + mt * 8 + gid;
        const int k = h * half_k + kr0 + st * 16 + 2 * tig;
        const bool okm = ok && m < M;
        const __nv_bfloat16* xr = x + (size_t)(okm ? m : 0) * K + k;
        xb[h][st][mt][0] = okm ? *reinterpret_cast<const uint32_t*>(xr) : 0u;
        xb[h][st][mt][1] =
            okm ? *reinterpret_cast<const uint32_t*>(xr + 8) : 0u;
      }
    }
  }

  float out[8][MT][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[t][mt][e] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {           // low nibbles, then high
    float part[8][MT][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[t][mt][e] = 0.f;
#pragma unroll
    for (int st = 0; st < kDecMaxSteps; ++st) {
      if (st >= steps) break;
      const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&raw[st][0]);
      const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&raw[st][1]);
      const uint32_t* w2 = reinterpret_cast<const uint32_t*>(&raw[st][2]);
      const uint32_t* w3 = reinterpret_cast<const uint32_t*>(&raw[st][3]);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        // bytes 2t, 2t+1 of rows (2tig, 2tig+1) and (2tig+8, 2tig+9)
        const uint32_t b = (t & 1) * 2;
        const uint32_t sel = b | ((b + 1) << 4) | ((b + 4) << 8) |
                             ((b + 5) << 12);
        uint32_t v01 = __byte_perm(w0[t >> 1], w1[t >> 1], sel);
        uint32_t v23 = __byte_perm(w2[t >> 1], w3[t >> 1], sel);
        if (h) {
          v01 >>= 4;
          v23 >>= 4;
        }
        uint32_t a[4];
        a[0] = nib2_bf16(v01);            // column 2t, k 2tig, 2tig+1
        a[1] = nib2_bf16(v01 >> 8);       // column 2t+1
        a[2] = nib2_bf16(v23);            // column 2t, k 2tig+8, 2tig+9
        a[3] = nib2_bf16(v23 >> 8);       // column 2t+1
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_bf16_16816(part[t][mt], a, xb[h][st][mt][0], xb[h][st][mt][1]);
      }
    }
    // scale by this half's group: s[g, col + 2t] and s[g, col + 2t + 1]
    const int g = (h ? g_half : 0) + kr0 / group;
    uint4 sv[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
    if (active && col_ok) {
      const uint4* sp = reinterpret_cast<const uint4*>(s + (size_t)g * N + col);
      sv[0] = sp[0];
      sv[1] = sp[1];
    }
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(sv);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float s0 = __uint_as_float(sw[t] << 16);
      const float s1 = __uint_as_float(sw[t] & 0xFFFF0000u);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        out[t][mt][0] += part[t][mt][0] * s0;
        out[t][mt][1] += part[t][mt][1] * s0;
        out[t][mt][2] += part[t][mt][2] * s1;
        out[t][mt][3] += part[t][mt][3] * s1;
      }
    }
  }

  // the block's 4 warps (4 k slices) summed in shared memory, in fragment
  // order, then one f32 atomicAdd per output into the zeroed y
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[warp][(t * MT + mt) * 4 + e][lane] =
          out[t][mt][e];
  __syncthreads();
  for (int i = tid; i < kFrag * 32; i += kDecThreads) {
    const int f = i >> 5;
    const int ln = i & 31;
    const int t = f / (MT * 4);
    const int mt = (f >> 2) % MT;
    const int e = f & 3;
    const int c = n0 + (ln >> 2) * 16 + 2 * t + (e >> 1);
    const int m = m0 + mt * 8 + 2 * (ln & 3) + (e & 1);
    if (m >= M || c >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kDecWarps; ++wi) v += red[wi][f][ln];
    atomicAdd(y + (size_t)m * N + c, v);
  }
}

template <int MT>
void launch_decode(const __nv_bfloat16* x, const uint8_t* w,
                   const __nv_bfloat16* s, float* y, int M, int K, int N,
                   int group, cudaStream_t stream) {
  // k16 steps per warp: the most of 4, 2, 1 that divides a group
  const int gs = group / 16;
  const int steps = gs % 4 == 0 ? 4 : (gs % 2 == 0 ? 2 : 1);
  const int rows_per_block = kDecWarps * steps * 16;
  const dim3 grid((N + kDecCols - 1) / kDecCols,
                  (K / 2 + rows_per_block - 1) / rows_per_block,
                  (M + 8 * MT - 1) / (8 * MT));
  w4a16_decode<MT><<<grid, kDecThreads, 0, stream>>>(x, w, s, y, M, K, N,
                                                     group, steps);
}

}  // namespace

extern "C" {

// y must be zero-filled when M <= 64 (split-K atomics); it is overwritten
// when M > 64.  Returns the launch's cudaError_t.
int lmd_w4a16_gemm(const void* x, const void* packed, const void* scales,
                   void* y, int M, int K, int N, int group, void* stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const uint8_t*>(packed);
  const auto* sb = static_cast<const __nv_bfloat16*>(scales);
  auto* yf = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (M <= 64) {
    if (group % 16 != 0 || (K / 2) % group != 0 || N % 16 != 0)
      return (int)cudaErrorInvalidValue;
    if (M <= 8)
      launch_decode<1>(xb, wb, sb, yf, M, K, N, group, st);
    else
      launch_decode<2>(xb, wb, sb, yf, M, K, N, group, st);
  } else {
    if (group != kMmaGroup) return (int)cudaErrorInvalidValue;
    const dim3 grid((N + kMmaBN - 1) / kMmaBN, (M + kMmaBM - 1) / kMmaBM);
    w4a16_mma<<<grid, kMmaThreads, 0, st>>>(xb, wb, sb, yf, M, K, N);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
