// Paged prefill (chunked context) attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel lmdeploy_tpu/ops/pallas/prefill_attention.py::
// paged_prefill_attention_batched (_prefill_kernel) at kv_bits 0 (bf16
// pool), 8 (int8 pool) and 4 (nibble-packed uint8 pool, last dim Dh/2,
// half-split: byte j holds feature j low and j + Dh/2 high).  Causal
// attention of a chunk q [B, T, H, Dh] at absolute positions
// start_pos[b] + t over the paged history plus the chunk (already written
// to the pool), mask kv_pos <= q_pos && kv_pos < context_end[b], fp32
// online softmax, scale Dh^-0.5.  Output [B, T, H, Dh] in q's dtype (bf16).
//
// Bound: bytes (the chunk's q/out plus the visible KV at 2, 1 or 0.5 bytes
// per element; Llama-2-7B, 512-token chunk from 0, bf16 pool: ~16.8 MB per
// layer, ~5 us at 3.35 TB/s); 4*T*ctx*Dh*H operations (/2 for the causal
// half), ~2.1 GFLOP, ~2 us at 989 TF/s.
//
// Design: FlashAttention-2 on mma.sync.m16n8k16 bf16 -> f32.
//  * Rows are r = t * G + g of kv head kh (GQA).  A warp owns 16 rows; a
//    block of 4 warps is WR row warps x WK = 4 / WR kv-slice warps.  All 4
//    warps share one 64-token K/V tile; a warp takes 64 / WK tokens of it,
//    and the WK slices of a row warp are merged at the end through shared
//    memory.  WR (4, 2 or 1) is the largest that still gives two blocks
//    per SM, so a 64-token chunk or a 5-row verify chunk spreads over more
//    warps (measured on an H100 against forced WR: the choice was the
//    fastest at a 512-token chunk, 64 tokens over 300 and 5 over 500).
//    Grid (KH, row blocks, B), row blocks in reverse: the heaviest causal
//    tiles are issued first.
//  * Q stays in registers as the bf16 A fragments it arrives as (exact);
//    Dh^-0.5 * log2(e) is applied to the f32 scores, then exp2f.
//  * S = Q K^T with ldmatrix on K, O += P V with ldmatrix.trans on V; the
//    row max takes 2 shuffles within a lane quad per tile, the row sum is
//    reduced once at the end.  P never touches shared memory: the f32 C
//    fragments of two adjacent n8 tiles of S are the A fragment of P V.
//  * P goes into the product as two bf16 terms, hi = bf16(p) and
//    lo = bf16(p - hi), so it carries ~2^-17 relative error per weight
//    instead of bf16's 2^-9.  With P rounded once to bf16, rows with few
//    keys (early rows of a chunk from 0) land one bf16 ulp of the output
//    (2^-6 at |x| in [2, 4)) away from the f32 reference, past the 1e-2
//    gate; the second term costs one more mma per P V step.
//  * Quantised pools are staged as their integer codes in bf16 (int8
//    -128..127, int4 (n ^ 8) - 8: exact), and the qparams are applied in
//    f32 outside the mma: S = k_s (Q C_k^T) (the key zero point adds
//    -k_s k_zp rowsum(Q), one constant per row, which softmax cancels),
//    and at the end O = v_s (P C_v / l - v_zp), since sum_j P / l = 1.
//    No value is rounded that the JAX kernel keeps in f32.
//  * Loads: bf16 tiles by cp.async 16-byte copies into a 3-stage ring
//    (tiles i+1 and i+2 in flight while tile i computes); int8 / int4
//    tiles are loaded to registers one tile ahead and converted into the
//    other buffer after the compute, without int->float conversions (the
//    codes are ORed into the mantissa of a power of two).  The block's
//    page-table entries (clamped at 0) are read once into shared memory,
//    so no dependent global load precedes a tile's copies; a 64-token tile
//    may span pages.  Tokens at or past context_end are not read
//    (zero-filled).
//  * Causal work: a block walks KV tiles up to its last row's position; a
//    warp skips tiles past its own rows and masks only the diagonal tile
//    and the tile holding context_end.  A block whose first token is at or
//    past context_end - start_pos (padding rows, context_end == start_pos)
//    writes zeros and returns; the JAX kernel leaves a different finite
//    value there, and both are discarded upstream.
//
// Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDh = 128;
constexpr int kTile = 64;                 // kv tokens per tile
constexpr int kThreads = 128;             // 4 warps
constexpr int kStride = kDh + 8;          // bf16 per smem row (272 bytes)
constexpr int kTileElems = kTile * kStride;
constexpr int kPtCap = 512;               // page-table entries kept in smem
// K/V stages: bf16 tiles arrive by cp.async two tiles ahead (3 stages);
// int8 / int4 tiles go through registers one tile ahead (2 stages)
__host__ __device__ constexpr int stages(int bits) {
  return bits == 0 ? 3 : 2;
}
__host__ __device__ constexpr size_t smem_bytes(int bits) {
  return 2 * stages(bits) * kTileElems * sizeof(__nv_bfloat16) +
         kPtCap * sizeof(int);
}
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// registers only: not volatile, so the compiler may interleave products
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// p as hi + lo bf16 pairs: hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split_p(float p0, float p1, uint32_t& hi,
                                        uint32_t& lo) {
  hi = pack_bf16(p0, p1);
  lo = pack_bf16(p0 - bf16_lo(hi), p1 - bf16_hi(hi));
}

// 16 int8 codes -> 16 bf16 (exact) into two 16-byte smem chunks.  A
// code c sits as c + 128 in the mantissa of f32 2^23 (no int->float
// conversion): (2^23 + c + 128) - (2^23 + 128) = c.
__device__ __forceinline__ void store_codes8(__nv_bfloat16* dst, uint4 raw) {
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                         raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float c[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[e] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540u + e)) -
             8388736.f;
    o[2 * i] = pack_bf16(c[0], c[1]);
    o[2 * i + 1] = pack_bf16(c[2], c[3]);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<uint4*>(dst + 8) = make_uint4(o[4], o[5], o[6], o[7]);
}

// Two nibbles n in bits 0-3 and 16-19 -> bf16x2 codes (n ^ 8) - 8, exact:
// OR n ^ 8 into the mantissa of bf16 128, then subtract 136.
__device__ __forceinline__ uint32_t nib2_code(uint32_t v) {
  uint32_t r = ((v & 0x000F000Fu) ^ 0x00080008u) | 0x43004300u;
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&r);
  b = __hsub2(b, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&b);
}

// 16 packed int4 bytes (features c..c+15 low, c+64..c+79 high) -> bf16
// codes at dst (low) and dst + Dh/2 (high)
__device__ __forceinline__ void store_codes4(__nv_bfloat16* dst, uint4 raw) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t lo[8], hi[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t v01 = __byte_perm(w[i], 0u, 0x4140u);  // bytes 0, 1
    const uint32_t v23 = __byte_perm(w[i], 0u, 0x4342u);  // bytes 2, 3
    lo[2 * i] = nib2_code(v01);
    lo[2 * i + 1] = nib2_code(v23);
    hi[2 * i] = nib2_code(v01 >> 4);
    hi[2 * i + 1] = nib2_code(v23 >> 4);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  *reinterpret_cast<uint4*>(dst + 8) = make_uint4(lo[4], lo[5], lo[6], lo[7]);
  *reinterpret_cast<uint4*>(dst + kDh / 2) =
      make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(dst + kDh / 2 + 8) =
      make_uint4(hi[4], hi[5], hi[6], hi[7]);
}

// 16-byte chunks per thread per tile (K or V): bf16 8, int8 4, int4 2
template <int BITS>
struct Pool {
  static constexpr int kRow = BITS == 0 ? 2 * kDh : (BITS == 8 ? kDh : kDh / 2);
  static constexpr int kChunksPerRow = kRow / 16;
  static constexpr int kPerThread = kTile * kChunksPerRow / kThreads;
};

struct TileCtx {
  const int* ptb;        // the slot's page-table row (global)
  const int* pts;        // its first kPtCap entries, clamped at 0 (smem)
  int page_size, KH, kh, ctx_end, kv_cap;
};

// byte offset of token pos's row for head kh in one layer of the pool,
// or -1 when the token is not to be read
template <int BITS>
__device__ __forceinline__ long long row_off(const TileCtx& c, int pos) {
  if (pos >= c.ctx_end || pos >= c.kv_cap) return -1;
  const int page = pos / c.page_size;
  const int phys = page < kPtCap ? c.pts[page] : max(c.ptb[page], 0);
  return (((long long)phys * c.page_size + pos % c.page_size) * c.KH + c.kh) *
         Pool<BITS>::kRow;
}

// bf16 pool: cp.async the tile at kv0 into ks/vs (zero past context_end)
__device__ __forceinline__ void load_tile_bf16(const TileCtx& c,
                                               const uint8_t* kp,
                                               const uint8_t* vp, int kv0,
                                               __nv_bfloat16* ks,
                                               __nv_bfloat16* vs, int tid) {
#pragma unroll
  for (int i = 0; i < Pool<0>::kPerThread; ++i) {
    const int chunk = tid + i * kThreads;
    const int tok = chunk / Pool<0>::kChunksPerRow;
    const int col = (chunk % Pool<0>::kChunksPerRow) * 8;
    const long long off = row_off<0>(c, kv0 + tok);
    const long long src = off < 0 ? 0 : off + 2 * col;
    cp_async16(ks + tok * kStride + col, kp + src, off >= 0);
    cp_async16(vs + tok * kStride + col, vp + src, off >= 0);
  }
}

// int8 / int4 pool: raw bytes of the tile at kv0 into registers
template <int BITS>
__device__ __forceinline__ void load_tile_regs(const TileCtx& c,
                                               const uint8_t* kp,
                                               const uint8_t* vp, int kv0,
                                               uint4* rk, uint4* rv, int tid) {
#pragma unroll
  for (int i = 0; i < Pool<BITS>::kPerThread; ++i) {
    const int chunk = tid + i * kThreads;
    const int tok = chunk / Pool<BITS>::kChunksPerRow;
    const int cb = (chunk % Pool<BITS>::kChunksPerRow) * 16;
    const long long off = row_off<BITS>(c, kv0 + tok);
    rk[i] = make_uint4(0u, 0u, 0u, 0u);
    rv[i] = rk[i];
    if (off >= 0) {
      rk[i] = *reinterpret_cast<const uint4*>(kp + off + cb);
      rv[i] = *reinterpret_cast<const uint4*>(vp + off + cb);
    }
  }
}

template <int BITS>
__device__ __forceinline__ void store_tile_regs(const uint4* rk,
                                                const uint4* rv,
                                                __nv_bfloat16* ks,
                                                __nv_bfloat16* vs, int tid) {
#pragma unroll
  for (int i = 0; i < Pool<BITS>::kPerThread; ++i) {
    const int chunk = tid + i * kThreads;
    const int tok = chunk / Pool<BITS>::kChunksPerRow;
    const int cb = (chunk % Pool<BITS>::kChunksPerRow) * 16;
    if constexpr (BITS == 8) {
      store_codes8(ks + tok * kStride + cb, rk[i]);
      store_codes8(vs + tok * kStride + cb, rv[i]);
    } else {
      store_codes4(ks + tok * kStride + cb, rk[i]);
      store_codes4(vs + tok * kStride + cb, rv[i]);
    }
  }
}

template <int BITS, int WR>
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
  constexpr int WK = 4 / WR;             // warps per row group (kv slices)
  constexpr int NS = kTile / WK;         // kv tokens per warp per tile
  constexpr int NT = NS / 8;             // n8 tiles of S per warp
  constexpr int KS = NS / 16;            // k16 steps of P V per warp
  constexpr int kRowsPerBlock = 16 * WR;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int kh = blockIdx.x;
  const int n_rb = gridDim.y;
  const int rb = n_rb - 1 - blockIdx.y;  // heaviest row blocks first
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = warp / WK;              // row warp
  const int ksl = warp % WK;             // kv slice of the tile
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int start = start_pos[b];
  const int ctx_end = context_end[b];
  const int rows = T * G;
  const int row0 = rb * kRowsPerBlock;

  // rows r -> token r / G, head kh * G + r % G
  auto q_index = [&](int r) {
    return (((size_t)b * T + r / G) * H + kh * G + r % G) * kDh;
  };

  if (row0 / G >= ctx_end - start) {
    // padding rows: zeros (discarded upstream)
    for (int i = tid; i < kRowsPerBlock * (kDh / 8); i += kThreads) {
      const int r = row0 + i / (kDh / 8);
      if (r < rows)
        *reinterpret_cast<uint4*>(out + q_index(r) + (i % (kDh / 8)) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const int r_last = min(row0 + kRowsPerBlock, rows) - 1;
  const int last_q_pos = min(start + r_last / G, ctx_end - 1);
  const int n_tiles = last_q_pos / kTile + 1;

  constexpr int S = stages(BITS);
  int* pts = reinterpret_cast<int*>(smem + 2 * S * kTileElems);
  TileCtx tc{page_tables + (size_t)b * max_pages, pts, page_size, KH, kh,
             ctx_end, max_pages * page_size};
  {
    // the pages this block reads, resolved once (no dependent global load
    // in front of each tile's copies)
    const int n_pages =
        min(min(min(n_tiles * kTile, ctx_end), tc.kv_cap) / page_size + 1,
            min(max_pages, kPtCap));
    for (int i = tid; i < n_pages; i += kThreads) pts[i] = max(tc.ptb[i], 0);
    __syncthreads();
  }

  auto kbuf = [&](int st) { return smem + 2 * st * kTileElems; };
  auto vbuf = [&](int st) { return smem + (2 * st + 1) * kTileElems; };
  constexpr int kRegs = BITS == 0 ? 1 : Pool<BITS>::kPerThread;
  uint4 rk[kRegs], rv[kRegs];
  if constexpr (BITS == 0) {
    load_tile_bf16(tc, kp, vp, 0, kbuf(0), vbuf(0), tid);
    cp_async_commit();
    if (n_tiles > 1) {
      load_tile_bf16(tc, kp, vp, kTile, kbuf(1), vbuf(1), tid);
      cp_async_commit();
    }
  } else {
    load_tile_regs<BITS>(tc, kp, vp, 0, rk, rv, tid);
    store_tile_regs<BITS>(rk, rv, kbuf(0), vbuf(0), tid);
  }

  // this warp's rows: wr0 + gid and wr0 + gid + 8
  const int wr0 = row0 + rg * 16;
  const int ra = wr0 + gid, rbw = wr0 + gid + 8;
  const int qpos_a = start + ra / G, qpos_b = start + rbw / G;
  const int warp_first_qpos = start + wr0 / G;
  const int warp_last_qpos =
      min(start + min(wr0 + 15, rows - 1) / G, ctx_end - 1);

  // Q fragments (bf16, exact), 8 k16 steps over Dh
  uint32_t qa[8][4];
  {
    const bool oka = ra < rows, okb = rbw < rows;
    const __nv_bfloat16* pa = q + (oka ? q_index(ra) : 0);
    const __nv_bfloat16* pb = q + (okb ? q_index(rbw) : 0);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int c = kk * 16 + tig * 2;
      qa[kk][0] = oka ? *reinterpret_cast<const uint32_t*>(pa + c) : 0u;
      qa[kk][1] = okb ? *reinterpret_cast<const uint32_t*>(pb + c) : 0u;
      qa[kk][2] = oka ? *reinterpret_cast<const uint32_t*>(pa + c + 8) : 0u;
      qa[kk][3] = okb ? *reinterpret_cast<const uint32_t*>(pb + c + 8) : 0u;
    }
  }
  const float sl2 = scale * kLog2e;
  // S = k_s (Q C_k^T) in log2 units; the key zero point's term
  // -k_s k_zp rowsum(Q) is one constant per row, which softmax cancels
  float k_mul = sl2, v_s = 1.f, v_z = 0.f;
  if constexpr (BITS != 0) {
    k_mul = qparams[0] * sl2;
    v_s = qparams[2];
    v_z = qparams[3];
  }

  float o_acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[j][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int cur = tile % S;
    const int kv0 = tile * kTile;
    if constexpr (BITS == 0) {
      if (tile + 1 < n_tiles)
        cp_async_wait<1>();  // this tile landed; the next may be in flight
      else
        cp_async_wait<0>();
    }
    __syncthreads();  // tile visible; everyone done with tile - 1's stage
    const bool more = tile + 1 < n_tiles;
    if constexpr (BITS == 0) {
      if (tile + 2 < n_tiles) {
        const int st = (tile + 2) % S;
        load_tile_bf16(tc, kp, vp, kv0 + 2 * kTile, kbuf(st), vbuf(st), tid);
        cp_async_commit();
      }
    } else if (more) {
      load_tile_regs<BITS>(tc, kp, vp, kv0 + kTile, rk, rv, tid);
    }

    const int s0 = kv0 + ksl * NS;  // this warp's first kv token
    if (s0 <= warp_last_qpos) {
      const __nv_bfloat16* ks = kbuf(cur);
      const __nv_bfloat16* vs = vbuf(cur);
      float sc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      // S = Q K^T: per pair of n8 tiles one ldmatrix.x4 per k16 step
      const int mi = lane >> 3;
      const __nv_bfloat16* krow =
          ks + (ksl * NS + (lane & 7) + ((mi >> 1) << 3)) * kStride +
          ((mi & 1) << 3);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t kb[NT / 2][4];  // all of this k16 step's K fragments first
#pragma unroll
        for (int j = 0; j < NT; j += 2)
          ldmatrix_x4(kb[j / 2], krow + j * 8 * kStride + kk * 16);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          mma_16816(sc[j], qa[kk], kb[j / 2][0], kb[j / 2][1]);
          mma_16816(sc[j + 1], qa[kk], kb[j / 2][2], kb[j / 2][3]);
        }
      }
      // scale, mask, row max
      const bool need_mask =
          s0 + NS - 1 > warp_first_qpos || s0 + NS > ctx_end;
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool row_b = e >= 2;
          float v = sc[j][e] * k_mul;
          if (need_mask) {
            const int kv = s0 + j * 8 + tig * 2 + (e & 1);
            const bool ok = kv <= (row_b ? qpos_b : qpos_a) && kv < ctx_end;
            v = ok ? v : -INFINITY;
          }
          sc[j][e] = v;
          if (row_b)
            mx_b = fmaxf(mx_b, v);
          else
            mx_a = fmaxf(mx_a, v);
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xFFFFFFFFu, mx_a, o));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xFFFFFFFFu, mx_b, o));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      // a row with nothing visible yet keeps base 0: exp2(-inf) = 0
      const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float al_a = exp2f(m_a - base_a), al_b = exp2f(m_b - base_b);
      m_a = mn_a;
      m_b = mn_b;
      l_a *= al_a;
      l_b *= al_b;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o_acc[j][0] *= al_a;
        o_acc[j][1] *= al_a;
        o_acc[j][2] *= al_b;
        o_acc[j][3] *= al_b;
      }
      // O += P V, P as hi + lo bf16 A fragments straight from registers
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        float p[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* c = sc[2 * s + h];
          p[h][0] = exp2f(c[0] - base_a);
          p[h][1] = exp2f(c[1] - base_a);
          p[h][2] = exp2f(c[2] - base_b);
          p[h][3] = exp2f(c[3] - base_b);
          l_a += p[h][0] + p[h][1];
          l_b += p[h][2] + p[h][3];
        }
        uint32_t ph[4], pl[4];
        split_p(p[0][0], p[0][1], ph[0], pl[0]);
        split_p(p[0][2], p[0][3], ph[1], pl[1]);
        split_p(p[1][0], p[1][1], ph[2], pl[2]);
        split_p(p[1][2], p[1][3], ph[3], pl[3]);
        const __nv_bfloat16* vrow =
            vs + (ksl * NS + s * 16 + (lane & 7) + ((mi & 1) << 3)) *
                     kStride + ((mi >> 1) << 3);
        uint32_t vb[8][4];  // the step's V fragments, then hi, then lo
#pragma unroll
        for (int d = 0; d < 8; ++d) ldmatrix_x4_trans(vb[d], vrow + d * 16);
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          mma_16816(o_acc[2 * d], ph, vb[d][0], vb[d][1]);
          mma_16816(o_acc[2 * d + 1], ph, vb[d][2], vb[d][3]);
        }
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          mma_16816(o_acc[2 * d], pl, vb[d][0], vb[d][1]);
          mma_16816(o_acc[2 * d + 1], pl, vb[d][2], vb[d][3]);
        }
      }
    }

    if constexpr (BITS != 0) {
      if (more)
        store_tile_regs<BITS>(rk, rv, kbuf(cur ^ 1), vbuf(cur ^ 1), tid);
    }
  }

#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l_a += __shfl_xor_sync(0xFFFFFFFFu, l_a, o);
    l_b += __shfl_xor_sync(0xFFFFFFFFu, l_b, o);
  }

  if constexpr (WK > 1) {
    // merge the WK kv slices of each row warp through shared memory
    float* mo = reinterpret_cast<float*>(smem_raw);       // [4][64][32]
    float* ml = mo + 4 * 64 * 32;                         // [4][4][32]
    __syncthreads();  // every warp done with the K/V buffers
    if (ksl != 0) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mo[(warp * 64 + j * 4 + e) * 32 + lane] = o_acc[j][e];
      ml[(warp * 4 + 0) * 32 + lane] = m_a;
      ml[(warp * 4 + 1) * 32 + lane] = m_b;
      ml[(warp * 4 + 2) * 32 + lane] = l_a;
      ml[(warp * 4 + 3) * 32 + lane] = l_b;
    }
    __syncthreads();
    if (ksl != 0) return;
    float mw_a[WK], mw_b[WK], lw_a[WK], lw_b[WK];
    mw_a[0] = m_a;
    mw_b[0] = m_b;
    lw_a[0] = l_a;
    lw_b[0] = l_b;
    float mt_a = m_a, mt_b = m_b;
#pragma unroll
    for (int w = 1; w < WK; ++w) {
      mw_a[w] = ml[((warp + w) * 4 + 0) * 32 + lane];
      mw_b[w] = ml[((warp + w) * 4 + 1) * 32 + lane];
      lw_a[w] = ml[((warp + w) * 4 + 2) * 32 + lane];
      lw_b[w] = ml[((warp + w) * 4 + 3) * 32 + lane];
      mt_a = fmaxf(mt_a, mw_a[w]);
      mt_b = fmaxf(mt_b, mw_b[w]);
    }
    const float bt_a = mt_a == -INFINITY ? 0.f : mt_a;
    const float bt_b = mt_b == -INFINITY ? 0.f : mt_b;
    float f_a[WK], f_b[WK];
    l_a = 0.f;
    l_b = 0.f;
#pragma unroll
    for (int w = 0; w < WK; ++w) {
      f_a[w] = exp2f(mw_a[w] - bt_a);
      f_b[w] = exp2f(mw_b[w] - bt_b);
      l_a += lw_a[w] * f_a[w];
      l_b += lw_b[w] * f_b[w];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float acc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[e] = o_acc[j][e] * (e < 2 ? f_a[0] : f_b[0]);
#pragma unroll
      for (int w = 1; w < WK; ++w)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[e] += mo[((warp + w) * 64 + j * 4 + e) * 32 + lane] *
                    (e < 2 ? f_a[w] : f_b[w]);
#pragma unroll
      for (int e = 0; e < 4; ++e) o_acc[j][e] = acc[e];
    }
  }

  // out = O / l (bf16 pool), or v_s (O / l - v_zp) (quantised pool)
  const float inv_a = 1.0f / fmaxf(l_a, 1e-20f);
  const float inv_b = 1.0f / fmaxf(l_b, 1e-20f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rbw : ra;
    if (r >= rows) continue;
    const float inv = half ? inv_b : inv_a;
    __nv_bfloat16* po = out + q_index(r);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float x0 = o_acc[j][2 * half] * inv;
      float x1 = o_acc[j][2 * half + 1] * inv;
      if constexpr (BITS != 0) {
        x0 = (x0 - v_z) * v_s;
        x1 = (x1 - v_z) * v_s;
      }
      *reinterpret_cast<uint32_t*>(po + j * 8 + tig * 2) = pack_bf16(x0, x1);
    }
  }
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

template <int BITS, int WR>
cudaError_t launch_wr(const void* q, const void* k_pool, const void* v_pool,
                      const void* page_tables, const void* start_pos,
                      const void* context_end, const void* qparams, void* out,
                      int B, int T, int H, int KH, int page_size,
                      int max_pages, float scale, cudaStream_t st) {
  static bool smem_set = false;  // once, outside any graph capture
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_prefill<BITS, WR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(BITS));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int G = H / KH;
  const int rows_per_block = 16 * WR;
  const dim3 grid(KH, (T * G + rows_per_block - 1) / rows_per_block, B);
  paged_prefill<BITS, WR><<<grid, kThreads, smem_bytes(BITS), st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const uint8_t*>(k_pool), static_cast<const uint8_t*>(v_pool),
      static_cast<const int*>(page_tables), static_cast<const int*>(start_pos),
      static_cast<const int*>(context_end),
      static_cast<const float*>(qparams), static_cast<__nv_bfloat16*>(out), T,
      H, KH, G, page_size, max_pages, scale);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* page_tables, const void* start_pos,
                   const void* context_end, const void* qparams, void* out,
                   int B, int T, int H, int KH, int page_size, int max_pages,
                   float scale, cudaStream_t st) {
  // the most rows per block that still gives every SM two blocks (on an
  // H100: a 512-token chunk of 32 heads takes 32-row blocks, a 64-token
  // chunk or a verify chunk 16-row blocks whose warps split each KV tile)
  const long long rows = (long long)T * (H / KH);
  const long long heads = (long long)B * KH;
  const int sms = 2 * num_sms();
  if (heads * ((rows + 63) / 64) >= sms)
    return launch_wr<BITS, 4>(q, k_pool, v_pool, page_tables, start_pos,
                              context_end, qparams, out, B, T, H, KH,
                              page_size, max_pages, scale, st);
  if (rows > 16 && heads * ((rows + 31) / 32) >= sms)
    return launch_wr<BITS, 2>(q, k_pool, v_pool, page_tables, start_pos,
                              context_end, qparams, out, B, T, H, KH,
                              page_size, max_pages, scale, st);
  return launch_wr<BITS, 1>(q, k_pool, v_pool, page_tables, start_pos,
                            context_end, qparams, out, B, T, H, KH, page_size,
                            max_pages, scale, st);
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
