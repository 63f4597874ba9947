// Paged prefill (chunked context) attention for Hopper (sm_90a), plain C
// interface: three routes, chosen by the wrapper from shapes only.
//
// Replaces the TPU kernel lmdeploy_tpu/ops/pallas/prefill_attention.py::
// paged_prefill_attention_batched (_prefill_kernel) at kv_bits 0 (bf16
// pool), 8 (int8 pool) and 4 (nibble-packed uint8 pool, last dim Dh/2,
// half-split: byte j holds feature j low and j + Dh/2 high).  Causal
// attention of a chunk q [B, T, H, Dh] at absolute positions
// start_pos[b] + t over the paged history plus the chunk (already written
// to the pool), mask kv_pos <= q_pos && kv_pos < context_end[b], fp32
// online softmax in base 2 (Dh^-0.5 log2 e applied to the f32 scores),
// scale Dh^-0.5.  Output [B, T, H, Dh] bf16.  Rows are r = t G + g of kv
// head kh (GQA).  Padding rows (context_end == start_pos) are written as
// zeros and walk no pages; the JAX kernel leaves a different finite value
// there, and both are discarded upstream.
//
// Route rule (ops/cuda/prefill_attention.py::prefill_route, from B, T, G,
// page size and kv_bits; never from the context values):
//   split  T <= 8 (the speculative verify's k+1 rows, any short chunk),
//          T G <= 64, B <= 256;
//   wgmma  every other shape, at a page size that divides 64 or is a
//          multiple of it (TMA boxes of whole pages or whole tiles);
//   mma    the rest: those shapes at any other page size.
//
// Route split (short chunks).  Bound: bytes, the slot's visible K/V (bs1,
// Llama-2-7B, ctx 512: 8.4 MB a layer, 2.5 us at 3.35 TB/s); the
// operations are ~T / 64 of a chunk's.  A grid of one block per (kv head,
// row block) gives bs1 32 blocks on 132 SMs, each walking the whole
// context in sequence.  Design:
//  * Grid (KH, W): W workers per kv head, W = resident blocks / KH (the
//    occupancy calculator, on the host).  All T G rows of a kv head are
//    in one block (16, 32 or 64 rows: 1, 2 or 4 row warps of the mma
//    body below, the other warps splitting each KV tile).
//  * The plan, computed by every block from context_end / start_pos on
//    the device (no host sync): each live slot's [0, context_end) in
//    64-token tiles, `per` = ceil(all live tiles / W) tiles a split, so
//    a bs1 request in the engine's 8-slot batch (7 padding rows) takes
//    all W workers and a full batch one split a slot; item i of the kv
//    head goes to worker i % W.  Padding slots are zeroed by worker b % W.
//  * Only the tiles past start_pos take the causal mask.  Each split
//    writes (m, l, O) to f32 scratch; the last split of a (slot, kv head)
//    to finish, found by an atomicAdd ticket after __threadfence(), merges
//    them by log-sum-exp in split order (the same bits on every run) and
//    resets the ticket.  A slot of one split writes its output directly.
//  * Tensor cores (mma.sync, as route mma): at T = 5 the m16 tile is 69%
//    padding, but the products cost far less than the bytes.
//
// Route wgmma (chunks).  Bound: bytes and operations together
// (Llama-2-7B, 512-token chunk from 0: 16.8 MB a layer, 5.0 us; 2.1
// GFLOP, 2.2 us at 989 TF/s).  Route mma reads every K / V fragment from
// shared memory into registers for one m16 tile per warp and sums P V
// twice.  Design:
//  * Warp-specialised block of 160 threads: warps 0-3 one consumer
//    warpgroup on 64 query rows, warp 4's lane 0 the producer.  Two
//    blocks per SM.  Grid (KH, row blocks, B); row blocks sorted by
//    causal work are issued from both ends of the list, so that the two
//    blocks an SM gets pair a heavy walk with a light one.
//  * Producer: TMA loads of 64-token K and V tiles (two 64-feature halves
//    each, 128-byte swizzle, one box per page per half: page 16 gives 4)
//    into a 3-stage mbarrier ring.  One tensor map per pool over the
//    whole [L P page, KH Dh] bf16 view, the layer a row coordinate,
//    encoded once per pool pointer and shape and cached on the host
//    (pool_map), passed as __grid_constant__.  Page ids come from the
//    block's page-table entries staged in shared memory.
//  * int8 / int4 pools: TMA brings the raw rows (no swizzle) into a ring
//    of half or a quarter the bytes; the consumers stage each tile's
//    codes as bf16 (exact, as route mma does) into one K/V tile in
//    wgmma's 128-byte-swizzle layout, release the raw stage, and run the
//    same products; the qparams are applied in f32 to S and O.
//  * Consumers: S = Q K^T by wgmma m64n64k16 (Q the register operand, in
//    the m16n8k16 A layout it arrives in; K K-major from shared memory),
//    the online softmax in f32 registers, O += P V by wgmma m64n128k16
//    (P the register operand straight from S's C fragments, V MN-major:
//    a transposed-B descriptor).  V rows at or past context_end are
//    zeroed in shared memory before P V (0 x stale pool bytes is not NaN
//    safe); their scores are masked.
//  * P enters P V as hi + lo bf16 terms: in one bf16 term (measured by
//    chip_smoke.py's breakdown phase) rows with few keys land one bf16
//    ulp of the output away from the f32 reference, past the 1e-2 gate.
//  * Per tile the consumer runs Q K^T, the softmax and P V in turn; the
//    second block on the SM fills the gaps.  Measured on an H100 at
//    chip_smoke.py's chunk shapes, each alternative was slower: two or
//    four context splits a row block with route split's merge, two
//    consumer warpgroups sharing every K/V tile (128 rows, one block an
//    SM), four stages at one block an SM, and Q K^T of tile i + 1 issued
//    beside P V of tile i (with Q in registers ptxas serialises the
//    wgmmas for lack of registers; with Q in shared memory only two
//    stages fit two blocks an SM).
//
// Route mma (the remaining shapes).  FlashAttention-2 on mma.sync.m16n8k16:
// a warp owns 16 rows; a block of 4 warps is WR row warps x 4 / WR kv
// slices sharing one 64-token K/V tile, WR (4, 2 or 1) the largest that
// still gives two blocks per SM; grid (KH, row blocks, B), row blocks in
// reverse.  Q stays in registers as bf16 A fragments; S = Q K^T with
// ldmatrix on K, O += P V with ldmatrix.trans on V, P as hi + lo bf16 A
// fragments straight from registers.  Quantised pools are staged as their
// integer codes in bf16 (int8 -128..127, int4 (n ^ 8) - 8: exact) and the
// qparams are applied in f32 outside the mma: S = k_s (Q C_k^T) (the key
// zero point adds -k_s k_zp rowsum(Q), one constant per row, which
// softmax cancels), and at the end O = v_s (P C_v / l - v_zp).  bf16
// tiles arrive by cp.async in a 3-stage ring; int8 / int4 tiles go
// through registers one tile ahead (the codes ORed into the mantissa of a
// power of two, no int->float conversion).  Tokens at or past
// context_end are not read (zero-filled).  Route split runs this body.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "sm90.cuh"

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

// 16 int8 codes -> 16 bf16 (exact): codes 0-7 in lo, 8-15 in hi.  A code
// c sits as c + 128 in the mantissa of f32 2^23 (no int->float
// conversion): (2^23 + c + 128) - (2^23 + 128) = c.
__device__ __forceinline__ void codes8_bf16(uint4 raw, uint4& lo, uint4& hi) {
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
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// 16 int8 codes -> 16 bf16 into two 16-byte smem chunks
__device__ __forceinline__ void store_codes8(__nv_bfloat16* dst, uint4 raw) {
  codes8_bf16(raw, *reinterpret_cast<uint4*>(dst),
              *reinterpret_cast<uint4*>(dst + 8));
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
// codes: c..c+7 in l0, c+8..c+15 in l1, c+64.. in h0, c+72.. in h1
__device__ __forceinline__ void codes4_bf16(uint4 raw, uint4& l0, uint4& l1,
                                            uint4& h0, uint4& h1) {
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
  l0 = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  l1 = make_uint4(lo[4], lo[5], lo[6], lo[7]);
  h0 = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  h1 = make_uint4(hi[4], hi[5], hi[6], hi[7]);
}

// 16 packed int4 bytes -> bf16 codes at dst (low) and dst + Dh/2 (high)
__device__ __forceinline__ void store_codes4(__nv_bfloat16* dst, uint4 raw) {
  codes4_bf16(raw, *reinterpret_cast<uint4*>(dst),
              *reinterpret_cast<uint4*>(dst + 8),
              *reinterpret_cast<uint4*>(dst + kDh / 2),
              *reinterpret_cast<uint4*>(dst + kDh / 2 + 8));
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
  const int* pts;        // entries pg0 .. pg0 + kPtCap - 1, clamped at 0 (smem)
  int pg0, page_size, KH, kh, ctx_end, kv_cap;
};

// byte offset of token pos's row for head kh in one layer of the pool,
// or -1 when the token is not to be read
template <int BITS>
__device__ __forceinline__ long long row_off(const TileCtx& c, int pos) {
  if (pos >= c.ctx_end || pos >= c.kv_cap) return -1;
  const int page = pos / c.page_size;
  const int i = page - c.pg0;
  const int phys = i < kPtCap ? c.pts[i] : max(c.ptb[page], 0);
  return (((long long)phys * c.page_size + pos % c.page_size) * c.KH + c.kh) *
         Pool<BITS>::kRow;
}

// The page-table entries of tokens [tok_lo, tok_hi) (clamped at 0, at most
// kPtCap of them) into pts, read once so that no dependent global load
// precedes a tile's copies; ends with the block synchronised.
__device__ __forceinline__ void stage_pages(TileCtx& c, int* pts, int tok_lo,
                                            int tok_hi) {
  c.pg0 = tok_lo / c.page_size;
  const int hi = min(min(tok_hi, c.ctx_end), c.kv_cap);
  const int n = hi > tok_lo ? min((hi - 1) / c.page_size - c.pg0 + 1, kPtCap)
                            : 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    pts[i] = max(c.ptb[c.pg0 + i], 0);
  __syncthreads();
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

// The operands of every route (one struct, passed by value).
struct Args {
  const __nv_bfloat16* q;   // [B, T, H, Dh]
  const uint8_t* kp;        // this layer of the K pool
  const uint8_t* vp;        // and of the V pool
  const int* page_tables;   // [B, max_pages]
  const int* start_pos;     // [B]
  const int* context_end;   // [B]
  const float* qparams;     // [4] (kv_bits 8, 4)
  __nv_bfloat16* out;       // [B, T, H, Dh]
  float* part;              // route split's partials
  int* counter;             // tickets, zero between launches
  int B, T, H, KH, G, page_size, max_pages;
  int layer, n_pages;       // TMA row coordinate of a token (route wgmma)
  int splits;               // route split's workers per kv head
  float scale;
};

__device__ __forceinline__ size_t q_index(const Args& a, int b, int kh,
                                          int r) {
  return (((size_t)b * a.T + r / a.G) * a.H + kh * a.G + r % a.G) * kDh;
}

// zeros for rows [r0, r1) of kv head kh of slot b (discarded upstream)
__device__ __forceinline__ void zero_rows(const Args& a, int b, int kh,
                                          int r0, int r1) {
  for (int i = threadIdx.x; i < (r1 - r0) * (kDh / 8); i += blockDim.x)
    *reinterpret_cast<uint4*>(a.out + q_index(a, b, kh, r0 + i / (kDh / 8)) +
                              (i % (kDh / 8)) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
}

// out = O / l (bf16 pool), or v_s (O / l - v_zp) (quantised pool)
template <int BITS>
__device__ __forceinline__ float finish(const Args& a, float o) {
  if constexpr (BITS != 0) return (o - a.qparams[3]) * a.qparams[2];
  return o;
}

// One warp's 16 rows after the walk: (m, l) of rows gid (a) and gid + 8
// (b) in base 2, l summed over the lane quad, and the unnormalised O in
// the m16n8 C layout (o[j][0..1] row a, o[j][2..3] row b, features
// 8 j + 2 tig, + 1).
struct RowState {
  float o[16][4];
  float m_a, m_b, l_a, l_b;
};

// FlashAttention-2 on mma.sync for the 16 WR rows row0.. of kv head kh of
// slot b, over KV tiles [tile_lo, tile_hi) (an empty range leaves the
// state at m = -inf, l = 0, O = 0).  On return the warps of kv slice 0
// hold their rows' state, merged over the block's WK kv slices; the block
// is synchronised, so shared memory may be reused.
template <int BITS, int WR>
__device__ __forceinline__ void attend_rows(const Args& a, const TileCtx& tc,
                                            int b, int row0, int tile_lo,
                                            int tile_hi, uint8_t* smem_raw,
                                            RowState& st) {
  constexpr int WK = 4 / WR;             // warps per row group (kv slices)
  constexpr int NS = kTile / WK;         // kv tokens per warp per tile
  constexpr int NT = NS / 8;             // n8 tiles of S per warp
  constexpr int KS = NS / 16;            // k16 steps of P V per warp
  constexpr int S = stages(BITS);
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = warp / WK;              // row warp
  const int ksl = warp % WK;             // kv slice of the tile
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int G = a.G;
  const int start = a.start_pos[b];
  const int ctx_end = tc.ctx_end;
  const int rows = a.T * G;
  const int n_tiles = max(tile_hi - tile_lo, 0);
  const int kvb = tile_lo * kTile;       // the walk's first token

  auto kbuf = [&](int s) { return smem + 2 * s * kTileElems; };
  auto vbuf = [&](int s) { return smem + (2 * s + 1) * kTileElems; };
  constexpr int kRegs = BITS == 0 ? 1 : Pool<BITS>::kPerThread;
  uint4 rk[kRegs], rv[kRegs];
  if (n_tiles > 0) {
    if constexpr (BITS == 0) {
      load_tile_bf16(tc, a.kp, a.vp, kvb, kbuf(0), vbuf(0), tid);
      cp_async_commit();
      if (n_tiles > 1) {
        load_tile_bf16(tc, a.kp, a.vp, kvb + kTile, kbuf(1), vbuf(1), tid);
        cp_async_commit();
      }
    } else {
      load_tile_regs<BITS>(tc, a.kp, a.vp, kvb, rk, rv, tid);
      store_tile_regs<BITS>(rk, rv, kbuf(0), vbuf(0), tid);
    }
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
    const __nv_bfloat16* pa = a.q + (oka ? q_index(a, b, tc.kh, ra) : 0);
    const __nv_bfloat16* pb = a.q + (okb ? q_index(a, b, tc.kh, rbw) : 0);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int c = kk * 16 + tig * 2;
      qa[kk][0] = oka ? *reinterpret_cast<const uint32_t*>(pa + c) : 0u;
      qa[kk][1] = okb ? *reinterpret_cast<const uint32_t*>(pb + c) : 0u;
      qa[kk][2] = oka ? *reinterpret_cast<const uint32_t*>(pa + c + 8) : 0u;
      qa[kk][3] = okb ? *reinterpret_cast<const uint32_t*>(pb + c + 8) : 0u;
    }
  }
  // S = k_s (Q C_k^T) in log2 units; the key zero point's term
  // -k_s k_zp rowsum(Q) is one constant per row, which softmax cancels
  const float k_mul = (BITS != 0 ? a.qparams[0] : 1.f) * a.scale * kLog2e;

  float (&o_acc)[16][4] = st.o;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[j][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int cur = tile % S;
    const int kv0 = kvb + tile * kTile;
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
        const int s2 = (tile + 2) % S;
        load_tile_bf16(tc, a.kp, a.vp, kv0 + 2 * kTile, kbuf(s2), vbuf(s2),
                       tid);
        cp_async_commit();
      }
    } else if (more) {
      load_tile_regs<BITS>(tc, a.kp, a.vp, kv0 + kTile, rk, rv, tid);
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
  __syncthreads();  // every warp done with the K/V buffers

  if constexpr (WK > 1) {
    // merge the WK kv slices of each row warp through shared memory
    float* mo = reinterpret_cast<float*>(smem_raw);       // [4][64][32]
    float* ml = mo + 4 * 64 * 32;                         // [4][4][32]
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
    if (ksl == 0) {
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
      m_a = mt_a;
      m_b = mt_b;
    }
    __syncthreads();  // the merge read its slices; shared memory is free
  }
  st.m_a = m_a;
  st.m_b = m_b;
  st.l_a = l_a;
  st.l_b = l_b;
}

// A kv-slice-0 warp's two rows, normalised, to out (rows < T G only).
template <int BITS>
__device__ __forceinline__ void write_rows(const Args& a, int b, int kh,
                                           int ra, const RowState& st) {
  const int tig = threadIdx.x & 3;
  const int rows = a.T * a.G;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = ra + 8 * half;
    if (r >= rows) continue;
    const float inv = 1.0f / fmaxf(half ? st.l_b : st.l_a, 1e-20f);
    __nv_bfloat16* po = a.out + q_index(a, b, kh, r);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float x0 = finish<BITS>(a, st.o[j][2 * half] * inv);
      const float x1 = finish<BITS>(a, st.o[j][2 * half + 1] * inv);
      *reinterpret_cast<uint32_t*>(po + j * 8 + tig * 2) = pack_bf16(x0, x1);
    }
  }
}

// The T G rows of slot b, kv head kh: the log-sum-exp merge of n split
// partials (acc [n][T G][Dh] at pacc, (m, l) [n][T G][2] at pml), in split
// order, written to out.  Run by the whole block; the partials were
// written by other blocks (read from L2).  A thread merges 4 features of a
// row online over the splits (the running max rescales the running
// sums), so its loads for all splits are independent and in flight
// together: one L2 round trip.
template <int BITS>
__device__ __forceinline__ void merge_rows(const Args& a, int b, int kh,
                                           int n,
                                           const float* __restrict__ pacc,
                                           const float* __restrict__ pml) {
  const int stride = a.T * a.G;                // rows of a partial
  const int ng = stride * (kDh / 4);           // float4 groups of the rows
  for (int g = threadIdx.x; g < ng; g += blockDim.x) {
    const int r = g / (kDh / 4);
    const float2* ml = reinterpret_cast<const float2*>(pml) + r;
    const float4* pa = reinterpret_cast<const float4*>(pacc) + g;
    float m = -INFINITY, l = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < n; ++s) {
      const float2 x = __ldcg(ml + (size_t)s * stride);
      const float4 v = __ldcg(pa + (size_t)s * stride * (kDh / 4));
      const float mn = fmaxf(m, x.x);
      const float base = mn == -INFINITY ? 0.f : mn;
      const float fo = exp2f(m - base), fn = exp2f(x.x - base);
      l = l * fo + x.y * fn;
      o.x = o.x * fo + v.x * fn;
      o.y = o.y * fo + v.y * fn;
      o.z = o.z * fo + v.z * fn;
      o.w = o.w * fo + v.w * fn;
      m = mn;
    }
    const float iv = 1.0f / fmaxf(l, 1e-20f);
    const int d = (g % (kDh / 4)) * 4;
    *reinterpret_cast<uint2*>(a.out + q_index(a, b, kh, r) + d) =
        make_uint2(pack_bf16(finish<BITS>(a, o.x * iv),
                             finish<BITS>(a, o.y * iv)),
                   pack_bf16(finish<BITS>(a, o.z * iv),
                             finish<BITS>(a, o.w * iv)));
  }
}

// ---------------------------------------------------------------------------
// route mma: one block per (kv head, row block, slot)
// ---------------------------------------------------------------------------

template <int BITS, int WR>
__global__ void __launch_bounds__(kThreads)
paged_prefill(const Args a) {
  constexpr int kRowsPerBlock = 16 * WR;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int kh = blockIdx.x;
  const int rb = gridDim.y - 1 - blockIdx.y;  // heaviest row blocks first
  const int b = blockIdx.z;
  const int start = a.start_pos[b];
  const int ctx_end = a.context_end[b];
  const int rows = a.T * a.G;
  const int row0 = rb * kRowsPerBlock;
  if (row0 / a.G >= ctx_end - start) {
    // padding rows: zeros (discarded upstream)
    zero_rows(a, b, kh, row0, min(row0 + kRowsPerBlock, rows));
    return;
  }
  const int r_last = min(row0 + kRowsPerBlock, rows) - 1;
  const int last_q_pos = min(start + r_last / a.G, ctx_end - 1);
  const int n_tiles = last_q_pos / kTile + 1;
  int* pts = reinterpret_cast<int*>(smem_raw + 2 * stages(BITS) * kTileElems *
                                                   sizeof(__nv_bfloat16));
  TileCtx tc{a.page_tables + (size_t)b * a.max_pages, pts, 0, a.page_size,
             a.KH, kh, ctx_end, a.max_pages * a.page_size};
  stage_pages(tc, pts, 0, n_tiles * kTile);
  RowState st;
  attend_rows<BITS, WR>(a, tc, b, row0, 0, n_tiles, smem_raw, st);
  const int warp = threadIdx.x >> 5;
  if (warp % (4 / WR) == 0)
    write_rows<BITS>(a, b, kh, row0 + (warp / (4 / WR)) * 16 +
                                   ((threadIdx.x & 31) >> 2), st);
}

// ---------------------------------------------------------------------------
// route split: T G <= 64 rows in one block, the context split over blocks
// ---------------------------------------------------------------------------

constexpr int kMaxSlots = 256;  // the plan's per-slot counts in shared memory

template <int BITS, int WR>
__global__ void __launch_bounds__(kThreads, 2)
paged_prefill_split(const Args a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ int s_tiles[kMaxSlots];
  __shared__ int s_base[kMaxSlots + 1];
  __shared__ int s_sum[kThreads / 32];
  __shared__ int s_ticket;
  const int kh = blockIdx.x;
  const int w = blockIdx.y;
  const int W = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int B = a.B;
  const int rows = a.T * a.G;
  const int kv_cap = a.max_pages * a.page_size;

  // ---- the plan, the same in every block: 64-token tiles of each live
  // slot's context, `per` tiles a split, so that all splits of all slots
  // number about W; item i of the kv head goes to worker i % W ----
  int mine = 0;
  for (int i = tid; i < B; i += kThreads) {
    const int ce = a.context_end[i], sp = a.start_pos[i];
    const int n_tok = ce > sp ? min(ce, kv_cap) : 0;
    s_tiles[i] = (max(n_tok, 0) + kTile - 1) / kTile;
    mine += s_tiles[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mine += __shfl_xor_sync(0xFFFFFFFFu, mine, o);
  if (lane == 0) s_sum[warp] = mine;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += s_sum[i];
  const int per = max(1, (total + W - 1) / W);
  if (warp == 0) {
    int carry = 0;
    if (lane == 0) s_base[0] = 0;
    for (int c = 0; c < B; c += 32) {
      const int i = c + lane;
      int v = i < B ? (s_tiles[i] + per - 1) / per : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xFFFFFFFFu, v, o);
        if (lane >= o) v += u;
      }
      if (i < B) s_base[i + 1] = carry + v;
      carry += __shfl_sync(0xFFFFFFFFu, v, 31);
    }
  }
  __syncthreads();
  const int n_items = s_base[B];
  const int n_cap = B + W;  // partial slots per kv head (n_items <= this)

  // padding slots (context_end <= start_pos): zeros, by worker b % W
  for (int b = w; b < B; b += W)
    if (s_tiles[b] == 0) zero_rows(a, b, kh, 0, rows);

  int* pts = reinterpret_cast<int*>(smem_raw + 2 * stages(BITS) * kTileElems *
                                                   sizeof(__nv_bfloat16));
  constexpr int WK = 4 / WR;
  const bool lead = warp % WK == 0;                 // kv slice 0
  const int ra = (warp / WK) * 16 + (lane >> 2);    // its rows ra, ra + 8
  for (int item = w; item < n_items; item += W) {
    int b = 0;  // the last slot whose first item is <= item
    for (int lo = 0, hi = B - 1; lo < hi;) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_base[mid] <= item) lo = mid; else hi = mid - 1;
      b = lo;
    }
    const int n_split = s_base[b + 1] - s_base[b];
    const int s = item - s_base[b];
    const int start = a.start_pos[b];
    const int ctx_end = min(a.context_end[b], kv_cap);
    // the rows need tiles up to their last position
    const int need = min(start + (rows - 1) / a.G, ctx_end - 1) / kTile + 1;
    const int tl = s * per;
    const int th = min(min(tl + per, s_tiles[b]), need);
    TileCtx tc{a.page_tables + (size_t)b * a.max_pages, pts, 0, a.page_size,
               a.KH, kh, ctx_end, kv_cap};
    stage_pages(tc, pts, tl * kTile, th * kTile);
    RowState st;
    attend_rows<BITS, WR>(a, tc, b, 0, tl, th, smem_raw, st);
    if (n_split == 1) {
      if (lead) write_rows<BITS>(a, b, kh, ra, st);
      continue;
    }
    // write this split's (m, l, O); the last split of the slot to finish
    // merges them all in split order and resets the ticket
    const size_t slot0 = (size_t)kh * n_cap + s_base[b];
    float* pacc = a.part + slot0 * rows * kDh;
    float* pml = a.part + (size_t)a.KH * n_cap * rows * kDh + slot0 * rows * 2;
    if (lead) {
      const int tig = lane & 3;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = ra + 8 * half;
        if (r >= rows) continue;
        float* po = pacc + ((size_t)s * rows + r) * kDh;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(po + j * 8 + tig * 2) =
              make_float2(st.o[j][2 * half], st.o[j][2 * half + 1]);
        if (tig == 0) {
          pml[((size_t)s * rows + r) * 2] = half ? st.m_b : st.m_a;
          pml[((size_t)s * rows + r) * 2 + 1] = half ? st.l_b : st.l_a;
        }
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) s_ticket = atomicAdd(a.counter + b * a.KH + kh, 1);
    __syncthreads();
    if (s_ticket == n_split - 1) {
      __threadfence();
      merge_rows<BITS>(a, b, kh, n_split, pacc, pml);
      if (tid == 0) a.counter[b * a.KH + kh] = 0;  // ready for the next launch
    }
    __syncthreads();  // s_ticket is read by everyone before the next item
  }
}

// ---------------------------------------------------------------------------
// route wgmma: chunks; warp-specialised, TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int kHalfBytes = kTile * 64 * 2;    // 64 tokens x 64 features, 8 KB
constexpr int kWStage = 4 * kHalfBytes;       // K and V, two halves each

constexpr int kWStages = 3;                   // K/V tiles in the ring
constexpr int kWThreads = 160;                // consumer warpgroup + producer

// Shared memory of route wgmma at a KV width: bf16 tiles land in the ring
// in wgmma's layout; int8 / int4 tiles land raw (a token's row of one kv
// head: 128 or 64 bytes) and the consumers stage them as bf16 codes in
// one more K/V tile, the `conv` buffer, in wgmma's layout.
template <int BITS>
struct WSmem {
  static constexpr int kRawRow = BITS == 8 ? kDh : kDh / 2;
  static constexpr int kConv = BITS == 0 ? 0 : kWStage;
  static constexpr int kStage = BITS == 0 ? kWStage : 2 * kTile * kRawRow;
  static constexpr int kBytes =
      1024 + kConv + kWStages * kStage + 2 * kWStages * 8 + kPtCap * 4;
};

// Shared-memory descriptor of an MN-major bf16 B tile with 128-byte
// swizzle, the V tile [64 tokens (K)][128 features (N)] stored as two
// halves of 64 features: 8-token atoms 1024 bytes apart (SBO), the second
// half of the features 8 KB further (LBO).
__device__ __forceinline__ uint64_t mn_sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kHalfBytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// S (64 x 64 f32) = Q (A, registers) K^T (B, K-major in shared memory)
__device__ __forceinline__ void wgmma_qk(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// O (64 x 128 f32) += P (A, registers) V (B, MN-major: transposed B)
__device__ __forceinline__ void wgmma_pv(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Grid (KH, row blocks of 64, B), row blocks in the order below.  Warps
// 0-3 are one consumer warpgroup on the block's 64 rows; warp 4's lane 0
// is the producer.  tm_k / tm_v: the whole pool as [L P page, KH row] (see
// pool_map).
template <int BITS>
__global__ void __launch_bounds__(kWThreads, 2)
paged_prefill_wgmma(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const Args a) {
  using W = WSmem<BITS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* conv = smem;                         // int8 / int4: codes in bf16
  uint8_t* ring = smem + W::kConv;              // K/V stages
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWStages * W::kStage);
  uint64_t* empty = full + kWStages;
  int* pts = reinterpret_cast<int*>(empty + kWStages);

  const int kh = blockIdx.x;
  const int b = blockIdx.z;
  // Row blocks by causal work, descending: the slot's row blocks with
  // valid rows from the last, then those past the chunk's valid rows
  // (zeros).  The first half of the grid's y takes that list in order,
  // the second half from its end, so that the two blocks an SM takes (one
  // from each half when the grid fills the card once) pair a heavy walk
  // with a light one.
  const int n_live =
      (min(a.T, max(a.context_end[b] - a.start_pos[b], 0)) * a.G + 63) / 64;
  const int k = blockIdx.y < (gridDim.y + 1) / 2
                    ? blockIdx.y
                    : gridDim.y - 1 - (blockIdx.y - (gridDim.y + 1) / 2);
  const int rb = k < n_live ? n_live - 1 - k : k;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = a.G;
  const int rows = a.T * G;
  const int start = a.start_pos[b];
  const int kv_cap = a.max_pages * a.page_size;
  const int ctx_end = min(a.context_end[b], kv_cap);
  const int row0 = rb * 64;
  const int r1 = min(row0 + 64, rows);
  if (row0 / G >= a.context_end[b] - start) {
    // padding rows: zeros (discarded upstream)
    zero_rows(a, b, kh, row0, r1);
    return;
  }
  const int n = min(start + (r1 - 1) / G, ctx_end - 1) / kTile + 1;

  // the page ids of the walk's tokens, clamped at 0 (0 past the table)
  const int* ptb = a.page_tables + (size_t)b * a.max_pages;
  const int n_pg = min((n * kTile - 1) / a.page_size + 1, kPtCap);
  for (int i = tid; i < n_pg; i += kWThreads)
    pts[i] = i < a.max_pages ? max(ptb[i], 0) : 0;
  if (tid == 0) {
    for (int i = 0; i < kWStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);            // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: K and V tiles by TMA, one box per page and half ----
    if (lane == 0) {
      const int br = min(a.page_size, kTile);   // tokens of one box
      const int row_l = a.layer * a.n_pages;    // the layer's first page
      for (int i = 0; i < n; ++i) {
        const int st = i % kWStages;
        if (i >= kWStages) mbar_wait(&empty[st], ((i / kWStages) - 1) & 1);
        mbar_expect_tx(&full[st], W::kStage);
        uint8_t* base = ring + st * W::kStage;
        for (int j = 0; j < kTile; j += br) {
          const int tok = i * kTile + j;
          const int page = tok / a.page_size;
          const int phys = page >= a.max_pages ? 0
                           : page < kPtCap     ? pts[page]
                                               : max(ptb[page], 0);
          const int row = (row_l + phys) * a.page_size + tok % a.page_size;
          if constexpr (BITS == 0) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int col = kh * kDh + h * 64;
              tma_load_2d(base + h * kHalfBytes + j * 128, &tm_k, col, row,
                          &full[st]);
              tma_load_2d(base + (2 + h) * kHalfBytes + j * 128, &tm_v, col,
                          row, &full[st]);
            }
          } else {
            const int col = kh * W::kRawRow;
            tma_load_2d(base + j * W::kRawRow, &tm_k, col, row, &full[st]);
            tma_load_2d(base + (kTile + j) * W::kRawRow, &tm_v, col, row,
                        &full[st]);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: rows ra, ra + 8 of each warp's 16 ----
  const int gid = lane >> 2;
  const int t4 = lane & 3;
  const int ra = row0 + warp * 16 + gid;
  const int rb2 = ra + 8;
  const int qpos_a = start + ra / G, qpos_b = start + rb2 / G;
  // Q as the A operand in registers (the m16n8k16 A layout of each
  // warp's 16 rows), exact bf16
  uint32_t qa[8][4];
  {
    const bool oka = ra < rows, okb = rb2 < rows;
    const __nv_bfloat16* pa = a.q + (oka ? q_index(a, b, kh, ra) : 0);
    const __nv_bfloat16* pb = a.q + (okb ? q_index(a, b, kh, rb2) : 0);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int c = kk * 16 + t4 * 2;
      qa[kk][0] = oka ? *reinterpret_cast<const uint32_t*>(pa + c) : 0u;
      qa[kk][1] = okb ? *reinterpret_cast<const uint32_t*>(pb + c) : 0u;
      qa[kk][2] = oka ? *reinterpret_cast<const uint32_t*>(pa + c + 8) : 0u;
      qa[kk][3] = okb ? *reinterpret_cast<const uint32_t*>(pb + c + 8) : 0u;
    }
  }
  // S = k_s (Q C_k^T) in log2 units for a quantised pool (the key zero
  // point's term is one constant per row, which softmax cancels)
  const float k_mul = (BITS != 0 ? a.qparams[0] : 1.f) * a.scale * kLog2e;
  float s[32], o[64];
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int st = i % kWStages;
    const int kv0 = i * kTile;
    uint8_t* base = (BITS == 0 ? ring + st * W::kStage : conv);
    const uint32_t kaddr = smem_u32(base);
    const uint32_t vaddr = smem_u32(base + 2 * kHalfBytes);
    mbar_wait(&full[st], (i / kWStages) & 1);
    if constexpr (BITS != 0) {
      // the raw tile's codes to bf16 (exact) in conv, in wgmma's layout
      // (16-byte chunk c of a 128-byte row r at chunk c ^ (r & 7)); the
      // previous tile's wgmmas, which read conv, are done in every warp
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      const uint8_t* raw = ring + st * W::kStage;
      constexpr int kChunks = W::kRawRow / 16;        // a row's 16 bytes
      for (int c = tid; c < 2 * kTile * kChunks; c += 128) {
        const int which = c / (kTile * kChunks);       // 0 K, 1 V
        const int tok = (c / kChunks) % kTile, ch = c % kChunks;
        const uint4 v = *reinterpret_cast<const uint4*>(
            raw + (which * kTile + tok) * W::kRawRow + ch * 16);
        uint8_t* row = conv + which * 2 * kHalfBytes + tok * 128;
        const int sw = tok & 7;
        if constexpr (BITS == 8) {        // features 16 ch .. 16 ch + 15
          const int h = ch >> 2, q = (ch & 3) * 2;
          uint4 lo, hi;
          codes8_bf16(v, lo, hi);
          *reinterpret_cast<uint4*>(row + h * kHalfBytes + ((q ^ sw) << 4)) =
              lo;
          *reinterpret_cast<uint4*>(row + h * kHalfBytes +
                                    (((q + 1) ^ sw) << 4)) = hi;
        } else {                          // 16 ch .. + 15 and 64 + 16 ch ..
          const int q = ch * 2;
          uint4 l0, l1, h0, h1;
          codes4_bf16(v, l0, l1, h0, h1);
          *reinterpret_cast<uint4*>(row + ((q ^ sw) << 4)) = l0;
          *reinterpret_cast<uint4*>(row + (((q + 1) ^ sw) << 4)) = l1;
          *reinterpret_cast<uint4*>(row + kHalfBytes + ((q ^ sw) << 4)) = h0;
          *reinterpret_cast<uint4*>(row + kHalfBytes +
                                    (((q + 1) ^ sw) << 4)) = h1;
        }
      }
      if (lane == 0) mbar_arrive(&empty[st]);   // the raw stage is free
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
    }

    // S = Q K^T: 8 k16 steps over Dh, K-major K from shared memory
#pragma unroll
    for (int j = 0; j < 32; ++j) pin(s[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_qk(s, qa[kk],
               kmajor_sw128_desc(kaddr + (kk >> 2) * kHalfBytes +
                                 32 * (kk & 3)),
               kk != 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 32; ++j) pin(s[j]);

    // scale (base 2), mask the diagonal and the context's last tile, row
    // max over the lane quad
    const bool need_mask = kv0 + kTile - 1 > qpos_a || kv0 + kTile > ctx_end;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool row_b = e >= 2;
        float v = s[4 * j + e] * k_mul;
        if (need_mask) {
          const int kv = kv0 + j * 8 + t4 * 2 + (e & 1);
          const bool ok = kv <= (row_b ? qpos_b : qpos_a) && kv < ctx_end;
          v = ok ? v : -INFINITY;
        }
        s[4 * j + e] = v;
        if (row_b)
          mx_b = fmaxf(mx_b, v);
        else
          mx_a = fmaxf(mx_a, v);
      }
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xFFFFFFFFu, mx_a, x));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xFFFFFFFFu, mx_b, x));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float al_a = exp2f(m_a - base_a), al_b = exp2f(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= al_a;
    l_b *= al_b;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[4 * j + 0] *= al_a;
      o[4 * j + 1] *= al_a;
      o[4 * j + 2] *= al_b;
      o[4 * j + 3] *= al_b;
    }
    // P in the A layout: k16 step k2 holds tokens 16 k2 .. + 15, the C
    // fragments of S's n8 blocks 2 k2 and 2 k2 + 1
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float* c = s + 4 * (2 * k2 + hh);
        const float p0 = exp2f(c[0] - base_a), p1 = exp2f(c[1] - base_a);
        const float p2 = exp2f(c[2] - base_b), p3 = exp2f(c[3] - base_b);
        l_a += p0 + p1;
        l_b += p2 + p3;
        split_p(p0, p1, ph[k2][2 * hh], pl[k2][2 * hh]);
        split_p(p2, p3, ph[k2][2 * hh + 1], pl[k2][2 * hh + 1]);
      }
    }
    // V rows at or past the context's end are not attended; zero them so
    // that 0 x (stale pool bytes) cannot be NaN (int codes are finite)
    if (BITS == 0 && kv0 + kTile > ctx_end) {
      const int z0 = max(ctx_end - kv0, 0);
      uint4* vz = reinterpret_cast<uint4*>(base + 2 * kHalfBytes);
      for (int c = tid; c < 2 * kTile * 8; c += 128) {
        const int r = (c >> 3) & (kTile - 1);
        if (r >= z0) vz[c] = make_uint4(0u, 0u, 0u, 0u);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
    }
    // O += P V: 4 k16 steps over the tile's tokens, V MN-major
#pragma unroll
    for (int j = 0; j < 64; ++j) pin(o[j]);
    wgmma_fence();
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
      const uint64_t dv = mn_sw128_desc(vaddr + k2 * 16 * 128);
      wgmma_pv(o, ph[k2], dv);
      wgmma_pv(o, pl[k2], dv);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 64; ++j) pin(o[j]);
    if (BITS == 0 && lane == 0) mbar_arrive(&empty[st]);
  }
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l_a += __shfl_xor_sync(0xFFFFFFFFu, l_a, x);
    l_b += __shfl_xor_sync(0xFFFFFFFFu, l_b, x);
  }

  // ---- epilogue: O / l to out ----
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = ra + 8 * half;
    if (r >= rows) continue;
    const float inv = 1.0f / fmaxf(half ? l_b : l_a, 1e-20f);
    __nv_bfloat16* po = a.out + q_index(a, b, kh, r);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(po + j * 8 + t4 * 2) =
          pack_bf16(finish<BITS>(a, o[4 * j + 2 * half] * inv),
                    finish<BITS>(a, o[4 * j + 2 * half + 1] * inv));
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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

// Set a kernel's dynamic shared memory once (outside any graph capture),
// then launch it, or with `occ` set write the blocks of it that fit on one
// SM instead.
template <auto kernel, typename... P>
cudaError_t run(dim3 grid, int threads, int smem, cudaStream_t st, int* occ,
                P... args) {
  static bool attr = false;  // one flag per kernel
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  if (occ != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kernel, threads,
                                                         smem);
  kernel<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// The tensor map of one pool viewed as [L P page, KH row]: bf16 (row Dh)
// with a box of {64 features, min(page, 64) tokens} and 128-byte swizzle,
// wgmma's layout; int8 / int4 bytes (row Dh or Dh / 2) with a box of {a
// row, min(page, 64) tokens}, no swizzle.  Encoded once per pool pointer,
// shape and width and kept on the host: no encode on the hot path and
// none inside a graph capture after the first call.
bool pool_map(CUtensorMap* map, const void* pool, int L, int P, int page,
              int KH, int bits) {
  struct Entry {
    const void* pool;
    int L, P, page, KH, bits;
    CUtensorMap map;
  };
  static std::mutex mu;
  static Entry cache[16];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.pool == pool && e.L == L && e.P == P && e.page == page &&
        e.KH == KH && e.bits == bits) {
      *map = e.map;
      return true;
    }
  }
  Entry e{pool, L, P, page, KH, bits, {}};
  const uint64_t rows = (uint64_t)L * P * page;
  const uint32_t box_rows = page < kTile ? page : kTile;
  const int row = bits == 0 ? kDh : (bits == 8 ? kDh : kDh / 2);
  const bool ok =
      bits == 0
          ? encode_2d(&e.map, pool, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rows,
                      (uint64_t)KH * kDh, box_rows, 64,
                      CU_TENSOR_MAP_SWIZZLE_128B)
          : encode_2d(&e.map, pool, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, rows,
                      (uint64_t)KH * row, box_rows, row,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return false;
  const int slot = used < 16 ? used++ : (next++ % 16);
  cache[slot] = e;
  *map = e.map;
  return true;
}

// route mma at BITS: 16 WR-row blocks, WR the most that still gives every
// SM two blocks (measured on an H100 against forced WR: the fastest at a
// 512-token chunk, 64 tokens over 300 and 5 over 500)
template <int BITS>
cudaError_t launch_mma(const Args& a, cudaStream_t st) {
  const long long rows = (long long)a.T * a.G;
  const long long heads = (long long)a.B * a.KH;
  const int sms = 2 * num_sms();
  const int smem = (int)smem_bytes(BITS);
  auto grid = [&](int wr) {
    return dim3(a.KH, (unsigned)((rows + 16 * wr - 1) / (16 * wr)), a.B);
  };
  if (heads * ((rows + 63) / 64) >= sms)
    return run<paged_prefill<BITS, 4>>(grid(4), kThreads, smem, st, nullptr, a);
  if (rows > 16 && heads * ((rows + 31) / 32) >= sms)
    return run<paged_prefill<BITS, 2>>(grid(2), kThreads, smem, st, nullptr, a);
  return run<paged_prefill<BITS, 1>>(grid(1), kThreads, smem, st, nullptr, a);
}

// route split at BITS: WR row warps cover the T G rows (<= 64)
template <int BITS>
cudaError_t launch_split(const Args& a, cudaStream_t st, int* occ) {
  const int rows = a.T * a.G;
  const dim3 grid(a.KH, a.splits);
  const int smem = (int)smem_bytes(BITS);
  if (rows <= 16)
    return run<paged_prefill_split<BITS, 1>>(grid, kThreads, smem, st, occ,
                                                a);
  if (rows <= 32)
    return run<paged_prefill_split<BITS, 2>>(grid, kThreads, smem, st, occ,
                                                a);
  return run<paged_prefill_split<BITS, 4>>(grid, kThreads, smem, st, occ,
                                                a);
}

template <int BITS>
cudaError_t launch_wgmma(const Args& a, const void* k_pool,
                         const void* v_pool, int L, cudaStream_t st,
                         int* occ) {
  CUtensorMap tk{}, tv{};
  if (occ == nullptr &&
      (!pool_map(&tk, k_pool, L, a.n_pages, a.page_size, a.KH, BITS) ||
       !pool_map(&tv, v_pool, L, a.n_pages, a.page_size, a.KH, BITS)))
    return cudaErrorInvalidValue;
  const dim3 grid(a.KH, (a.T * a.G + 63) / 64, a.B);
  constexpr int kSmem = WSmem<BITS>::kBytes;
  return run<paged_prefill_wgmma<BITS>>(grid, kWThreads, kSmem, st, occ, tk,
                                        tv, a);
}

template <int BITS>
cudaError_t dispatch(int route, const Args& a, const void* k_pool,
                     const void* v_pool, int L, cudaStream_t st, int* occ) {
  switch (route) {
    case 0:
      if (occ != nullptr) return cudaErrorInvalidValue;
      return launch_mma<BITS>(a, st);
    case 1: return launch_split<BITS>(a, st, occ);
    case 2: return launch_wgmma<BITS>(a, k_pool, v_pool, L, st, occ);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bits(int kv_bits, int route, const Args& a,
                          const void* k_pool, const void* v_pool, int L,
                          cudaStream_t st, int* occ) {
  switch (kv_bits) {
    case 0: return dispatch<0>(route, a, k_pool, v_pool, L, st, occ);
    case 8: return dispatch<8>(route, a, k_pool, v_pool, L, st, occ);
    case 4: return dispatch<4>(route, a, k_pool, v_pool, L, st, occ);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// route 0 mma, 1 split, 2 wgmma (see above).  k_pool / v_pool point at the
// WHOLE pool [L, P, page, KH, Dh] bf16 (kv_bits 0) or int8 (8), [L, P,
// page, KH, Dh/2] uint8 (4); the kernel reads layer `layer`.  page_tables
// [B, max_pages], start_pos [B], context_end [B] are int32; qparams f32
// [4] (kv_bits 8, 4; may be null for 0).  `splits`: route split's workers
// per kv head (ignored by the others); with more than one, `part` is f32
// scratch of KH (B + splits) T G (Dh + 2) floats and `counter` B KH int32
// tickets, zero before the first launch (each launch leaves them at zero).
int lmd_paged_prefill_attention(int route, const void* q, const void* k_pool,
                                const void* v_pool, const void* page_tables,
                                const void* start_pos, const void* context_end,
                                const void* qparams, void* out, void* part,
                                void* counter, int B, int T, int H, int KH,
                                int Dh, int L, int P, int layer, int page_size,
                                int max_pages, int kv_bits, int splits,
                                float scale, void* stream) {
  if (Dh != kDh || KH <= 0 || H % KH != 0 || splits <= 0 || page_size <= 0 ||
      layer < 0 || layer >= L)
    return (int)cudaErrorInvalidValue;
  if (kv_bits != 0 && qparams == nullptr) return (int)cudaErrorInvalidValue;
  const int G = H / KH;
  if (route == 1 && (T * G > 64 || B > kMaxSlots || 64 % G != 0))
    return (int)cudaErrorInvalidValue;
  if (route == 2 && page_size % kTile != 0 && kTile % page_size != 0)
    return (int)cudaErrorInvalidValue;
  if (route == 1 && splits > 1 && (part == nullptr || counter == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0) return (int)cudaSuccess;
  const int row = kv_bits == 0 ? 2 * kDh : (kv_bits == 8 ? kDh : kDh / 2);
  const size_t layer_bytes = (size_t)P * page_size * KH * row;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kp = static_cast<const uint8_t*>(k_pool) + layer * layer_bytes;
  a.vp = static_cast<const uint8_t*>(v_pool) + layer * layer_bytes;
  a.page_tables = static_cast<const int*>(page_tables);
  a.start_pos = static_cast<const int*>(start_pos);
  a.context_end = static_cast<const int*>(context_end);
  a.qparams = static_cast<const float*>(qparams);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part = static_cast<float*>(part);
  a.counter = static_cast<int*>(counter);
  a.B = B;
  a.T = T;
  a.H = H;
  a.KH = KH;
  a.G = G;
  a.page_size = page_size;
  a.max_pages = max_pages;
  a.layer = layer;
  a.n_pages = P;
  a.splits = route == 1 ? splits : 1;
  a.scale = scale;
  return (int)dispatch_bits(kv_bits, route, a, k_pool, v_pool, L,
                            static_cast<cudaStream_t>(stream), nullptr);
}

// Blocks of route `route` at this width and T G rows that the card holds
// at once (SMs x resident blocks per SM, from the occupancy calculator); a
// negative value is a CUDA error.
int lmd_paged_prefill_capacity(int route, int kv_bits, int rows) {
  int occ = 0;
  Args a{};
  a.T = rows;
  a.G = 1;
  const cudaError_t e =
      dispatch_bits(kv_bits, route, a, nullptr, nullptr, 1, nullptr, &occ);
  if (e != cudaSuccess) return -(int)e;
  return num_sms() * occ;
}

}  // extern "C"
