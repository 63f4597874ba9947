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
// Two regimes; the wrapper (ops/cuda/quant_matmul.py) picks one by M at the
// crossover measured on the H100:
//  * decode (small M): w4a16_decode.  Bound by the packed weight bytes
//    (K*N/2: Llama-2-7B wqkv 25.2 MB, ~7.5 us at 3.35 TB/s).  Tensor cores
//    on mma.sync.m16n8k16 bf16 -> f32 with A and B swapped: the weight is
//    the A operand (16 output columns x 16 k) and x^T the B operand (16 k x
//    8 rows of x), so M = 8, the engine's decode shape, fills one n8 tile;
//    M <= 8 takes one n8 tile, larger M two per pass (grid z over 16-row
//    slabs).  The packed layout is kept: a lane builds its A fragments
//    from 16-byte loads along N of 4 packed rows, 8 lanes covering 128
//    contiguous bytes of a row, and the kernel owns the order of its
//    output columns (see w4a16_decode).  Nibbles become bf16 without cvt:
//    OR into the mantissa of bf16 128 and subtract 128 (exact, two per
//    32-bit op).  A byte's low and high nibbles belong to groups gb and
//    G/2 + gb and go to two partial sums, each scaled once by its group's
//    s.  A warp keeps all 16 of its 16-byte weight loads in flight; a
//    block's 4 warps split K and are summed in shared memory in warp
//    order.  The grid's y blocks split K further (8 for K = 4096, 22 for
//    K = 11008).  Their sum is taken in a fixed order, so a call gives the
//    same bits on every run (the TPU kernel's K loop is sequential too,
//    and a seed must give one sampled stream): each y block writes its f32
//    partial tile to a workspace [S, M, N] (staged in shared memory, so
//    the stores are coalesced 16-byte rows); the last block of a column
//    tile to arrive, found by a ticket counter per (x, z) tile that it
//    resets for the next launch (as paged_decode_attention.cu merges its
//    splits), sums the S partials into y in a fixed order: q = 128 /
//    outputs threads per float4 output (4 at M = 1), each over a fixed
//    range of splits in index order, their sums added in range order.  At M = 8 the
//    partials are S*M*N*4 bytes (2.9 MB for w2, 3.1 MB for wqkv) against
//    22-25 MB of weight, written and read back through L2.  Chosen over a
//    cluster with a DSMEM reduction: a portable cluster holds 8 blocks, so
//    w2's 22 splits would need the non-portable size 16 or a new split of
//    K, while the ticket pattern keeps the split and tile as they were.
//    y is written, not accumulated, so no zero-fill launch precedes it.
//  * prefill (large M): w4a16_wgmma.  Bound by operations (2*M*K*N; one
//    Llama-2-7B layer at M = 512 is 207 GFLOP, 0.21 ms at 989 TF/s), and
//    behind that by the L2 -> SM traffic of the x tiles, which every block
//    along N reads again.  Design:
//    - wgmma.mma_async m64nBMk16 (the only path to the tensor cores' full
//      rate) with A and B swapped, as in the decode regime: A is 64 output
//      columns x 16 k of the weight, built IN REGISTERS from the packed
//      bytes by the same mantissa trick (wgmma's register-A form), so the
//      weight never goes through shared memory as bf16; B is a [BM rows of
//      x] x [16 k] tile in shared memory, K-major as x is, with 128-byte
//      swizzle.  M rows of x are wgmma's N (64 or 128); TMA zero-fills the
//      ragged M edge and the ragged N edge of the weight.
//    - The lane -> column map of the decode kernel, for one m64 tile: a
//      warp owns 16 output columns and lane (gid, t) holds A rows gid and
//      gid + 8 = columns 2*gid and 2*gid + 1, so it reads one 16-bit pair
//      per packed row and its accumulator rows are two adjacent output
//      columns: scales come as one bf16 pair, results leave as float2.
//    - Half-split K: a pipeline stage holds 64 packed rows of the block's
//      columns and the two x tiles they multiply (low nibbles: x columns
//      k'.., high nibbles: K/2 + k'..).  A group (128 packed rows) is two
//      stages; its low and high halves are groups gb and G/2 + gb.
//    - Exact per-group scaling, as in the TPU kernel: each half's 8 k16
//      steps run into one f32 partial that the first step resets (scale-d
//      0), and after wgmma.wait_group the partial is folded into the
//      running sum with s[g, n] (n is the accumulator's row, so a thread
//      reads one scale pair per group).  Nibbles and x are exact in bf16
//      and their products exact in f32, as in the decode kernel.  No split
//      over K: deterministic.
//    - Pipeline: a ring of 5-6 stages in dynamic shared memory with full /
//      empty mbarriers.  One producer thread (its warpgroup gives registers
//      away with setmaxnreg) issues three TMA loads per stage; one or two
//      consumer warpgroups, each on its own 64 columns of the block, build
//      A fragments from shared memory and run wgmma.  While one consumer
//      waits on its partial and folds it, the other's wgmmas keep the
//      tensor cores busy.
//    - Tiles: 128 columns x 128 rows or 128 x 64 (two consumers), 64 x 64
//      (one consumer), chosen per call from N and M by the number of waves
//      over the card's SMs (see pick_tile).  Tensor maps are encoded on the
//      host per call (cuTensorMapEncodeTiled through the runtime's driver
//      entry point; its cost is measured by lmd_tmap_encode_ns).
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>

namespace {

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two packed bytes' nibbles, in bits 0-3 and 16-19 of v, as exact bf16
// values 0..15: OR into the mantissa of bf16 128, then subtract 128.
__device__ __forceinline__ uint32_t nib2_bf16(uint32_t v) {
  uint32_t r = (v & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 c = __floats2bfloat162_rn(128.f, 128.f);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&r);
  b = __hsub2(b, c);
  return *reinterpret_cast<uint32_t*>(&b);
}

// ---------------------------------------------------------------------------
// prefill regime: wgmma with the weight as the register operand
// ---------------------------------------------------------------------------

constexpr int kGroup = 128;     // the prefill regime's quantisation group
constexpr int kChunk = 64;      // packed rows per pipeline stage
constexpr int kSmemBudget = 200 * 1024;

template <int BM, int NWG>
struct Tile {
  static constexpr int kBN = 64 * NWG;              // output columns
  static constexpr int kWBytes = kChunk * kBN;      // packed weight tile
  static constexpr int kXBytes = BM * kChunk * 2;   // one half's x tile
  static constexpr int kStage = kWBytes + 2 * kXBytes;
  static constexpr int kStages =
      kSmemBudget / kStage < 6 ? kSmemBudget / kStage : 6;
  static constexpr int kThreads = 128 * (NWG + 1);  // + producer warpgroup
  static constexpr int kSmem = 1024 + kStages * kStage + 2 * kStages * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of v across the wgmma barriers.
__device__ __forceinline__ void pin(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}

// Shared-memory descriptor of a K-major bf16 tile with 128-byte swizzle
// (rows of 64 k, 8-row atoms 1024 bytes apart).
__device__ __forceinline__ uint64_t kmajor_sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// D (64 x N, f32, in registers) += A (64 x 16 bf16, four registers a
// thread, the m16n8k16 A layout per warp) x B (16 x N, shared memory,
// descriptor desc); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
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

__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}


// Byte offset of (packed row r, byte column c) in a TMA-swizzled weight
// tile: 128-byte rows swizzle 16-byte chunks with r % 8 (SWIZZLE_128B),
// 64-byte rows with (r / 2) % 4 (SWIZZLE_64B).
template <int BN>
__device__ __forceinline__ int w_off(int r, int c) {
  if constexpr (BN == 128)
    return r * 128 + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15));
  else
    return r * 64 + ((((c >> 4) ^ ((r >> 1) & 3)) << 4) | (c & 15));
}

template <int BM>
__device__ __forceinline__ void wgmma_bm(float (&d)[BM / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  if constexpr (BM == 128)
    wgmma_n128(d, a, desc, scale_d);
  else
    wgmma_n64(d, a, desc, scale_d);
}

// Grid (ceil(N / BN), ceil(M / BM)); NWG consumer warpgroups, then one
// producer warpgroup.  tm_x: x [M, K] bf16, box {64, BM}, SWIZZLE_128B;
// tm_w: the layer's packed [K/2, N] uint8, box {BN, 64}, swizzled to the
// row width.
template <int BM, int NWG>
__global__ void __launch_bounds__(Tile<BM, NWG>::kThreads, 1)
w4a16_wgmma(const __grid_constant__ CUtensorMap tm_x,
            const __grid_constant__ CUtensorMap tm_w,
            const __nv_bfloat16* __restrict__ s, float* __restrict__ y,
            int M, int K, int N) {
  using T = Tile<BM, NWG>;
  constexpr int kBN = T::kBN;
  constexpr int kS = T::kStages;
  constexpr int kD = BM / 2;                // accumulator floats per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kS * T::kStage);
  uint64_t* empty = full + kS;

  const int half_k = K >> 1;
  const int g_half = half_k / kGroup;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;

  if (tid == 0) {
    for (int i = 0; i < kS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * NWG);       // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer: one thread keeps the ring full ----
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == NWG * 128) {
      for (int i = 0; i < 2 * g_half; ++i) {
        const int st = i % kS;
        if (i >= kS) mbar_wait(&empty[st], ((i / kS) - 1) & 1);
        mbar_expect_tx(&full[st], T::kStage);
        const int krow = (i >> 1) * kGroup + (i & 1) * kChunk;
        uint8_t* base = smem + st * T::kStage;
        tma_load_2d(base, &tm_w, n0, krow, &full[st]);
        tma_load_2d(base + T::kWBytes, &tm_x, krow, m0, &full[st]);
        tma_load_2d(base + T::kWBytes + T::kXBytes, &tm_x, half_k + krow, m0,
                    &full[st]);
      }
    }
  } else {
    // ---- consumer warpgroup wg: output columns n0 + 64 wg .. + 63 ----
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = tid & 31;
    const int warp = (tid >> 5) & 3;
    const int gid = lane >> 2;
    const int t4 = lane & 3;
    const int col = wg * 64 + warp * 16 + 2 * gid;   // byte column in tile
    const int n = n0 + col;                          // columns n, n + 1
    const bool n_ok = n < N;                         // N % 16 == 0
    // this lane's packed rows 2t4, 2t4+1, 2t4+8, 2t4+9 of each k16 step;
    // 16 rows further keep the same swizzle
    const int off0 = w_off<kBN>(2 * t4, col);
    const int off1 = w_off<kBN>(2 * t4 + 1, col);
    const int off2 = w_off<kBN>(2 * t4 + 8, col);
    const int off3 = w_off<kBN>(2 * t4 + 9, col);

    float acc[kD], part[kD];
#pragma unroll
    for (int i = 0; i < kD; ++i) acc[i] = 0.f;

    for (int gb = 0; gb < g_half; ++gb) {
      // the group's two scale pairs, read while the wgmmas run
      uint32_t sc[2] = {0u, 0u};
      if (n_ok) {
        sc[0] = *reinterpret_cast<const uint32_t*>(s + (size_t)gb * N + n);
        sc[1] = *reinterpret_cast<const uint32_t*>(
            s + (size_t)(g_half + gb) * N + n);
      }
      const int i0 = 2 * gb;
      mbar_wait(&full[i0 % kS], (i0 / kS) & 1);
      mbar_wait(&full[(i0 + 1) % kS], ((i0 + 1) / kS) & 1);

      // the packed bytes of both stages: rows (2t4, 2t4+1) and
      // (2t4+8, 2t4+9) of each k16 step, as [row a | row b << 16]
      uint32_t v01[2][4], v23[2][4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint8_t* wt = smem + ((i0 + c) % kS) * T::kStage;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int r = kk * 16 * kBN;
          const uint32_t b0 = *reinterpret_cast<const uint16_t*>(wt + off0 + r);
          const uint32_t b1 = *reinterpret_cast<const uint16_t*>(wt + off1 + r);
          const uint32_t b2 = *reinterpret_cast<const uint16_t*>(wt + off2 + r);
          const uint32_t b3 = *reinterpret_cast<const uint16_t*>(wt + off3 + r);
          v01[c][kk] = b0 | (b1 << 16);
          v23[c][kk] = b2 | (b3 << 16);
        }
      }

#pragma unroll
      for (int h = 0; h < 2; ++h) {       // low nibbles, then high
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint32_t xaddr = smem_u32(smem + ((i0 + c) % kS) * T::kStage +
                                          T::kWBytes + h * T::kXBytes);
          uint32_t a[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t p = v01[c][kk] >> (4 * h);
            const uint32_t q = v23[c][kk] >> (4 * h);
            a[kk][0] = nib2_bf16(p);        // column n,   k 2t4, 2t4+1
            a[kk][1] = nib2_bf16(p >> 8);   // column n+1
            a[kk][2] = nib2_bf16(q);        // column n,   k 2t4+8, 2t4+9
            a[kk][3] = nib2_bf16(q >> 8);   // column n+1
          }
#pragma unroll
          for (int i = 0; i < kD; ++i) pin(part[i]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_bm<BM>(part, a[kk], kmajor_sw128_desc(xaddr + 32 * kk),
                         (c | kk) != 0);
        }
        wgmma_commit();
        wgmma_wait0();
#pragma unroll
        for (int i = 0; i < kD; ++i) pin(part[i]);
        // fold: accumulator rows gid / gid + 8 are columns n / n + 1
        const float s0 = __uint_as_float(sc[h] << 16);
        const float s1 = __uint_as_float(sc[h] & 0xFFFF0000u);
#pragma unroll
        for (int j = 0; j < kD / 4; ++j) {
          acc[4 * j + 0] += part[4 * j + 0] * s0;
          acc[4 * j + 1] += part[4 * j + 1] * s0;
          acc[4 * j + 2] += part[4 * j + 2] * s1;
          acc[4 * j + 3] += part[4 * j + 3] * s1;
        }
      }
      if (lane == 0) {
        mbar_arrive(&empty[i0 % kS]);
        mbar_arrive(&empty[(i0 + 1) % kS]);
      }
    }

    // accumulator (row gid | gid + 8, column 8j + 2t4 | + 1) is
    // y[m0 + 8j + 2t4 (+1), n (+1)]
    if (n_ok) {
#pragma unroll
      for (int j = 0; j < kD / 4; ++j) {
        const int m = m0 + 8 * j + 2 * t4;
        if (m < M)
          *reinterpret_cast<float2*>(y + (size_t)m * N + n) =
              make_float2(acc[4 * j + 0], acc[4 * j + 2]);
        if (m + 1 < M)
          *reinterpret_cast<float2*>(y + (size_t)(m + 1) * N + n) =
              make_float2(acc[4 * j + 1], acc[4 * j + 3]);
      }
    }
  }
}

// ---- host side of the prefill regime ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D row-major tensor map: rows x cols elements of `elem` bytes, a box
// of box_rows x box_cols, zero fill out of bounds.
bool encode_2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
               int elem, uint64_t rows, uint64_t cols, uint32_t box_rows,
               uint32_t box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <int BM, int NWG>
cudaError_t launch_wgmma(const __nv_bfloat16* x, const uint8_t* w,
                         const __nv_bfloat16* s, float* y, int M, int K,
                         int N, cudaStream_t stream) {
  using T = Tile<BM, NWG>;
  CUtensorMap tm_x, tm_w;
  if (!encode_2d(&tm_x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, BM,
                 kChunk, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&tm_w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K / 2, N,
                 kChunk, T::kBN,
                 T::kBN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        w4a16_wgmma<BM, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::kSmem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid((N + T::kBN - 1) / T::kBN, (M + BM - 1) / BM);
  w4a16_wgmma<BM, NWG><<<grid, T::kThreads, T::kSmem, stream>>>(
      tm_x, tm_w, s, y, M, K, N);
  return cudaGetLastError();
}

// The tile (BM, consumer warpgroups) with the least estimated time: waves
// of blocks over the SMs (one block per SM) times the block's work, the
// smaller tiles charged for their lower tensor-core efficiency (more
// weight dequantised per product, more x re-read per column).
int pick_tile(int M, int N) {
  const int sms = sm_count();
  const struct { int bm, nwg; float cost; } tiles[3] = {
      {128, 2, 1.0f}, {64, 2, 1.15f}, {64, 1, 1.4f}};
  int best = 0;
  float best_t = 0.f;
  for (int i = 0; i < 3; ++i) {
    const int blocks = ((N + 64 * tiles[i].nwg - 1) / (64 * tiles[i].nwg)) *
                       ((M + tiles[i].bm - 1) / tiles[i].bm);
    const int waves = (blocks + sms - 1) / sms;
    const float t = waves * tiles[i].bm * 64.f * tiles[i].nwg * tiles[i].cost;
    if (i == 0 || t < best_t) {
      best = i;
      best_t = t;
    }
  }
  return best;
}

// ---------------------------------------------------------------------------
// decode regime (small M): swap AB on mma.sync.m16n8k16
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 128;          // 4 warps, each one task
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecCols = 128;             // output columns per block
constexpr int kDecMaxSteps = 4;           // k16 steps of packed rows per warp

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
             float* __restrict__ ws, int* __restrict__ counter, int M, int K,
             int N, int group, int steps) {
  constexpr int kFrag = 8 * MT * 4;       // f32 partials per lane
  constexpr int kRows = 8 * MT;           // rows of x in the tile
  constexpr int kStride = kDecCols + kDecCols / 16;  // a pad per 16 columns
  constexpr int kVecs = kDecCols / 4;     // float4 columns of the tile
  __shared__ float red[kDecWarps][kFrag][32];
  __shared__ __align__(16) float stage[kRows * kStride];
  __shared__ int last;

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

  // the block's 4 warps (4 k slices) summed in shared memory in warp
  // order into a [rows, 128] tile (padded against bank conflicts), then
  // written with coalesced 16-byte stores: into y when the grid does not
  // split K, else into this block's partial tile of the workspace
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
    const int cc = (ln >> 2) * 16 + 2 * t + (e >> 1);  // column in the tile
    const int r = mt * 8 + 2 * (ln & 3) + (e & 1);
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kDecWarps; ++wi) v += red[wi][f][ln];
    stage[r * kStride + cc + (cc >> 4)] = v;
  }
  __syncthreads();
  const int splits = gridDim.y;
  float* dst = splits > 1 ? ws + (size_t)blockIdx.y * M * N : y;
  for (int i = tid; i < kRows * kVecs; i += kDecThreads) {
    const int r = i / kVecs;
    const int cc = (i % kVecs) * 4;
    const int m = m0 + r;
    const int c = n0 + cc;
    if (m >= M || c >= N) continue;       // N % 16 == 0: c + 3 < N
    const float* sp = stage + r * kStride + cc + (cc >> 4);
    *reinterpret_cast<float4*>(dst + (size_t)m * N + c) =
        make_float4(sp[0], sp[1], sp[2], sp[3]);
  }
  if (splits == 1) return;

  // the last y block of this (x, z) tile sums the S partials in a fixed
  // order.  The ticket is taken after the block's partial is visible
  // card-wide: thread 0's fence after the barrier orders the block's
  // stores before its atomic.
  __syncthreads();
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(counter + tile, 1) == splits - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // q threads sum each float4 output of the tile's live rows, each over
  // a fixed range of the splits in index order, and the q sums are added
  // in range order, so a small tile (M = 1: 32 outputs) keeps every
  // thread's loads in flight
  const int tasks = min(kRows, M - m0) * kVecs;
  const int q = max(1, kDecThreads / tasks);
  const size_t stride = (size_t)M * N / 4;
  float4* sums = reinterpret_cast<float4*>(stage);
  for (int i = tid; i < tasks * q; i += kDecThreads) {
    const int o = i % tasks;
    const int j = i / tasks;
    const int m = m0 + o / kVecs;
    const int c = n0 + (o % kVecs) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < N) {                          // N % 16 == 0: c + 3 < N
      const float4* p =
          reinterpret_cast<const float4*>(ws + (size_t)m * N + c);
      const int hi = (j + 1) * splits / q;
#pragma unroll 8
      for (int sp = j * splits / q; sp < hi; ++sp) {
        const float4 v = __ldcg(p + sp * stride);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
    if (q > 1)
      sums[i] = acc;
    else if (c < N)
      *reinterpret_cast<float4*>(y + (size_t)m * N + c) = acc;
  }
  if (q > 1) {
    __syncthreads();
    if (tid < tasks) {
      float4 acc = sums[tid];
      for (int j = 1; j < q; ++j) {
        const float4 v = sums[j * tasks + tid];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      const int c = n0 + (tid % kVecs) * 4;
      if (c < N)
        *reinterpret_cast<float4*>(y + (size_t)(m0 + tid / kVecs) * N + c) =
            acc;
    }
  }
  if (tid == 0) counter[tile] = 0;        // ready for the next launch
}

// k16 steps per warp: the most of 4, 2, 1 that divides a group
int decode_steps(int group) {
  const int gs = group / 16;
  return gs % 4 == 0 ? 4 : (gs % 2 == 0 ? 2 : 1);
}

// y blocks of the decode grid: its split of K
int decode_splits(int K, int group) {
  const int rows_per_block = kDecWarps * decode_steps(group) * 16;
  return (K / 2 + rows_per_block - 1) / rows_per_block;
}

template <int MT>
void launch_decode(const __nv_bfloat16* x, const uint8_t* w,
                   const __nv_bfloat16* s, float* y, float* ws, int* counter,
                   int M, int K, int N, int group, cudaStream_t stream) {
  const dim3 grid((N + kDecCols - 1) / kDecCols, decode_splits(K, group),
                  (M + 8 * MT - 1) / (8 * MT));
  w4a16_decode<MT><<<grid, kDecThreads, 0, stream>>>(
      x, w, s, y, ws, counter, M, K, N, group, decode_steps(group));
}

}  // namespace

extern "C" {

// y is overwritten by both regimes.
// regime 0: the decode kernel.  With lmd_w4a16_decode_splits(K, group) = S
// > 1 it takes `ws`, f32 [S, M, N] (16-byte aligned), and `counter`, int32
// with one entry per (N/128, M/16 or M/8) tile, zero before the first
// launch; every launch leaves it at zero.
// regime 1: the wgmma kernel (group 128); ws and counter are not used.
// Returns the launch's cudaError_t.
int lmd_w4a16_gemm(const void* x, const void* packed, const void* scales,
                   void* y, void* ws, void* counter, int M, int K, int N,
                   int group, int regime, void* stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const uint8_t*>(packed);
  const auto* sb = static_cast<const __nv_bfloat16*>(scales);
  auto* yf = static_cast<float*>(y);
  auto* wsf = static_cast<float*>(ws);
  auto* cnt = static_cast<int*>(counter);
  auto st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N % 16 != 0 || K % 16 != 0) return (int)cudaErrorInvalidValue;
  if (regime == 0) {
    if (group % 16 != 0 || (K / 2) % group != 0 ||
        (decode_splits(K, group) > 1 &&
         (wsf == nullptr || cnt == nullptr ||
          (reinterpret_cast<uintptr_t>(ws) & 15) != 0)))
      return (int)cudaErrorInvalidValue;
    if (M <= 8)
      launch_decode<1>(xb, wb, sb, yf, wsf, cnt, M, K, N, group, st);
    else
      launch_decode<2>(xb, wb, sb, yf, wsf, cnt, M, K, N, group, st);
    return (int)cudaGetLastError();
  }
  if (regime != 1 || group != kGroup || (K / 2) % kGroup != 0 ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(packed) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  switch (pick_tile(M, N)) {
    case 0: return (int)launch_wgmma<128, 2>(xb, wb, sb, yf, M, K, N, st);
    case 1: return (int)launch_wgmma<64, 2>(xb, wb, sb, yf, M, K, N, st);
    default: return (int)launch_wgmma<64, 1>(xb, wb, sb, yf, M, K, N, st);
  }
}

// The decode regime's split of K (its grid's y blocks); the wrapper sizes
// the workspace [S, M, N] by it.
int lmd_w4a16_decode_splits(int K, int group) {
  return group > 0 && group % 16 == 0 ? decode_splits(K, group) : -1;
}

// The tile (0: 128 columns x 128 rows, 1: 128 x 64, 2: 64 x 64) the wgmma
// regime takes at this M and N.
int lmd_w4a16_wgmma_tile(int M, int N) { return pick_tile(M, N); }

// Mean host time of one tensor-map encode, in nanoseconds, over `iters`
// encodes of an x map (the wgmma regime encodes two per call); -1 when the
// driver entry point is missing.
int lmd_tmap_encode_ns(int iters) {
  CUtensorMap map;
  alignas(16) static uint8_t dummy[256];
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (!encode_2d(&map, dummy, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                   512 + (i & 1), 4096, 128, kChunk,
                   CU_TENSOR_MAP_SWIZZLE_128B))
      return -1;
  const auto t1 = std::chrono::steady_clock::now();
  return (int)(std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0)
                   .count() / (iters > 0 ? iters : 1));
}

}  // extern "C"
