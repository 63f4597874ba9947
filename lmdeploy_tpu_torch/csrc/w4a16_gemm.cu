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
// One kernel, w4a16_wgmma, at every group that is a multiple of 16 and
// every M, on two routes that the wrapper picks from shapes alone
// (ops/cuda/quant_matmul.py::gemm_route).  Bound by the weight's bytes at
// the decode steps, the verify's M = 40 and the 64-row bucket (one
// Llama-2-7B layer: 101 MB, 0.030 ms at 3.35 TB/s) and by operations from
// M ~ 80 (2*M*K*N; M = 512: 207 GFLOP, 0.21 ms at 989 TF/s).
//    - wgmma.mma_async m64nBMk16 (the only path to the tensor cores' full
//      rate) with A and B swapped: A is 64 output columns x 16 k of the
//      weight, built IN REGISTERS from the packed bytes (wgmma's
//      register-A form), so the weight never goes through shared memory
//      as bf16: nibbles become exact bf16 without cvt (OR into the mantissa
//      of bf16 128 and subtract 128, two per 32-bit op); B is a [BM rows of
//      x] x [16 k] tile in shared memory, K-major as x is, with 128-byte
//      swizzle.  BM is wgmma's N: M rounded up to 8 up to 64 (16 to 64),
//      else 128, so the verify's 40 rows take n40 and M = 8 an n16 tile;
//      TMA zero-fills the ragged M edge and the ragged N edge of the
//      weight without reading them.
//    - The lane -> column map, for one m64 tile: a warp owns 16 output
//      columns and lane (gid, t) holds A rows gid and gid + 8 = columns
//      2*gid and 2*gid + 1, so it reads one 16-bit pair per packed row
//      (ldmatrix.trans) and its accumulator rows are two adjacent output
//      columns: scales come as one bf16 pair, results leave as float2.
//    - Half-split K: a pipeline stage holds 64 packed rows of the tile's
//      128 columns and the two x tiles they multiply (low nibbles: x
//      columns k'.., high nibbles: K/2 + k'..).  A half group (`group`
//      packed rows) holds groups gb (low) and G/2 + gb (high).
//    - Exact per-group scaling, as in the TPU kernel: every group's
//      products of a nibble half run into an f32 partial that its first
//      k16 step resets (scale-d 0); after wgmma.wait_group the partial is
//      folded into the running sum with s[g, n] (n is the accumulator's
//      row, so a thread reads one scale pair per group), low then high,
//      group by group.  At a multiple of 64 a half group is whole stages,
//      taken in pieces of one or two stages (a partial of 64 or 128 rows;
//      256 is two partials of 128 rows, each folded with the group's
//      scales).  At any other multiple of 16 (the step form) a group is
//      group / 16 k16 steps, which may straddle stages: a commit group
//      holds one whole group (16, 32, 48) or one step of a group whose
//      partials carry on (any other), and a stage brings the scale rows
//      of the groups that begin in it.
//      Nibbles and x are exact in bf16 and their products exact in f32.
//    - Persistent grid: min(items, SMs) blocks of 384 threads, one an SM,
//      each walking work items b, b + grid, ... of (column tile, row tile,
//      split) in an order that keeps a column tile's weight and a row
//      tile's x in L2 for the blocks in flight.  One producer thread keeps
//      the ring of stages (5 at BM = 128 up to 12 at BM <= 32, ~210 KB;
//      a stage also brings its groups' scale rows) full across item
//      boundaries, so an item's epilogue overlaps the next one's loads and
//      no wave of blocks waits on a tail.
//    - Ping-pong at 128-row tiles: the two consumer warpgroups (64 columns
//      each) issue their products of a piece in turn, ordered by two
//      named barriers, so that one folds its partial while the other's
//      products keep the tensor cores busy.  At <= 64 rows the products
//      are short and the ordering measured slower, so they issue freely.
//      A second partial in flight (wait_group 1) would overlap a
//      warpgroup's own fold too, but ptxas then serializes every wgmma
//      (C7514: the fold reads accumulator registers inside the pipeline
//      stage), which measured slower (at 128 rows, and again for the step
//      form's short tiles); so did building the next half's A fragments
//      while the products run at 128 rows (64 more registers).
//    - Route "splitk" (S > 1): where the output tiles fill at most half
//      the SMs, the half groups are cut into the most splits S <= 8 that
//      keep the items in one wave (quant_matmul.py::splitk_splits), so wo
//      and w2 at M = 40 run over 128 items and not 32 tiles.  Each item
//      writes its f32 partial tile to a workspace [S, M, N]; the last of a
//      tile's S items to arrive, found by a ticket per tile that it resets
//      for the next launch, sums the S partials into y in split order,
//      each thread over its own outputs, every split's values of a few
//      outputs in flight at once.  Chosen over a cluster reduction through
//      distributed shared memory: the plan's S (up to 8) would need
//      clusters of S blocks co-scheduled, which a persistent grid of one
//      block per SM cannot promise for every S, while the ticket keeps the
//      persistent walk as it is.  A call gives the same bits on every run
//      (the TPU kernel's K loop is sequential too, and a seed must give
//      one sampled stream).  Route "tiles" (S = 1): each item writes y
//      directly.
//    Tensor maps are encoded on the host per call (cuTensorMapEncodeTiled
//    through the runtime's driver entry point; its cost is measured by
//    lmd_tmap_encode_ns).
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>

#include "sm90.cuh"

namespace {

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
// wgmma with the weight as the register operand
// ---------------------------------------------------------------------------

constexpr int kChunk = 64;      // packed rows per pipeline stage
constexpr int kBN = 128;        // output columns of a tile: 2 x 64
constexpr int kMaxStages = 12;
constexpr int kMaxSplits = 8;   // route splitk's splits of K at most
constexpr int kSmemBudget = 210 * 1024;
constexpr int kThreads = 384;   // 2 consumer warpgroups + 1 producer
// named barriers (0 is __syncthreads): the consumers' own, and the two
// that order their product issues (ping-pong)
constexpr int kBarConsumers = 1;
constexpr int kBarTurn0 = 2;
constexpr int kBarTurn1 = 3;
// scale rows a stage brings per nibble half in the step form (the groups
// that begin in it: four at group 16)
constexpr int kStepRows = 4;

// A tile of BM rows of x (wgmma's N: 16, 32, 48, 64 or 128) by kBN
// output columns; a stage holds 64 packed rows of the tile's columns and
// the two x tiles they multiply (low nibbles: x columns k'..., high
// nibbles: K/2 + k'...), and scale rows: the group pair's (one row a
// half), or in the step form up to kStepRows a half.
template <int BM, bool kStep = false>
struct Tile {
  static constexpr int kWBytes = kChunk * kBN;      // packed weight tile
  static constexpr int kXBytes = BM * kChunk * 2;   // one half's x tile
  static constexpr int kSBytes = 2 * kBN * 2;       // the group pair's scales
  // weight, two x tiles, scales (padded so stages stay 1024-aligned)
  static constexpr int kSOff = kWBytes + 2 * kXBytes;  // the scale rows
  static constexpr int kStage =
      kSOff + (kStep ? 2 * kStepRows * kBN * 2 : 1024);
  static constexpr int kStages = kSmemBudget / kStage < kMaxStages
                                     ? kSmemBudget / kStage
                                     : kMaxStages;
  static constexpr int kSmem = 1024 + kStages * kStage + 2 * kStages * 8;
};

// D (64 x N, f32, in registers) += A (64 x 16 bf16, four registers a
// thread, the m16n8k16 A layout per warp) x B (16 x N, shared memory,
// descriptor desc); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_n16(float (&d)[8],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n48(float (&d)[24],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n24(float (&d)[12],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n40(float (&d)[20],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n56(float (&d)[28],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27"
      "}, {%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

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


// Byte offset of (packed row r, byte column c) in the TMA-swizzled
// weight tile: 128-byte rows swizzle 16-byte chunks with r % 8
// (SWIZZLE_128B).
__device__ __forceinline__ int w_off(int r, int c) {
  return r * 128 + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15));
}

template <int BM>
__device__ __forceinline__ void wgmma_bm(float (&d)[BM / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  if constexpr (BM == 128)
    wgmma_n128(d, a, desc, scale_d);
  else if constexpr (BM == 64)
    wgmma_n64(d, a, desc, scale_d);
  else if constexpr (BM == 56)
    wgmma_n56(d, a, desc, scale_d);
  else if constexpr (BM == 48)
    wgmma_n48(d, a, desc, scale_d);
  else if constexpr (BM == 40)
    wgmma_n40(d, a, desc, scale_d);
  else if constexpr (BM == 32)
    wgmma_n32(d, a, desc, scale_d);
  else if constexpr (BM == 24)
    wgmma_n24(d, a, desc, scale_d);
  else
    wgmma_n16(d, a, desc, scale_d);
}

// Four 8x8 b16 matrices from shared memory, transposed: lane (g, t) gets
// elements (rows 2t, 2t + 1; column g) of each, row 2t in the low half.
// Lane L gives the address of row L % 8 of matrix L / 8.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& d0,
                                              uint32_t& d1, uint32_t& d2,
                                              uint32_t& d3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(d0), "=r"(d1), "=r"(d2), "=r"(d3) : "r"(addr) : "memory");
}

// Two 8x8 b16 matrices (one k16 step's rows 0-7 and 8-15), transposed,
// as ldsm_x4_trans gives its first two; lanes 0-15 give the addresses.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t& d0,
                                              uint32_t& d1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(d0), "=r"(d1) : "r"(addr) : "memory");
}

// A 32-bit shared-memory load by its shared address (LDS; the step form
// measured faster with it than with a generic load at M <= 16)
__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void prefetch_tmap(const CUtensorMap* m) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(m)) : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Work item i of a grid over (column tile, row tile, split): split i % S
// of row tile (i / S) % tiles_m of column tile i / (S tiles_m), so the
// blocks in flight share the weight's column tiles and x's row tiles in
// L2.  Split s covers half groups [s G/2 / S, (s + 1) G/2 / S).
struct Item {
  int n0, m0, tile, split, gb0, gb1;
  __device__ Item(int i, int splits, int tiles_m, int bm, int g_half) {
    split = i % splits;
    const int r = i / splits;
    const int tm = r % tiles_m;
    const int tn = r / tiles_m;
    n0 = tn * kBN;
    m0 = tm * bm;
    tile = r;
    gb0 = split * g_half / splits;
    gb1 = (split + 1) * g_half / splits;
  }
};

// Persistent grid: block b takes items b, b + gridDim.x, ... of
// ceil(N / 128) x ceil(M / BM) x S.  Threads 0-255: two consumer
// warpgroups, each on 64 of the tile's columns; thread 256: the producer.
// tm_x: x [M, K] bf16, box {64, BM}, SWIZZLE_128B; tm_w: the layer's
// packed [K/2, N] uint8, box {128, 64}, SWIZZLE_128B; tm_s: the layer's
// scales [G, N] bf16, box {128, 1}: the first stage of a half group also
// brings the scale rows of its two groups, so no consumer waits on a
// global load.  With S > 1 each item writes its f32 partial tile to
// ws[split] and the last of a tile's S items to arrive sums ws[0..S-1]
// into y in split order.
//
// Two forms of the partial.  U = 0 (a group that is a multiple of 64): a
// half group is group / 64 whole stages, taken in pieces of P stages
// (C: that stage count fixed at compile time, 0: a runtime count), each
// piece's products one partial a nibble half.  U != 0 (the step form:
// any other multiple of 16): a group is gs = group / 16 k16 steps, which
// may straddle stages; an item's stages start at its own first packed
// row, so every item's stages hold the same steps.  The consumer walks
// the steps in commit groups within one group: U > 0 (gs = U) the whole
// group, U < 0 (any other gs) -U steps, its partials carried to the
// next; each group's low and high products run into partials of their
// own (scale-d 0 at its first step) and after its last step are folded
// with its scale pairs, low then high, group by group.  A stage brings, in one TMA box a half, the
// scale rows of the groups that begin in it (tm_s box {srows, 128},
// srows = ceil(4 / gs) up to kStepRows).
template <int BM, int P, int C, int U>
__global__ void __launch_bounds__(kThreads, 1)
w4a16_wgmma(const __grid_constant__ CUtensorMap tm_x,
            const __grid_constant__ CUtensorMap tm_w,
            const __grid_constant__ CUtensorMap tm_s, float* __restrict__ y,
            float* __restrict__ ws, int* __restrict__ counter, int M, int K,
            int N, int group, int splits) {
  constexpr bool kStep = U != 0;
  using T = Tile<BM, kStep>;
  constexpr int kS = T::kStages;
  constexpr int kD = BM / 2;                // accumulator floats per thread
  // the consumers issue in turn at 128-row tiles, where the products are
  // long (measured: faster there, slower at <= 64 rows)
  constexpr bool kPingPong = BM > 64;
  // The step form's commit groups: kH nibble halves (both up to 64-row
  // tiles; one at 128 rows, where two partials of 64 floats beside the
  // sum spill) of kU k16 steps of one group (the whole group where U >
  // 0), the halves into partials of their own
  constexpr int kH = BM > 64 ? 1 : 2;
  constexpr int kU = U > 0 ? U : -U;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_last;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kS * T::kStage);
  uint64_t* empty = full + kS;

  const int half_k = K >> 1;
  const int g_half = half_k / group;
  // stages per half group: C where the launch fixes it at compile time
  // (group 128, the converters' default: the loops below unroll to one
  // piece and no runtime trip count), else group / 64
  const int chunks = C > 0 ? C : group / kChunk;
  // the step form's k16 steps a group: U where the launch fixes it
  const int gs = U > 0 ? U : group >> 4;
  const int tiles_m = (M + BM - 1) / BM;
  const int items = (N + kBN - 1) / kBN * tiles_m * splits;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;

  if (tid == 0) {
    for (int i = 0; i < kS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);             // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full across items ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      prefetch_tmap(&tm_w);
      prefetch_tmap(&tm_x);
      prefetch_tmap(&tm_s);
      int i = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const Item it(item, splits, tiles_m, BM, g_half);
        if constexpr (kStep) {
          // the item's packed rows [gb0 group, gb1 group) in stages from
          // its first row; a tail stage's rows past them are not used
          // (past K/2 the map fills zeros)
          const int ng = it.gb1 - it.gb0;
          const int steps = ng * gs;
          const int srows = gs >= kStepRows ? 1 : (kStepRows + gs - 1) / gs;
          for (int c = 0; 4 * c < steps; ++c, ++i) {
            const int st = i % kS;
            if (i >= kS) mbar_wait(&empty[st], ((i / kS) - 1) & 1);
            const int jb = (4 * c + gs - 1) / gs;  // first group begun here
            const bool scales = jb < ng && jb * gs < 4 * c + 4;
            mbar_expect_tx(&full[st], T::kSOff +
                                          (scales ? 2 * srows * kBN * 2 : 0));
            const int row = it.gb0 * group + c * kChunk;
            uint8_t* at = smem + st * T::kStage;
            tma_load_2d(at, &tm_w, it.n0, row, &full[st]);
            tma_load_2d(at + T::kWBytes, &tm_x, row, it.m0, &full[st]);
            tma_load_2d(at + T::kWBytes + T::kXBytes, &tm_x, half_k + row,
                        it.m0, &full[st]);
            if (scales) {
              uint8_t* sb = at + T::kSOff;
              tma_load_2d(sb, &tm_s, it.n0, it.gb0 + jb, &full[st]);
              tma_load_2d(sb + kStepRows * kBN * 2, &tm_s, it.n0,
                          g_half + it.gb0 + jb, &full[st]);
            }
          }
        } else {
        for (int gb = it.gb0; gb < it.gb1; ++gb) {
#pragma unroll
          for (int c = 0; c < chunks; ++c, ++i) {
            const int st = i % kS;
            if (i >= kS) mbar_wait(&empty[st], ((i / kS) - 1) & 1);
            mbar_expect_tx(&full[st], T::kWBytes + 2 * T::kXBytes +
                                          (c == 0 ? T::kSBytes : 0));
            const int krow = gb * group + c * kChunk;
            uint8_t* base = smem + st * T::kStage;
            tma_load_2d(base, &tm_w, it.n0, krow, &full[st]);
            tma_load_2d(base + T::kWBytes, &tm_x, krow, it.m0, &full[st]);
            tma_load_2d(base + T::kWBytes + T::kXBytes, &tm_x,
                        half_k + krow, it.m0, &full[st]);
            if (c == 0) {
              uint8_t* sb = base + T::kWBytes + 2 * T::kXBytes;
              tma_load_2d(sb, &tm_s, it.n0, gb, &full[st]);
              tma_load_2d(sb + kBN * 2, &tm_s, it.n0, g_half + gb, &full[st]);
            }
          }
        }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: output columns n0 + 64 wg .. + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int gid = lane >> 2;
  const int t4 = lane & 3;
  const int col = wg * 64 + warp * 16 + 2 * gid;   // byte column in tile
  // The warp's 16 columns are one 16-byte chunk of each packed row, read
  // as 8 b16 columns by ldmatrix.trans: lane L addresses row L % 8 of
  // matrix L / 8, matrices (rows 0-7, 8-15) of k16 steps 2p and 2p + 1,
  // so lane (gid, t4) gets rows 2t4, 2t4+1 and 2t4+8, 2t4+9 of its
  // columns 2 gid, 2 gid + 1 in one register each; 32 rows further (the
  // next pair of steps) keep the same swizzle.
  const int lrow = 16 * (lane >> 4) + 8 * ((lane >> 3) & 1) + (lane & 7);
  const uint32_t w_lane = w_off(lrow, wg * 64 + warp * 16);
  // the step form reads one step (rows 0-15) at a time: lanes 0-15
  // address its rows
  const uint32_t w_lane2 = w_off(lane & 15, wg * 64 + warp * 16);
  const size_t mn = (size_t)M * N;

  // Wait for the P stages of a half group's piece at ring index i and
  // read this lane's packed bytes of them, columns (2 gid, 2 gid + 1) of
  // rows (2t4, 2t4+1) and (2t4+8, 2t4+9) of each k16 step as [row a | row
  // b << 16], and, for the piece that opens the half group (its first
  // stage brought them), its two groups' scale pairs of columns n, n + 1
  // (zero past N).
  auto load = [&](int i, uint32_t (&v01)[P][4], uint32_t (&v23)[P][4],
                  uint32_t (&sc)[2], bool first) {
#pragma unroll
    for (int c = 0; c < P; ++c)
      mbar_wait(&full[(i + c) % kS], ((i + c) / kS) & 1);
    if (first) {
      const uint8_t* sb = smem + (i % kS) * T::kStage + T::kWBytes +
                          2 * T::kXBytes + col * 2;
      sc[0] = *reinterpret_cast<const uint32_t*>(sb);
      sc[1] = *reinterpret_cast<const uint32_t*>(sb + kBN * 2);
    }
#pragma unroll
    for (int c = 0; c < P; ++c) {
      const uint32_t wt = smem_u32(smem + ((i + c) % kS) * T::kStage) + w_lane;
#pragma unroll
      for (int p = 0; p < 2; ++p)         // k16 steps 2p and 2p + 1
        ldsm_x4_trans(wt + p * 32 * kBN, v01[c][2 * p], v23[c][2 * p],
                      v01[c][2 * p + 1], v23[c][2 * p + 1]);
    }
  };
  // Issue the 4P products of nibble half h (0: low, group gb; 1: high,
  // group G/2 + gb) of the piece at ring index i into the partial d (the
  // first one overwrites it), as one commit group; a stage's A fragments
  // are built while the previous stage's products run.
  auto issue = [&](float (&d)[kD], const uint32_t (&v01)[P][4],
                   const uint32_t (&v23)[P][4], int i, int h) {
#pragma unroll
    for (int j = 0; j < kD; ++j) pin(d[j]);
#pragma unroll
    for (int c = 0; c < P; ++c) {
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t p = v01[c][kk] >> (4 * h);
        const uint32_t q = v23[c][kk] >> (4 * h);
        a[kk][0] = nib2_bf16(p);          // column n,   k 2t4, 2t4+1
        a[kk][1] = nib2_bf16(p >> 8);     // column n+1
        a[kk][2] = nib2_bf16(q);          // column n,   k 2t4+8, 2t4+9
        a[kk][3] = nib2_bf16(q >> 8);     // column n+1
      }
      const uint32_t xaddr = smem_u32(smem + ((i + c) % kS) * T::kStage +
                                      T::kWBytes + h * T::kXBytes);
      wgmma_fence();            // orders the A registers' writes
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bm<BM>(d, a[kk], kmajor_sw128_desc(xaddr + 32 * kk),
                     (c | kk) != 0);
    }
    wgmma_commit();
  };
  // Fold a finished group partial into the sum with its scale pair:
  // accumulator rows gid / gid + 8 are columns n / n + 1.
  auto fold = [&](float (&acc)[kD], float (&d)[kD], uint32_t sc) {
#pragma unroll
    for (int j = 0; j < kD; ++j) pin(d[j]);
    const float s0 = __uint_as_float(sc << 16);
    const float s1 = __uint_as_float(sc & 0xFFFF0000u);
#pragma unroll
    for (int j = 0; j < kD / 4; ++j) {  // fold
      acc[4 * j + 0] += d[4 * j + 0] * s0;
      acc[4 * j + 1] += d[4 * j + 1] * s0;
      acc[4 * j + 2] += d[4 * j + 2] * s1;
      acc[4 * j + 3] += d[4 * j + 3] * s1;
    }
  };
  int i = 0;        // stages consumed
  int issues = 0;   // product groups this warpgroup issued
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it(item, splits, tiles_m, BM, g_half);
    const int n = it.n0 + col;                       // columns n, n + 1
    const bool n_ok = n < N;                         // N % 16 == 0
    float acc[kD];
#pragma unroll
    for (int j = 0; j < kD; ++j) acc[j] = 0.f;
    if constexpr (kStep) {
      const int ng = it.gb1 - it.gb0;
      const int steps = ng * gs;
      const int i0 = i;     // ring index of the item's first stage
      int done = 0;         // the item's stages released
      float part[kH][kD];   // the group's partials of the halves
      for (int j = 0; j < ng; ++j) {
        uint32_t sc[2];
        for (int h0 = 0; h0 < 2; h0 += kH) {
          for (int s0 = 0; s0 < gs; s0 += kU) {
            // the packed bytes of kU steps of group j
            uint32_t v[kU][2];
#pragma unroll
            for (int u = 0; u < kU; ++u) {
              const int t = j * gs + s0 + u;
              const int ri = i0 + (t >> 2);
              if (h0 == 0 && (t & 3) == 0)
                mbar_wait(&full[ri % kS], (ri / kS) & 1);
              const uint8_t* stage = smem + (ri % kS) * T::kStage;
              if (h0 == 0 && s0 + u == 0) {
                // the group begins here: its scale pairs, from the
                // stage's box of the groups that begin in it
                const int slot = j - ((t & ~3) + gs - 1) / gs;
                const uint32_t sb = smem_u32(stage + T::kSOff) +
                                    slot * kBN * 2 + col * 2;
                sc[0] = lds_u32(sb);
                sc[1] = lds_u32(sb + kStepRows * kBN * 2);
              }
              ldsm_x2_trans(smem_u32(stage) + w_lane2 + (t & 3) * 16 * kBN,
                            v[u][0], v[u][1]);
            }
            if (kPingPong && (wg == 1 || issues > 0))
              named_sync(wg == 0 ? kBarTurn0 : kBarTurn1);
#pragma unroll
            for (int hh = 0; hh < kH; ++hh)
#pragma unroll
              for (int jj = 0; jj < kD; ++jj) pin(part[hh][jj]);
            // one nibble half at a time: its A fragments, then its
            // products, so the next half's fragments are built while
            // this half's products run
#pragma unroll
            for (int hh = 0; hh < kH; ++hh) {
              const int h = h0 + hh;
              uint32_t a[kU][4];
#pragma unroll
              for (int u = 0; u < kU; ++u) {
                const uint32_t p = v[u][0] >> (4 * h);
                const uint32_t q = v[u][1] >> (4 * h);
                a[u][0] = nib2_bf16(p);       // column n,   k 2t4, +1
                a[u][1] = nib2_bf16(p >> 8);  // column n+1
                a[u][2] = nib2_bf16(q);       // column n,   k 2t4+8, +9
                a[u][3] = nib2_bf16(q >> 8);  // column n+1
              }
              wgmma_fence();
#pragma unroll
              for (int u = 0; u < kU; ++u) {
                const int t = j * gs + s0 + u;
                const uint32_t xaddr =
                    smem_u32(smem + ((i0 + (t >> 2)) % kS) * T::kStage +
                             T::kWBytes + h * T::kXBytes) + 32 * (t & 3);
                wgmma_bm<BM>(part[hh], a[u], kmajor_sw128_desc(xaddr),
                             s0 + u != 0);
              }
            }
            wgmma_commit();
            if (kPingPong) named_arrive(wg == 0 ? kBarTurn1 : kBarTurn0);
            ++issues;
            wgmma_wait0();
            if (h0 + kH == 2) {
              // release the stages whose steps have all run
              const int t1 = j * gs + s0 + kU;
              const int upto = t1 == steps ? (steps + 3) >> 2 : t1 >> 2;
              for (; done < upto; ++done)
                if (lane == 0) mbar_arrive(&empty[(i0 + done) % kS]);
            }
            if (s0 + kU == gs) {
              // the finished group's partials, low half then high
#pragma unroll
              for (int hh = 0; hh < kH; ++hh)
                fold(acc, part[hh], sc[h0 + hh]);
            }
          }
        }
      }
      i = i0 + ((steps + 3) >> 2);
    } else {
    float part[kD];
    for (int gb = it.gb0; gb < it.gb1; ++gb) {
      uint32_t sc[2];
      // a half group's stages in pieces of P: each piece's products of a
      // nibble half run into one partial, folded with its group's scales
#pragma unroll
      for (int c0 = 0; c0 < chunks; c0 += P, i += P) {
        uint32_t v01[P][4], v23[P][4];
        load(i, v01, v23, sc, c0 == 0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {     // low nibbles, then high
          // ping-pong: the warpgroups issue their products in turn, so
          // one folds while the other's products keep the tensor cores
          // busy
          if (kPingPong && (wg == 1 || issues > 0))
            named_sync(wg == 0 ? kBarTurn0 : kBarTurn1);
          issue(part, v01, v23, i, h);
          if (kPingPong) named_arrive(wg == 0 ? kBarTurn1 : kBarTurn0);
          ++issues;
          wgmma_wait0();
          fold(acc, part, sc[h]);
        }
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < P; ++c) mbar_arrive(&empty[(i + c) % kS]);
        }
      }
    }
    }

    // accumulator (row gid | gid + 8, column 8j + 2t4 | + 1) is
    // y[m0 + 8j + 2t4 (+1), n (+1)]; with S > 1 it is this split's
    // partial, written to ws[split]
    float* dst = splits > 1 ? ws + it.split * mn : y;
    if (n_ok) {
#pragma unroll
      for (int j = 0; j < kD / 4; ++j) {
        const int m = it.m0 + 8 * j + 2 * t4;
        if (m < M)
          *reinterpret_cast<float2*>(dst + (size_t)m * N + n) =
              make_float2(acc[4 * j + 0], acc[4 * j + 2]);
        if (m + 1 < M)
          *reinterpret_cast<float2*>(dst + (size_t)(m + 1) * N + n) =
              make_float2(acc[4 * j + 1], acc[4 * j + 3]);
      }
    }
    if (splits == 1) continue;

    // the last of the tile's S items to arrive sums the S partials in
    // split order (a ticket per tile, left at zero for the next launch).
    // The ticket is taken after the consumers' partials are visible
    // card-wide: thread 0's fence after the barrier orders their stores
    // before its atomic.
    named_sync(kBarConsumers);
    if (tid == 0) {
      __threadfence();
      const bool last = atomicAdd(counter + it.tile, 1) == splits - 1;
      if (last) {
        counter[it.tile] = 0;
        __threadfence();
      }
      s_last = last;
    }
    named_sync(kBarConsumers);
    if (!s_last || !n_ok) continue;
    // four (two at 128-row tiles) of this thread's outputs at a time,
    // every split's values of them in flight at once, summed in split
    // order; rows past M read row 0 and are not stored
    constexpr int kB = BM > 64 ? 2 : 4;
#pragma unroll
    for (int j0 = 0; j0 < kD / 2; j0 += kB) {
      float2 v[kMaxSplits][kB];
#pragma unroll
      for (int sp = 0; sp < kMaxSplits; ++sp) {
#pragma unroll
        for (int j = 0; j < kB; ++j) {
          const int jj = j0 + j;
          const int m = it.m0 + 8 * (jj >> 1) + 2 * t4 + (jj & 1);
          if (sp < splits && jj < kD / 2)
            v[sp][j] = __ldcg(reinterpret_cast<const float2*>(
                ws + sp * mn + (size_t)(m < M ? m : 0) * N + n));
        }
      }
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const int jj = j0 + j;
        const int m = it.m0 + 8 * (jj >> 1) + 2 * t4 + (jj & 1);
        if (jj >= kD / 2 || m >= M) continue;
        float2 sum = v[0][j];
#pragma unroll
        for (int sp = 1; sp < kMaxSplits; ++sp) {
          if (sp < splits) {
            sum.x += v[sp][j].x;
            sum.y += v[sp][j].y;
          }
        }
        *reinterpret_cast<float2*>(y + (size_t)m * N + n) = sum;
      }
    }
  }
  // pairs the other warpgroup's last arrival on this barrier
  if (kPingPong && wg == 0) named_sync(kBarTurn0);
}

// ---- host side ----

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

// Rows of x a tile holds (wgmma's N): M rounded up to 8 (at least 16) up
// to 64, else 128 (ops/cuda/quant_matmul.py::wgmma_rows).
int wgmma_rows(int M) {
  return M <= 16 ? 16 : M <= 64 ? (M + 7) / 8 * 8 : 128;
}

// Stages a partial spans (the kernel's P): two where a half group has an
// even count of stages (group 128: one partial a group; 256: two), else
// one (64: one a group).  Two stages are the most a consumer holds, so at
// every group the ring (5-12 stages) stays free to fill ahead.
int wgmma_piece(int group) { return (group / kChunk) % 2 == 0 ? 2 : 1; }



// Scale rows a stage brings per nibble half in the step form: the most
// groups that begin in its 4 steps.
int wgmma_step_rows(int group) {
  const int gs = group / 16;
  return gs >= kStepRows ? 1 : (kStepRows + gs - 1) / gs;
}

template <int BM, int P, int C, int U>
cudaError_t launch_wgmma(const __nv_bfloat16* x, const uint8_t* w,
                         const __nv_bfloat16* s, float* y, float* ws,
                         int* counter, int M, int K, int N, int group,
                         int splits, cudaStream_t stream) {
  using T = Tile<BM, (U != 0)>;
  CUtensorMap tm_x, tm_w, tm_s;
  if (!encode_2d(&tm_x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, BM,
                 kChunk, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&tm_w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K / 2, N,
                 kChunk, kBN, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&tm_s, s, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K / group,
                 N, U != 0 ? wgmma_step_rows(group) : 1, kBN,
                 CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        w4a16_wgmma<BM, P, C, U>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const int items =
      (N + kBN - 1) / kBN * ((M + BM - 1) / BM) * splits;
  const int grid = items < sm_count() ? items : sm_count();
  w4a16_wgmma<BM, P, C, U><<<grid, kThreads, T::kSmem, stream>>>(
      tm_x, tm_w, tm_s, y, ws, counter, M, K, N, group, splits);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_wgmma(const __nv_bfloat16* x, const uint8_t* w,
                         const __nv_bfloat16* s, float* y, float* ws,
                         int* counter, int M, int K, int N, int group,
                         int splits, cudaStream_t stream) {
  if (group == 2 * kChunk)            // 128: the stage count fixed at 2
    return launch_wgmma<BM, 2, 2, 0>(x, w, s, y, ws, counter, M, K, N,
                                     group, splits, stream);
  if (group % kChunk == 0)
    return wgmma_piece(group) == 2
               ? launch_wgmma<BM, 2, 0, 0>(x, w, s, y, ws, counter, M, K, N,
                                           group, splits, stream)
               : launch_wgmma<BM, 1, 0, 0>(x, w, s, y, ws, counter, M, K, N,
                                           group, splits, stream);
  // the step form (P is not read there): groups of 1-3 k16 steps (16,
  // 32, 48) fixed at compile time, a whole group a commit group; any
  // other a runtime count, one step a commit group (on the H100 the
  // runtime count at 16 / 32 / 48 took 1.5-1.8x their time at M = 8, 40
  // and 512)
  switch (group / 16) {
    case 1:
      return launch_wgmma<BM, 1, 0, 1>(x, w, s, y, ws, counter, M, K, N,
                                       group, splits, stream);
    case 2:
      return launch_wgmma<BM, 1, 0, 2>(x, w, s, y, ws, counter, M, K, N,
                                       group, splits, stream);
    case 3:
      return launch_wgmma<BM, 1, 0, 3>(x, w, s, y, ws, counter, M, K, N,
                                       group, splits, stream);
    default:
      return launch_wgmma<BM, 1, 0, -1>(x, w, s, y, ws, counter, M, K, N,
                                        group, splits, stream);
  }
}

}  // namespace

extern "C" {

// y is overwritten.  The wgmma kernel at any group that is a multiple of
// 16 and divides K/2, over `splits` = S splits of the K / (2 group) half
// groups (1 <= S <= min(K / (2 group), 8); the wrapper's plan).  With S > 1
// it takes `ws`, f32 [S, M, N], and `counter`, one int32 per (column tile,
// row tile), zero before the first launch and left at zero.
// Returns the launch's cudaError_t.
int lmd_w4a16_gemm(const void* x, const void* packed, const void* scales,
                   void* y, void* ws, void* counter, int M, int K, int N,
                   int group, int splits, void* stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const uint8_t*>(packed);
  const auto* sb = static_cast<const __nv_bfloat16*>(scales);
  auto* yf = static_cast<float*>(y);
  auto* wsf = static_cast<float*>(ws);
  auto* cnt = static_cast<int*>(counter);
  auto st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N % 16 != 0 || K % 16 != 0 || group <= 0 ||
      group % 16 != 0 || (K / 2) % group != 0 || splits < 1 ||
      splits > K / (2 * group) || splits > kMaxSplits ||
      (splits > 1 && (wsf == nullptr || cnt == nullptr ||
                      (reinterpret_cast<uintptr_t>(ws) & 7) != 0)) ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(packed) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(scales) & 15) != 0)
    return (int)cudaErrorInvalidValue;
#define LMD_WGMMA_CASE(BM)                                               \
  case BM:                                                                 \
    return (int)launch_wgmma<BM>(xb, wb, sb, yf, wsf, cnt, M, K, N, group, \
                                 splits, st);
  switch (wgmma_rows(M)) {
    LMD_WGMMA_CASE(16)
    LMD_WGMMA_CASE(24)
    LMD_WGMMA_CASE(32)
    LMD_WGMMA_CASE(40)
    LMD_WGMMA_CASE(48)
    LMD_WGMMA_CASE(56)
    LMD_WGMMA_CASE(64)
    default:
      return (int)launch_wgmma<128>(xb, wb, sb, yf, wsf, cnt, M, K, N, group,
                                    splits, st);
  }
#undef LMD_WGMMA_CASE
}

// Rows of x a wgmma tile holds at this M (the wrapper's plan mirrors it).
int lmd_w4a16_wgmma_rows(int M) { return wgmma_rows(M); }

// Mean host time of one tensor-map encode, in nanoseconds, over `iters`
// encodes of an x map (a call encodes three); -1 when the
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
