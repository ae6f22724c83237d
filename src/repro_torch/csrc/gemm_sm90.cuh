// The Hopper GEMM mainloop shared by matmul_tiled.cu and moe_gmm.cu:
//
//   out[e] (M, N) = x[e] (M, K) @ w[e] (K, N),   e < E,  bf16 in, fp32 sum,
//
// x read through an expert stride and one more stride, w through an
// expert stride and one more, out contiguous. matmul_tiled is the case
// E = 1. Each operand lies one of two ways, and the kernel reads it where
// it lies (the backward's W^T and X^T are views, never copies):
// - x K-major (unit K stride, a row stride: the forward's x, and dY), or
//   MN-major (unit M stride, a K stride: X^T, the view of the forward's x
//   that the backward's dW = X^T dY reads);
// - w MN-major (unit N stride, a row stride: the forward's w, and dY), or
//   K-major (unit K stride, an N stride: W^T, the view that dX = dY W^T
//   reads).
// The layouts are template parameters, since they are the immediates of
// the wgmma instruction (its transpose bits) and the TMA boxes' shape.
//
// One CTA per output tile (and, in the decode form, per K chunk); the grid
// is not persistent, so its CTA count is the B of paper Eq. 3. Each CTA
// has CW consumer warpgroups and one producer warpgroup around a ring of
// STAGES shared-memory stages:
//
// - the producer fills a stage with one (BM x 64) tile of x and one
//   (64 x 64 CW) tile of w, each kept in 128-byte swizzle atoms of 64
//   contiguous elements by 8 rows: K-major tiles as rows of 64 K, MN-major
//   tiles as 64-column atoms of 64 K rows, 8 KB each, side by side. Where
//   the shapes allow it (16-byte aligned bases and strides) one thread
//   issues the stage's TMA loads (cp.async.bulk.tensor, 128-byte swizzle:
//   one box per K-major tile, one per 64-column atom of an MN-major one)
//   that complete on the stage's "full" mbarrier; a tile past the edge of
//   M, N or K, or of an expert's K, is zero-filled by the TMA unit and
//   never reads the next expert. Otherwise its 128 threads load element by
//   element, masked, into the same swizzled layout, and arrive on the
//   barrier after a proxy fence;
// - each consumer computes its 64 columns of the tile transposed, out^T =
//   w^T x^T: the 64 columns of w are wgmma's 64 rows (A; MN-major through
//   the transpose bit, or K-major) and the BM rows of x its N (B;
//   K-major, or MN-major through the transpose bit), so a 128-row tile is
//   one m64n128k16 per 16 of K, which reads fewer shared-memory bytes per
//   operation than two warpgroups' m64n64k16 (3-20 % faster at the main
//   path's prefill shapes on the H100). Four per stage (bf16 in, fp32
//   accumulators in registers); it waits for them and frees the stage on
//   its "empty" mbarrier. Keeping one stage's group in flight and freeing
//   each stage one k-tile late measured slower in 27 of 32 (tile, product)
//   pairs at the backward's training shapes on the H100, by up to 7 %
//   (PERF.md §6), so no form does it.
//
// Forms, chosen by the caller:
// - prefill (M > DECODE_BLOCK_M): BM x 64 CW tiles, the whole of K in one
//   CTA, one CTA per SM: the CTA asks for more than half an SM's shared
//   memory, so a second never shares its SM. The forward's tiles are
//   PREFILL_TILES (BM 64, 128 or 256 rows, one consumer: m64n64k16,
//   m64n128k16 or m64n256k16), chosen by the caller (128 unless it asks
//   for another; the tile autotuner, kernels/autotune.py, scores them by
//   paper Eq. 3); the backward's are BWD_TILES (up to two consumers on one
//   x tile, each over its own 64 columns of w), which the forward, the
//   autotuner and the planner never launch. A tile changes which CTA
//   computes an output, not the order of its K sum. Two co-resident
//   CTAs ran 1.6-1.8x one's time, and the kernel's time then rose inside
//   every wave of 132 CTAs on an H100 (5-6 us from 11 x 16 to 11 x 17
//   tiles) instead of stepping at the waves' edges as paper Eq. 3 has it;
//   one CTA per SM steps there and is flat in between (PERF.md §6).
//   Where all of w fits in W_L2_BYTES the CTAs run row by row (n
//   fastest), which re-reads w from the L2 for each row tile; where it
//   does not, they run in bands of columns whose w does, every row tile
//   of a band before the next band, so w is read from HBM about once and
//   each wave's time stays that of the first;
// - decode (M <= DECODE_BLOCK_M): 64 x 64 tiles (m64n64k16), K cut into
//   chunks of the fixed length SPLIT_K, one CTA per chunk, three CTAs per
//   SM. The 64 rows of x hold the few live ones; the weight bytes bound
//   it, and the chunks put every weight byte of the main path's decode
//   products in flight at once. Each CTA writes its fp32
//   partial tile to a workspace; the last CTA of a tile to finish (an
//   integer counter per tile says so, and that CTA resets it) sums the
//   partials in chunk order over all its consumer threads and stores
//   bf16. No float atomics: the sum order of every output is fixed by K
//   alone, so a repeat is bit-equal, and cutting K or N (zero rows or
//   columns, or their absence) changes no other output's bits.
// A layout changes where the tensor cores' operands come from, not the
// products or their order: an output read through a transposed view equals
// the same tile's output on a contiguous copy bit for bit.
// The epilogue stores bf16 straight from the accumulators, masked at the
// ragged M and N edges.

#pragma once

#include <string.h>

#include "sm90.cuh"

namespace gemm_sm90 {
// Internal linkage for all of it: each kernel library that includes this
// header keeps its own kernels and its own once-per-device state (a static
// inside an inline or template function would otherwise be one symbol
// shared by every library loaded into the process).
namespace {
// mbarriers, TMA, descriptors and tensor maps (no using-directive: nvcc's
// generated stubs name the unnamed namespace, which it would make ambiguous)
using sm90::acc_fence;
using sm90::desc_b128;
using sm90::encode_3d;
using sm90::encode_tiled;
using sm90::EncodeTiled;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::tma_load_3d;

constexpr int BK = 64;             // K per stage: one 128-byte swizzled row
constexpr int BN = 64;             // columns of w a consumer warpgroup covers
constexpr int ATOM = 64 * 128;     // bytes of 64 swizzled 128-byte rows
constexpr int STAGES = 4;
constexpr int SPLIT_K = 256;       // the decode form's fixed K chunk
constexpr int DECODE_BLOCK_M = 64; // M at or below this: the decode form
constexpr int PREFILL_BLOCK_M = 128;   // the prefill tile by default
// the prefill tiles' rows (each has BN columns), smallest first
constexpr int PREFILL_TILES[] = {64, 128, 256};
constexpr int N_PREFILL_TILES = 3;
// the backward's prefill tiles (rows of x, columns of w), rows first
constexpr int BWD_TILES[][2] = {{128, 64}, {128, 128}, {192, 128},
                                {256, 128}};
constexpr int N_BWD_TILES = 4;
constexpr int WG = 128;            // threads of a warpgroup
// the share of the H100's 50 MB L2 that one band of w may fill (without
// the bands a wave took longer once w outgrew about half the L2)
constexpr long long W_L2_BYTES = 24ll << 20;
// shared memory an SM holds, less a CTA's reserved 1 KB: a prefill CTA
// asks for more than half of it
constexpr int SM_SMEM = 227 * 1024;
static_assert(SPLIT_K % BK == 0, "a chunk is whole K tiles");

// BM: the rows of x (tokens) a CTA covers, wgmma's N; CW: its consumer
// warpgroups, each over BN columns of w; SOLO: a prefill tile, one CTA an
// SM (else the decode form, three)
template <int BM, int CW, bool SOLO>
struct Tile {
  static constexpr int BNT = CW * BN;                   // columns of w
  static constexpr int THREADS = (CW + 1) * WG;         // consumers, producer
  static constexpr int MIN_BLOCKS = SOLO ? 1 : 3;       // per SM
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BNT * 2;
  // 1024 for aligning the swizzled tiles, the ring, 2 x STAGES barriers
  // and the last-CTA flag
  static constexpr int USED = 1024 + STAGES * (A_BYTES + B_BYTES) +
                              2 * STAGES * 8 + 16;
  // a prefill tile's request keeps its SM to itself
  static constexpr int SMEM =
      SOLO && USED <= SM_SMEM / 2 ? SM_SMEM / 2 + 1024 : USED;
  static_assert(SMEM <= SM_SMEM, "the ring fits an SM");
  static_assert(!SOLO || SMEM > SM_SMEM / 2, "a prefill CTA owns its SM");
  static_assert(BM % 64 == 0 && BM <= 256, "x is whole 64-row atoms");
};

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  __nv_bfloat16* out;
  float* ws;           // splits x E x M x N fp32 partials (splits > 1)
  int* counters;       // one per (e, m tile, n tile), zero between launches
  int M, N, K;         // per expert
  long long sx_e, sx_r;  // x: expert stride; row (K-major) or K stride
  long long sw_e, sw_r;  // w: expert stride; row (MN-major) or N stride
  int splits;          // K chunks (1: all of K in one CTA)
  int tma;             // 1: loads through the tensor maps
  int x_bcast;         // x's expert stride is 0: its map holds one expert
  int band;            // > 0: column tiles of w in one band (splits == 1)
};

// ---------------------------------------------------------------------------
// PTX (the rest is in sm90.cuh)
// ---------------------------------------------------------------------------
// d (64 x 64, fp32) += A (64 x 16) * B (16 x 64); TA, TB: the transpose bits
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31 "
      "}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 128, fp32) += A (64 x 16) * B (16 x 128); TA, TB: the transpose bits
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 192, fp32) += A (64 x 16) * B (16 x 192); TA, TB: the transpose bits
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[96], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95 "
      "}, %96, %97, p, 1, 1, %99, %100;\n"
      "}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 256, fp32) += A (64 x 16) * B (16 x 256); TA, TB: the transpose bits
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// Byte offset of element (r, c) in a tile of 64-element (128-byte) rows
// under the 128-byte swizzle: TMA's layout, and wgmma's B128.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------
// XM: x MN-major (else K-major); WK: w K-major (else MN-major)
template <int BM, int CW, bool SOLO, bool XM, bool WK>
__global__ void __launch_bounds__(Tile<BM, CW, SOLO>::THREADS,
                                  Tile<BM, CW, SOLO>::MIN_BLOCKS)
gemm_kernel(__grid_constant__ const CUtensorMap map_x,
            __grid_constant__ const CUtensorMap map_w, const Args a) {
  using T = Tile<BM, CW, SOLO>;
  constexpr int BNT = T::BNT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sa = base;                           // STAGES x x tiles
  const uint32_t sb = sa + STAGES * T::A_BYTES;       // STAGES x w tiles
  const uint32_t bars = sb + STAGES * T::B_BYTES;     // full, then empty
  int* flag = reinterpret_cast<int*>(smem + (bars - base) + 2 * STAGES * 8);

  const int tid = threadIdx.x;
  const int wg = tid / WG;
  // (n tile, row of the grid) of this CTA: blockIdx itself, or, in bands
  // of a.band column tiles, its place in launch order within its band
  int nt = blockIdx.x, gy = blockIdx.y;
  if (a.band > 0) {
    const int order = blockIdx.y * gridDim.x + blockIdx.x;
    const int per_band = a.band * gridDim.y;
    const int b0 = order / per_band * a.band;
    const int width = min(a.band, (int)gridDim.x - b0);
    const int r = order - b0 * gridDim.y;
    gy = r / width;
    nt = b0 + r % width;
  }
  const int n0 = nt * BNT;
  const int mt = gy / a.splits, split = gy % a.splits;
  const int m0 = mt * BM;
  const int e = blockIdx.z;
  const int kb = a.splits > 1 ? split * SPLIT_K : 0;
  const int ke = a.splits > 1 ? min(a.K, kb + SPLIT_K) : a.K;
  const int ktiles = (ke - kb + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, a.tma ? 1 : WG);
      mbar_init(bars + 8 * (STAGES + s), CW * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (wg == CW) {
    // ---- producer warpgroup ----
    const int pt = tid - CW * WG;
    if (a.tma) {
      if (pt == 0) {
        const int xe = a.x_bcast ? 0 : e;
        for (int i = 0; i < ktiles; ++i) {
          const int s = i % STAGES;
          if (i >= STAGES) mbar_wait(bars + 8 * (STAGES + s),
                                     ((i / STAGES) - 1) & 1);
          const uint32_t full = bars + 8 * s;
          const uint32_t ta = sa + s * T::A_BYTES, tb = sb + s * T::B_BYTES;
          mbar_expect_tx(full, T::A_BYTES + T::B_BYTES);
          const int k0 = kb + i * BK;
          if (XM) {     // a box per 64-row atom of x, 64 K rows each
#pragma unroll
            for (int j = 0; j < BM / 64; ++j)
              tma_load_3d(ta + j * ATOM, &map_x, full, m0 + 64 * j, k0, xe);
          } else {
            tma_load_3d(ta, &map_x, full, k0, m0, xe);
          }
          if (WK) {     // BNT rows of 64 K
            tma_load_3d(tb, &map_w, full, k0, n0, e);
          } else {      // a box per consumer's 64 columns, 64 K rows each
#pragma unroll
            for (int c = 0; c < CW; ++c)
              tma_load_3d(tb + c * ATOM, &map_w, full, n0 + 64 * c, k0, e);
          }
        }
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16(0.0f);
      const __nv_bfloat16* xe = a.x + (long long)e * a.sx_e;
      const __nv_bfloat16* we = a.w + (long long)e * a.sw_e;
      for (int i = 0; i < ktiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(bars + 8 * (STAGES + s),
                                   ((i / STAGES) - 1) & 1);
        const int k0 = kb + i * BK;
        uint8_t* ta = smem + (sa - base) + s * T::A_BYTES;
        uint8_t* tb = smem + (sb - base) + s * T::B_BYTES;
        // neighbouring threads on the unit stride
        for (int idx = pt; idx < BM * BK; idx += WG) {
          const int c = idx & 63;
          int gm, gk;
          uint32_t off;
          if (XM) {
            const int j = idx >> 12, r = (idx >> 6) & 63;
            gm = m0 + 64 * j + c, gk = k0 + r, off = j * ATOM + swz(r, c);
          } else {
            const int r = idx >> 6;
            gm = m0 + r, gk = k0 + c, off = swz(r, c);
          }
          *reinterpret_cast<__nv_bfloat16*>(ta + off) =
              gm < a.M && gk < ke
                  ? xe[XM ? gm + gk * a.sx_r : gm * a.sx_r + gk]
                  : zero;
        }
        for (int idx = pt; idx < BK * BNT; idx += WG) {
          const int c = idx & 63;
          int gk, gn;
          uint32_t off;
          if (WK) {
            const int r = idx >> 6;
            gn = n0 + r, gk = k0 + c, off = swz(r, c);
          } else {
            const int j = idx >> 12, r = (idx >> 6) & 63;
            gk = k0 + r, gn = n0 + 64 * j + c, off = j * ATOM + swz(r, c);
          }
          *reinterpret_cast<__nv_bfloat16*>(tb + off) =
              gk < ke && gn < a.N
                  ? we[WK ? gn * a.sw_r + gk : gk * a.sw_r + gn]
                  : zero;
        }
        // generic-proxy writes, read next by wgmma (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(bars + 8 * s);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: out^T (its 64 columns of w x BM rows of x)
  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.0f;
  for (int i = 0; i < ktiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(bars + 8 * s, (i / STAGES) & 1);
    const uint32_t ta = sa + s * T::A_BYTES;            // x
    const uint32_t tb = sb + s * T::B_BYTES + wg * ATOM;  // its 64 of w
    acc_fence(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // w (A): MN-major, 16 K rows are two 8-row groups of 1024 bytes; the
      // tile is one 64-column swizzle atom wide, so its MN stride is never
      // used and both offsets carry the group stride. K-major: 16 K values
      // are 32 bytes along the swizzled row, 8-row groups 1024 bytes apart.
      const uint64_t da = WK ? desc_b128(tb + kk * 32, 16, 1024)
                             : desc_b128(tb + kk * 2048, 1024, 1024);
      // x (B): K-major as w's K-major; MN-major, BM / 64 atoms ATOM bytes
      // apart (the leading offset), 8-row groups of K 1024 bytes apart
      const uint64_t db = XM ? desc_b128(ta + kk * 2048, ATOM, 1024)
                             : desc_b128(ta + kk * 32, 16, 1024);
      wgmma<WK ? 0 : 1, XM ? 1 : 0>(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    acc_fence(acc);
    mbar_arrive(bars + 8 * (STAGES + s));
  }

  // accumulator fragment of out^T: acc[4j + q] is column n0 + n of out
  // (n = 64 wg + warp*16 + lane/4, +8 for q >= 2) and row m0 + 8j +
  // 2(lane%4) of out (+1 for odd q)
  const int ct = tid - wg * WG;
  const int n_t = n0 + wg * BN + (ct >> 5) * 16 + ((ct & 31) >> 2);
  const int m_t = m0 + 2 * (ct & 3);
  const int M = a.M, N = a.N;

  if (a.splits == 1) {
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m_t + 8 * j + (q & 1), c = n_t + 8 * (q >> 1);
        if (r < M && c < N)
          a.out[((size_t)e * M + r) * N + c] =
              __float2bfloat16(acc[4 * j + q]);
      }
    return;
  }

  // decode form: this chunk's fp32 partial, then the last CTA of the tile
  // sums all chunks in order
  constexpr int CT = CW * WG;      // consumer threads
  const size_t slab = (size_t)M * N;
  const size_t e_off = (size_t)e * slab;
  const size_t chunk = (size_t)gridDim.z * slab;
  float* part = a.ws + (size_t)split * chunk + e_off;
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = m_t + 8 * j + (q & 1), c = n_t + 8 * (q >> 1);
      if (r < M && c < N) part[(size_t)r * N + c] = acc[4 * j + q];
    }
  __threadfence();
  asm volatile("bar.sync 1, %0;" ::"r"(CT) : "memory");
  if (tid == 0) {
    const int m_tiles = gridDim.y / a.splits;
    int* cnt = a.counters + ((size_t)e * m_tiles + mt) * gridDim.x + nt;
    const int last = atomicAdd(cnt, 1) == a.splits - 1;
    if (last) *cnt = 0;   // every chunk has arrived: ready for the next launch
    *flag = last;
  }
  asm volatile("bar.sync 1, %0;" ::"r"(CT) : "memory");
  if (!*flag) return;
  __threadfence();
  // every live output of the tile, spread over the consumer threads; the
  // loads of 8 chunks are issued together, the adds stay in chunk order
  const int rows = min(BM, M - m0);
  for (int idx = tid; idx < rows * BNT; idx += CT) {
    const int r = m0 + idx / BNT, c = n0 + idx % BNT;
    if (c >= N) continue;
    const float* p = a.ws + e_off + (size_t)r * N + c;
    float sum = __ldcg(p);
    int s = 1;
    for (; s + 8 <= a.splits; s += 8) {
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = __ldcg(p + (size_t)(s + q) * chunk);
#pragma unroll
      for (int q = 0; q < 8; ++q) sum += v[q];
    }
    for (; s < a.splits; ++s) sum += __ldcg(p + (size_t)s * chunk);
    a.out[((size_t)e * M + r) * N + c] = __float2bfloat16(sum);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// One form's launch and its attributes, called through `dispatch`.
template <int BM, int CW, bool SOLO, bool XM, bool WK>
struct Form {
  using T = Tile<BM, CW, SOLO>;

  static int launch(const CUtensorMap* mx, const CUtensorMap* mw,
                    const Args* a, int E, int device, cudaStream_t s) {
    // above 48 KB of dynamic shared memory needs the attribute, once per
    // device (setting it twice from two threads is harmless)
    static bool attr_set[64];
    if (device < 0 || device >= 64 || !attr_set[device]) {
      const cudaError_t attr = cudaFuncSetAttribute(
          gemm_kernel<BM, CW, SOLO, XM, WK>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
      if (attr != cudaSuccess) return static_cast<int>(attr);
      if (device >= 0 && device < 64) attr_set[device] = true;
    }
    const dim3 grid((a->N + T::BNT - 1) / T::BNT,
                    ((a->M + BM - 1) / BM) * a->splits, E);
    gemm_kernel<BM, CW, SOLO, XM, WK>
        <<<grid, T::THREADS, T::SMEM, s>>>(*mx, *mw, *a);
    return static_cast<int>(cudaGetLastError());
  }

  // into out[5]: threads a CTA, registers a thread, dynamic shared memory
  // bytes, CTAs an SM holds at once
  // (cudaOccupancyMaxActiveBlocksPerMultiprocessor), local (spilled) bytes
  // a thread
  static int attributes(int* out) {
    cudaFuncAttributes attr;
    const auto kernel = gemm_kernel<BM, CW, SOLO, XM, WK>;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        T::THREADS, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = T::THREADS;
    out[1] = attr.numRegs;
    out[2] = T::SMEM;
    out[3] = per_sm;
    out[4] = static_cast<int>(attr.localSizeBytes);
    return 0;
  }
};

constexpr int INVALID = static_cast<int>(cudaErrorInvalidValue);

// The backward's forms at one layout: the decode tile or one of BWD_TILES.
template <template <int, int, bool, bool, bool> class F, bool XM, bool WK,
          typename Op>
int bwd_form(int decode, int bm, int bn, Op op) {
  if (decode)
    return bm == DECODE_BLOCK_M && bn == BN ? op(F<64, 1, false, XM, WK>())
                                            : INVALID;
  if (bm == 128 && bn == 64) return op(F<128, 1, true, XM, WK>());
  if (bm == 128 && bn == 128) return op(F<128, 2, true, XM, WK>());
  if (bm == 192 && bn == 128) return op(F<192, 2, true, XM, WK>());
  if (bm == 256 && bn == 128) return op(F<256, 2, true, XM, WK>());
  return INVALID;
}

// Calls op(Form<...>()) on the form that the arguments name, or returns
// cudaErrorInvalidValue where the header builds none: the forward's (bwd
// == 0: both operands in today's layout, the decode tile (block_m
// DECODE_BLOCK_M) or one of PREFILL_TILES, block_n BN) or the backward's
// (bwd != 0: x MN-major, w K-major, or neither, not both; the decode tile
// or one of BWD_TILES).
template <typename Op>
int dispatch(int bwd, int decode, int bm, int bn, int xm, int wk, Op op) {
  if (!bwd) {
    if (xm || wk || bn != BN) return INVALID;
    if (decode)
      return bm == DECODE_BLOCK_M ? op(Form<64, 1, false, false, false>())
                                  : INVALID;
    if (bm == 64) return op(Form<64, 1, true, false, false>());
    if (bm == 128) return op(Form<128, 1, true, false, false>());
    if (bm == 256) return op(Form<256, 1, true, false, false>());
    return INVALID;
  }
  if (xm && wk) return INVALID;
  if (xm) return bwd_form<Form, true, false>(decode, bm, bn, op);
  if (wk) return bwd_form<Form, false, true>(decode, bm, bn, op);
  return bwd_form<Form, false, false>(decode, bm, bn, op);
}

// Makes `device` current for the call, and the previous device after it.
template <typename Fn>
int on_device(int device, Fn fn) {
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess) current = -1;
  if (current != device) {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  const int err = fn();
  if (current != device && current >= 0) cudaSetDevice(current);
  return err;
}

// The form that (bwd, decode, block_m, block_n, xm, wk) name, as dispatch,
// on `device`, into out[5] (Form::attributes). Returns 0 or a cudaError_t.
inline int form(int bwd, int decode, int block_m, int block_n, int xm, int wk,
                int device, int* out) {
  return on_device(device, [&] {
    return dispatch(bwd, decode, block_m, block_n, xm, wk,
                    [&](auto f) { return decltype(f)::attributes(out); });
  });
}

// Launches one product on `device`'s `stream`, in the form that (bwd,
// decode, block_m, block_n, xm, wk) name (see dispatch; another is
// cudaErrorInvalidValue). x (E, M, K): expert stride sx_e (0: one x for
// every expert), unit K stride and row stride sx_r, or (xm) unit M stride
// and K stride sx_r; w (E, K, N): expert stride sw_e, unit N stride and
// row stride sw_r, or (wk) unit K stride and N stride sw_r; out (E, M, N)
// contiguous. decode != 0 takes `splits` chunks of SPLIT_K (the caller's
// schedule); ws holds splits x E x M x N floats when splits > 1, counters
// one zeroed int per (e, m tile, n tile). vec != 0 promises 16-byte
// aligned x and w and strides that are multiples of 8: then the loads go
// through TMA, else element by element. Returns the load path taken (1:
// TMA, 0: element-wise) or minus a cudaError_t.
inline int launch(const void* x, const void* w, void* out, void* ws,
                  void* counters, int E, int M, int N, int K, long long sx_e,
                  long long sx_r, long long sw_e, long long sw_r, int xm,
                  int wk, int bwd, int decode, int splits, int vec,
                  int block_m, int block_n, int device, void* stream) {
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.M = M;
  a.N = N;
  a.K = K;
  a.sx_e = sx_e;
  a.sx_r = sx_r;
  a.sw_e = sw_e;
  a.sw_r = sw_r;
  a.splits = decode ? splits : 1;
  a.x_bcast = sx_e == 0 || E == 1;
  // bands of w where all of it does not fit in W_L2_BYTES (the decode
  // form's chunks keep their order)
  const long long w_tile = (long long)K * block_n * 2;
  a.band = !decode && w_tile * ((N + block_n - 1) / block_n) > W_L2_BYTES
               ? (int)(W_L2_BYTES / w_tile > 1 ? W_L2_BYTES / w_tile : 1)
               : 0;
  a.tma = 0;
  CUtensorMap mx, mw;
  memset(&mx, 0, sizeof(mx));
  memset(&mw, 0, sizeof(mw));
  if (vec) {
    // the maps take each operand as it lies, unit stride innermost: x
    // (K, M) or (M, K), w (N, K) or (K, N), then the experts
    const EncodeTiled fn = encode_tiled();
    const uint64_t rx = (uint64_t)sx_r * 2, rw = (uint64_t)sw_r * 2;
    const uint64_t ex = a.x_bcast ? rx * (xm ? K : M) : (uint64_t)sx_e * 2;
    const uint64_t ew = (uint64_t)sw_e * 2;
    const uint32_t bm = block_m, bn = block_n;
    a.tma = fn &&
            (xm ? encode_3d(fn, &mx, x, M, K, a.x_bcast ? 1 : E, rx, ex, 64,
                            BK)
                : encode_3d(fn, &mx, x, K, M, a.x_bcast ? 1 : E, rx, ex, BK,
                            bm)) &&
            (wk ? encode_3d(fn, &mw, w, K, N, E, rw, ew, BK, bn)
                : encode_3d(fn, &mw, w, N, K, E, rw, ew, BN, BK));
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int err = on_device(device, [&] {
    return dispatch(bwd, decode, block_m, block_n, xm, wk, [&](auto f) {
      return decltype(f)::launch(&mx, &mw, &a, E, device, s);
    });
  });
  return err == 0 ? a.tma : -err;
}

}  // namespace
}  // namespace gemm_sm90
