// Flash attention for Hopper: online-softmax attention over bf16 q, k, v.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py,
// body _flash_kernel): the same function (causal, local with a window, or no
// mask; GQA with kv head h // (H / KV); scale 1/sqrt(dh); masked scores set
// to -1e30; m, l and the output accumulator in fp32; l floored at 1e-30;
// P rounded to bf16 before P @ V). The TPU kernel walks kv blocks as the
// sequential axis of its grid and carries m, l and acc in VMEM scratch;
// here one CTA owns a (b, h, 64-row query block) and loops over kv blocks
// itself, with the carry in registers.
//
// Layout: q and out are (B, Sq, H, dh), k and v (B, Skv, KV, dh),
// contiguous. Each is read through a 4-D TMA tensor map (dh, heads, S, B),
// so nothing is transposed: a 64-row box of one head lands in shared memory
// as 64 rows of 128 bytes under the 128-byte swizzle, one box per 64
// columns of dh (a dh = 128 tile is two such atom columns, 8 KB apart).
// Rows past Sq or Skv come back zero-filled; they are masked by position
// all the same (keys past Skv are excluded, queries past Sq not stored).
//
// One CTA is one consumer warpgroup and one producer warp:
// - the producer's first thread issues the Q tile and then the K and V
//   tiles of each kv block into a ring of STAGES stages, every stage's
//   loads up front, each tile completing on its own mbarrier. It refills
//   a stage's K once Q K^T has read it and its V once P V has (a "free"
//   barrier each), so the next K is in flight while P V still runs;
// - the consumer computes S = Q K^T on wgmma m64n64k16 (both operands from
//   shared memory, K-major: K's tile is B in its natural form), dh/16
//   k-steps; the masked online softmax on the accumulator fragment (each
//   warp owns 16 query rows; the 4 threads of a group share a row and
//   reduce by shuffles), in base 2: scores times scale * log2(e), then
//   ex2 on the special-function unit; and O += P V on wgmma m64n{dh}k16
//   with P from registers (the score fragment packed to bf16 is the A
//   fragment) and V's tile as the MN-major B (the transpose bit set; its
//   two atom columns at dh = 128 are the descriptor's leading offset
//   apart). The products overlap the softmax: block i's Q K^T is issued,
//   block i-1's P V queued behind it, and block i's softmax runs while
//   that P V does (the first block is peeled, the last P V follows the
//   loop).
// The epilogue divides by max(l, 1e-30), rounds to bf16 and stores the
// rows below Sq; on request (a non-null lse, for the backward in
// flash_attention_bwd.cu) it also stores each row's log-sum-exp of the
// scaled scores, m + log(max(l, 1e-30)) in natural log, as fp32 (B, H, Sq).
// Serving does not request it, and its launches store no more than before.
//
// Bound: at the prefill shape (B 4, S 128, 16 heads, dh 64) the work is
// small (128 CTAs, two kv blocks at most) and latency bounds it: every
// load of a CTA is in flight at once, one trip to device memory. At long S
// it is bound by tensor-core operations; at dh 64 the exponentials (4096
// a block on 16 special-function lanes an SM) take about as long as the
// block's products at the tensor cores' peak. For causal and local masks
// the kernel skips kv blocks that no row of the query block can see, which
// is exact (the TPU kernel visits every block); blocks wholly visible to
// every row skip the mask arithmetic. Rows with no visible key exist only
// for a local mask with Sq > Skv, which the wrapper refuses.

#include <math.h>

#include "sm90.cuh"

namespace {
using sm90::acc_fence;
using sm90::desc_b128;
using sm90::encode_map;
using sm90::encode_tiled;
using sm90::EncodeTiled;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::tma_load_4d;

constexpr int BQ = 64, BKV = 64;
constexpr int WG = 128;                   // the consumer warpgroup
constexpr int THREADS = WG + 32;          // and one producer warp
constexpr int ATOM = 64 * 128;            // a 64-row box of 128-byte rows
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int ERR_ENCODE = 1 << 20;       // not a cudaError_t
enum MaskKind { MASK_NONE = 0, MASK_CAUSAL = 1, MASK_LOCAL = 2 };

template <int DH>
struct Form {
  // dh 64: 4 stages, 3 CTAs an SM; dh 128: 2 stages (a stage is 32 KB),
  // 2 CTAs an SM
  static constexpr int STAGES = DH == 64 ? 4 : 2;
  static constexpr int MIN_BLOCKS = DH == 64 ? 3 : 2;
  static constexpr int TILE = 64 * DH * 2;  // bytes of a Q, K or V tile
  // 1024 for aligning the swizzled tiles, Q, the K and V rings, and the
  // barriers (Q; per stage K in, V in, K free, V free)
  static constexpr int SMEM =
      1024 + TILE * (1 + 2 * STAGES) + 8 * (1 + 4 * STAGES);
};

struct Args {
  __nv_bfloat16* out;
  float* lse;                             // (B, H, Sq), or null
  int Sq, Skv, H, KV, mask_kind, window;
  float scale_log2;                       // scale * log2(e)
};

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo = low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// s (64 x 64, fp32) (+)= Q (64 x 16, K-major) K^T (16 x 64, K-major);
// accumulate = 0 overwrites s.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// o (64 x 64, fp32) += P (64 x 16, registers) V (16 x 64, MN-major).
__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// o (64 x 128, fp32) += P (64 x 16, registers) V (16 x 128, MN-major).
__device__ __forceinline__ void wgmma_pv(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}


// 2^x on the special-function unit (flushes results below 2^-126 to 0,
// far below any l, which is at least 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DH>
__global__ void __launch_bounds__(THREADS, Form<DH>::MIN_BLOCKS)
flash_attention_kernel(__grid_constant__ const CUtensorMap map_q,
                       __grid_constant__ const CUtensorMap map_k,
                       __grid_constant__ const CUtensorMap map_v,
                       const Args a) {
  using F = Form<DH>;
  constexpr int STAGES = F::STAGES, TILE = F::TILE;
  constexpr int COLS = DH / 64;       // 128-byte atom columns of a tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;    // the Q tile
  const uint32_t sk = sq + TILE;                 // STAGES K tiles
  const uint32_t sv = sk + STAGES * TILE;        // STAGES V tiles
  // barriers, 8 bytes each (+ 8 s for stage s): Q in; K in, V in; K
  // free, V free
  const uint32_t bar_q = sv + STAGES * TILE;
  const uint32_t bar_k = bar_q + 8;
  const uint32_t bar_v = bar_k + 8 * STAGES;
  const uint32_t bar_kf = bar_v + 8 * STAGES;
  const uint32_t bar_vf = bar_kf + 8 * STAGES;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = blockIdx.x * BQ;
  int kv_lo = 0, kv_hi = a.Skv;
  if (a.mask_kind != MASK_NONE)
    kv_hi = min(a.Skv, min(q0 + BQ, a.Sq));             // keys <= last row
  if (a.mask_kind == MASK_LOCAL && a.window > 0)
    kv_lo = (max(0, q0 - a.window + 1) / BKV) * BKV;    // > first row - w
  const int blocks = (kv_hi - kv_lo + BKV - 1) / BKV;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_kf + 8 * s, WG);
      mbar_init(bar_vf + 8 * s, WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (tid >= WG) {
    // ---- producer warp: its first thread issues every load. A stage's
    // K is refilled once Q K^T has read it, its V once P V has. ----
    if (tid == WG) {
      mbar_expect_tx(bar_q, TILE);
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        tma_load_4d(sq + c * ATOM, &map_q, bar_q, c * 64, h, q0, b);
      for (int i = 0; i < blocks; ++i) {
        const int s = i % STAGES;
        const uint32_t freed = ((i / STAGES) - 1) & 1;
        const int kv0 = kv_lo + i * BKV;
        if (i >= STAGES) mbar_wait(bar_kf + 8 * s, freed);
        mbar_expect_tx(bar_k + 8 * s, TILE);
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          tma_load_4d(sk + s * TILE + c * ATOM, &map_k, bar_k + 8 * s,
                      c * 64, kvh, kv0, b);
        if (i >= STAGES) mbar_wait(bar_vf + 8 * s, freed);
        mbar_expect_tx(bar_v + 8 * s, TILE);
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          tma_load_4d(sv + s * TILE + c * ATOM, &map_v, bar_v + 8 * s,
                      c * 64, kvh, kv0, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup: 16 query rows a warp ----
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;    // row in the 8-row group, column
  const int qa = q0 + warp * 16 + g, qb = qa + 8;   // this thread's 2 rows
  const float c2 = a.scale_log2;
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;   // m in base 2
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  uint32_t pa[4][4];                 // P of the block in hand, bf16

  // S = Q K^T of the block in stage s. A k-step of 16 is 32 bytes along
  // a swizzled row; 8-row groups are 1024 bytes apart; dh 128 continues
  // in the second atom column.
  auto issue_qk = [&](float (&sc)[32], int s) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk / 4) * ATOM + (kk % 4) * 32;
      wgmma_qk(sc, desc_b128(sq + off, 16, 1024),
               desc_b128(sk + s * TILE + off, 16, 1024), kk > 0);
    }
  };
  // O += P V of the block in stage s: V's 16 keys of a k-step are two
  // 8-row groups (2048 bytes, the stride offset); its dh columns are the
  // MN side, the leading offset the 8 KB between atom columns (dh 64 has
  // one, and gives the group stride there, as the GEMMs' one-atom MN-major
  // operand does)
  auto issue_pv = [&](int s) {
    constexpr uint32_t lbo = COLS > 1 ? ATOM : 1024;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv(o, pa[kk], desc_b128(sv + s * TILE + kk * 2048, lbo, 1024));
  };
  // P's registers stay live until the product that reads them is done
  auto pa_fence = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        asm volatile("" : "+r"(pa[kk][r])::"memory");
  };
  // Scale into base 2 (x scale log2(e)), mask, and the online softmax of
  // the block at kv0: m and l move on, sc becomes P (packed into pa),
  // and the rows' corrections of O come back. sc[4j + e]: row qa (e < 2)
  // or qb, key kv0 + 8j + 2t + (e & 1). A block that every row sees whole
  // needs no mask. Masked scores are -1e30 after scaling, as in the
  // reference, so a row whose visible keys all lie in later blocks takes
  // 2^(-1e30 - -1e30) = 1 here and a correction of 0 once they come: the
  // difference is exact, where an FMA folding the scale into exp2's
  // argument leaves a residual of about 1e22 at these magnitudes.
  auto softmax = [&](float (&sc)[32], int kv0, float& corr_a,
                     float& corr_b) {
    const bool whole =
        kv0 + BKV <= a.Skv &&
        (a.mask_kind == MASK_NONE ||
         (kv0 + BKV - 1 <= q0 &&
          (a.mask_kind != MASK_LOCAL || a.window <= 0 ||
           kv0 > q0 + BQ - 1 - a.window)));
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float va = sc[4 * j + e] * c2, vb = sc[4 * j + 2 + e] * c2;
        if (!whole) {
          const int kpos = kv0 + 8 * j + 2 * t + e;
          if (kpos >= a.Skv) {
            va = vb = -INFINITY;                   // not a key at all
          } else {
            if (a.mask_kind != MASK_NONE) {
              if (kpos > qa) va = NEG;
              if (kpos > qb) vb = NEG;
            }
            if (a.mask_kind == MASK_LOCAL && a.window > 0) {
              if (kpos <= qa - a.window) va = NEG;
              if (kpos <= qb - a.window) vb = NEG;
            }
          }
        }
        sc[4 * j + e] = va;
        sc[4 * j + 2 + e] = vb;
        mx_a = fmaxf(mx_a, va);
        mx_b = fmaxf(mx_b, vb);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    corr_a = ex2(m_a - mx_a);
    corr_b = ex2(m_b - mx_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j] = ex2(sc[4 * j] - mx_a);
      sc[4 * j + 1] = ex2(sc[4 * j + 1] - mx_a);
      sc[4 * j + 2] = ex2(sc[4 * j + 2] - mx_b);
      sc[4 * j + 3] = ex2(sc[4 * j + 3] - mx_b);
      sum_a += sc[4 * j] + sc[4 * j + 1];
      sum_b += sc[4 * j + 2] + sc[4 * j + 3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
    m_a = mx_a;
    m_b = mx_b;
  };
  // P in bf16: the score fragments of n-tiles 2kk and 2kk + 1 form the A
  // fragment of k-step kk (rows g and g + 8, keys 2t and 8 + 2t)
  auto pack = [&](const float (&sc)[32]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_f32(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_f32(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_f32(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_f32(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };

  mbar_wait(bar_q, 0);
  if (blocks > 0) {
    {   // block 0: S, then its softmax (O is zero: nothing to correct)
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.f;
      mbar_wait(bar_k, 0);
      acc_fence(sc);
      wgmma_fence();
      issue_qk(sc, 0);
      wgmma_commit_wait();
      acc_fence(sc);
      mbar_arrive(bar_kf);
      float corr_a, corr_b;
      softmax(sc, kv_lo, corr_a, corr_b);
      pack(sc);
    }
    // block i: S_i on the tensor cores, P_(i-1) V_(i-1) queued behind it,
    // and the softmax of block i while that product runs. (No wgmma sits
    // under a branch: ptxas would serialize them.)
    for (int i = 1; i < blocks; ++i) {
      const int s = i % STAGES, sp = (i - 1) % STAGES;
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.f;
      mbar_wait(bar_k + 8 * s, (i / STAGES) & 1);
      mbar_wait(bar_v + 8 * sp, ((i - 1) / STAGES) & 1);
      acc_fence(sc);
      acc_fence(o);
      wgmma_fence();
      issue_qk(sc, s);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      issue_pv(sp);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      acc_fence(sc);
      mbar_arrive(bar_kf + 8 * s);
      float corr_a, corr_b;
      softmax(sc, kv_lo + i * BKV, corr_a, corr_b);
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      acc_fence(o);
      pa_fence();
      mbar_arrive(bar_vf + 8 * sp);
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        o[4 * n] *= corr_a;
        o[4 * n + 1] *= corr_a;
        o[4 * n + 2] *= corr_b;
        o[4 * n + 3] *= corr_b;
      }
      pack(sc);
    }
    const int sl = (blocks - 1) % STAGES;   // the last block's P V
    mbar_wait(bar_v + 8 * sl, ((blocks - 1) / STAGES) & 1);
    acc_fence(o);
    wgmma_fence();
    issue_pv(sl);
    wgmma_commit_wait();
    acc_fence(o);
    pa_fence();
  }

  // o[4n + e]: row qa (e < 2) or qb, column 8n + 2t + (e & 1)
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  const size_t row = (size_t)a.H * DH;
  __nv_bfloat16* ob =
      a.out + (size_t)b * a.Sq * row + (size_t)h * DH + 2 * t;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    if (qa < a.Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)qa * row + 8 * n) =
          pack_f32(o[4 * n] * inv_a, o[4 * n + 1] * inv_a);
    if (qb < a.Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)qb * row + 8 * n) =
          pack_f32(o[4 * n + 2] * inv_b, o[4 * n + 3] * inv_b);
  }
  // m is in base 2 of the scaled scores: L = (m + log2 l) ln 2
  if (a.lse != nullptr && t == 0) {
    float* lp = a.lse + ((size_t)b * a.H + h) * a.Sq;
    if (qa < a.Sq) lp[qa] = (m_a + log2f(fmaxf(l_a, 1e-30f))) * LN2;
    if (qb < a.Sq) lp[qb] = (m_b + log2f(fmaxf(l_b, 1e-30f))) * LN2;
  }
}

// (dh, heads, S, B) of a contiguous (B, S, heads, dh) bf16 tensor, boxes
// of 64 columns x 1 head x 64 rows x 1 batch row
bool encode_bshd(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B,
                 int S, int heads, int dh) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)S * heads * dh * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  return encode_map(fn, map, ptr, 4, dims, strides, box);
}

template <int DH>
cudaError_t launch_dh(const CUtensorMap& mq, const CUtensorMap& mk,
                      const CUtensorMap& mv, const Args& a, int B,
                      cudaStream_t s) {
  using F = Form<DH>;
  // above 48 KB of dynamic shared memory needs the attribute, once per
  // device (setting it twice from two threads is harmless)
  static bool attr_set[64];
  int device = -1;
  if (cudaGetDevice(&device) != cudaSuccess) device = -1;
  if (device < 0 || device >= 64 || !attr_set[device]) {
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_attention_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
    if (attr != cudaSuccess) return attr;
    if (device >= 0 && device < 64) attr_set[device] = true;
  }
  const dim3 grid((a.Sq + BQ - 1) / BQ, B * a.H);
  flash_attention_kernel<DH><<<grid, THREADS, F::SMEM, s>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

template <int DH>
int form_dh(int* out) {
  using F = Form<DH>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, flash_attention_kernel<DH>);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_attention_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             F::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, flash_attention_kernel<DH>, THREADS, F::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = F::STAGES;
  out[1] = THREADS;
  out[2] = attr.numRegs;
  out[3] = F::SMEM;
  out[4] = per_sm;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // namespace

extern "C" {

int flash_attention_block_q() { return BQ; }

// The kernel's form at head dim dh, into out[6]: ring stages, threads a
// CTA, registers a thread, dynamic shared memory bytes, CTAs an SM can
// hold, local (spilled) bytes a thread. Returns 0 or a cudaError_t.
int flash_attention_form(int dh, int* out) {
  if (dh == 64) return form_dh<64>(out);
  if (dh == 128) return form_dh<128>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// mask_kind: 0 none, 1 causal, 2 local (window > 0). dh must be 64 or 128;
// q, k, v and out contiguous and 16-byte aligned; lse null, or (B, H, Sq)
// fp32 for each row's log-sum-exp. Serving passes null.
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int Sq, int Skv,
                         int H, int KV, int dh, int mask_kind, int window,
                         float scale, void* stream) {
  if (dh != 64 && dh != 128) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  CUtensorMap mq, mk, mv;
  if (!fn || !encode_bshd(fn, &mq, q, B, Sq, H, dh) ||
      !encode_bshd(fn, &mk, k, B, Skv, KV, dh) ||
      !encode_bshd(fn, &mv, v, B, Skv, KV, dh))
    return ERR_ENCODE;
  Args a;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse = lse;
  a.Sq = Sq;
  a.Skv = Skv;
  a.H = H;
  a.KV = KV;
  a.mask_kind = mask_kind;
  a.window = window;
  a.scale_log2 = scale * LOG2E;
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dh == 64 ? launch_dh<64>(mq, mk, mv, a, B, s)
                                   : launch_dh<128>(mq, mk, mv, a, B, s);
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int err) {
  if (err == ERR_ENCODE)
    return "cuTensorMapEncodeTiled refused a tensor map of q, k or v";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
