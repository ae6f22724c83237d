// Flash attention's backward for Hopper: dQ, dK and dV of bf16 attention.
//
// The gradient of flash_attention.cu's function (causal or no mask; GQA
// with kv head h // (H / KV); scale 1/sqrt(dh)). flash_attention_pallas
// (src/repro/kernels/flash_attention.py) has no backward: repro trains
// through plain JAX, and this kernel is held to jax.grad of that plain
// attention (through attention_bwd_ref) on the CPU, and to
// attention_bwd_ref on the card.
//
// FlashAttention-2's recomputation scheme, from the forward's output O and
// its row log-sum-exp L (flash_attention_bf16 with a non-null lse, natural
// log, fp32):
//   D = rowsum(dO * O)                 (fp32, by each CTA for its own rows)
//   P = exp(S * scale - L), S = Q K^T  (recomputed, never stored)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D)
//   dK = scale * dS^T Q,  dQ = scale * dS K
// P and dS are rounded to bf16 as operands; products accumulate in fp32.
//
// One launch, two CTA roles that share no output, so nothing is summed
// across CTAs and no atomics are used: two calls are bit-equal.
// - dK/dV role, one CTA per (batch x kv head, 64-key block): K and V stay in
//   shared memory; (Q, dO, O) tiles of every query block of every head of
//   the GQA group stream through a ring. S^T = K Q^T and dP^T = V dO^T,
//   then dV += P^T dO and dK += dS^T Q. The accumulator is transposed (keys
//   x queries), so L and D belong to its columns: the warpgroup writes both
//   for the block's 64 queries into shared memory (D from the dO and O
//   tiles while S^T and dP^T run), and each thread reads its columns.
// - dQ role, one CTA per (batch x head, 64-query block): Q, dO and O stay;
//   (K, V) tiles stream through the ring. S = Q K^T and dP = dO V^T, then
//   dQ += dS K. This role recomputes S and dP (seven products where the
//   gradient needs five): the price of no atomics.
// Under the causal mask a role skips blocks that no pair of its block
// sees (keys after the query block's last row; query blocks before the
// key block's first key), which is exact.
//
// The grid is one dimension, heaviest walks first: "levels" of B*KV dK/dV
// CTAs (a key block) and B*H dQ CTAs (a query block) merged by their walk's
// products (4 a block for dK/dV, 3 for dQ), ties to dK/dV. Under the causal
// mask that starts with the dK/dV CTAs of the first key blocks and the dQ
// CTAs of the last query blocks, so the long walks do not form the tail.
// cta_of is compiled for the host too (flash_attention_bwd_order), and
// kernels/flash_attention.py's bwd_order mirrors it.
//
// A CTA is one warpgroup at dh 64 (3 CTAs an SM: 168 registers a thread,
// 66 KB of shared memory) and two at dh 128 (one CTA an SM), which split
// each walk: block i goes to warpgroup i % 2, and at the end warpgroup 0
// adds warpgroup 1's partial sums, in that order, through shared memory.
// (One warpgroup a CTA at dh 128 left the longest dK/dV walk of a GQA
// group, 4 heads x 64 query blocks at S 4096, as the kernel's time.) The
// CTA's first thread loads its fixed tiles and its first STAGES blocks, and
// each warpgroup's first thread refills the stage of a block it is done
// with, through 4-D TMA tensor maps over (dh, heads, S, B), 128-byte
// swizzle (as the forward); rows past Sq or Skv come back zero (a box still
// counts its bytes on the barrier) and are masked by position, never
// stored. No producer warp: its fifth warp cost the registers of a third
// CTA an SM, which hides more latency than a warp that only issues loads.
// All products are wgmma: S, dP, S^T and dP^T with both operands K-major
// in shared memory (m64n64k16); dV, dK and dQ with A from registers (the
// fp32 fragment packed to bf16, as the forward's P) and B MN-major with
// the transpose bit (as the forward's V; at dh 128 its two atom columns
// are the descriptor's leading offset, 8 KB, apart). A block's last
// products are waited for before the next block's S and dP are issued:
// keeping them in flight needs both sets of registers live, which made
// ptxas serialize every wgmma at 168 registers; the CTAs (or warpgroups)
// of an SM overlap each other's elementwise work instead.
//
// Bound: at qwen's training shape (B 8, S 128, 16 heads, dh 64, causal) the
// work is five products over the visible pairs, 0.68 GFLOP, against 16.8
// MB to move: bytes bound it (5 us at 3.35 TB/s); in practice latency does,
// which the design meets with one launch, three CTAs an SM, every load of
// a short walk in flight at once, and the heavy walks first. At long
// sequences the tensor cores bound it (seven products where five are
// needed, in the dQ role's recomputation), at the rate one or two
// warpgroups an SM reach when each waits for its own products.

#include <math.h>

#include "sm90.cuh"

namespace {
using sm90::acc_fence;
using sm90::desc_b128;
using sm90::encode_map;
using sm90::encode_tiled;
using sm90::EncodeTiled;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::tma_load_4d;

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64, BKV = 64;
constexpr int WG = 128;                   // threads of a warpgroup
constexpr int ATOM = 64 * 128;            // a 64-row box of 128-byte rows
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ERR_ENCODE = 1 << 20;       // not a cudaError_t
// products of one block of each role's walk, the grid order's weights
constexpr int COST_KV = 4, COST_Q = 3;
enum MaskKind { MASK_NONE = 0, MASK_CAUSAL = 1 };
enum Role { ROLE_DKDV = 0, ROLE_DQ = 1 };

template <int DH>
struct Form {
  // dh 64: one warpgroup, 2 stages, 3 CTAs an SM (168 registers a
  // thread); dh 128: two warpgroups that split each walk (block i to
  // warpgroup i % 2, its own stage i % 2; a stage of Q, dO and O is 48 KB),
  // 1 CTA an SM
  static constexpr int WGS = DH == 64 ? 1 : 2;
  static constexpr int THREADS = WG * WGS;
  static constexpr int STAGES = 2;
  static constexpr int MIN_BLOCKS = DH == 64 ? 3 : 1;
  static constexpr int TILE = 64 * DH * 2;  // bytes of a 64-row tile
  // the dK/dV role's K and V and its stages of Q, dO and O; the dQ role's
  // Q, dO and O and its stages of K and V fit in the same 2 + 3 STAGES
  static constexpr int TILES = 2 + 3 * STAGES;
  // 1024 for aligning the swizzled tiles, the tiles, L and D (64 fp32
  // each) a stage, the barriers (fixed tiles in; a stage full)
  static constexpr int SMEM =
      1024 + TILE * TILES + STAGES * 512 + 8 * (1 + STAGES);
};

struct Args {
  const float* lse;                       // (B, H, Sq), natural log
  bf16 *dq, *dk, *dv;
  int B, Sq, Skv, H, KV, mask_kind;
  float scale;
  int role_only;                          // -1: both roles; else that one
};

// ---------------------------------------------------------------------------
// the grid's order (host and device)
// ---------------------------------------------------------------------------
struct Cta {
  int role, blk, bh;  // role; key or query block; batch x (kv) head
};

__host__ __device__ inline int nblocks(int s) { return (s + 63) / 64; }

// blocks that key block j's dK/dV CTA walks: the query blocks from the
// first that sees one of its keys, over every head of the group
__host__ __device__ inline int walk_kv(const Args& a, int j) {
  const int first = a.mask_kind == MASK_CAUSAL ? (j * BKV) / BQ : 0;
  const int n = nblocks(a.Sq) - first;
  return n > 0 ? n * (a.H / a.KV) : 0;
}

// blocks that query block i's dQ CTA walks: the key blocks up to its last
// visible key
__host__ __device__ inline int walk_q(const Args& a, int i) {
  int hi = a.Skv;
  if (a.mask_kind == MASK_CAUSAL) {
    const int last = (i + 1) * BQ < a.Sq ? (i + 1) * BQ : a.Sq;
    hi = last < hi ? last : hi;
  }
  return nblocks(hi);
}

// The CTA at position idx of the grid: levels of B*KV dK/dV CTAs (key
// blocks 0, 1, ...) and of B*H dQ CTAs (query blocks last to first), each
// list in falling cost, merged by cost, ties to dK/dV.
__host__ __device__ inline Cta cta_of(const Args& a, int idx) {
  const int nkv = nblocks(a.Skv);
  int j = 0, i = nblocks(a.Sq) - 1;
  for (;;) {
    const bool kv = j < nkv && a.role_only != ROLE_DQ &&
                    (i < 0 || a.role_only == ROLE_DKDV ||
                     COST_KV * walk_kv(a, j) >= COST_Q * walk_q(a, i));
    const int width = kv ? a.B * a.KV : a.B * a.H;
    if (idx < width) return {kv ? ROLE_DKDV : ROLE_DQ, kv ? j : i, idx};
    idx -= width;
    if (kv) ++j; else --i;
  }
}

// ---------------------------------------------------------------------------
// device
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo = low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit, as the forward
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// warpgroup w alone (named barrier 1 + w: an immediate, so that ptxas
// reserves no more barriers than are used)
__device__ __forceinline__ void wg_sync(int w) {
  if (w == 0)
    asm volatile("bar.sync 1, %0;" ::"n"(WG) : "memory");
  else
    asm volatile("bar.sync 2, %0;" ::"n"(WG) : "memory");
}

// d (64 x 64, fp32) (+)= A (64 x 16, K-major) B^T (16 x 64, K-major), both
// from shared memory; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
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

// d (64 x 64, fp32) += A (64 x 16, registers) B (16 x 64, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
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

// d (64 x 128, fp32) += A (64 x 16, registers) B (16 x 128, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
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

// d = A B^T over DH: A's and B's 64-row tiles K-major in shared memory. A
// k-step of 16 is 32 bytes along a swizzled row; dh 128 continues in the
// second atom column.
template <int DH>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk / 4) * ATOM + (kk % 4) * 32;
    wgmma_ss(d, desc_b128(a + off, 16, 1024), desc_b128(b + off, 16, 1024),
             kk > 0);
  }
}

// d += A B over 64: A's fragments in registers, B's 64 rows (the k index)
// x DH MN-major: a k-step's 16 rows are two 8-row groups (2048 bytes, the
// stride offset), the leading offset the 8 KB between atom columns (dh 64
// has one, and gives the group stride there, as the forward's V)
template <int DH>
__device__ __forceinline__ void issue_rs(float (&d)[DH / 2],
                                         const uint32_t (&pa)[4][4],
                                         uint32_t b) {
  constexpr uint32_t lbo = DH > 64 ? ATOM : 1024;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(d, pa[kk], desc_b128(b + kk * 2048, lbo, 1024));
}

// A registers stay live until the product that reads them is done
__device__ __forceinline__ void reg_fence(uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(pa[kk][r])::"memory");
}

// a 64 x 64 fp32 fragment, rounded to bf16, as the A fragments of its 4
// k-steps: n-tiles 2kk and 2kk + 1 (rows g and g + 8, k 2t and 8 + 2t)
__device__ __forceinline__ void pack(uint32_t (&pa)[4][4],
                                     const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_f32(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// L (base 2) and D = rowsum(dO * O) of the 64 rows of a query block into
// sl[64], sd[64]: two threads a row, each half of every atom column's 16-
// byte chunks of the swizzled dO and O tiles (chunk c of row r lies at
// chunk c ^ (r % 8)). `l` is row tid / 2's lse, loaded by the caller. At
// 2 CTAs an SM (168 registers) the loop is not unrolled: unrolled, its
// loads spilled.
template <int DH>
__device__ __forceinline__ void rows_ld(const uint8_t* tdo, const uint8_t* to,
                                        float* sl, float* sd, float l,
                                        int tid) {
  const int r = tid >> 1, half = tid & 1;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < DH / 64; ++c)
#pragma unroll 1        // one chunk's loads at a time: S^T and dP^T are
    for (int k = 0; k < 4; ++k) {   // in flight beside dK and dV
      const int off = c * ATOM + r * 128 + (((half * 4 + k) ^ (r & 7)) << 4);
      const uint4 x = *reinterpret_cast<const uint4*>(tdo + off);
      const uint4 y = *reinterpret_cast<const uint4*>(to + off);
      const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(xs[e]);
        const float2 yf = __bfloat1622float2(ys[e]);
        sum = fmaf(xf.x, yf.x, sum);
        sum = fmaf(xf.y, yf.y, sum);
      }
    }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (half == 0) {
    sl[r] = l * LOG2E;
    sd[r] = sum;
  }
}

// a 64 x DH fp32 accumulator times `mul`, as bf16, into rows ra and ra + 8
// (below `rows`) of one head of a (B, rows, heads, DH) tensor
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&d)[DH / 2],
                                           float mul, int b, int ra, int rows,
                                           int heads, int head, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = ra + 8 * half;
    if (row >= rows) continue;
    bf16* p = dst + (((size_t)b * rows + row) * heads + head) * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(p + 8 * n) =
          pack_f32(d[4 * n + 2 * half] * mul, d[4 * n + 2 * half + 1] * mul);
  }
}

template <int DH>
__global__ void __launch_bounds__(Form<DH>::THREADS, Form<DH>::MIN_BLOCKS)
flash_attention_bwd_kernel(__grid_constant__ const CUtensorMap map_q,
                           __grid_constant__ const CUtensorMap map_k,
                           __grid_constant__ const CUtensorMap map_v,
                           __grid_constant__ const CUtensorMap map_o,
                           __grid_constant__ const CUtensorMap map_do,
                           const Args a) {
  using F = Form<DH>;
  constexpr int STAGES = F::STAGES, TILE = F::TILE, COLS = DH / 64;
  constexpr int WGS = F::WGS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);  // the same, generic
  float* const sld = reinterpret_cast<float*>(gbase + TILE * F::TILES);
  const uint32_t bar_fixed = base + TILE * F::TILES + STAGES * 512;
  const uint32_t bar_full = bar_fixed + 8;

  const Cta cta = cta_of(a, blockIdx.x);
  const bool kv_role = cta.role == ROLE_DKDV;
  const bool causal = a.mask_kind == MASK_CAUSAL;
  const int group = a.H / a.KV;
  // dK/dV: K and V fixed, stages of (Q, dO, O); dQ: Q, dO and O fixed,
  // stages of (K, V)
  const int stage_tiles = kv_role ? 3 : 2;
  const uint32_t ring = base + (kv_role ? 2 : 3) * TILE;
  int b, kvh, h0, q_first = 0, nqb = 0, blocks;
  if (kv_role) {
    b = cta.bh / a.KV;
    kvh = cta.bh % a.KV;
    h0 = kvh * group;
    q_first = causal ? (cta.blk * BKV) / BQ : 0;
    nqb = max(0, nblocks(a.Sq) - q_first);
    blocks = walk_kv(a, cta.blk);
  } else {
    b = cta.bh / a.H;
    h0 = cta.bh % a.H;
    kvh = h0 / group;
    blocks = walk_q(a, cta.blk);
  }
  // block i of a dK/dV walk: head h0 + i / nqb, query block q_first + i % nqb
  auto kv_head = [&](int i) { return h0 + i / nqb; };
  auto kv_q0 = [&](int i) { return (q_first + i % nqb) * BQ; };

  // thread 0 issues the first loads, block i of the walk into stage i %
  // STAGES; the first thread of the warpgroup that took block i (i % WGS)
  // refills its stage
  const int tid = threadIdx.x;
  const int wg = WGS > 1 ? tid / WG : 0, lt = WGS > 1 ? tid % WG : tid;
  auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar,
                  int head, int row0) {
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      tma_load_4d(dst + c * ATOM, map, bar, c * 64, head, row0, b);
  };
  auto issue = [&](int i) {
    const int s = i % STAGES;
    const uint32_t st = ring + s * stage_tiles * TILE;
    const uint32_t full = bar_full + 8 * s;
    mbar_expect_tx(full, stage_tiles * TILE);
    if (kv_role) {
      const int h = kv_head(i), q0 = kv_q0(i);
      load(st, &map_q, full, h, q0);
      load(st + TILE, &map_do, full, h, q0);
      load(st + 2 * TILE, &map_o, full, h, q0);
    } else {
      load(st, &map_k, full, kvh, i * BKV);
      load(st + TILE, &map_v, full, kvh, i * BKV);
    }
  };
  if (tid == 0) {
    mbar_init(bar_fixed, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(bar_full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (kv_role) {
      const int kv0 = cta.blk * BKV;
      mbar_expect_tx(bar_fixed, 2 * TILE);
      load(base, &map_k, bar_fixed, kvh, kv0);
      load(base + TILE, &map_v, bar_fixed, kvh, kv0);
    } else {
      const int q0 = cta.blk * BQ;
      mbar_expect_tx(bar_fixed, 3 * TILE);
      load(base, &map_q, bar_fixed, h0, q0);
      load(base + TILE, &map_do, bar_fixed, h0, q0);
      load(base + 2 * TILE, &map_o, bar_fixed, h0, q0);
    }
    for (int i = 0; i < STAGES && i < blocks; ++i) issue(i);
  }
  __syncthreads();
  // stage i % STAGES holds block i + STAGES next (the same warpgroup's),
  // once every thread of the warpgroup is done with block i (its last
  // products waited for)
  auto refill = [&](int i) {
    if (i + STAGES < blocks) {
      wg_sync(wg);
      if (lt == 0) issue(i + STAGES);
    }
  };
  // a walk split between warpgroups: warpgroup 1 leaves its partial sums
  // in the ring (free once both walks are done), thread-major from float
  // `off` on (put), warpgroup 0 adds them to its own (add), in that fixed
  // order
  float* const red = reinterpret_cast<float*>(gbase + (ring - base));
  auto put = [&](const auto& d, int off) {
    constexpr int N = sizeof(d) / sizeof(float);
#pragma unroll
    for (int n = 0; n < N; ++n) red[(off + n) * WG + lt] = d[n];
  };
  auto add = [&](auto& d, int off) {
    constexpr int N = sizeof(d) / sizeof(float);
#pragma unroll
    for (int n = 0; n < N; ++n) d[n] += red[(off + n) * WG + lt];
  };

  // ---- 16 rows of the 64 a warp ----
  const int warp = lt / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const float c2 = a.scale * LOG2E;
  const float* const lse_b = a.lse + (size_t)b * a.H * a.Sq;
  float acc_s[32], acc_dp[32];
  uint32_t pd[4][4];              // dS^T (or dS) as A fragments

  if (kv_role) {
    const int kv0 = cta.blk * BKV;
    const int ka = kv0 + warp * 16 + g;   // this thread's keys ka, ka + 8
    float dk[DH / 2], dv[DH / 2];
#pragma unroll
    for (int n = 0; n < DH / 2; ++n) dk[n] = dv[n] = 0.f;
    uint32_t pp[4][4];            // P^T as A fragments
    // row lt / 2's lse of block i (rows past Sq: 0, masked)
    auto lse_of = [&](int i) {
      const int qi = kv_q0(i) + (lt >> 1);
      return qi < a.Sq ? lse_b[(size_t)kv_head(i) * a.Sq + qi] : 0.f;
    };
    float l_next = wg < blocks ? lse_of(wg) : 0.f;
    mbar_wait(bar_fixed, 0);
    for (int i = wg; i < blocks; i += WGS) {
      const int s = i % STAGES, q0 = kv_q0(i);
      const uint32_t st = ring + s * 3 * TILE;              // Q, dO, O
      const uint8_t* const gst = gbase + (st - base);
      float* const sl = sld + s * 128;
      float* const sd = sl + 64;
      mbar_wait(bar_full + 8 * s, (i / STAGES) & 1);
#pragma unroll
      for (int j = 0; j < 32; ++j) acc_s[j] = acc_dp[j] = 0.f;
      acc_fence(acc_s);
      acc_fence(acc_dp);
      wgmma_fence();
      issue_ss<DH>(acc_s, base, st);                  // S^T = K Q^T
      issue_ss<DH>(acc_dp, base + TILE, st + TILE);   // dP^T = V dO^T
      wgmma_commit();
      // L and D of the block's queries while those run
      rows_ld<DH>(gst + TILE, gst + 2 * TILE, sl, sd, l_next, lt);
      if (i + WGS < blocks) l_next = lse_of(i + WGS);
      wg_sync(wg);
      wgmma_wait0();
      acc_fence(acc_s);
      acc_fence(acc_dp);
      acc_fence(dk);
      acc_fence(dv);
      // P^T and dS^T: acc[4j + e] is key ka + 8 (e / 2), query q0 + 8j +
      // 2t + (e & 1); a block that every pair sees needs no mask
      const bool whole = kv0 + BKV <= a.Skv && q0 + BQ <= a.Sq &&
                         (!causal || kv0 + BKV - 1 <= q0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * j + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(sd + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = ka + 8 * (e >> 1), qi = q0 + 8 * j + 2 * t + (e & 1);
          const bool seen = whole || (key < a.Skv && qi < a.Sq &&
                                      (!causal || key <= qi));
          const float p =
              seen ? ex2(acc_s[4 * j + e] * c2 - ((e & 1) ? l2.y : l2.x))
                   : 0.f;
          acc_s[4 * j + e] = p;
          acc_dp[4 * j + e] = p * (acc_dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
        }
      }
      pack(pp, acc_s);
      pack(pd, acc_dp);
      acc_fence(dk);
      acc_fence(dv);
      wgmma_fence();
      issue_rs<DH>(dv, pp, st + TILE);   // dV += P^T dO
      issue_rs<DH>(dk, pd, st);          // dK += dS^T Q
      wgmma_commit();
      wgmma_wait0();
      acc_fence(dk);
      acc_fence(dv);
      reg_fence(pp);
      reg_fence(pd);
      refill(i);
    }
    if constexpr (WGS > 1) {
      __syncthreads();
      if (wg == 1) {
        put(dk, 0);
        put(dv, DH / 2);
      }
      __syncthreads();
      if (wg == 1) return;
      add(dk, 0);
      add(dv, DH / 2);
    }
    store_rows<DH>(a.dk, dk, a.scale, b, ka, a.Skv, a.KV, kvh, t);
    store_rows<DH>(a.dv, dv, 1.f, b, ka, a.Skv, a.KV, kvh, t);
    return;
  }

  // ---- dQ role ----
  const int q0 = cta.blk * BQ;
  const int qa = q0 + warp * 16 + g;      // this thread's rows qa, qa + 8
  float dq[DH / 2];
#pragma unroll
  for (int n = 0; n < DH / 2; ++n) dq[n] = 0.f;
  float* const sl = sld + wg * 128;      // each warpgroup's own copy
  {
    const int qi = q0 + (lt >> 1);
    const float l = qi < a.Sq ? lse_b[(size_t)h0 * a.Sq + qi] : 0.f;
    mbar_wait(bar_fixed, 0);
    rows_ld<DH>(gbase + TILE, gbase + 2 * TILE, sl, sl + 64, l, lt);
    wg_sync(wg);
  }
  const int r0 = warp * 16 + g;
  const float la = sl[r0], lb = sl[r0 + 8];
  const float da = sl[64 + r0], db = sl[64 + r0 + 8];
  for (int i = wg; i < blocks; i += WGS) {
    const int s = i % STAGES, kv0 = i * BKV;
    const uint32_t st = ring + s * 2 * TILE;                // K, V
    mbar_wait(bar_full + 8 * s, (i / STAGES) & 1);
#pragma unroll
    for (int j = 0; j < 32; ++j) acc_s[j] = acc_dp[j] = 0.f;
    acc_fence(acc_s);
    acc_fence(acc_dp);
    wgmma_fence();
    issue_ss<DH>(acc_s, base, st);                 // S = Q K^T
    issue_ss<DH>(acc_dp, base + TILE, st + TILE);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait0();
    acc_fence(acc_s);
    acc_fence(acc_dp);
    acc_fence(dq);
    // dS: acc[4j + e] is query qa + 8 (e / 2), key kv0 + 8j + 2t + (e & 1)
    const bool whole = kv0 + BKV <= a.Skv && q0 + BQ <= a.Sq &&
                       (!causal || kv0 + BKV - 1 <= q0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qa + 8 * (e >> 1), key = kv0 + 8 * j + 2 * t + (e & 1);
        const bool seen =
            whole || (key < a.Skv && qi < a.Sq && (!causal || key <= qi));
        const float p =
            seen ? ex2(acc_s[4 * j + e] * c2 - (e < 2 ? la : lb)) : 0.f;
        acc_dp[4 * j + e] = p * (acc_dp[4 * j + e] - (e < 2 ? da : db));
      }
    pack(pd, acc_dp);
    acc_fence(dq);
    wgmma_fence();
    issue_rs<DH>(dq, pd, st);          // dQ += dS K
    wgmma_commit();
    wgmma_wait0();
    acc_fence(dq);
    reg_fence(pd);
    refill(i);
  }
  if constexpr (WGS > 1) {
    __syncthreads();
    if (wg == 1) put(dq, 0);
    __syncthreads();
    if (wg == 1) return;
    add(dq, 0);
  }
  store_rows<DH>(a.dq, dq, a.scale, b, qa, a.Sq, a.H, h0, t);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------
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

int grid_of(const Args& a) {
  return (a.role_only == ROLE_DQ ? 0 : nblocks(a.Skv) * a.B * a.KV) +
         (a.role_only == ROLE_DKDV ? 0 : nblocks(a.Sq) * a.B * a.H);
}

template <int DH>
cudaError_t set_smem() {
  // above 48 KB of dynamic shared memory needs the attribute, once per
  // device (setting it twice from two threads is harmless)
  static bool done[64];
  int device = -1;
  if (cudaGetDevice(&device) != cudaSuccess) device = -1;
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Form<DH>::SMEM);
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

template <int DH>
cudaError_t launch_dh(const CUtensorMap (&m)[5], const Args& a,
                      cudaStream_t s) {
  const cudaError_t err = set_smem<DH>();
  if (err != cudaSuccess) return err;
  using F = Form<DH>;
  flash_attention_bwd_kernel<DH><<<grid_of(a), F::THREADS, F::SMEM, s>>>(
      m[0], m[1], m[2], m[3], m[4], a);
  return cudaGetLastError();
}

template <int DH>
int form_dh(int* out) {
  using F = Form<DH>;
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, flash_attention_bwd_kernel<DH>);
  if (err == cudaSuccess) err = set_smem<DH>();
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, flash_attention_bwd_kernel<DH>, F::THREADS, F::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = F::THREADS;
  out[1] = F::SMEM;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = per_sm;
  out[5] = F::STAGES;
  return 0;
}

}  // namespace

extern "C" {

int flash_attention_bwd_block() { return BQ; }

// The kernel's form at head dim dh, into out[6]: threads a CTA, dynamic
// shared memory bytes, registers and spilled bytes a thread (both roles
// run in the one kernel), CTAs an SM holds, ring stages. Returns 0 or a
// cudaError_t.
int flash_attention_bwd_form(int dh, int* out) {
  if (dh == 64) return form_dh<64>(out);
  if (dh == 128) return form_dh<128>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The grid's order, as the kernel reads it: for each blockIdx.x in turn,
// (role: 0 dK/dV, 1 dQ; its key or query block; batch x (kv) head) into
// out[3 n] (at most `cap` CTAs). Returns the grid's CTAs.
int flash_attention_bwd_order(int B, int Sq, int Skv, int H, int KV,
                              int mask_kind, int* out, int cap) {
  Args a{};
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
  a.H = H;
  a.KV = KV;
  a.mask_kind = mask_kind;
  a.role_only = -1;
  const int n = grid_of(a);
  for (int idx = 0; idx < n && idx < cap; ++idx) {
    const Cta c = cta_of(a, idx);
    out[3 * idx] = c.role;
    out[3 * idx + 1] = c.blk;
    out[3 * idx + 2] = c.bh;
  }
  return n;
}

// mask_kind: 0 none, 1 causal. q, o, dout, dq: (B, Sq, H, dh); k, v, dk,
// dv: (B, Skv, KV, dh); bf16, contiguous, 16-byte aligned; lse (B, H, Sq)
// fp32. role: -1 both (the gradient), 0 or 1 that role's CTAs alone (for
// timing each). One launch on `stream`.
int flash_attention_bwd_role_bf16(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* dout, const float* lse,
                                  void* dq, void* dk, void* dv, int B,
                                  int Sq, int Skv, int H, int KV, int dh,
                                  int mask_kind, float scale, int role,
                                  void* stream) {
  if ((dh != 64 && dh != 128) ||
      (mask_kind != MASK_NONE && mask_kind != MASK_CAUSAL) || role < -1 ||
      role > ROLE_DQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  CUtensorMap m[5];
  if (!fn || !encode_bshd(fn, &m[0], q, B, Sq, H, dh) ||
      !encode_bshd(fn, &m[1], k, B, Skv, KV, dh) ||
      !encode_bshd(fn, &m[2], v, B, Skv, KV, dh) ||
      !encode_bshd(fn, &m[3], o, B, Sq, H, dh) ||
      !encode_bshd(fn, &m[4], dout, B, Sq, H, dh))
    return ERR_ENCODE;
  Args a;
  a.lse = lse;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
  a.H = H;
  a.KV = KV;
  a.mask_kind = mask_kind;
  a.scale = scale;
  a.role_only = role;
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dh == 64 ? launch_dh<64>(m, a, s)
                                   : launch_dh<128>(m, a, s);
  return static_cast<int>(err);
}

// The gradient, as flash_attention_bwd_role_bf16 with role -1. `delta` is
// not read (earlier forms wrote D there; each CTA now computes its own)
// and may be null: the signature of the three-launch form.
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const float* lse, float* delta, void* dq,
                             void* dk, void* dv, int B, int Sq, int Skv,
                             int H, int KV, int dh, int mask_kind,
                             float scale, void* stream) {
  (void)delta;
  return flash_attention_bwd_role_bf16(q, k, v, o, dout, lse, dq, dk, dv, B,
                                       Sq, Skv, H, KV, dh, mask_kind, scale,
                                       -1, stream);
}

const char* flash_attention_bwd_error_string(int err) {
  if (err == ERR_ENCODE)
    return "cuTensorMapEncodeTiled refused a tensor map of q, k, v, o or dout";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
