// RWKV6 backward for Hopper: the gradients of the chunked linear attention
// of rwkv6.cu with respect to r, k, v, the log decays, the bonus u and the
// initial state.
//
// Replaces no Pallas kernel: repro trains through plain JAX, and
// rwkv6_pallas (src/repro/kernels/rwkv6.py:66) has no backward. The
// forward, per (batch row, head), with w_t = exp(log_w_t) and S the
// (dh x dh) state, is
//
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t
//   o_t = r_t (diag(w_t) S_{t-1} + (u * k_t)^T v_t)
//
// and with G_t = dS_t, the cotangent of S_t (dS_final at T - 1), and
// G_{t-1} = diag(w_t) (G_t + r_t^T do_t), the gradients are
//
//   dr_t = w_t * (S_{t-1} do_t) + u * k_t (v_t . do_t)
//   dk_t = G_t v_t + u * r_t (v_t . do_t)
//   dv_t = G_t^T k_t + (r_t . (u * k_t)) do_t
//   du   = sum_t r_t * k_t (v_t . do_t),     ds0 = G_{-1}
//   dlog_w_t = rowsum(G_{t-1} * S_{t-1})     (elementwise product)
//
// The kernel cuts T into chunks of C rows (32; 16 at head dims whose chunk
// of 32 does not fit in shared memory), the last zero-padded (log_w 0,
// r = k = v = do = 0), with le the inclusive cumulative log decay within a
// chunk and le_C its value at the chunk's end. Two launches:
//
// 1. A CTA per (pass, b, h, block of VB value columns) walks the chunks.
//    Pass 1, forward from s0, writes the state before each chunk after the
//    first, S_c = exp(le_C) S_{c-1} + (k * exp(le_C - le))^T V. Pass 2,
//    backward from zeros, writes G^o at each chunk's end but the last (the
//    outputs' part of G), G^o_{c-1} = exp(le_C) G^o_c + (r * exp(le))^T dO,
//    and, where dS_final is given, the log decay of the later chunks
//    (Lrest_c); at the start it writes ds0 = G^o_{-1} + exp(L_{T-1}) dS.
//    Both keep their (dh x VB) block in registers as mma accumulators
//    (VB = 64: all value columns up to dh 64) and stream the chunks through
//    a ring of two cp.async stages, the next chunk arriving while one is
//    computed.
// 2. A CTA per (b, h, chunk), all independent, takes S_{c-1} and the whole
//    cotangent at its chunk's end, G = G^o_c + exp(Lrest_c) dS_final (the
//    dS part formed here, never carried through a recursion), and writes
//    the chunk's dr, dk, dv, dlog_w and its rows' sums of du. Its rows
//    arrive by cp.async in one group, S and G in a second that lands
//    while the scores are computed.
//
// In a chunk, 16-row sub-chunks factor each decay between sub-chunks
// through the row before a sub-chunk, as rwkv6.cu does: for j in J < I
// and i in I, exp(le_i - le_j) = Ef_i X[I][J+1] Kfac_j with Ef_i =
// exp(le_i - LB[I]), Kfac_j = exp(LB[J+1] - le_j) and X[a][b] = exp(LB[a] -
// LB[b]), LB[a] le at the row before sub-chunk a (every exponent <= 0; the
// TPU kernel's exp(-le) overflows at the model's log decays of -e^4). With
// P = dO V^T and A the forward's scores (the bonus on the diagonal):
//
//   dr'_I = Ef_I * (dO_I (S X[I][0])^T + sum_{J<I} P_IJ (Kf_J X[I][J+1]))
//   dks_J = Kfac_J X[ns][J+1] * (V_J G^T)        (the state's part of dk)
//   dkq_J = Kfac_J * sum_{I>J} P_IJ^T (Rf_I X[I][J+1])  (the chunk's part)
//   dv_J  = sum_{I>=J} A_IJ^T dO_I + (Kf_J X[ns][J+1]) G
//
// (Rf = r * Ef, Kf = k * Kfac), and pairs within one sub-chunk add their
// terms pairwise, by running products of the steps' decays. Then
// dr = dr' + u * k (v . do), dk = dks + dkq + u * r (v . do), and
//
//   dlog_w_t = X[ns][0] rowsum(G * S_{c-1}) + sum_{j<t} k_j * dks_j
//              + sum_{i>=t} (r_i * dr'_i - k_i * dkq_i)
//
// within the chunk: a prefix and a suffix sum, no walk over T. Each term
// is of the size of the decays it carries, so dlog_w keeps its relative
// accuracy where the decays are steep (log_w -54.6, dlog_w about 1e-23).
//
// The products run on the tensor cores, mma.sync m16n8k8 TF32 at fp32
// accuracy: each fp32 operand is split into a TF32 high part and a TF32
// low part and a product takes 3 passes (lo*hi, hi*lo, hi*hi), 2 where
// one operand is bf16 v, which TF32 holds exactly (the split, the mma,
// the cp.async wrappers and the reduce-scatter are the forward's, from
// rwkv6_common.cuh). The cumulative sums, the exponentials, the
// sub-chunks' own pairs and the per-channel sums of dlog_w run on the
// CUDA cores.
//
// Bound: about 12 dh^2 fp32 operations a step (18 with dS_final) and 40
// bytes of rows; at rwkv6-1.6b's training shape (B 8, T 128, H 32, dh 64)
// the operations bound it. The kernel is far from that bound: launch 2's
// CTAs run 2 an SM (their shared memory) through 7 barrier-separated
// phases, latency-bound, and launch 1 is a chain of dependent chunk steps
// (PERF.md, row 6b). Every sum runs in a fixed order (no atomics), so two
// calls are bit-equal; the kernel neither allocates (the wrapper passes
// the states, the chunk-end cotangents and the sums of du as scratch) nor
// synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rwkv6_common.cuh"

namespace {

constexpr int SCAN_THREADS = 128;
constexpr int THREADS = 256;      // a CTA of launch 2
constexpr int WARPS = THREADS / 32;
// Both kernels are compiled for head dims up to DPMAX = 64 and up to 128.
// Value columns a CTA of launch 1: all of them up to dh 64.
template <int DPMAX>
__host__ __device__ constexpr int value_block() {
  return DPMAX == 64 ? 64 : 32;
}
// Products whose results a warp of launch 2 holds through a barrier: at
// most (3 ns - 1) dh / 16 of them over the warps (ns 2 up to dh 112).
template <int DPMAX>
__host__ __device__ constexpr int max_held() {
  return ((3 * 2 - 1) * (DPMAX == 64 ? 64 : 112) / SUB + WARPS - 1) / WARPS;
}
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Args {
  const T* r;
  const T* k;
  const T* v;
  const float* lw;
  const float* u;
  const float* s0;      // or null: zeros
  const float* dout;
  const float* ds;      // or null: zeros
  T* dr;
  T* dk;
  T* dv;
  float* dlw;
  float* du_part;       // (B, n, H, D): each chunk's rows summed
  float* ds0;
  float* states;        // (B, H, n - 1, D, D): S before chunks 1 .. n-1
  float* gends;         // (B, H, n - 1, D, D): G^o at the end of 0 .. n-2
  float* lrest;         // (B, H, n, D): the later chunks' log decay (dS)
  int H, L, D, dp, C, n, nvb;
  // cp.async pieces, bytes: r, k, v (16, 4, or 0: bf16 element-wise);
  // log_w and do (16 or 4); S and G's sources (16 or 4)
  int vec, fvec, mvec;
};

// shared memory of launch 1, in floats: two stages of a chunk's rows as
// they arrive (k or r: C x dp of T; log_w: C x dp; v or do: C x ldy of T
// or fp32), the scaled k or r in fp32 (C x ldx), le_C and the log decay
// summed so far
struct ScanLayout {
  int ldx, ldy, x, l, y, stage, xs, last, lsum, words;
};
__host__ __device__ inline ScanLayout scan_layout(int dp, int C, int vb,
                                                  int esz) {
  ScanLayout s;
  s.ldx = dp + 8;        // rows of 8 (mod 16) words: the fragment reads of
  s.ldy = vb + 8;        // 4 rows x 8 columns fall in 32 banks
  s.x = 0;
  s.l = s.x + C * dp * esz / 4;
  s.y = s.l + C * dp;
  s.stage = s.y + C * s.ldy;
  s.xs = 2 * s.stage;
  s.last = s.xs + C * s.ldx;
  s.lsum = s.last + dp;
  s.words = s.lsum + dp;
  return s;
}

// shared memory of launch 2, in floats. The rows of r, k, v, do and the
// log decays (then the steps' decays), Ef and Kfac (C x ldc each); S and
// G (dh x ldc), whose room dr', dks and dkq take once the products have
// read them; P and A (C x ldp); u, LB, LH (le at every 8th row), X, rowsum
// (G * S) and the per-channel sums' segments.
struct Layout {
  int ldc, ldp;
  int r, k, v, o, w, ef, kf, s, g, dr, dks, dkq, p, a, u, lb, lh, x, rho, seg;
  int words;
};
__host__ __device__ inline Layout chunk_layout(int dp, int C) {
  Layout L;
  const int ns = C / SUB;
  L.ldc = dp + 4;        // rows of 4 (mod 8) words
  L.ldp = C + 4;
  const int rows = C * L.ldc;
  L.r = 0;
  L.k = L.r + rows;
  L.v = L.k + rows;
  L.o = L.v + rows;
  L.w = L.o + rows;
  L.ef = L.w + rows;
  L.kf = L.ef + rows;
  L.s = L.kf + rows;
  L.g = L.s + dp * L.ldc;
  L.dr = L.s;
  L.dks = L.dr + rows;
  L.dkq = L.dks + rows;
  const int s_room = (2 * dp > 3 * C ? 2 * dp : 3 * C) * L.ldc;
  L.p = L.s + s_room;
  L.a = L.p + C * L.ldp;
  L.u = L.a + C * L.ldp;
  L.lb = L.u + dp;
  L.lh = L.lb + (ns + 1) * dp;
  L.x = L.lh + (C / 8 + 1) * dp;
  L.rho = L.x + (ns + 1) * (ns + 1) * dp;
  L.seg = L.rho + dp;
  L.words = L.seg + 3 * THREADS;
  return L;
}

// chunk rows at padded head dim dp: 32 where launch 2's shared memory
// holds them, else 16
inline int chunk_for(int dp) {
  return chunk_layout(dp, 32).words * 4 <= MAX_SMEM ? 32 : 16;
}

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// hi + lo += A B over k in [k0, k1) (a multiple of 8), for a warp's tile
// of 16 rows x 8 NT columns: fa(m, k) is A's element (m < 16), fb(k, n)
// B's (n < 8 NT). The low-part passes go to lo, hi*hi to hi: 2 NT
// accumulator chains. An EXACT operand has no low part.
template <bool A_EXACT, bool B_EXACT, int NT, typename FA, typename FB>
__device__ __forceinline__ void mma_rows(float (&hi)[NT][4],
                                         float (&lo)[NT][4], int k0, int k1,
                                         FA fa, FB fb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = k0; k < k1; k += 8) {
    uint32_t ah[4], al[4];
    split<A_EXACT>(fa(g, k + t), ah[0], al[0]);
    split<A_EXACT>(fa(g + 8, k + t), ah[1], al[1]);
    split<A_EXACT>(fa(g, k + t + 4), ah[2], al[2]);
    split<A_EXACT>(fa(g + 8, k + t + 4), ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh[2], bl[2];
      split<B_EXACT>(fb(k + t, nt * 8 + g), bh[0], bl[0]);
      split<B_EXACT>(fb(k + t + 4, nt * 8 + g), bh[1], bl[1]);
      if (!A_EXACT) mma(lo[nt], al, bh[0], bh[1]);
      if (!B_EXACT) mma(lo[nt], ah, bl[0], bl[1]);
      mma(hi[nt], ah, bh[0], bh[1]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&x)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) x[nt][q] = 0.f;
}

// Calls f(row, col, value) for the 16 x 8 NT tile's elements that this
// lane holds: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) of each
// n8 tile.
template <int NT, typename F>
__device__ __forceinline__ void each(const float (&x)[NT][4], F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      f(g + (q >> 1) * 8, nt * 8 + 2 * t + (q & 1), x[nt][q]);
}

// Rows 0 .. np - 1 of an array whose row i is at src + i * stride, columns
// 0 .. cols - 1, into dst (ld elements a row) by cp.async in pieces of
// BYTES, zero at rows >= nrows and columns >= ncols (a multiple of the
// piece's elements). The threads are dealt (piece column, row) by shifts.
template <int NTH, int BYTES, typename T>
__device__ __forceinline__ void async_rows(T* dst, int ld, const T* src,
                                           size_t stride, int nrows, int np,
                                           int ncols, int cols) {
  constexpr int E = BYTES / sizeof(T);
  for (int c = (threadIdx.x & 15) * E; c < cols; c += 16 * E)
    for (int i = threadIdx.x >> 4; i < np; i += NTH / 16) {
      const bool ok = i < nrows && c < ncols;
      cp_async<BYTES>(dst + i * ld + c, ok ? src + i * stride + c : src,
                      ok);
    }
}

// Rows t0 .. t0 + nrows - 1 of (b, h) of a (B, L, H, D) array, channels
// c0 .. c0 + cols - 1, into np x cols of dst (ld elements a row), zero past
// the rows and past D: by cp.async in `vec`-byte pieces (16 or 4; 4 takes
// fp32 an element, bf16 a pair), or (vec 0: bf16 rows not in 4-byte
// pairs) element-wise and synchronously.
template <int NTH, typename T, typename A>
__device__ __forceinline__ void rows_in(T* dst, int ld, const T* src,
                                        const A& a, int b, int h, int t0,
                                        int nrows, int np, int c0, int cols,
                                        int vec) {
  const T* s0 = src + (((size_t)b * a.L + t0) * a.H + h) * a.D + c0;
  const size_t rstep = (size_t)a.H * a.D;
  const int D = a.D - c0;
  if (vec == 16) {
    async_rows<NTH, 16>(dst, ld, s0, rstep, nrows, np, D, cols);
  } else if (vec == 4) {
    async_rows<NTH, 4>(dst, ld, s0, rstep, nrows, np, D, cols);
  } else {
    for (int c = threadIdx.x & 15; c < cols; c += 16)
      for (int i = threadIdx.x >> 4; i < np; i += NTH / 16)
        dst[i * ld + c] = i < nrows && c < D ? s0[i * rstep + c] : T(0.f);
  }
}

// For a tile of `rows` rows (at most MAXR * NTH / 16) and `groups` groups
// of 16 columns (at most MAXG), calls st(i, c, x) with x = ld(i, c) for
// this thread's elements: column 16 g + tid % 16 of each group g, rows
// tid / 16 + q NTH / 16. All its loads are in flight before its first
// store (a loop that stores each load before the next waits out a load's
// latency per element), and the deal takes no division.
template <int NTH, int MAXR, int MAXG, typename LD, typename ST>
__device__ __forceinline__ void copy_tile(int rows, int groups, LD ld,
                                          ST st) {
  constexpr int RS = NTH / 16;
  const int c = threadIdx.x & 15, r = threadIdx.x >> 4;
  float x[MAXG][MAXR];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int q = 0; q < MAXR; ++q) {
      const int i = r + q * RS;
      x[g][q] = g < groups && i < rows ? ld(i, 16 * g + c) : 0.f;
    }
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int q = 0; q < MAXR; ++q) {
      const int i = r + q * RS;
      if (g < groups && i < rows) st(i, 16 * g + c, x[g][q]);
    }
}

// the (b, t, h) row of a (B, L, H, D) array, in elements
template <typename T>
__device__ __forceinline__ size_t row_at(const Args<T>& a, int b, int t,
                                         int h) {
  return (((size_t)b * a.L + t) * a.H + h) * a.D;
}

// ---------------------------------------------------------------------------
// launch 1: the chunk-start states (pass 1) and the chunk-end cotangents
// (pass 2), a CTA per (pass, b, h, VB value columns)
// ---------------------------------------------------------------------------
// 4 CTAs an SM (128 registers a thread) where that spills nothing: bf16,
// no dS, dh <= 64, the training path's form; else 3
template <typename T, bool HAS_DS>
__host__ __device__ constexpr int scan_ctas(int dpmax) {
  return sizeof(T) == 2 && !HAS_DS && dpmax == 64 ? 4 : 3;
}

template <typename T, bool HAS_DS, int DPMAX>
__global__ void __launch_bounds__(SCAN_THREADS, scan_ctas<T, HAS_DS>(DPMAX))
rwkv6_bwd_scan(const Args<T> a) {
  constexpr int VB = value_block<DPMAX>();
  constexpr int NT = VB / 8;
  constexpr int RB = DPMAX / 64;   // row blocks of 16 a warp
  constexpr bool V_EXACT = sizeof(T) == 2;
  extern __shared__ __align__(16) float sm[];
  const int dp = a.dp, D = a.D, C = a.C, n = a.n;
  const ScanLayout Ly = scan_layout(dp, C, VB, sizeof(T));
  float* xs = sm + Ly.xs;
  float* last = sm + Ly.last;
  float* lsum = sm + Ly.lsum;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nbh = gridDim.x / (2 * a.nvb);
  const int vb = blockIdx.x % a.nvb, bh = blockIdx.x / a.nvb % nbh;
  const bool fwd = blockIdx.x / a.nvb < nbh;
  const int b = bh / a.H, h = bh % a.H, e0 = vb * VB;
  const size_t mat = (size_t)bh * D * D;

  // this warp's row blocks d0 = 16 (warp + 4 m) of the (dp x VB) block,
  // as mma accumulators: S from s0 (pass 1), G^o from zeros (pass 2)
  float st[RB][NT][4];
#pragma unroll
  for (int m = 0; m < RB; ++m) {
    const int d0 = 16 * (warp + 4 * m);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int d = d0 + g + (q >> 1) * 8;
        const int e = e0 + nt * 8 + 2 * t4 + (q & 1);
        st[m][nt][q] = fwd && a.s0 && d < D && e < D
                           ? a.s0[mat + (size_t)d * D + e] : 0.f;
      }
  }
  for (int d = tid; d < dp; d += SCAN_THREADS) lsum[d] = 0.f;

  // the (D x D) block's elements this lane holds, to dst
  auto store = [&](float* dst) {
#pragma unroll
    for (int m = 0; m < RB; ++m) {
      const int d0 = 16 * (warp + 4 * m);
      if (d0 >= dp) continue;
      each(st[m], [&](int i, int j, float x) {
        const int d = d0 + i, e = e0 + j;
        if (d < D && e < D) dst[(size_t)d * D + e] = x;
      });
    }
  };
  // the chunks in walk order into a ring of two stages: k or r, log_w, v
  // or do's VB columns
  const int steps = fwd ? n - 1 : n;
  auto chunk_of = [&](int s_) { return fwd ? s_ : n - 1 - s_; };
  auto stage = [&](int s_) { return sm + (s_ & 1) * Ly.stage; };
  auto fetch = [&](int s_) {
    if (s_ < steps) {
      const int c = chunk_of(s_), t0 = c * C, nrows = min(C, a.L - t0);
      float* sg = stage(s_);
      const int np = round16(nrows);
      rows_in<SCAN_THREADS>(reinterpret_cast<T*>(sg + Ly.x), dp,
                            fwd ? a.k : a.r, a, b, h, t0, nrows, np, 0, dp,
                            a.vec);
      rows_in<SCAN_THREADS>(sg + Ly.l, dp, a.lw, a, b, h, t0, nrows, np, 0,
                            dp, a.fvec);
      if (fwd)
        rows_in<SCAN_THREADS>(reinterpret_cast<T*>(sg + Ly.y), Ly.ldy, a.v,
                              a, b, h, t0, nrows, np, e0, VB, a.vec);
      else
        rows_in<SCAN_THREADS>(sg + Ly.y, Ly.ldy, a.dout, a, b, h, t0, nrows,
                              np, e0, VB, a.fvec);
    }
    cp_commit();
  };
  fetch(0);
  for (int s = 0; s < steps; ++s) {
    const int c = chunk_of(s);
    const int nrows = min(C, a.L - c * C), np = round16(nrows);
    if (!fwd) {
      if (c + 1 < n) store(a.gends + ((size_t)bh * (n - 1) + c) * D * D);
      if (HAS_DS && vb == 0 && tid < D)
        a.lrest[((size_t)bh * n + c) * D + tid] = lsum[tid];
    }
    cp_wait<0>();
    __syncthreads();   // chunk s is in place; the other stage is free
    fetch(s + 1);
    const float* sg = stage(s);
    const T* xr = reinterpret_cast<const T*>(sg + Ly.x);
    float* ls = const_cast<float*>(sg + Ly.l);
    // le, in place, in row order per channel; le_C
    if (tid < dp) {
      float acc = 0.f;
      for (int i = 0; i < np; ++i) {
        acc += ls[i * dp + tid];
        ls[i * dp + tid] = acc;
      }
      last[tid] = acc;
      lsum[tid] += acc;
    }
    __syncthreads();
    // pass 1: k * exp(le_C - le); pass 2: r * exp(le)
    for (int d = tid & 15; d < dp; d += 16)
      for (int i = tid >> 4; i < np; i += SCAN_THREADS / 16) {
        const float l = ls[i * dp + d];
        xs[i * Ly.ldx + d] = to_f(xr[i * dp + d]) * ex(fwd ? last[d] - l : l);
      }
    __syncthreads();
    // the block = exp(le_C) * block + xs^T y (rows d, columns e)
#pragma unroll
    for (int m = 0; m < RB; ++m) {
      const int d0 = 16 * (warp + 4 * m);
      if (d0 >= dp) continue;
      const float dec0 = ex(last[d0 + g]), dec1 = ex(last[d0 + g + 8]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        st[m][nt][0] *= dec0;
        st[m][nt][1] *= dec0;
        st[m][nt][2] *= dec1;
        st[m][nt][3] *= dec1;
      }
      // in two halves of the columns (fewer fragments live at once)
      auto fa = [&](int i, int j) { return xs[j * Ly.ldx + d0 + i]; };
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        constexpr int NH = NT / 2;
        float(&acc)[NH][4] =
            *reinterpret_cast<float(*)[NH][4]>(&st[m][hc * NH][0]);
        float lo[NH][4];
        zero(lo);
        if (fwd) {
          const T* yv = reinterpret_cast<const T*>(sg + Ly.y) + hc * NH * 8;
          mma_rows<false, V_EXACT, NH>(
              acc, lo, 0, np, fa,
              [&](int j, int e) { return to_f(yv[j * Ly.ldy + e]); });
        } else {
          const float* yd = sg + Ly.y + hc * NH * 8;
          mma_rows<false, false, NH>(
              acc, lo, 0, np, fa,
              [&](int j, int e) { return yd[j * Ly.ldy + e]; });
        }
#pragma unroll
        for (int nt = 0; nt < NH; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[nt][q] += lo[nt][q];
      }
    }
    if (fwd) store(a.states + ((size_t)bh * (n - 1) + c) * D * D);
  }
  cp_wait<0>();
  if (!fwd) {
    // ds0 = G^o_{-1} + exp(L_{T-1}) dS_final
    __syncthreads();
#pragma unroll
    for (int m = 0; m < RB; ++m) {
      const int d0 = 16 * (warp + 4 * m);
      if (d0 >= dp) continue;
      each(st[m], [&](int i, int j, float x) {
        const int d = d0 + i, e = e0 + j;
        if (d < D && e < D) {
          const size_t o = mat + (size_t)d * D + e;
          a.ds0[o] = HAS_DS ? fmaf(ex(lsum[d]), a.ds[o], x) : x;
        }
      });
    }
  }
}

// ---------------------------------------------------------------------------
// launch 2: a CTA per (b, h, chunk)
// ---------------------------------------------------------------------------
template <typename T, bool HAS_DS, int DPMAX>
__global__ void __launch_bounds__(THREADS)
rwkv6_bwd_chunk(const Args<T> a) {
  constexpr bool V_EXACT = sizeof(T) == 2;
  constexpr int MAXH = max_held<DPMAX>();
  extern __shared__ __align__(16) float sm[];
  const int dp = a.dp, D = a.D, n = a.n;
  const Layout Ly = chunk_layout(dp, a.C);
  const int ldc = Ly.ldc, ldp = Ly.ldp;
  float* R = sm + Ly.r;
  float* K = sm + Ly.k;
  float* V = sm + Ly.v;
  float* O = sm + Ly.o;      // do
  float* W = sm + Ly.w;      // log_w, then le, then the steps' decays
  float* EF = sm + Ly.ef;
  float* KF = sm + Ly.kf;
  float* S = sm + Ly.s;
  float* G = sm + Ly.g;
  float* DR = sm + Ly.dr;
  float* DKS = sm + Ly.dks;
  float* DKQ = sm + Ly.dkq;
  float* P = sm + Ly.p;
  float* A = sm + Ly.a;
  float* U = sm + Ly.u;
  float* LB = sm + Ly.lb;
  float* LH = sm + Ly.lh;
  float* X = sm + Ly.x;
  float* RHO = sm + Ly.rho;
  float* SEG = sm + Ly.seg;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x / n, c = blockIdx.x % n;
  const int b = bh / a.H, h = bh % a.H;
  const int t0 = c * a.C, nrows = min(a.C, a.L - t0), np = round16(nrows);
  const int ns = np / SUB, nx = ns + 1;
  const size_t mat = (size_t)bh * D * D;
  auto xt = [&](int p, int q) { return X + (p * nx + q) * dp; };

  // ---- load: the chunk's rows, S_{c-1}, G, u, by cp.async (bf16 r, k,
  // v in pairs through the room of Ef and Kfac, widened below) ----
  constexpr int MAXR = 32 / (THREADS / 16), MAXG = DPMAX / 16;
  T* staged = reinterpret_cast<T*>(EF);     // bf16 r, k, v: 3 x np x dp
  {
    auto rkv = [&](const T* src, float* dst, int q) {
      if constexpr (sizeof(T) == 4) {
        rows_in<THREADS>(dst, ldc, src, a, b, h, t0, nrows, np, 0, dp, a.vec);
      } else if (a.vec) {
        rows_in<THREADS>(staged + q * np * dp, dp, src, a, b, h, t0, nrows,
                         np, 0, dp, a.vec);
      } else {
        const size_t row0 = row_at(a, b, t0, h), rstep = (size_t)a.H * D;
        copy_tile<THREADS, MAXR, MAXG>(
            np, dp / 16,
            [&](int i, int d) {
              return i < nrows && d < D ? to_f(src[row0 + i * rstep + d])
                                        : 0.f;
            },
            [&](int i, int d, float x) { dst[i * ldc + d] = x; });
      }
    };
    rkv(a.r, R, 0);
    rkv(a.k, K, 1);
    rkv(a.v, V, 2);
    rows_in<THREADS>(O, ldc, a.dout, a, b, h, t0, nrows, np, 0, dp, a.fvec);
    rows_in<THREADS>(W, ldc, a.lw, a, b, h, t0, nrows, np, 0, dp, a.fvec);
    cp_commit();   // the rows: phases 1-3 need only them
    // a (D x D) matrix (or zeros) into (dp x ldc)
    auto matrix = [&](const float* src, float* dst) {
      const float* p = src ? src : a.ds0;   // ds0: a 16-byte aligned dummy
      const int nd = src ? D : 0;
      if (a.mvec == 16)
        async_rows<THREADS, 16>(dst, ldc, p, D, nd, dp, D, dp);
      else
        async_rows<THREADS, 4>(dst, ldc, p, D, nd, dp, D, dp);
    };
    matrix(c > 0 ? a.states + ((size_t)bh * (n - 1) + c - 1) * D * D
                 : a.s0 ? a.s0 + mat : nullptr, S);
    matrix(c + 1 < n ? a.gends + ((size_t)bh * (n - 1) + c) * D * D
                     : nullptr, G);
    cp_commit();   // S and G: waited for at the end of phase 3
    for (int d = tid; d < dp; d += THREADS)
      U[d] = d < D ? a.u[(size_t)h * D + d] : 0.f;
    cp_wait<1>();
    __syncthreads();
  }
  if constexpr (sizeof(T) == 2) {
    // the staged bf16 rows widened (before phase 2 takes Ef's room)
    if (a.vec)
      for (int d = tid & 15; d < dp; d += 16)
        for (int i = tid >> 4; i < np; i += THREADS / 16) {
          R[i * ldc + d] = to_f(staged[i * dp + d]);
          K[i * ldc + d] = to_f(staged[(np + i) * dp + d]);
          V[i * ldc + d] = to_f(staged[(2 * np + i) * dp + d]);
        }
  }

  // ---- 1. le in place, in row order per channel; LB, LH and X ----
  if (tid < dp) {
    const int d = tid;
    float l[32];   // all rows loaded before the first store
#pragma unroll
    for (int i = 0; i < 32; ++i) l[i] = i < np ? W[i * ldc + d] : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i >= np) break;
      acc += l[i];
      W[i * ldc + d] = acc;
      if (i % 8 == 7) LH[(i / 8) * dp + d] = acc;
      if (i % SUB == SUB - 1) LB[(i / SUB + 1) * dp + d] = acc;
    }
    LB[d] = 0.f;
    for (int p = 0; p <= ns; ++p)
      for (int q = 0; q <= p; ++q)
        xt(p, q)[d] = ex(LB[p * dp + d] - LB[q * dp + d]);
  }
  __syncthreads();

  // ---- 2. Ef, Kfac and the steps' decays exp(le_i - le_{i-1}) in place of
  // le (unused at a sub-chunk's first row), a task per (channel, 8 rows);
  // le before a task's rows comes from LH ----
  for (int task = tid; task < dp * (np / 8); task += THREADS) {
    const int d = task % dp, i0 = task / dp * 8, I = i0 / SUB;
    const float lbi = LB[I * dp + d], lq = LB[(I + 1) * dp + d];
    float le[9];
    le[0] = i0 % SUB ? LH[(i0 / 8 - 1) * dp + d] : 0.f;
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) le[ii + 1] = W[(i0 + ii) * ldc + d];
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
      const int si = (i0 + ii) * ldc + d;
      W[si] = ex(le[ii + 1] - le[ii]);
      EF[si] = ex(le[ii + 1] - lbi);
      KF[si] = ex(lq - le[ii + 1]);
    }
  }
  __syncthreads();

  // ---- 3. P = dO V^T (blocks I >= J) and the scores' off-diagonal blocks
  // A_IJ = Rf_I (Kf_J X[I][J+1])^T on the tensor cores, a warp a 16 x 16
  // block; the scores' diagonal blocks pairwise ----
  {
    const int npb = ns * (ns + 1) / 2, nab = ns * (ns - 1) / 2;
    for (int item = warp; item < npb + nab; item += WARPS) {
      const bool isp = item < npb;
      int q = isp ? item : item - npb, I = isp ? 0 : 1;
      while (q >= I + (isp ? 1 : 0)) {
        q -= I + (isp ? 1 : 0);
        ++I;
      }
      const int J = q;
      float hi[2][4], lo[2][4];
      zero(hi);
      zero(lo);
      if (isp) {
        mma_rows<false, V_EXACT, 2>(
            hi, lo, 0, dp,
            [&](int m, int e) { return O[(I * SUB + m) * ldc + e]; },
            [&](int e, int j) { return V[(J * SUB + j) * ldc + e]; });
      } else {
        const float* x = xt(I, J + 1);
        mma_rows<false, false, 2>(
            hi, lo, 0, dp,
            [&](int m, int d) {
              const int si = (I * SUB + m) * ldc + d;
              return R[si] * EF[si];
            },
            [&](int d, int j) {
              const int si = (J * SUB + j) * ldc + d;
              return K[si] * KF[si] * x[d];
            });
      }
      float* dst = isp ? P : A;
      each(hi, [&](int i, int j, float x) {
        dst[(I * SUB + i) * ldp + J * SUB + j] = x;
      });
      each(lo, [&](int i, int j, float x) {
        dst[(I * SUB + i) * ldp + J * SUB + j] += x;
      });
    }
  }
  // the diagonal blocks: lane (j, part) of a half-warp holds k_j (times the
  // decay so far) on channels part, part + 16, ...; it walks the block's 16
  // rows i (rows up to j give the bonus or 0) and the 16 lanes of a j
  // reduce-scatter the 16 sums
  for (int task = tid; task < ns * SUB * SUB; task += THREADS) {
    const int I = task / (SUB * SUB), jl = task / SUB % SUB, part = task % SUB;
    const int j = I * SUB + jl;
    constexpr int MAXC = DPMAX / SUB;
    float kd[MAXC];
    float bonus = 0.f;
#pragma unroll
    for (int m = 0; m < MAXC; ++m) {
      const int ch = part + SUB * m;
      kd[m] = ch < dp ? K[j * ldc + ch] : 0.f;
      if (ch < dp) bonus += R[j * ldc + ch] * U[ch] * kd[m];
    }
    float sums[SUB];
#pragma unroll
    for (int ii = 0; ii < SUB; ++ii) {
      const int i = I * SUB + ii;
      float s = 0.f;
      if (ii > jl) {
#pragma unroll
        for (int m = 0; m < MAXC; ++m) {
          const int ch = part + SUB * m;
          if (ch < dp) {
            kd[m] *= W[i * ldc + ch];
            s += R[i * ldc + ch] * kd[m];
          }
        }
      }
      sums[ii] = ii > jl ? s : (ii == jl ? bonus : 0.f);
    }
    scatter_sum(sums, part);
    A[(I * SUB + part) * ldp + j] = sums[0];
  }
  cp_wait<0>();
  __syncthreads();   // the scores, S and G are in place
  if (HAS_DS) {
    // G += exp(Lrest_c) dS_final, the factor a row, 32 rows at a time
    for (int d = tid; d < dp; d += THREADS)
      RHO[d] = d < D ? ex(a.lrest[((size_t)bh * n + c) * D + d]) : 0.f;
    __syncthreads();
    for (int i0 = 0; i0 < dp; i0 += 32)
      copy_tile<THREADS, MAXR, MAXG>(
          min(32, dp - i0), dp / 16,
          [&](int i, int e) {
            return i0 + i < D && e < D
                       ? a.ds[mat + (size_t)(i0 + i) * D + e] : 0.f;
          },
          [&](int i, int e, float x) {
            float* p = G + (i0 + i) * ldc + e;
            *p = fmaf(RHO[i0 + i], x, *p);
          });
    __syncthreads();
  }
  // rowsum(G * S) for dlog_w's carry, 8 rows a warp at once (their
  // shuffle chains interleaved); read in phase 6
  for (int d0 = warp; d0 < dp; d0 += 8 * WARPS) {
    float x[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int d = d0 + q * WARPS;
      x[q] = 0.f;
      if (d < dp)
        for (int e = lane; e < dp; e += 32)
          x[q] += G[d * ldc + e] * S[d * ldc + e];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < 8; ++q) x[q] += __shfl_xor_sync(FULL, x[q], off);
    if (lane == 0)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (d0 + q * WARPS < dp) RHO[d0 + q * WARPS] = x[q];
  }

  // ---- 4. the products on the tensor cores, a warp a 16 x 16 tile:
  // dr' (I, 16 channels), dks (J, ...), dkq (J < ns - 1, ...), held in
  // registers through the barrier (S and G's room takes them), then dv
  // (J, 16 value columns), stored at once ----
  const int cg = dp / SUB;
  const int n_dr = ns * cg, n_ks = ns * cg, n_kq = (ns - 1) * cg;
  const int n_held = n_dr + n_ks + n_kq;
  float held[MAXH][2][4];
#pragma unroll
  for (int qh = 0; qh < MAXH; ++qh) {
    const int item = warp + WARPS * qh;
    float lo[2][4];
    zero(held[qh]);
    zero(lo);
    if (item < n_dr) {
      const int I = item / cg, d0 = item % cg * SUB;
      const float* x0 = xt(I, 0);
      mma_rows<false, false, 2>(
          held[qh], lo, 0, dp,
          [&](int m, int e) { return O[(I * SUB + m) * ldc + e]; },
          [&](int e, int d) {
            return S[(d0 + d) * ldc + e] * x0[d0 + d];
          });
      for (int J = 0; J < I; ++J) {
        const float* x = xt(I, J + 1);
        mma_rows<false, false, 2>(
            held[qh], lo, J * SUB, J * SUB + SUB,
            [&](int m, int j) { return P[(I * SUB + m) * ldp + j]; },
            [&](int j, int d) {
              const int si = j * ldc + d0 + d;
              return K[si] * KF[si] * x[d0 + d];
            });
      }
    } else if (item < n_dr + n_ks) {
      const int J = (item - n_dr) / cg, d0 = (item - n_dr) % cg * SUB;
      mma_rows<V_EXACT, false, 2>(
          held[qh], lo, 0, dp,
          [&](int m, int e) { return V[(J * SUB + m) * ldc + e]; },
          [&](int e, int d) { return G[(d0 + d) * ldc + e]; });
    } else if (item < n_held) {
      const int J = (item - n_dr - n_ks) / cg;
      const int d0 = (item - n_dr - n_ks) % cg * SUB;
      for (int I = J + 1; I < ns; ++I) {
        const float* x = xt(I, J + 1);
        mma_rows<false, false, 2>(
            held[qh], lo, I * SUB, I * SUB + SUB,
            [&](int m, int i) { return P[i * ldp + J * SUB + m]; },
            [&](int i, int d) {
              const int si = i * ldc + d0 + d;
              return R[si] * EF[si] * x[d0 + d];
            });
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) held[qh][nt][q] += lo[nt][q];
  }
  // dv, the items after the held ones in the same deal
  for (int item = (warp - n_held % WARPS + WARPS) % WARPS; item < ns * cg;
       item += WARPS) {
    const int J = item / cg, e0 = item % cg * SUB;
    const float* x = xt(ns, J + 1);
    float hi[2][4], lo[2][4];
    zero(hi);
    zero(lo);
    mma_rows<false, false, 2>(
        hi, lo, J * SUB, np,
        [&](int m, int i) { return A[i * ldp + J * SUB + m]; },
        [&](int i, int e) { return O[i * ldc + e0 + e]; });
    mma_rows<false, false, 2>(
        hi, lo, 0, dp,
        [&](int m, int d) {
          const int si = (J * SUB + m) * ldc + d;
          return K[si] * KF[si] * x[d];
        },
        [&](int d, int e) { return G[d * ldc + e0 + e]; });
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) hi[nt][q] += lo[nt][q];
    each(hi, [&](int i, int j, float v) {
      const int row = J * SUB + i, e = e0 + j;
      if (row < nrows && e < D)
        a.dv[row_at(a, b, t0 + row, h) + e] = from_f<T>(v);
    });
  }
  __syncthreads();   // S and G are read
#pragma unroll
  for (int qh = 0; qh < MAXH; ++qh) {
    const int item = warp + WARPS * qh;
    if (item < n_dr) {
      const int I = item / cg, d0 = item % cg * SUB;
      each(held[qh], [&](int i, int d, float v) {
        const int si = (I * SUB + i) * ldc + d0 + d;
        DR[si] = v * EF[si];
      });
    } else if (item < n_dr + n_ks) {
      const int J = (item - n_dr) / cg, d0 = (item - n_dr) % cg * SUB;
      const float* x = xt(ns, J + 1);
      each(held[qh], [&](int i, int d, float v) {
        const int si = (J * SUB + i) * ldc + d0 + d;
        DKS[si] = v * KF[si] * x[d0 + d];
      });
    } else if (item < n_held) {
      const int J = (item - n_dr - n_ks) / cg;
      const int d0 = (item - n_dr - n_ks) % cg * SUB;
      each(held[qh], [&](int i, int d, float v) {
        const int si = (J * SUB + i) * ldc + d0 + d;
        DKQ[si] = v * KF[si];
      });
    }
  }
  // the last sub-chunk's dkq has no later sub-chunk's part
  for (int d = tid & 15; d < dp; d += 16)
    DKQ[((ns - 1) * SUB + (tid >> 4)) * ldc + d] = 0.f;
  __syncthreads();

  // ---- 5. the pairs within a sub-chunk, a task per (dr' or dkq, I,
  // channel): running products of the steps' decays ----
  for (int task = tid; task < 2 * ns * dp; task += THREADS) {
    const bool kq = task >= ns * dp;
    const int rem = kq ? task - ns * dp : task;
    const int I = rem / dp, d = rem % dp, r0 = I * SUB;
    float x[SUB];
#pragma unroll
    for (int ii = 0; ii < SUB; ++ii)
      x[ii] = (kq ? R : K)[(r0 + ii) * ldc + d];
    if (!kq) {
      // dr'_i += sum_{j < i} P_ij k_j exp(le_i - le_j)
#pragma unroll
      for (int ii = 1; ii < SUB; ++ii) {
        const float w = W[(r0 + ii) * ldc + d];
        float s = 0.f;
#pragma unroll
        for (int jj = 0; jj < ii; ++jj) {
          x[jj] *= w;
          s += P[(r0 + ii) * ldp + r0 + jj] * x[jj];
        }
        DR[(r0 + ii) * ldc + d] += s;
      }
    } else {
      // dkq_j += sum_{i > j} P_ij r_i exp(le_i - le_j)
#pragma unroll
      for (int jj = SUB - 2; jj >= 0; --jj) {
        const float w = W[(r0 + jj + 1) * ldc + d];
        float s = 0.f;
#pragma unroll
        for (int ii = jj + 1; ii < SUB; ++ii) {
          x[ii] *= w;
          s += P[(r0 + ii) * ldp + r0 + jj] * x[ii];
        }
        DKQ[(r0 + jj) * ldc + d] += s;
      }
    }
  }
  __syncthreads();

  // ---- 6. per channel: dr, dk, du's sum and dlog_w's prefix and suffix
  // sums, a thread a (channel, segment of rows) ----
  const int segs = min(THREADS / dp, np), rps = (np + segs - 1) / segs;
  const int d = tid % dp, sg = tid / dp;
  const bool active = sg < segs;
  const int i0 = sg * rps, i1 = min(np, i0 + rps);
  const float ud = U[d];
  {
    float tf = 0.f, tb = 0.f, tu = 0.f;
    if (active)
      for (int i = i0; i < i1; ++i) {
        const int si = i * ldc + d;
        const float ri = R[si], ki = K[si];
        tf += ki * DKS[si];
        tb += ri * DR[si] - ki * DKQ[si];
        tu += ri * ki * P[i * ldp + i];
      }
    SEG[tid] = tf;
    SEG[THREADS + tid] = tb;
    SEG[2 * THREADS + tid] = tu;
  }
  __syncthreads();
  if (active) {
    float f = xt(ns, 0)[d] * RHO[d];
    for (int s = 0; s < sg; ++s) f += SEG[s * dp + d];
    float bsum = 0.f;
    for (int s = segs - 1; s > sg; --s) bsum += SEG[THREADS + s * dp + d];
    for (int i = i0; i < i1; ++i) {
      const int si = i * ldc + d;
      const float ki = K[si], dks = DKS[si];
      if (i < nrows && d < D)
        a.dk[row_at(a, b, t0 + i, h) + d] = from_f<T>(
            (dks + DKQ[si]) + ud * R[si] * P[i * ldp + i]);
      DKS[si] = f;   // now the prefix sum before row i
      f += ki * dks;
    }
    for (int i = i1 - 1; i >= i0; --i) {
      const int si = i * ldc + d;
      const float ki = K[si], dr = DR[si];
      bsum += R[si] * dr - ki * DKQ[si];
      if (i < nrows && d < D) {
        const size_t gi = row_at(a, b, t0 + i, h) + d;
        a.dlw[gi] = DKS[si] + bsum;
        a.dr[gi] = from_f<T>(dr + ud * ki * P[i * ldp + i]);
      }
    }
    if (sg == 0 && d < D) {
      float du = 0.f;
      for (int s = 0; s < segs; ++s) du += SEG[2 * THREADS + s * dp + d];
      a.du_part[(((size_t)b * n + c) * a.H + h) * D + d] = du;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <typename T, bool HAS_DS, int DPMAX>
cudaError_t set_smem_attrs() {
  // the attribute holds per device; set once on each (setting it twice
  // from two threads is harmless)
  static bool attr_set[64];
  int device = -1;
  if (cudaGetDevice(&device) != cudaSuccess) device = -1;
  if (device >= 0 && device < 64 && attr_set[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_bwd_scan<T, HAS_DS, DPMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rwkv6_bwd_chunk<T, HAS_DS, DPMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
  if (err == cudaSuccess && device >= 0 && device < 64)
    attr_set[device] = true;
  return err;
}

template <typename T, bool HAS_DS, int DPMAX>
int launch_dp(const Args<T>& a, int B, cudaStream_t stream) {
  const cudaError_t attr = set_smem_attrs<T, HAS_DS, DPMAX>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int bh = B * a.H;
  rwkv6_bwd_scan<T, HAS_DS, DPMAX>
      <<<2 * bh * a.nvb, SCAN_THREADS,
         scan_layout(a.dp, a.C, value_block<DPMAX>(), sizeof(T)).words * 4,
         stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_bwd_chunk<T, HAS_DS, DPMAX>
      <<<bh * a.n, THREADS, chunk_layout(a.dp, a.C).words * 4, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int attrs_of(K kernel, int threads, int bytes, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = threads;
  out[1] = attr.numRegs;
  out[2] = bytes;
  out[3] = per_sm;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

template <typename T, bool HAS_DS, int DPMAX>
int form_dp(int dp, int* out) {
  const cudaError_t err = set_smem_attrs<T, HAS_DS, DPMAX>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int C = chunk_for(dp);
  int e = attrs_of(rwkv6_bwd_chunk<T, HAS_DS, DPMAX>, THREADS,
                   chunk_layout(dp, C).words * 4, out);
  if (e) return e;
  e = attrs_of(rwkv6_bwd_scan<T, HAS_DS, DPMAX>, SCAN_THREADS,
               scan_layout(dp, C, value_block<DPMAX>(), sizeof(T)).words * 4,
               out + 5);
  if (e) return e;
  out[10] = C;
  out[11] = value_block<DPMAX>();
  return 0;
}

template <typename T, bool HAS_DS>
int form_ds(int D, int* out) {
  const int dp = round16(D);
  return dp <= 64 ? form_dp<T, HAS_DS, 64>(dp, out)
                  : form_dp<T, HAS_DS, 128>(dp, out);
}

template <typename T, bool HAS_DS>
int launch_ds(const Args<T>& a, int B, cudaStream_t stream) {
  return a.dp <= 64 ? launch_dp<T, HAS_DS, 64>(a, B, stream)
                    : launch_dp<T, HAS_DS, 128>(a, B, stream);
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* lw,
           const float* u, const float* s0, const float* dout,
           const float* ds, void* dr, void* dk, void* dv, float* dlw,
           float* du_part, float* ds0, float* states, float* gends,
           float* lrest, int B, int L, int H, int D, cudaStream_t stream) {
  Args<T> a;
  a.r = static_cast<const T*>(r);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.lw = lw;
  a.u = u;
  a.s0 = s0;
  a.dout = dout;
  a.ds = ds;
  a.dr = static_cast<T*>(dr);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  a.dlw = dlw;
  a.du_part = du_part;
  a.ds0 = ds0;
  a.states = states;
  a.gends = gends;
  a.lrest = lrest;
  a.H = H;
  a.L = L;
  a.D = D;
  a.dp = round16(D);
  a.C = chunk_for(a.dp);
  a.n = (L + a.C - 1) / a.C;
  const int vb = a.dp <= 64 ? value_block<64>() : value_block<128>();
  a.nvb = (a.dp + vb - 1) / vb;
  auto al = [](const void* p, int m) {
    return p == nullptr || (reinterpret_cast<uintptr_t>(p) & (m - 1)) == 0;
  };
  const int esz = sizeof(T);
  a.vec = (D * esz) % 16 == 0 && al(r, 16) && al(k, 16) && al(v, 16) ? 16
          : esz == 4 || (D % 2 == 0 && al(r, 4) && al(k, 4) && al(v, 4))
              ? 4 : 0;
  a.fvec = D % 4 == 0 && al(lw, 16) && al(dout, 16) ? 16 : 4;
  a.mvec = D % 4 == 0 && al(s0, 16) && al(states, 16) && al(gends, 16)
               ? 16 : 4;
  if ((long long)B * H * (a.n > 2 * a.nvb ? a.n : 2 * a.nvb) >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  return ds ? launch_ds<T, true>(a, B, stream)
            : launch_ds<T, false>(a, B, stream);
}

}  // namespace

extern "C" {

int rwkv6_bwd_max_head_dim() { return MAX_DH; }

// rows a chunk at head dim D (the scratch the wrapper passes has
// ceil(L / chunk) chunks)
int rwkv6_bwd_chunk_rows(int D) {
  return D < 1 || D > MAX_DH ? 0 : chunk_for(round16(D));
}

// The kernels' form at head dim D, bf16 (bf16 != 0) or fp32 r, k, v, with
// (ds != 0) or without a final state's gradient, into out[12]: launch 2's
// threads a CTA, registers a thread, dynamic shared memory bytes, CTAs an
// SM holds, local (spilled) bytes a thread; the same five of launch 1;
// rows a chunk; value columns a CTA of launch 1. Returns 0 or a
// cudaError_t.
int rwkv6_bwd_form(int D, int bf16, int ds, int* out) {
  if (D < 1 || D > MAX_DH) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return ds ? form_ds<__nv_bfloat16, true>(D, out)
              : form_ds<__nv_bfloat16, false>(D, out);
  return ds ? form_ds<float, true>(D, out) : form_ds<float, false>(D, out);
}

// r, k, v: (B, L, H, D) bf16 (bf16 != 0) or fp32; log_w, dout: (B, L, H, D)
// fp32; u: (H, D) fp32; s0, ds: (B, H, D, D) fp32 or null for zeros.
// Writes dr, dk, dv (r's type) and dlw (B, L, H, D) fp32, du_part
// (B, n, H, D) fp32 (each chunk's rows summed; n = ceil(L /
// rwkv6_bwd_chunk_rows(D))), ds0 (B, H, D, D) fp32. Scratch: states and
// gends (B, H, n - 1, D, D) fp32, lrest (B, H, n, D) fp32 where ds is
// given. All contiguous; B, L, H >= 1. Two launches on the stream.
int rwkv6_backward(const void* r, const void* k, const void* v,
                   const void* log_w, const void* u, const void* s0,
                   const void* dout, const void* ds, void* dr, void* dk,
                   void* dv, void* dlw, void* du_part, void* ds0,
                   void* states, void* gends, void* lrest, int B, int L,
                   int H, int D, int bf16, void* stream) {
  if (D < 1 || D > MAX_DH || B < 1 || L < 1 || H < 1 || (ds && !lrest))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  if (bf16)
    return launch<__nv_bfloat16>(r, k, v, f(log_w), f(u), f(s0), f(dout),
                                 f(ds), dr, dk, dv, m(dlw), m(du_part),
                                 m(ds0), m(states), m(gends), m(lrest), B, L,
                                 H, D, s);
  return launch<float>(r, k, v, f(log_w), f(u), f(s0), f(dout), f(ds), dr,
                       dk, dv, m(dlw), m(du_part), m(ds0), m(states),
                       m(gends), m(lrest), B, L, H, D, s);
}

const char* rwkv6_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
