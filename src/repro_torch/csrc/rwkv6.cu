// RWKV6 chunked linear attention for Hopper, from a carried state.
//
// Replaces rwkv6_pallas (src/repro/kernels/rwkv6.py, body _rwkv_kernel) and
// adds what the model's prefill needs beyond it: an initial state s0 and the
// final state. Per (batch row, head), with inclusive in-chunk log decays
// le_i = sum_{t <= i} log_w_t (per channel, all <= 0):
//
//   scores[i][j] = sum_d r_i[d] k_j[d] exp(le_i[d] - le_j[d])   (j < i)
//   scores[i][i] = sum_d r_i[d] u[d] k_i[d]                      (the bonus)
//   o_i          = sum_{j <= i} scores[i][j] v_j + (r_i * exp(le_i)) S
//   S'           = exp(le_C) * S + (k * exp(le_C - le))^T v
//
// Every exponent is <= 0: the pairwise-safe form of the reference model's
// rwkv_chunked, never the TPU kernel's factored r*exp(le) @ (k*exp(-le))^T,
// which overflows fp32 once the decays reach the model's -e^4.
//
// On the TPU the chunks were a sequential grid axis with S in VMEM scratch.
// Here a CTA of 16 warps owns one (b, h) and a block of DV value columns
// (DV = 64, so all of dh 64: 128 CTAs at rwkv6-1.6b's prefill; 32 where 64
// does not fit in shared memory, and then the CTAs of a head each compute
// the chunk's scores). It keeps S in shared memory (in registers, as mma
// accumulators, while it updates them) and walks the chunks in order.
//
// A chunk of n rows is cut into 16-row sub-chunks I (rows b_I..b_I+15, the
// last zero-padded: log_w 0, r = k = v = 0, which leaves S as it is). With
// B_I = b_I - 1 (le at B_0 is 0) and q_J = b_J + 15, for j <= B_I < i:
//
//   exp(le_i - le_j) = exp(le_i - le_{B_I}) * exp(le_{B_I} - le_j)
//
// and both factors have exponents <= 0. So the kernel forms, once a chunk,
//   Rf_i = r_i * exp(le_i - le_{B_I})     (i in I)
//   Kf_j = k_j * exp(le_{q_J} - le_j)     (j in J)
// and a few per-channel vectors X[a][b] = exp(le_{B_a} - le_{B_b}) (B_ns is
// the chunk's last row), and every product of the chunk becomes a matrix
// product of those with a diagonal scaling folded into a fragment:
//   off-diagonal scores (I, J < I) = Rf_I (Kf_J * X[I][J+1])^T
//   o_I  = A_I V + (Rf_I * X[I][0]) S
//   S'   = X[ns][0] * S + sum_J (Kf_J * X[ns][J+1])^T V_J
// Only the 16 x 16 diagonal blocks stay pairwise. There exp(le_i - le_j) is
// the running product of the steps' decays exp(le_t - le_{t-1}), t = j+1..i
// (each <= 1; one multiply a pair and channel instead of an exponential).
// A chunk of 32 takes 3 x 2048 exponentials (Rf, Kf, the steps) instead of
// the pairwise form's 31,744.
//
// The matrix products run on the tensor cores, mma.sync m16n8k8 TF32, at
// fp32 accuracy: each fp32 operand is split into a TF32 high part and a
// TF32 low part (each rounded to nearest), and a product takes 3 passes
// (lo*hi, hi*lo, hi*hi), or 2 where the other operand is bf16 v, which
// TF32 holds exactly. The k-steps alternate between two accumulator chains,
// each keeping its low-part passes apart from its hi*hi pass. The diagonal
// blocks, the cumulative sum and the exponentials are fp32 on the CUDA
// cores. The cumulative sum runs in row order per channel.
//
// A chunk is 4 phases between block barriers: (1) the cumulative sum and
// X, a thread a channel; (2) Rf, Kf and the steps' decays, a thread a
// (channel, 8 rows); (3) the diagonal blocks (a lane a key row and 1/16 of
// the channels, all 16 rows unrolled, the rows above a warp's first key
// row skipped, the 16 lanes' sums reduce-scattered) beside the tensor-core
// work that needs no scores: the off-diagonal score blocks (each split in
// two halves of the channels, summed where read), S' and o's state term
// (Rf X) S into registers, dealt first to the warps that skip most of the
// diagonal; (4) o += A V on the tensor cores and the store. S is
// double-buffered where it fits (else S' waits for phase 4).
//
// Loads: a ring of 2 chunk buffers (1 where 2 do not fit in shared memory)
// filled by cp.async, 16 bytes a thread, so chunk c+1 streams in while
// chunk c is computed; rows past the chunk and channels past dh are
// zero-filled by the copy itself. Row strides that are not a multiple of
// 16 bytes, or an unaligned base, take element-wise loads instead.
//
// Bound: the work a chunk is a few small products and the exponentials; at
// the model's shapes a CTA is alone on its SM and the kernel is bound by
// its serial chunk walk (4 barriers a chunk) and by instruction issue in
// phase 3, not by bytes or by the tensor cores. It sums in a fixed order
// (no atomics), so two launches on the same inputs are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rwkv6_common.cuh"

namespace {

constexpr int DV_MAIN = 64;               // value columns a CTA owns (half
                                          // where they do not fit)
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_CHUNK = 64;
static_assert(THREADS >= MAX_DH, "the cumulative sum takes a thread a "
                                 "channel");

__host__ __device__ inline int tri(int a, int b) {  // X[a][b], b < a
  return a * (a - 1) / 2 + b;
}

// Byte offsets into shared memory, for dp channels (dh rounded up to 16),
// npc chunk rows (chunk rounded up to 16), esz bytes a value of r, k, v,
// dv value columns.
struct Layout {
  int ldv;                   // a v row in the stage, elements
  int stage;                 // bytes of one chunk buffer
  int r, k, v, lw;           // offsets within a chunk buffer
  int rf, kf, a, s, u, lb, lh, x;
  int bytes;                 // in all
};

__host__ __device__ inline Layout make_layout(int dp, int npc, int esz,
                                              int stages, int sbufs,
                                              int dv) {
  Layout L;
  // v rows of 8 (mod 16) words: the fragment reads of 4 k-rows x 8
  // columns fall in 32 distinct banks
  const int words = dv * esz / 4;
  L.ldv = (words + (24 - words % 16) % 16) * 4 / esz;
  L.r = 0;
  L.k = L.r + npc * dp * esz;
  L.v = L.k + npc * dp * esz;
  L.lw = L.v + npc * L.ldv * esz;
  L.stage = L.lw + npc * dp * 4;
  int o = stages * L.stage;
  L.rf = o;  o += npc * (dp + 4) * 4;     // rows of 4 (mod 8) words
  L.kf = o;  o += npc * (dp + 8) * 4;     // rows of 8 (mod 16) words
  L.a = o;   o += npc * (npc + 4) * 4;
  L.s = o;   o += sbufs * dp * (dv + 8) * 4;
  L.u = o;   o += dp * 4;
  const int ns = npc / SUB;
  L.lb = o;  o += (ns + 1) * dp * 4;
  L.lh = o;  o += npc / 8 * dp * 4;
  L.x = o;   o += ns * (ns + 1) / 2 * dp * 4;
  L.bytes = o;
  return L;
}

template <typename T>
struct Args {
  const T* r;
  const T* k;
  const T* v;
  const float* lw;
  const float* u;
  const float* s0;
  float* o;
  float* s_out;
  int H, L, D, C, dp, npc, nv, stages, sbufs, vec;
  Layout lay;
};

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// G = 4 consecutive values (aligned to 4 elements) as fp32
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x;
  o[1] = a.y;
  o[2] = a.z;
  o[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&o)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(a.x << 16);
  o[1] = __uint_as_float(a.x & 0xffff0000u);
  o[2] = __uint_as_float(a.y << 16);
  o[3] = __uint_as_float(a.y & 0xffff0000u);
}

// c += a b at fp32 accuracy: the small terms first, then hi * hi; a bf16 b
// (B_EXACT) has no low part
template <bool B_EXACT>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(c, al, bh[0], bh[1]);
  if (!B_EXACT) mma(c, ah, bl[0], bl[1]);
  mma(c, ah, bh[0], bh[1]);
}

// the B fragment of v (k = chunk rows j0.., n = columns n0..): b0 at
// (j0 + t, n0 + g), b1 at (j0 + t + 4, n0 + g)
template <typename T>
__device__ __forceinline__ void v_frag(const T* vs, int ldv, int j0, int n0,
                                       int g, int t, uint32_t (&bh)[2],
                                       uint32_t (&bl)[2]) {
  const float x0 = to_f(vs[(j0 + t) * ldv + n0 + g]);
  const float x1 = to_f(vs[(j0 + t + 4) * ldv + n0 + g]);
  split<sizeof(T) == 2>(x0, bh[0], bl[0]);
  split<sizeof(T) == 2>(x1, bh[1], bl[1]);
}

// Calls f(i, p) for rows i < np and pieces p < pieces of a tile, the
// threads dealt over (row, piece) once (no division a copy).
template <typename F>
__device__ __forceinline__ void for_pieces(int np, int pieces, F f) {
  const int rows = THREADS / pieces, i0 = threadIdx.x / pieces;
  const int p = threadIdx.x % pieces;
  if (i0 < rows)
    for (int i = i0; i < np; i += rows) f(i, p);
}

// Chunk rows t0..t0+n-1 of (b, h) into a chunk buffer: r, k and log_w
// (np x dp) and v's DV columns from e0 (np x ldv); rows n..np-1 and
// channels past D zero.
template <int DV, typename T>
__device__ void load_chunk(const Args<T>& a, uint8_t* st, int b, int h,
                           int e0, int t0, int n, int np) {
  const int D = a.D, dp = a.dp;
  T* rs = reinterpret_cast<T*>(st + a.lay.r);
  T* ks = reinterpret_cast<T*>(st + a.lay.k);
  T* vs = reinterpret_cast<T*>(st + a.lay.v);
  float* ws = reinterpret_cast<float*>(st + a.lay.lw);
  const int ldv = a.lay.ldv;
  const size_t row0 = ((size_t)b * a.L + t0) * a.H + h;  // (b, t0, h)
  const size_t rstep = (size_t)a.H * D;                 // a row of T
  if (a.vec) {
    constexpr int E = 16 / sizeof(T);
    for_pieces(np, dp / E, [&](int i, int p) {
      const int c = p * E;
      const bool ok = i < n && c < D;
      const size_t gi = row0 * D + i * rstep + c;
      cp_async<16>(rs + i * dp + c, ok ? a.r + gi : a.r, ok);
      cp_async<16>(ks + i * dp + c, ok ? a.k + gi : a.k, ok);
    });
    for_pieces(np, DV / E, [&](int i, int p) {
      const int c = p * E;
      const bool ok = i < n && e0 + c < D;
      const size_t gi = row0 * D + i * rstep + e0 + c;
      cp_async<16>(vs + i * ldv + c, ok ? a.v + gi : a.v, ok);
    });
    for_pieces(np, dp / 4, [&](int i, int p) {
      const int c = p * 4;
      const bool ok = i < n && c < D;
      const size_t gi = row0 * D + i * rstep + c;
      cp_async<16>(ws + i * dp + c, ok ? a.lw + gi : a.lw, ok);
    });
  } else {
    for (int idx = threadIdx.x; idx < np * dp; idx += THREADS) {
      const int i = idx / dp, c = idx % dp;
      const bool ok = i < n && c < D;
      const size_t gi = row0 * D + i * rstep + c;
      rs[i * dp + c] = ok ? a.r[gi] : zero<T>();
      ks[i * dp + c] = ok ? a.k[gi] : zero<T>();
      ws[i * dp + c] = ok ? a.lw[gi] : 0.f;
    }
    for (int idx = threadIdx.x; idx < np * DV; idx += THREADS) {
      const int i = idx / DV, c = idx % DV;
      const bool ok = i < n && e0 + c < D;
      const size_t gi = row0 * D + i * rstep + e0 + c;
      vs[i * ldv + c] = ok ? a.v[gi] : zero<T>();
    }
  }
}

// c = (sum of the even accumulator pair) + (the odd pair): the products'
// k-steps alternate between two chains, each with its low-part passes
// apart from its hi*hi pass, so 4 mma chains run at once (the parity must
// be a constant after unrolling, or the accumulators go to local memory)
struct Acc4 {
  float c[2][2][4];   // [k-step parity][0: hi*hi, 1: low parts][fragment]
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 16; ++i) (&c[0][0][0])[i] = 0.f;
  }
  template <bool B_EXACT>
  __device__ __forceinline__ void add(int par, const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4],
                                      const uint32_t (&bh)[2],
                                      const uint32_t (&bl)[2]) {
    mma(c[par][1], al, bh[0], bh[1]);
    if (!B_EXACT) mma(c[par][1], ah, bl[0], bl[1]);
    mma(c[par][0], ah, bh[0], bh[1]);
  }
  __device__ __forceinline__ float get(int i) const {
    return (c[0][1][i] + c[0][0][i]) + (c[1][1][i] + c[1][0][i]);
  }
};

// The diagonal blocks: a block's 16 key rows j, each shared by P adjacent
// lanes that split its channels (G-channel groups part, part + P, ...), so
// that a chunk of 2 sub-chunks gives every thread one key row.
constexpr int P = WARPS;                  // lanes a key row
constexpr int G = 4;                      // channels a group
constexpr int MAXG = MAX_DH / G / P;      // groups a lane
static_assert(P == 16, "the reduce-scatter takes 16 lanes a key row");

// ---------------------------------------------------------------------------
// the kernel: one CTA per (b, h, block of DV value columns)
// ---------------------------------------------------------------------------
template <typename T, int DV>
__global__ void __launch_bounds__(THREADS)
rwkv6_kernel(const Args<T> a) {
  constexpr bool V_EXACT = sizeof(T) == 2;
  constexpr int NT = DV / 8;                 // n8 tiles across DV columns
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout& L = a.lay;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / a.nv, e0 = blockIdx.x % a.nv * DV;
  const int b = bh / a.H, h = bh % a.H;
  const int D = a.D, dp = a.dp;
  const int ldrf = dp + 4, ldkf = dp + 8, lda = a.npc + 4, lds = DV + 8;
  const int ldv = L.ldv;
  float* rf = reinterpret_cast<float*>(smem + L.rf);
  float* kf = reinterpret_cast<float*>(smem + L.kf);
  float* A = reinterpret_cast<float*>(smem + L.a);
  float* us = reinterpret_cast<float*>(smem + L.u);
  float* lb = reinterpret_cast<float*>(smem + L.lb);
  float* lh = reinterpret_cast<float*>(smem + L.lh);
  float* x = reinterpret_cast<float*>(smem + L.x);

  // S (dp x DV) lives in shared memory, in two buffers where they fit (a
  // chunk reads the one its predecessor wrote and writes the other), else
  // in one updated in place
  const float* s0 = a.s0 ? a.s0 + (size_t)bh * D * D : nullptr;
  {
    float* S = reinterpret_cast<float*>(smem + L.s);
    for (int idx = tid; idx < dp * DV; idx += THREADS) {
      const int d = idx / DV, e = idx % DV;
      S[d * lds + e] =
          s0 && d < D && e0 + e < D ? s0[(size_t)d * D + e0 + e] : 0.f;
    }
  }
  for (int d = tid; d < dp; d += THREADS)
    us[d] = d < D ? a.u[(size_t)h * D + d] : 0.f;

  const bool s2 = a.sbufs == 2;
  const int nch = (a.L + a.C - 1) / a.C;
  const int n0 = min(a.C, a.L);
  load_chunk<DV>(a, smem, b, h, e0, 0, n0, round16(n0));
  cp_commit();
  for (int c = 0; c < nch; ++c) {
    const int t0 = c * a.C, n = min(a.C, a.L - t0);
    const int np = round16(n), ns = np / SUB;
    const int n1 = c + 1 < nch ? min(a.C, a.L - t0 - a.C) : 0;
    uint8_t* st = smem + (a.stages == 2 ? (c & 1) : 0) * L.stage;
    uint8_t* st1 = smem + (a.stages == 2 ? (c + 1) & 1 : 0) * L.stage;
    float* S = reinterpret_cast<float*>(
        smem + L.s + (s2 ? c & 1 : 0) * dp * lds * 4);
    float* Snew = reinterpret_cast<float*>(
        smem + L.s + (s2 ? (c + 1) & 1 : 0) * dp * lds * 4);
    cp_wait<0>();
    __syncthreads();  // this chunk's rows and S are in place; the other
                      // chunk buffer and S buffer are free
    if (a.stages == 2 && n1 > 0) {
      load_chunk<DV>(a, st1, b, h, e0, t0 + a.C, n1, round16(n1));
      cp_commit();
    }
    const T* rs = reinterpret_cast<const T*>(st + L.r);
    const T* ks = reinterpret_cast<const T*>(st + L.k);
    const T* vs = reinterpret_cast<const T*>(st + L.v);
    float* ws = reinterpret_cast<float*>(st + L.lw);

    // 1. le = the inclusive cumulative sum of log_w, in place, in row
    // order per channel; le at every 8th row's end (LH) and at the
    // boundaries (LB[a] = le at B_a); the table X[a][b] = exp(LB[a] -
    // LB[b]) for b < a <= ns
    if (tid < dp) {
      const int d = tid;
      float acc = 0.f;
      for (int i0 = 0; i0 < np; i0 += SUB) {
        float l[SUB];
#pragma unroll
        for (int ii = 0; ii < SUB; ++ii) l[ii] = ws[(i0 + ii) * dp + d];
#pragma unroll
        for (int ii = 0; ii < SUB; ++ii) {
          acc += l[ii];
          ws[(i0 + ii) * dp + d] = acc;
          if (ii == 7) lh[(i0 / 8) * dp + d] = acc;
        }
        lb[(i0 / SUB + 1) * dp + d] = acc;
        lh[(i0 / 8 + 1) * dp + d] = acc;
      }
      lb[d] = 0.f;
      for (int p = 1; p <= ns; ++p) {
        const float lp = lb[p * dp + d];
        for (int q = 0; q < p; ++q)
          x[tri(p, q) * dp + d] = ex(lp - lb[q * dp + d]);
      }
    }
    __syncthreads();

    // 2. the factors Rf and Kf and the steps' decays exp(le_i - le_{i-1})
    // in place of le, a task per (channel, 8 rows); le before a task's
    // rows comes from LH, which nobody overwrites
    for (int task = tid; task < dp * (np / 8); task += THREADS) {
      const int d = task % dp, i0 = task / dp * 8, I = i0 / SUB;
      const float lbi = lb[I * dp + d], lq = lb[(I + 1) * dp + d];
      float le[9], rv[8], kv[8];
      le[0] = i0 % SUB ? lh[(i0 / 8 - 1) * dp + d] : 0.f;
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        le[ii + 1] = ws[(i0 + ii) * dp + d];
        rv[ii] = to_f(rs[(i0 + ii) * dp + d]);
        kv[ii] = to_f(ks[(i0 + ii) * dp + d]);
      }
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const int i = i0 + ii;
        ws[i * dp + d] = ex(le[ii + 1] - le[ii]);
        rf[i * ldrf + d] = rv[ii] * ex(le[ii + 1] - lbi);
        kf[i * ldkf + d] = kv[ii] * ex(lq - le[ii + 1]);
      }
    }
    __syncthreads();

    // The work beside the diagonal blocks goes first to the warps that
    // skip most of theirs: a block's WARPS / 2 warps hold key rows in
    // order, so a warp's rank is its block's last first. Items of a kind
    // with offset `off` go to ranks off, off + 1, ... (mod WARPS).
    const int rank = 2 * (WARPS / 2 - 1 - warp % (WARPS / 2)) +
                     warp / (WARPS / 2);
    auto dealt = [&](int off) { return (rank - off + WARPS) % WARPS; };
    // 4a. Snew = X[ns][0] * S + sum_J (Kf_J * X[ns][J+1])^T V_J, an item
    // per 16 rows d x 32 columns, as mma accumulators (d0 + g (+8),
    // n0 + nt*8 + 2t (+1)); each thread reads and writes only its own
    // elements, so Snew may be S
    constexpr int SNT = NT < 4 ? NT : 4;          // n8 tiles an S item
    const float* xdec = x + tri(ns, 0) * dp;
    auto update_state = [&](int first) {   // items first, first + WARPS..
      for (int item = first; item < dp / 16 * (NT / SNT); item += WARPS) {
        const int d0 = item / (NT / SNT) * 16;
        const int n0 = item % (NT / SNT) * SNT * 8;
        const float dec0 = xdec[d0 + g], dec1 = xdec[d0 + g + 8];
        float sacc[SNT][4];
#pragma unroll
        for (int nt = 0; nt < SNT; ++nt) {
          const float* sp = S + (d0 + g) * lds + n0 + nt * 8 + 2 * t;
          sacc[nt][0] = sp[0] * dec0;
          sacc[nt][1] = sp[1] * dec0;
          sacc[nt][2] = sp[8 * lds] * dec1;
          sacc[nt][3] = sp[8 * lds + 1] * dec1;
        }
        for (int j0 = 0; j0 < np; j0 += 8) {
          const int J = j0 >> 4;
          const float* gx = J == ns - 1 ? nullptr : x + tri(ns, J + 1) * dp;
          const float G0 = gx ? gx[d0 + g] : 1.f;
          const float G1 = gx ? gx[d0 + g + 8] : 1.f;
          const float* kr = kf + (j0 + t) * ldkf + d0 + g;
          uint32_t ah[4], al[4];
          split(kr[0] * G0, ah[0], al[0]);              // (d0+g, j0+t)
          split(kr[8] * G1, ah[1], al[1]);              // (d0+g+8, j0+t)
          split(kr[4 * ldkf] * G0, ah[2], al[2]);       // (d0+g, j0+t+4)
          split(kr[4 * ldkf + 8] * G1, ah[3], al[3]);   // (d0+g+8, j0+t+4)
#pragma unroll
          for (int nt = 0; nt < SNT; ++nt) {
            uint32_t bh[2], bl[2];
            v_frag(vs, ldv, j0, n0 + nt * 8, g, t, bh, bl);
            mma3<V_EXACT>(sacc[nt], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int nt = 0; nt < SNT; ++nt) {
          float* sp = Snew + (d0 + g) * lds + n0 + nt * 8 + 2 * t;
          sp[0] = sacc[nt][0];
          sp[1] = sacc[nt][1];
          sp[8 * lds] = sacc[nt][2];
          sp[8 * lds + 1] = sacc[nt][3];
        }
      }
    };
    // 3a. off-diagonal score blocks (I, J < I), a 16 x 8 half each, over
    // the even or the odd 16-channel steps: Rf_I (Kf_J * X[I][J+1])^T. The
    // even half lands in block (I, J) of A, the odd one in block (J, I),
    // which causality leaves free; 4b adds them.
    const int nblk = ns * (ns - 1) / 2;
    for (int item = dealt(8); item < 4 * nblk; item += WARPS) {
      int I = 1, J = item >> 2;
      while (J >= I) {
        J -= I;
        ++I;
      }
      const int kh = item >> 1 & 1;
      const int j0 = J * SUB + (item & 1) * 8;
      const float* gx = J + 1 == I ? nullptr : x + tri(I, J + 1) * dp;
      const float* ar = rf + (I * SUB + g) * ldrf;
      const float* bk = kf + (j0 + g) * ldkf;
      Acc4 acc;
      acc.zero();
      for (int k0 = 16 * kh; k0 < dp; k0 += 32) {
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const int d0 = k0 + 8 * par;
          uint32_t ah[4], al[4], bh[2], bl[2];
          split(ar[d0 + t], ah[0], al[0]);
          split(ar[8 * ldrf + d0 + t], ah[1], al[1]);
          split(ar[d0 + t + 4], ah[2], al[2]);
          split(ar[8 * ldrf + d0 + t + 4], ah[3], al[3]);
          const float g0 = gx ? gx[d0 + t] : 1.f;
          const float g1 = gx ? gx[d0 + t + 4] : 1.f;
          split(bk[d0 + t] * g0, bh[0], bl[0]);
          split(bk[d0 + t + 4] * g1, bh[1], bl[1]);
          acc.add<false>(par, ah, al, bh, bl);
        }
      }
      float* ap = kh ? A + (J * SUB + g) * lda + I * SUB + (item & 1) * 8
                           + 2 * t
                     : A + (I * SUB + g) * lda + j0 + 2 * t;
      ap[0] = acc.get(0);
      ap[1] = acc.get(1);
      ap[8 * lda] = acc.get(2);
      ap[8 * lda + 1] = acc.get(3);
    }
    // 3b. diagonal blocks, pairwise: lane (j, part) holds k_j (times the
    // decay so far) on its part's channel groups and walks the block's 16
    // rows i, fully unrolled (rows up to j give the bonus or 0; rows up to
    // the warp's first key row are skipped); the P lanes of a j
    // reduce-scatter the 16 sums. Whole warps take a task (ns * 16 * P of
    // them).
    for (int task = tid; task < ns * SUB * P; task += THREADS) {
      const int I = task / (SUB * P), jl = task / P % SUB, part = task % P;
      const int j = I * SUB + jl;
      // the warp's first key row: no lane of the warp needs a row above it
      const int jw = __shfl_sync(0xffffffffu, jl, 0);
      float kd[MAXG][G];
      float bonus = 0.f;
#pragma unroll
      for (int m = 0; m < MAXG; ++m) {
        const int c0 = (part + P * m) * G;
        if (c0 < dp) {
          float rj[G];
          load4(ks + j * dp + c0, kd[m]);
          load4(rs + j * dp + c0, rj);
#pragma unroll
          for (int e = 0; e < G; ++e) bonus += rj[e] * us[c0 + e] * kd[m][e];
        }
      }
      float sums[SUB];
#pragma unroll
      for (int ii = 0; ii < SUB; ++ii) {
        const int i = I * SUB + ii;
        const bool after = ii > jl;
        float s0_ = 0.f, s1_ = 0.f;
#pragma unroll
        for (int m = 0; m < MAXG; ++m) {
          const int c0 = (part + P * m) * G;
          if (ii > jw && c0 < dp) {   // warp-uniform in ii
            float ri[G], wi[G];
            load4(rs + i * dp + c0, ri);
            load4(ws + i * dp + c0, wi);
#pragma unroll
            for (int e = 0; e < G; ++e) {
              kd[m][e] *= after ? wi[e] : 1.f;
              const float q = ri[e] * kd[m][e];
              if (e & 1) s1_ += q;
              else s0_ += q;
            }
          }
        }
        sums[ii] = ii > jl ? s0_ + s1_ : (ii == jl ? bonus : 0.f);
      }
      scatter_sum(sums, part);
#pragma unroll
      for (int k = 0; k < SUB / P; ++k)
        A[(I * SUB + SUB / P * part + k) * lda + j] = sums[k];
    }
    if (s2) update_state(dealt(0));
    // 4b, first half: o_I = (Rf_I * X[I][0]) S, a 16 x 16 tile an item
    // (at most MAXI a warp), into registers; it needs no scores, so it
    // runs beside them, as does S' where S is double-buffered
    constexpr int MAXI = (MAX_CHUNK / SUB * (DV / 16) + WARPS - 1) / WARPS;
    const int nitem = ns * (DV / 16);
    Acc4 oacc[MAXI][2];
#pragma unroll
    for (int q = 0; q < MAXI; ++q) {
      const int item = dealt(0) + WARPS * q;
      if (item < nitem) {
        const int it = item / (DV / 16), n0 = item % (DV / 16) * 16;
        Acc4 (&acc)[2] = oacc[q];
        acc[0].zero();
        acc[1].zero();
        const float* hx = it == 0 ? nullptr : x + tri(it, 0) * dp;
        const float* rr = rf + (it * SUB + g) * ldrf;
        for (int k0 = 0; k0 < dp; k0 += 16) {
#pragma unroll
          for (int par = 0; par < 2; ++par) {
            const int d0 = k0 + 8 * par;
            const float h0 = hx ? hx[d0 + t] : 1.f;
            const float h1 = hx ? hx[d0 + t + 4] : 1.f;
            uint32_t ah[4], al[4];
            split(rr[d0 + t] * h0, ah[0], al[0]);
            split(rr[8 * ldrf + d0 + t] * h0, ah[1], al[1]);
            split(rr[d0 + t + 4] * h1, ah[2], al[2]);
            split(rr[8 * ldrf + d0 + t + 4] * h1, ah[3], al[3]);
#pragma unroll
            for (int nn = 0; nn < 2; ++nn) {
              const int e = n0 + nn * 8 + g;
              uint32_t bh[2], bl[2];
              split(S[(d0 + t) * lds + e], bh[0], bl[0]);
              split(S[(d0 + t + 4) * lds + e], bh[1], bl[1]);
              acc[nn].add<false>(par, ah, al, bh, bl);
            }
          }
        }
      }
    }
    __syncthreads();  // the scores are in place; S is read
    if (!s2) update_state(warp);
    // 4b, second half: o_I += A_I V, and the store
#pragma unroll
    for (int q = 0; q < MAXI; ++q) {
      const int item = dealt(0) + WARPS * q;
      if (item < nitem) {
        const int it = item / (DV / 16), n0 = item % (DV / 16) * 16;
        Acc4 (&acc)[2] = oacc[q];
        const float* ar = A + (it * SUB + g) * lda;
        for (int k0 = 0; k0 < (it + 1) * SUB; k0 += 16) {
          // the odd channel half of off-diagonal block (it, k0 / 16), at
          // block (k0 / 16, it); none on the diagonal
          const float* ar2 =
              k0 < it * SUB ? A + (k0 + g) * lda + it * SUB - k0 : nullptr;
#pragma unroll
          for (int par = 0; par < 2; ++par) {
            const int j0 = k0 + 8 * par;
            float a4[4] = {ar[j0 + t], ar[8 * lda + j0 + t], ar[j0 + t + 4],
                           ar[8 * lda + j0 + t + 4]};
            if (ar2) {
              a4[0] += ar2[j0 + t];
              a4[1] += ar2[8 * lda + j0 + t];
              a4[2] += ar2[j0 + t + 4];
              a4[3] += ar2[8 * lda + j0 + t + 4];
            }
            uint32_t ah[4], al[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) split(a4[q], ah[q], al[q]);
#pragma unroll
            for (int nn = 0; nn < 2; ++nn) {
              uint32_t bh[2], bl[2];
              v_frag(vs, ldv, j0, n0 + nn * 8, g, t, bh, bl);
              acc[nn].add<V_EXACT>(par, ah, al, bh, bl);
            }
          }
        }
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          const int col = e0 + n0 + nn * 8 + 2 * t;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = it * SUB + g + half * 8;
            if (i < n) {
              float* op =
                a.o + (((size_t)b * a.L + t0 + i) * a.H + h) * D + col;
              if (col < D) op[0] = acc[nn].get(2 * half);
              if (col + 1 < D) op[1] = acc[nn].get(2 * half + 1);
            }
          }
        }
      }
    }
    if (a.stages == 1 && n1 > 0) {
      __syncthreads();  // every read of the one chunk buffer is done
      load_chunk<DV>(a, smem, b, h, e0, t0 + a.C, n1, round16(n1));
      cp_commit();
    }
  }

  __syncthreads();
  const float* S = reinterpret_cast<const float*>(
      smem + L.s + (a.sbufs == 2 ? nch & 1 : 0) * dp * lds * 4);
  float* so = a.s_out + (size_t)bh * D * D;
  for (int idx = tid; idx < dp * DV; idx += THREADS) {
    const int d = idx / DV, e = idx % DV;
    if (d < D && e0 + e < D) so[(size_t)d * D + e0 + e] = S[d * lds + e];
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// value columns a CTA (DV_MAIN, or half where that does not fit), chunk
// buffers and S buffers (2 of each where they fit, else 1 of S, else 1 of
// each)
struct Form {
  int dv, stages, sbufs;
  Layout lay;
};

Form form_for(int dp, int npc, int esz) {
  Form f;
  for (f.dv = DV_MAIN; f.dv >= DV_MAIN / 2; f.dv /= 2)
    for (f.stages = 2; f.stages >= 1; --f.stages)
      for (f.sbufs = 2; f.sbufs >= 1; --f.sbufs) {
        f.lay = make_layout(dp, npc, esz, f.stages, f.sbufs, f.dv);
        if (f.lay.bytes <= MAX_SMEM) return f;
      }
  return f;  // too large: launch refuses it
}

template <typename T, int DV>
cudaError_t set_smem_attr() {
  // the attribute holds per device; set once on each (setting it twice
  // from two threads is harmless)
  static bool attr_set[64];
  int device = -1;
  if (cudaGetDevice(&device) != cudaSuccess) device = -1;
  if (device >= 0 && device < 64 && attr_set[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      rwkv6_kernel<T, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (err == cudaSuccess && device >= 0 && device < 64)
    attr_set[device] = true;
  return err;
}

template <typename T, int DV>
cudaError_t launch_dv(const Args<T>& a, int grid, cudaStream_t stream) {
  const cudaError_t attr = set_smem_attr<T, DV>();
  if (attr != cudaSuccess) return attr;
  rwkv6_kernel<T, DV><<<grid, THREADS, a.lay.bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* log_w,
           const float* u, const float* s0, float* o, float* s_out, int B,
           int L, int H, int D, int C, cudaStream_t stream) {
  Args<T> a;
  a.r = static_cast<const T*>(r);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.lw = log_w;
  a.u = u;
  a.s0 = s0;
  a.o = o;
  a.s_out = s_out;
  a.H = H;
  a.L = L;
  a.D = D;
  a.C = C;
  a.dp = round16(D);
  a.npc = round16(C);
  const Form f = form_for(a.dp, a.npc, sizeof(T));
  if (f.lay.bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  a.nv = (D + f.dv - 1) / f.dv;
  a.stages = f.stages;
  a.sbufs = f.sbufs;
  a.lay = f.lay;
  a.vec = (D * (int)sizeof(T)) % 16 == 0 && D % 4 == 0 && aligned16(r) &&
          aligned16(k) && aligned16(v) && aligned16(log_w);
  const int grid = B * H * a.nv;
  const cudaError_t err = f.dv == DV_MAIN
                              ? launch_dv<T, DV_MAIN>(a, grid, stream)
                              : launch_dv<T, DV_MAIN / 2>(a, grid, stream);
  return static_cast<int>(err);
}

template <typename T, int DV>
int form_dv(const Form& f, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, rwkv6_kernel<T, DV>);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem_attr<T, DV>();
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rwkv6_kernel<T, DV>, THREADS, f.lay.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = THREADS;
  out[1] = attr.numRegs;
  out[2] = f.lay.bytes;
  out[3] = per_sm;
  out[4] = f.stages;
  out[5] = DV;
  out[6] = static_cast<int>(attr.localSizeBytes);
  out[7] = f.sbufs;
  return 0;
}

template <typename T>
int form(int D, int C, int* out) {
  const Form f = form_for(round16(D), round16(C), sizeof(T));
  if (f.lay.bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  return f.dv == DV_MAIN ? form_dv<T, DV_MAIN>(f, out)
                         : form_dv<T, DV_MAIN / 2>(f, out);
}

}  // namespace

extern "C" {

int rwkv6_max_head_dim() { return MAX_DH; }
int rwkv6_max_chunk() { return MAX_CHUNK; }
int rwkv6_value_block() { return DV_MAIN; }

// The kernel's form for head dim D and chunk C, bf16 (bf16 != 0) or fp32
// r, k, v, into out[8]: threads a CTA, registers a thread, dynamic shared
// memory bytes, CTAs an SM holds, chunk buffers, value columns a CTA, local
// (spilled) bytes a thread, S buffers. Returns 0 or a cudaError_t.
// rwkv6_value_block() is the value columns a CTA takes where they fit.
int rwkv6_form(int D, int C, int bf16, int* out) {
  if (D < 1 || D > MAX_DH || C < 1 || C > MAX_CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? form<__nv_bfloat16>(D, C, out) : form<float>(D, C, out);
}

// r, k, v: (B, L, H, D) bf16 (bf16 != 0) or fp32; log_w: (B, L, H, D) fp32;
// u: (H, D) fp32; s0: (B, H, D, D) fp32 or null for zeros. Writes o
// (B, L, H, D) fp32 and s_out (B, H, D, D) fp32. All contiguous.
int rwkv6_forward(const void* r, const void* k, const void* v,
                  const void* log_w, const void* u, const void* s0, void* o,
                  void* s_out, int B, int L, int H, int D, int C, int bf16,
                  void* stream) {
  if (D < 1 || D > MAX_DH || C < 1 || C > MAX_CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto lw = static_cast<const float*>(log_w);
  auto up = static_cast<const float*>(u);
  auto sp = static_cast<const float*>(s0);
  auto op = static_cast<float*>(o);
  auto so = static_cast<float*>(s_out);
  if (bf16)
    return launch<__nv_bfloat16>(r, k, v, lw, up, sp, op, so, B, L, H, D, C,
                                 s);
  return launch<float>(r, k, v, lw, up, sp, op, so, B, L, H, D, C, s);
}

const char* rwkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
