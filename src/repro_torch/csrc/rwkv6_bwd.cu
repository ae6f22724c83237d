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
// The last needs S_{t-1} and G_{t-1} at the same step, while S runs
// forward in time and G backward, and S_{t-1} cannot be recovered from
// S_t by dividing by w_t (the decays reach exp(-e^4) and underflow). So
// the kernel splits G = G^o + G^S: G^o from the outputs' gradients
// (G^o_{T-1} = 0) and G^S_t = diag(exp(L_{T-1} - L_t)) dS_final (L the
// inclusive cumulative log decay). For G^o the two recurrences give
//
//   phi_{t-1} = phi_t + r_t * dr'_t - k_t * (G^o_t v_t),   phi_{T-1} = 0
//
// with phi_t = rowsum(G^o_t * S_t) and dr'_t = w_t * (S_{t-1} do_t); for
// G^S the term is exp(L_{T-1} - L_{t-1}) * rowsum(dS_final * S_{t-1}).
// Every exponent is <= 0, and every term of phi is of the size of the
// decays it carries, so dlog_w keeps its relative accuracy where the
// decays are steep (a recursion over all of G would cancel terms of size
// |dS_final| |S_T| down to a gradient of size exp(-54.6)).
//
// The work, per (b, h): a forward walk over T that recomputes S from s0
// and writes dr'_t (into dlog_w's buffer) and rowsum(dS_final * S_{t-1})
// (into a scratch buffer, only where dS_final is given); then a reverse
// walk over T that carries G^o, phi and the log decay summed since T - 1,
// and writes dr, dk, dv, dlog_w, and at the end ds0 and its row of du.
//
// Layout: one CTA per (b, h), 4 x DP threads (DP = dh rounded up to 32,
// 64 or 128): thread (d, q) owns row d of S or G^o and columns q, q + 4,
// q + 8, ... (DP / 4 of them, in registers). A product along a row
// (S do_t, G^o v_t) is a thread's sum and two shuffles within its 4
// lanes; the product down the columns (G^T k_t) is reduce-scattered
// within the warp (3 halving shuffle rounds over its 8 rows) and summed
// over the warps through shared memory, in warp order. The rows of
// r, k, v, log_w, do and the forward walk's buffers stream through a
// ring of two stages of NS steps in shared memory, each thread loading
// the next stage into registers while the current one is walked. One
// block barrier a reverse step (the column sums), none a forward step.
//
// Bound: the work is about 12 dh^2 fp32 operations and 40 bytes of rows a
// step; at rwkv6-1.6b's training shape (B 8, T 128, H 32, dh 64) the
// fp32 operations bound it. A sequential walk is the simple form: its
// time is the latency of T dependent steps, not the card's rate (the
// tensor-core form of a chunked backward is later work). Every sum runs
// in a fixed order (no atomics), so two launches are bit-equal; the
// kernel neither allocates nor synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_DH = 128;
constexpr int MAX_SMEM = 232448;  // an H100 block's shared memory
constexpr unsigned FULL = 0xffffffffu;

// the arrays of a stage, each NS rows of DP floats
enum { A_R, A_K, A_V, A_LW, A_DO, A_DRP, A_RHO, NARR };

template <int DP>
struct Shape {
  static constexpr int THREADS = 4 * DP;
  static constexpr int N = DP / 4;          // columns a thread
  static constexpr int WARPS = THREADS / 32;
  static constexpr int NS = DP == 128 ? 8 : 16;   // steps a stage
  static constexpr int LPA = NS / 4;        // loads a thread, per array
  static constexpr int STAGE = NARR * NS * DP;    // floats of a stage
  // two stages, two buffers of the warps' column sums, u
  static constexpr int SMEM = (2 * STAGE + 2 * WARPS * DP + DP) * 4;
};

template <typename T>
struct Args {
  const T* r;
  const T* k;
  const T* v;
  const float* lw;
  const float* u;
  const float* s0;   // or null: zeros
  const float* dout;
  const float* ds;   // or null: zeros
  T* dr;
  T* dk;
  T* dv;
  float* dlw;        // the forward walk's dr' first, then dlog_w
  float* du_rows;    // (B, H, D): each (b, h)'s sum over T
  float* ds0;
  float* rho;        // (B, T, H, D) scratch where ds is given
  int H, L, D;   // heads, steps, head dim
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the sum over a row's 4 lanes, equal in all four
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// One halving round of the warp's column sums: v[0, M/2) becomes this
// lane's half (the upper one where `upper`) of v plus the partner's.
template <int M>
__device__ __forceinline__ void halve(float* v, int mask, bool upper) {
#pragma unroll
  for (int j = 0; j < M / 2; ++j) {
    const float send = upper ? v[j] : v[j + M / 2];
    const float keep = upper ? v[j + M / 2] : v[j];
    v[j] = keep + __shfl_xor_sync(FULL, send, mask);
  }
}

// element (b, t, h, e) of a (B, T, H, D) array
__device__ __forceinline__ size_t at(int b, int t, int h, int e, int T,
                                     int H, int D) {
  return (((size_t)b * T + t) * H + h) * D + e;
}

// The stage of steps [t0, t0 + NS) of the arrays in `arrays` (a bit per
// array) into registers: thread tid loads column tid % DP of steps
// tid / DP + 4 j. Steps past T and columns past D are 0.
template <typename T, int DP>
__device__ __forceinline__ void fetch(const Args<T>& a, int b, int h, int t0,
                                      unsigned arrays,
                                      float (&x)[NARR][Shape<DP>::LPA]) {
  using S = Shape<DP>;
  const int e = threadIdx.x % DP, s0 = threadIdx.x / DP;
#pragma unroll
  for (int j = 0; j < S::LPA; ++j) {
    const int t = t0 + s0 + 4 * j;
    const bool ok = t < a.L && e < a.D;
    const size_t g = ok ? at(b, t, h, e, a.L, a.H, a.D) : 0;
    x[A_R][j] = (arrays >> A_R & 1) && ok ? to_f(a.r[g]) : 0.f;
    x[A_K][j] = (arrays >> A_K & 1) && ok ? to_f(a.k[g]) : 0.f;
    x[A_V][j] = (arrays >> A_V & 1) && ok ? to_f(a.v[g]) : 0.f;
    x[A_LW][j] = (arrays >> A_LW & 1) && ok ? a.lw[g] : 0.f;
    x[A_DO][j] = (arrays >> A_DO & 1) && ok ? a.dout[g] : 0.f;
    // written by this CTA's forward walk: plain (coherent) loads
    x[A_DRP][j] = (arrays >> A_DRP & 1) && ok ? a.dlw[g] : 0.f;
    x[A_RHO][j] = (arrays >> A_RHO & 1) && ok ? a.rho[g] : 0.f;
  }
}

template <int DP>
__device__ __forceinline__ void stash(float* stage,
                                      const float (&x)[NARR][Shape<DP>::LPA],
                                      unsigned arrays) {
  using S = Shape<DP>;
  const int e = threadIdx.x % DP, s0 = threadIdx.x / DP;
#pragma unroll
  for (int arr = 0; arr < NARR; ++arr) {
    if (!(arrays >> arr & 1)) continue;
#pragma unroll
    for (int j = 0; j < S::LPA; ++j)
      stage[(arr * S::NS + s0 + 4 * j) * DP + e] = x[arr][j];
  }
}

template <typename T, int DP, bool HAS_DS>
__global__ void __launch_bounds__(Shape<DP>::THREADS)
rwkv6_bwd_kernel(const Args<T> a) {
  using S = Shape<DP>;
  constexpr int N = S::N, NS = S::NS;
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                          // 2 x STAGE
  float* red = smem + 2 * S::STAGE;              // 2 x WARPS x DP
  float* us = red + 2 * S::WARPS * DP;           // DP

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = tid >> 2, q = tid & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int L = a.L, H = a.H, D = a.D;
  const bool row_ok = d < D;
  const bool writer = q == 0 && row_ok;

  for (int e = tid; e < DP; e += S::THREADS)
    us[e] = e < D ? a.u[(size_t)h * D + e] : 0.f;

  // this thread's row of S (then of G^o) and of dS_final, columns q + 4 i
  float st[N], dS[N];
  const size_t mat = ((size_t)bh * D + d) * D;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = q + 4 * i;
    const bool ok = row_ok && e < D;
    st[i] = a.s0 && ok ? a.s0[mat + e] : 0.f;
    dS[i] = HAS_DS && ok ? a.ds[mat + e] : 0.f;
  }

  const int nblk = (L + NS - 1) / NS;
  float x[NARR][S::LPA];

  // ---- the forward walk: S from s0; dr'_t and rowsum(dS * S_{t-1}) ----
  constexpr unsigned FWD = 1u << A_K | 1u << A_V | 1u << A_LW | 1u << A_DO;
  fetch<T, DP>(a, b, h, 0, FWD, x);
  stash<DP>(stages, x, FWD);
  __syncthreads();
  for (int blk = 0; blk < nblk; ++blk) {
    const bool more = blk + 1 < nblk;
    if (more) fetch<T, DP>(a, b, h, (blk + 1) * NS, FWD, x);
    const float* sg = stages + (blk & 1) * S::STAGE;
    const int n = min(NS, L - blk * NS);
    for (int s = 0; s < n; ++s) {
      const int t = blk * NS + s;
      const float* kr = sg + (A_K * NS + s) * DP;
      const float* vr = sg + (A_V * NS + s) * DP;
      const float* dor = sg + (A_DO * NS + s) * DP;
      const float w = expf(sg[(A_LW * NS + s) * DP + d]);
      const float kd = kr[d];
      float p = 0.f, rho = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        p = fmaf(st[i], dor[q + 4 * i], p);
        if (HAS_DS) rho = fmaf(dS[i], st[i], rho);
      }
      p = quad_sum(p);
      if (HAS_DS) rho = quad_sum(rho);
      if (writer) {
        const size_t g = at(b, t, h, d, L, H, D);
        a.dlw[g] = w * p;
        if (HAS_DS) a.rho[g] = rho;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) st[i] = fmaf(w, st[i], kd * vr[q + 4 * i]);
    }
    if (more) stash<DP>(stages + ((blk + 1) & 1) * S::STAGE, x, FWD);
    __syncthreads();   // also: dr' and rho are written for the reverse walk
  }

  // ---- the reverse walk: G^o, phi and the log decay since T - 1 ----
  constexpr unsigned REV = 1u << A_R | 1u << A_K | 1u << A_V | 1u << A_LW |
                           1u << A_DO | 1u << A_DRP |
                           (HAS_DS ? 1u << A_RHO : 0u);
#pragma unroll
  for (int i = 0; i < N; ++i) st[i] = 0.f;   // now G^o
  float phi = 0.f, ls = 0.f, du = 0.f;
  fetch<T, DP>(a, b, h, (nblk - 1) * NS, REV, x);
  stash<DP>(stages + ((nblk - 1) & 1) * S::STAGE, x, REV);
  __syncthreads();
  int par = 0;
  for (int blk = nblk - 1; blk >= 0; --blk) {
    const bool more = blk > 0;
    if (more) fetch<T, DP>(a, b, h, (blk - 1) * NS, REV, x);
    const float* sg = stages + (blk & 1) * S::STAGE;
    const int n = min(NS, L - blk * NS);
    for (int s = n - 1; s >= 0; --s, par ^= 1) {
      const int t = blk * NS + s;
      const float* rr = sg + (A_R * NS + s) * DP;
      const float* kr = sg + (A_K * NS + s) * DP;
      const float* vr = sg + (A_V * NS + s) * DP;
      const float* dor = sg + (A_DO * NS + s) * DP;
      const float lw = sg[(A_LW * NS + s) * DP + d];
      const float drp = sg[(A_DRP * NS + s) * DP + d];
      const float w = expf(lw);
      const float ed = HAS_DS ? expf(ls) : 0.f;
      const float rd = rr[d], kd = kr[d], ud = us[d];
      float c = 0.f, ruk = 0.f, dko = 0.f, dks = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int e = q + 4 * i;
        const float ve = vr[e];
        c = fmaf(ve, dor[e], c);
        ruk = fmaf(rr[e] * us[e], kr[e], ruk);
        dko = fmaf(st[i], ve, dko);
        if (HAS_DS) dks = fmaf(dS[i], ve, dks);
      }
      c = quad_sum(c);
      ruk = quad_sum(ruk);
      dko = quad_sum(dko);
      if (HAS_DS) dks = quad_sum(dks);
      phi += rd * drp - kd * dko;
      du = fmaf(rd * kd, c, du);
      if (writer) {
        const size_t g = at(b, t, h, d, L, H, D);
        const float dkd = (HAS_DS ? fmaf(ed, dks, dko) : dko) + ud * rd * c;
        a.dk[g] = from_f<T>(dkd);
        a.dr[g] = from_f<T>(drp + ud * kd * c);
        a.dlw[g] = HAS_DS ? fmaf(expf(ls + lw), sg[(A_RHO * NS + s) * DP + d],
                                 phi)
                          : phi;
      }
      // G^T k_t down the columns: the warp's 8 rows, then the warps
      float col[N];
#pragma unroll
      for (int i = 0; i < N; ++i)
        col[i] = (HAS_DS ? fmaf(ed, dS[i], st[i]) : st[i]) * kd;
      halve<N>(col, 16, lane & 16);
      halve<N / 2>(col, 8, lane & 8);
      halve<N / 4>(col, 4, lane & 4);
      float* rp = red + par * S::WARPS * DP + warp * DP;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        rp[q + 4 * ((lane >> 2) * (N / 8) + j)] = col[j];
      __syncthreads();
      if (tid < DP && tid < D) {
        const float* rs = red + par * S::WARPS * DP + tid;
        float sum = 0.f;
        for (int wi = 0; wi < S::WARPS; ++wi) sum += rs[wi * DP];
        a.dv[at(b, t, h, tid, L, H, D)] = from_f<T>(fmaf(ruk, dor[tid], sum));
      }
      // G^o_{t-1} = w_t (G^o_t + r_t^T do_t)
#pragma unroll
      for (int i = 0; i < N; ++i) st[i] = w * fmaf(rd, dor[q + 4 * i], st[i]);
      ls += lw;
    }
    if (more) stash<DP>(stages + ((blk - 1) & 1) * S::STAGE, x, REV);
    __syncthreads();
  }

  // ds0 = G_{-1} = G^o_{-1} + exp(L_{T-1}) dS_final; this row of du
  const float ed = HAS_DS ? expf(ls) : 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = q + 4 * i;
    if (row_ok && e < D)
      a.ds0[mat + e] = HAS_DS ? fmaf(ed, dS[i], st[i]) : st[i];
  }
  if (writer) a.du_rows[(size_t)bh * D + d] = du;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <typename T, int DP, bool HAS_DS>
cudaError_t set_smem_attr() {
  // the attribute holds per device; set once on each (setting it twice
  // from two threads is harmless)
  static bool attr_set[64];
  int device = -1;
  if (cudaGetDevice(&device) != cudaSuccess) device = -1;
  if (device >= 0 && device < 64 && attr_set[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      rwkv6_bwd_kernel<T, DP, HAS_DS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Shape<DP>::SMEM);
  if (err == cudaSuccess && device >= 0 && device < 64)
    attr_set[device] = true;
  return err;
}

template <typename T, int DP, bool HAS_DS>
int launch_dp(const Args<T>& a, int grid, cudaStream_t stream) {
  static_assert(Shape<DP>::SMEM <= MAX_SMEM, "shared memory");
  const cudaError_t attr = set_smem_attr<T, DP, HAS_DS>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  rwkv6_bwd_kernel<T, DP, HAS_DS>
      <<<grid, Shape<DP>::THREADS, Shape<DP>::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int padded(int D) { return D <= 32 ? 32 : D <= 64 ? 64 : 128; }

template <typename T, bool HAS_DS>
int launch_ds(const Args<T>& a, int grid, cudaStream_t stream) {
  switch (padded(a.D)) {
    case 32: return launch_dp<T, 32, HAS_DS>(a, grid, stream);
    case 64: return launch_dp<T, 64, HAS_DS>(a, grid, stream);
    default: return launch_dp<T, 128, HAS_DS>(a, grid, stream);
  }
}

template <typename T, int DP, bool HAS_DS>
int form_dp(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr,
                                          rwkv6_bwd_kernel<T, DP, HAS_DS>);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem_attr<T, DP, HAS_DS>();
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rwkv6_bwd_kernel<T, DP, HAS_DS>, Shape<DP>::THREADS,
      Shape<DP>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = Shape<DP>::THREADS;
  out[1] = attr.numRegs;
  out[2] = Shape<DP>::SMEM;
  out[3] = per_sm;
  out[4] = Shape<DP>::NS;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

template <typename T, bool HAS_DS>
int form_ds(int D, int* out) {
  switch (padded(D)) {
    case 32: return form_dp<T, 32, HAS_DS>(out);
    case 64: return form_dp<T, 64, HAS_DS>(out);
    default: return form_dp<T, 128, HAS_DS>(out);
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* lw,
           const float* u, const float* s0, const float* dout,
           const float* ds, void* dr, void* dk, void* dv, float* dlw,
           float* du_rows, float* ds0, float* rho, int B, int L, int H,
           int D, cudaStream_t stream) {
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
  a.du_rows = du_rows;
  a.ds0 = ds0;
  a.rho = rho;
  a.H = H;
  a.L = L;
  a.D = D;
  const int grid = B * H;
  return ds ? launch_ds<T, true>(a, grid, stream)
            : launch_ds<T, false>(a, grid, stream);
}

}  // namespace

extern "C" {

int rwkv6_bwd_max_head_dim() { return MAX_DH; }

// The kernel's form at head dim D, bf16 (bf16 != 0) or fp32 r, k, v, with
// (ds != 0) or without a final state's gradient, into out[6]: threads a
// CTA, registers a thread, dynamic shared memory bytes, CTAs an SM holds,
// steps a stage, local (spilled) bytes a thread. Returns 0 or a
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
// Writes dr, dk, dv (r's type) and dlw (B, L, H, D) fp32, du_rows (B, H, D)
// fp32 (each row's sum over L), ds0 (B, H, D, D) fp32; rho (B, L, H, D)
// fp32 is scratch, needed where ds is given. All contiguous; B, L, H >= 1.
int rwkv6_backward(const void* r, const void* k, const void* v,
                   const void* log_w, const void* u, const void* s0,
                   const void* dout, const void* ds, void* dr, void* dk,
                   void* dv, void* dlw, void* du_rows, void* ds0, void* rho,
                   int B, int L, int H, int D, int bf16, void* stream) {
  if (D < 1 || D > MAX_DH || B < 1 || L < 1 || H < 1 ||
      (long long)B * H >= (1ll << 31) || (ds && !rho))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  if (bf16)
    return launch<__nv_bfloat16>(r, k, v, f(log_w), f(u), f(s0), f(dout),
                                 f(ds), dr, dk, dv, m(dlw), m(du_rows),
                                 m(ds0), m(rho), B, L, H, D, s);
  return launch<float>(r, k, v, f(log_w), f(u), f(s0), f(dout), f(ds), dr,
                       dk, dv, m(dlw), m(du_rows), m(ds0), m(rho), B, L, H,
                       D, s);
}

const char* rwkv6_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
