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
// Every exponent is <= 0: the pairwise form of the reference model's
// rwkv_chunked, never the TPU kernel's factored r*exp(le) @ (k*exp(-le))^T,
// which overflows fp32 once the decays reach the model's -e^4.
//
// On the TPU the chunks were a sequential grid axis with S in VMEM scratch;
// here one CTA owns one (b, h), keeps S (dh x dh) in shared memory and walks
// the chunks in order. A ragged last chunk runs with its n < C rows. The
// work per chunk is a few small products (C x C x dh and C x dh x dh) and
// C*C*dh/2 exponentials, bound by operations at the model's shapes; this
// first version is plain fp32 FMA loops over shared memory (rows padded by
// one element against bank conflicts). The grid is B*H CTAs, not
// persistent: at rwkv6-1.6b's prefill (B 4, H 32) 128 CTAs on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DH = 128;
constexpr int MAX_CHUNK = 64;
constexpr int MAX_SMEM = 232448;         // an H100 block's shared memory

constexpr size_t smem_bytes(int D, int C) {
  return sizeof(float) *
         ((size_t)4 * C * (D + 1) + (size_t)D * D + (size_t)C * C + D);
}
static_assert(smem_bytes(MAX_DH, MAX_CHUNK) <= MAX_SMEM,
              "the largest head dim and chunk must fit a block");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ log_w,
             const float* __restrict__ u, const float* __restrict__ s0,
             float* __restrict__ o, float* __restrict__ s_out, int H, int L,
             int D, int C) {
  extern __shared__ __align__(16) float smem[];
  const int LD = D + 1;                 // padded row: fewer bank conflicts
  float* rs = smem;                     // C x LD: r, then r * exp(le)
  float* ks = rs + C * LD;              // C x LD: k, then k * exp(le_C - le)
  float* vs = ks + C * LD;              // C x LD
  float* le = vs + C * LD;              // C x LD: log_w, then its cumsum
  float* S = le + C * LD;               // D x D state
  float* A = S + D * D;                 // C x C scores
  float* us = A + C * C;                // D bonus

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const size_t s_base = (size_t)bh * D * D;

  for (int idx = tid; idx < D * D; idx += THREADS)
    S[idx] = s0 ? s0[s_base + idx] : 0.f;
  for (int d = tid; d < D; d += THREADS) us[d] = u[h * D + d];

  for (int t0 = 0; t0 < L; t0 += C) {
    const int n = min(C, L - t0);
    __syncthreads();                    // the previous chunk is done
    for (int idx = tid; idx < n * D; idx += THREADS) {
      const int i = idx / D, d = idx % D;
      const size_t g = (((size_t)b * L + t0 + i) * H + h) * D + d;
      rs[i * LD + d] = to_f(r[g]);
      ks[i * LD + d] = to_f(k[g]);
      vs[i * LD + d] = to_f(v[g]);
      le[i * LD + d] = log_w[g];
    }
    __syncthreads();
    for (int d = tid; d < D; d += THREADS) {
      float acc = 0.f;
      for (int i = 0; i < n; ++i) {
        acc += le[i * LD + d];
        le[i * LD + d] = acc;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < n * n; idx += THREADS) {
      const int i = idx / n, j = idx % n;
      float acc = 0.f;
      if (j < i) {
        for (int d = 0; d < D; ++d)
          acc += rs[i * LD + d] * ks[j * LD + d] *
                 expf(le[i * LD + d] - le[j * LD + d]);
      } else if (j == i) {
        for (int d = 0; d < D; ++d)
          acc += rs[i * LD + d] * us[d] * ks[i * LD + d];
      }
      A[i * C + j] = acc;
    }
    __syncthreads();
    for (int idx = tid; idx < n * D; idx += THREADS) {
      const int i = idx / D, d = idx % D;
      const float lc = le[(n - 1) * LD + d];
      rs[i * LD + d] *= expf(le[i * LD + d]);
      ks[i * LD + d] *= expf(lc - le[i * LD + d]);
    }
    __syncthreads();
    for (int idx = tid; idx < n * D; idx += THREADS) {
      const int i = idx / D, e = idx % D;
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc += A[i * C + j] * vs[j * LD + e];
      for (int d = 0; d < D; ++d) acc += rs[i * LD + d] * S[d * D + e];
      o[(((size_t)b * L + t0 + i) * H + h) * D + e] = acc;
    }
    __syncthreads();                    // o has read S
    for (int idx = tid; idx < D * D; idx += THREADS) {
      const int d = idx / D, e = idx % D;
      float acc = expf(le[(n - 1) * LD + d]) * S[idx];
      for (int j = 0; j < n; ++j) acc += ks[j * LD + d] * vs[j * LD + e];
      S[idx] = acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < D * D; idx += THREADS)
    s_out[s_base + idx] = S[idx];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* log_w,
           const float* u, const float* s0, float* o, float* s_out, int B,
           int L, int H, int D, int C, cudaStream_t stream) {
  // set on every launch: the attribute holds for the current device only,
  // and the call is cheap
  const cudaError_t attr = cudaFuncSetAttribute(
      rwkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  rwkv6_kernel<T><<<B * H, THREADS, smem_bytes(D, C), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), log_w, u, s0, o, s_out, H, L, D, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rwkv6_max_head_dim() { return MAX_DH; }
int rwkv6_max_chunk() { return MAX_CHUNK; }

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
