// Tile-quantized bf16 matmul for Hopper: out (M, N) = x (M, K) @ w (K, N).
//
// Replaces matmul_pallas (src/repro/kernels/matmul_tiled.py, body
// matmul_kernel): one CTA per (BM, BN) output tile, the K loop inside the
// CTA, fp32 accumulation, output cast to bf16. The grid is
// ceil(M/BM) x ceil(N/BN) CTAs and is not persistent, so its size is the B of
// paper Eq. 3 and the wave tail over the SMs stays visible.
//
// Bound: at the MLP's prefill shapes (M = 512, K x N = 1024 x 2816) the
// product does about 304 operations per byte it must move, just above the
// H100's ridge of ~295 bf16 ops/byte, so it is bound by tensor-core
// operations; at decode (M = batch = 4) it is bound by reading the weight. This first version is right and simple:
// WMMA bf16 16x16x16 fragments on tiles staged in shared memory, one stage,
// 16-byte loads where alignment allows. Ragged M, N and K are masked in the
// kernel (tails of the shared tiles are zero-filled), with no host padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int THREADS = 128;               // 4 warps, 2 x 2 over the tile
constexpr int A_LD = BK + 8, B_LD = BN + 8, C_LD = BN + 4;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
matmul_tiled_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // the warp's 32 x 32 sub-tile
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: BM x BK = 256 chunks of 8 values, two per thread.
#pragma unroll
    for (int c = tid; c < BM * BK / 8; c += THREADS) {
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const int gr = m0 + r, gc = k0 + col;
      __nv_bfloat16* dst = &As[r * A_LD + col];
      if (VEC && gr < M && gc < K) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(&x[(size_t)gr * K + gc]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gr < M && gc + e < K) ? x[(size_t)gr * K + gc + e] : zero;
      }
    }
    // w tile: BK x BN = 256 chunks of 8 values, two per thread.
#pragma unroll
    for (int c = tid; c < BK * BN / 8; c += THREADS) {
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      const int gr = k0 + r, gc = n0 + col;
      __nv_bfloat16* dst = &Bs[r * B_LD + col];
      if (VEC && gr < K && gc < N) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(&w[(size_t)gr * N + gc]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gr < K && gc + e < N) ? w[(size_t)gr * N + gc + e] : zero;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm * 32 + i * 16) * A_LD + kk],
                               A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk * B_LD + wn * 32 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * C_LD + wn * 32 + j * 16],
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();

  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, col = idx % BN;
    const int gr = m0 + r, gc = n0 + col;
    if (gr < M && gc < N)
      out[(size_t)gr * N + gc] = __float2bfloat16(Cs[r * C_LD + col]);
  }
}

}  // namespace

extern "C" {

// Tile sizes, so the Python side computes the grid (paper Eq. 3's B) from
// the kernel itself.
int matmul_tiled_block_m() { return BM; }
int matmul_tiled_block_n() { return BN; }

// vec != 0 promises K % 8 == 0, N % 8 == 0 and 16-byte aligned x and w.
int matmul_tiled_bf16(const void* x, const void* w, void* out, int M, int N,
                      int K, int vec, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (vec)
    matmul_tiled_kernel<true><<<grid, THREADS, 0, s>>>(xp, wp, op, M, N, K);
  else
    matmul_tiled_kernel<false><<<grid, THREADS, 0, s>>>(xp, wp, op, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

const char* matmul_tiled_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
