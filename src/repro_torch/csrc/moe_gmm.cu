// Grouped (per-expert) bf16 matmul for Hopper:
//   out[e] (C, F) = x[e] (C, D) @ w[e] (D, F),   e < E.
//
// Replaces moe_gmm_pallas (src/repro/kernels/moe_gmm.py, body _gmm_kernel):
// one CTA per (expert, BM-row C tile, BN-column F tile), the D loop inside
// the CTA, fp32 accumulation, output cast to bf16. The TPU kernel's
// sequential D grid axis with its VMEM accumulator becomes that loop, since
// CTAs run in no order. The grid is E x ceil(C/BM) x ceil(F/BN) CTAs and is
// not persistent, so its size is the B of paper Eq. 3.
//
// x is read through an expert stride and a row stride (its D stride is 1):
// the dense MoE path hands the same (T, D) activations to every expert with
// expert stride 0 instead of writing E copies. w and out are contiguous.
//
// Bound: at granite's dense prefill (E = 32, C = 512, D x F = 1024 x 512)
// gate and up do 17.2 GFLOP against 51 MB, above the H100's ridge of ~295
// bf16 ops/byte, so they are bound by tensor-core operations; down writes a
// 33.5 MB output and is bound by bytes; at decode (C = 4) every product is
// bound by reading the 33.5 MB of expert weights. This first version is
// right and simple: WMMA bf16 16x16x16 fragments on tiles staged in shared
// memory, one stage, 16-byte loads where alignment allows. Ragged C, D and
// F are masked in the kernel (tails of the shared tiles are zero-filled),
// with no host padding. At decode a 64-row tile holds 4 live rows.

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
moe_gmm_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ out, int C, int D, int F,
               long long sx_e, long long sx_r) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // the warp's 32 x 32 sub-tile
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  const __nv_bfloat16* xe = x + (long long)e * sx_e;
  const __nv_bfloat16* we = w + (size_t)e * D * F;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < D; k0 += BK) {
    // x tile: BM x BK = 256 chunks of 8 values, two per thread.
#pragma unroll
    for (int c = tid; c < BM * BK / 8; c += THREADS) {
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const int gr = m0 + r, gc = k0 + col;
      __nv_bfloat16* dst = &As[r * A_LD + col];
      const __nv_bfloat16* src = xe + (long long)gr * sx_r + gc;
      if (VEC && gr < C && gc < D) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          dst[i] = (gr < C && gc + i < D) ? src[i] : zero;
      }
    }
    // w tile: BK x BN = 256 chunks of 8 values, two per thread.
#pragma unroll
    for (int c = tid; c < BK * BN / 8; c += THREADS) {
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      const int gr = k0 + r, gc = n0 + col;
      __nv_bfloat16* dst = &Bs[r * B_LD + col];
      const __nv_bfloat16* src = we + (size_t)gr * F + gc;
      if (VEC && gr < D && gc < F) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          dst[i] = (gr < D && gc + i < F) ? src[i] : zero;
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

  __nv_bfloat16* oe = out + (size_t)e * C * F;
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, col = idx % BN;
    const int gr = m0 + r, gc = n0 + col;
    if (gr < C && gc < F)
      oe[(size_t)gr * F + gc] = __float2bfloat16(Cs[r * C_LD + col]);
  }
}

}  // namespace

extern "C" {

// Tile sizes, so the Python side computes the grid (paper Eq. 3's B) from
// the kernel itself.
int moe_gmm_block_c() { return BM; }
int moe_gmm_block_f() { return BN; }

// x: expert stride sx_e and row stride sx_r in elements, unit D stride;
// w (E, D, F) and out (E, C, F) contiguous. vec != 0 promises D % 8 == 0,
// F % 8 == 0, strides that are multiples of 8 and 16-byte aligned x and w.
int moe_gmm_bf16(const void* x, const void* w, void* out, int E, int C,
                 int D, int F, long long sx_e, long long sx_r, int vec,
                 void* stream) {
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (vec)
    moe_gmm_kernel<true><<<grid, THREADS, 0, s>>>(xp, wp, op, C, D, F, sx_e,
                                                  sx_r);
  else
    moe_gmm_kernel<false><<<grid, THREADS, 0, s>>>(xp, wp, op, C, D, F, sx_e,
                                                   sx_r);
  return static_cast<int>(cudaGetLastError());
}

const char* moe_gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
