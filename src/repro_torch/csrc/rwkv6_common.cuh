// Device helpers shared by the RWKV6 forward (rwkv6.cu) and backward
// (rwkv6_bwd.cu): the limits both take, the TF32 split of an fp32 operand
// into a high and a low part, the m16n8k8 TF32 mma.sync, the cp.async
// wrappers and the half-warp reduce-scatter of the diagonal blocks.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_DH = 128;
constexpr int SUB = 16;                   // rows of a sub-chunk
constexpr int MAX_SMEM = 232448;          // an H100 block's shared memory

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// exp of an exponent <= 0 (ex2.approx; error ~2 ulp plus the rounding of
// x log2(e), which matters only where the result is tiny)
__device__ __forceinline__ float ex(float x) { return __expf(x); }

// x = hi + lo: hi is x rounded to nearest TF32 (ties away: add half a
// TF32 ulp to the magnitude bits, clear the 13 low bits), lo = x - hi is
// exact in fp32 and rounded to TF32 the same way (2^-22 of x); an EXACT x
// (a bf16 value, which TF32 holds) is its own high part
template <bool EXACT = false>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
    lo = 0;
  } else {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    const uint32_t l = __float_as_uint(x - __uint_as_float(hi));
    lo = (l + 0x1000u) & 0xffffe000u;
  }
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// BYTES (4 or 16) from global src to shared dst by cp.async, or as many
// zero bytes where !ok (src then unread)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Sums each of v's N slots over the 16 adjacent lanes of a half-warp and
// leaves slots N/16 * part .. N/16 * (part + 1) - 1 in v[0 .. N/16) of
// lane `part` (recursive halving, lane offset O first: N - N/16 shuffles,
// in a fixed order). A template step a halving, so every index is a
// constant.
template <int N, int O = 8>
__device__ __forceinline__ void scatter_sum(float (&v)[N], int part) {
  static_assert(N % 16 == 0, "a slot count the 16 lanes share evenly");
  constexpr int HALF = N / 16 * O;
  const bool up = part & O;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float send = up ? v[k] : v[k + HALF];
    const float keep = up ? v[k + HALF] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
  if constexpr (O > 1) scatter_sum<N, O / 2>(v, part);
}

}  // namespace
