// What the RG-LRU kernels share (rglru_scan.cu, the forward, and
// rglru_scan_bwd.cu, its backward): both stream windows of steps of
// (B, T, W) fp32 tensors into a shared-memory ring, by TMA through a
// (W, T, B) tensor map where rows and bases are 16-byte aligned, else by
// 4-byte cp.async copies zero-filled out of range.

#pragma once

#include <cstring>

#include "sm90.cuh"

namespace rglru {
// Internal linkage, as in sm90.cuh: each kernel library keeps its own copy.
namespace {

constexpr int MAX_SMEM = 232448;  // a CTA's shared memory on sm_90

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most `pending` (0-3) of this thread's commit groups are
// in flight (wait_group takes an immediate).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
  }
}

// (W, T, B) fp32 of a contiguous (B, T, W) tensor, boxes of ch channels x
// tw steps x 1 row, no swizzle, zero fill out of bounds (a box may start
// before step 0 or end past T or W).
inline bool encode_btw(sm90::EncodeTiled fn, CUtensorMap* map,
                       const void* ptr, int B, int T, int W, int ch, int tw) {
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)T * W * 4};
  const cuuint32_t box[3] = {(cuuint32_t)ch, (cuuint32_t)tw, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
}  // namespace rglru
