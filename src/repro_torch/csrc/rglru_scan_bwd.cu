// RG-LRU backward for Hopper: the gradients of the linear recurrence of
// rglru_scan.cu,
//
//   h_t = a_t * h_{t-1} + b_t,   h_{-1} = h0,   y_t = h_t,
//
// with respect to a, b and h0, from the gradients dy of y (B, T, W) and
// dh_last of the final state (B, W; null for zeros). Per batch row and
// channel it walks the reverse recurrence
//
//   g_{T-1} = dy_{T-1} + dh_last,   g_t = dy_t + a_{t+1} g_{t+1}
//   db_t = g_t,   da_t = g_t * y_{t-1} (h0 at t = 0),   dh0 = a_0 g_0
//
// in fp32, each product and sum rounded once in the order above (no fused
// multiply-add), so the kernel equals its plain version on the card bit
// for bit.
//
// Replaces no Pallas kernel: repro trains through plain JAX, and
// rglru_pallas (src/repro/kernels/rglru.py:43) has no backward.
//
// Bound: bytes. Each step of a channel reads a_t, y_{t-1} and dy_t and
// writes da_t and db_t, 20 B for two multiplies and an add. One thread
// owns a (batch row, channel) pair for all of T (neighbouring threads on
// neighbouring channels, so each step's loads and stores are whole lines),
// and walks T from the end in blocks of STEPS steps whose loads it issues
// all at once before walking them: the carry is the only dependence, so
// STEPS x 3 loads a thread are in flight instead of one step's. A ragged
// W and T are masked. The kernel neither allocates nor synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int STEPS = 32;    // steps a thread loads ahead

struct Args {
  const float* a;
  const float* y;
  const float* h0;
  const float* dy;
  const float* dh_last;   // or null: zeros
  float* da;
  float* db;
  float* dh0;
  long long rows;         // B x W
  int T, W;
};

__global__ void __launch_bounds__(THREADS)
rglru_scan_bwd_kernel(const Args p) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= p.rows) return;
  const long long row = idx / p.W, c = idx % p.W;
  const size_t W = p.W;
  const size_t base = (size_t)row * p.T * W + c;   // (row, 0, c)
  const float h0 = p.h0[idx];
  float ag = p.dh_last ? p.dh_last[idx] : 0.f;     // a_{t+1} g_{t+1}
  for (int t1 = p.T; t1 > 0; t1 -= STEPS) {
    float av[STEPS], dyv[STEPS], yp[STEPS];
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int t = t1 - 1 - j;
      if (t >= 0) {
        const size_t o = base + (size_t)t * W;
        av[j] = __ldg(p.a + o);
        dyv[j] = __ldg(p.dy + o);
        yp[j] = t > 0 ? __ldg(p.y + o - W) : h0;
      }
    }
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int t = t1 - 1 - j;
      if (t >= 0) {
        const size_t o = base + (size_t)t * W;
        const float g = __fadd_rn(dyv[j], ag);
        p.db[o] = g;
        p.da[o] = __fmul_rn(g, yp[j]);
        ag = __fmul_rn(av[j], g);
      }
    }
  }
  p.dh0[idx] = ag;
}

}  // namespace

extern "C" {

// The compiled kernel, into out[4]: threads a CTA, registers a thread,
// CTAs an SM holds, local (spilled) bytes a thread. Returns 0 or a
// cudaError_t.
int rglru_scan_bwd_attrs(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, rglru_scan_bwd_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rglru_scan_bwd_kernel, THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = THREADS;
  out[1] = attr.numRegs;
  out[2] = per_sm;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// a, y, dy: (B, T, W) fp32; h0: (B, W) fp32; dh_last: (B, W) fp32 or null
// for zeros. Writes da, db (B, T, W) and dh0 (B, W) fp32. All contiguous;
// B, T, W >= 1.
int rglru_scan_backward(const void* a, const void* y, const void* h0,
                        const void* dy, const void* dh_last, void* da,
                        void* db, void* dh0, int B, int T, int W,
                        void* stream) {
  if (B < 1 || T < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.a = static_cast<const float*>(a);
  p.y = static_cast<const float*>(y);
  p.h0 = static_cast<const float*>(h0);
  p.dy = static_cast<const float*>(dy);
  p.dh_last = static_cast<const float*>(dh_last);
  p.da = static_cast<float*>(da);
  p.db = static_cast<float*>(db);
  p.dh0 = static_cast<float*>(dh0);
  p.rows = (long long)B * W;
  p.T = T;
  p.W = W;
  const long long grid = (p.rows + THREADS - 1) / THREADS;
  if (grid >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  rglru_scan_bwd_kernel<<<(int)grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* rglru_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
