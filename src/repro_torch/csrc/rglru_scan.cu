// RG-LRU linear recurrence for Hopper, from a carried state.
//
// Replaces rglru_pallas (src/repro/kernels/rglru.py:43, body
// _rglru_kernel). Per batch row and channel, in fp32:
//
//   h_t = a_t * h_{t-1} + b_t,   h_{-1} = h0,   y_t = h_t
//
// over (B, T, W) a and b and a (B, W) h0, writing y (B, T, W) and
// h_last = y[:, T-1] (B, W).
//
// Bound: bytes. Each step of a channel reads a_t and b_t and writes y_t,
// 12 B for one fused multiply-add; the recurrence is sequential in T and
// shares nothing across channels. What held the earlier kernel back was not
// its grid but latency: it walked T one step at a time, each step waiting
// for its own loads from device memory (about 0.45 us a step at T = 128),
// so its time grew with T and not with W. The card's 3.35 TB/s at about a
// microsecond of latency needs megabytes of loads in flight; this kernel
// keeps whole windows of steps in flight instead of one.
//
// On the TPU the time chunks were a sequential grid axis with h in VMEM
// scratch. Here one CTA of 4 warps owns a (batch row, strip of 32 channels)
// pair for all of T (a step of a strip is one 128-byte line) and walks T in
// windows of TW steps (32, 64 or 128; the host picks):
//
// - Loads: a ring of `stages` window slots in shared memory, each TW x 32
//   of a and of b. Where the row stride (W x 4 bytes) and both bases are
//   16-byte aligned, one thread issues two TMA tensor loads a window
//   (cp.async.bulk.tensor, completion counted on an mbarrier; steps past T
//   and channels past W are zero-filled). Otherwise every thread issues
//   4-byte cp.async copies, zero-filled out of range, in commit groups.
// - Scan of a window: warp w takes the window's w-th quarter, S = TW / 4
//   steps, a lane a channel (conflict-free: a step's 32 channels lie in 32
//   banks), and reads it into registers. Pass 1 walks the quarter from
//   zero, keeping its affine map h -> P h + Y (Y the walk's end, P the
//   running product of a). The maps go through shared memory; once every
//   warp has written its map the slot has been read, and window
//   i + stages is issued into it, so loads stay in flight through pass 2
//   and the windows between. Each warp folds, in order, the carry into the
//   window (h) through the maps of the warps before it, then pass 2
//   re-walks its quarter from that carry with the same FMA chain as the
//   sequential form and writes y (each warp stores 128-byte lines). Steps
//   past T are the identity (a = 1, b = 0) in both passes.
// - The warp that holds the window's last step hands its h through shared
//   memory to the next window, so the carry between windows is the y
//   written, and h_last equals y[:, T-1].
//
// Every sum runs in a fixed order (no atomics), so two launches on the same
// inputs are bit-equal. The kernel neither allocates nor synchronises; the
// tensor maps are kernel parameters, so a launch can be captured in a CUDA
// graph.

#include "rglru_common.cuh"

namespace {

using rglru::cp_async4;
using rglru::cp_async_commit;
using rglru::cp_async_wait;
using rglru::encode_btw;
using rglru::MAX_SMEM;
using sm90::EncodeTiled;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::tma_load_3d;

constexpr int CH = 32;          // channels a CTA: one lane each
constexpr int WARPS = 4;        // each takes a quarter of a window
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_STAGES = 2;   // more slots measured no faster

// Dynamic shared memory of a launch: 128 bytes to align the ring, the ring
// (stages x {a, b} x TW x CH fp32), an mbarrier a stage slot, the warps'
// maps (float2 per warp and lane) and the hand-over of h between windows.
constexpr int smem_bytes(int tw, int stages) {
  return 128 + stages * 2 * tw * CH * 4 + 8 * MAX_STAGES + WARPS * CH * 8 +
         CH * 4;
}

struct Args {
  const float* a;
  const float* b;
  const float* h0;
  float* y;
  float* h_last;
  int T, W, strips, stages, tma;
};

template <int TW>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(__grid_constant__ const CUtensorMap map_a,
                  __grid_constant__ const CUtensorMap map_b, const Args p) {
  constexpr int S = TW / WARPS;         // steps a warp scans in a window
  constexpr int BUF = 2 * TW * CH;      // floats of one stage (a, then b)
  extern __shared__ uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + p.stages * BUF);
  float2* maps = reinterpret_cast<float2*>(bars + MAX_STAGES);
  float* hand = reinterpret_cast<float*>(maps + WARPS * CH);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x / p.strips, strip = blockIdx.x % p.strips;
  const int c = strip * CH + lane;
  const bool cv = c < p.W;
  const int T = p.T, W = p.W;
  const int nwin = (T + TW - 1) / TW;
  // (row, 0, c): the channel's first step
  const size_t base = (size_t)row * T * W + c;

  if (p.tma && threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(smem_u32(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Fills ring slot i % stages with window i. TMA: one thread, both
  // arrays; cp.async: every thread its channel's rows warp, warp + 4, ...,
  // one commit group a window (empty past the last, so the count of
  // groups in flight stays `stages`).
  auto issue = [&](int i) {
    float* dst = ring + (i % p.stages) * BUF;
    if (p.tma) {
      if (threadIdx.x == 0 && i < nwin) {
        const uint32_t bar = smem_u32(bars + i % p.stages);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect_tx(bar, BUF * 4);
        tma_load_3d(smem_u32(dst), &map_a, bar, strip * CH, i * TW, row);
        tma_load_3d(smem_u32(dst + TW * CH), &map_b, bar, strip * CH, i * TW,
                    row);
      }
    } else {
      if (i < nwin) {
        for (int r = warp; r < TW; r += WARPS) {
          const int t = i * TW + r;
          const bool ok = cv && t < T;
          const size_t off = ok ? base + (size_t)t * W : 0;
          cp_async4(smem_u32(dst + r * CH + lane), p.a + off, ok);
          cp_async4(smem_u32(dst + TW * CH + r * CH + lane), p.b + off, ok);
        }
      }
      cp_async_commit();
    }
  };

  for (int i = 0; i < p.stages; ++i) issue(i);
  float h = cv ? p.h0[(size_t)row * W + c] : 0.f;

  for (int i = 0; i < nwin; ++i) {
    const int t0 = i * TW;
    const int n = min(TW, T - t0);    // the window's steps within T
    if (p.tma) {
      mbar_wait(smem_u32(bars + i % p.stages), (i / p.stages) & 1);
    } else {
      cp_async_wait(p.stages - 1);
      __syncthreads();
    }
    // this warp's quarter of the window, into registers (steps past T as
    // the identity: a = 1, b = 0)
    const float* sa = ring + (i % p.stages) * BUF + warp * S * CH + lane;
    const float* sb = sa + TW * CH;
    const int m = n - warp * S;       // the quarter's steps within T
    float av[S], bv[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      av[k] = k < m ? sa[k * CH] : 1.f;
      bv[k] = k < m ? sb[k * CH] : 0.f;
    }

    // pass 1: the quarter's map h -> P h + Y, walked from zero
    float Y = 0.f, P = 1.f;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      Y = fmaf(av[k], Y, bv[k]);
      P *= av[k];
    }
    maps[warp * CH + lane] = make_float2(P, Y);
    __syncthreads();    // the maps are written; the slot has been read
    issue(i + p.stages);
    // the carry into this warp's quarter: h through the earlier maps
    float carry = h;
    for (int j = 0; j < warp; ++j) {
      const float2 mp = maps[j * CH + lane];
      carry = fmaf(mp.x, carry, mp.y);
    }

    // pass 2: re-walk from the carry, writing y
    float* yp = p.y + base + (size_t)(t0 + warp * S) * W;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      carry = fmaf(av[k], carry, bv[k]);
      if (cv && k < m) yp[(size_t)k * W] = carry;
    }
    // y at the window's last step (identity steps after it leave it as is)
    if (warp == (n - 1) / S) hand[lane] = carry;
    __syncthreads();
    h = hand[lane];
  }
  if (warp == 0 && cv) p.h_last[(size_t)row * W + c] = h;
}

template <int TW>
cudaError_t set_smem_attr() {
  // the attribute holds per device; set once on each (setting it twice
  // from two threads is harmless)
  static bool attr_set[64];
  int device = -1;
  if (cudaGetDevice(&device) != cudaSuccess) device = -1;
  if (device >= 0 && device < 64 && attr_set[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (err == cudaSuccess && device >= 0 && device < 64)
    attr_set[device] = true;
  return err;
}

template <int TW>
cudaError_t launch_tw(const CUtensorMap& ma, const CUtensorMap& mb,
                      const Args& p, int grid, cudaStream_t stream) {
  const cudaError_t attr = set_smem_attr<TW>();
  if (attr != cudaSuccess) return attr;
  rglru_scan_kernel<TW><<<grid, THREADS, smem_bytes(TW, p.stages), stream>>>(
      ma, mb, p);
  return cudaGetLastError();
}

template <int TW>
int attrs_tw(int stages, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, rglru_scan_kernel<TW>);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem_attr<TW>();
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rglru_scan_kernel<TW>, THREADS, smem_bytes(TW, stages));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = THREADS;
  out[1] = attr.numRegs;
  out[2] = smem_bytes(TW, stages);
  out[3] = per_sm;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

bool valid_form(int window, int stages) {
  return (window == 32 || window == 64 || window == 128) && stages >= 1 &&
         stages <= MAX_STAGES && smem_bytes(window, stages) <= MAX_SMEM;
}

}  // namespace

extern "C" {

int rglru_scan_channels() { return CH; }
int rglru_scan_warps() { return WARPS; }
int rglru_scan_max_stages() { return MAX_STAGES; }

// The compiled kernel at window steps `window` and `stages` ring slots,
// into out[5]: threads a CTA, registers a thread, dynamic shared memory
// bytes, CTAs an SM holds, local (spilled) bytes a thread. Returns 0 or a
// cudaError_t.
int rglru_scan_attrs(int window, int stages, int* out) {
  if (!valid_form(window, stages))
    return static_cast<int>(cudaErrorInvalidValue);
  if (window == 32) return attrs_tw<32>(stages, out);
  if (window == 64) return attrs_tw<64>(stages, out);
  return attrs_tw<128>(stages, out);
}

// a, b: (B, T, W) fp32; h0: (B, W) fp32; writes y (B, T, W) and h_last
// (B, W) fp32. All contiguous; B, T, W >= 1. window: 32, 64 or 128 steps;
// stages: 1-2 ring slots; tma != 0 loads by TMA, which needs W % 4 == 0
// and a, b 16-byte aligned.
int rglru_scan_forward(const void* a, const void* b, const void* h0, void* y,
                       void* h_last, int B, int T, int W, int window,
                       int stages, int tma, void* stream) {
  if (B < 1 || T < 1 || W < 1 || !valid_form(window, stages))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tma && (W % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(b) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.h0 = static_cast<const float*>(h0);
  p.y = static_cast<float*>(y);
  p.h_last = static_cast<float*>(h_last);
  p.T = T;
  p.W = W;
  p.strips = (W + CH - 1) / CH;
  p.stages = stages;
  p.tma = tma != 0;
  CUtensorMap ma, mb;
  memset(&ma, 0, sizeof(ma));
  memset(&mb, 0, sizeof(mb));
  if (p.tma) {
    const EncodeTiled fn = sm90::encode_tiled();
    if (!fn) return static_cast<int>(cudaErrorNotSupported);
    if (!encode_btw(fn, &ma, a, B, T, W, CH, window) ||
        !encode_btw(fn, &mb, b, B, T, W, CH, window))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long grid = (long long)B * p.strips;
  if (grid >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (window == 32)
    err = launch_tw<32>(ma, mb, p, (int)grid, s);
  else if (window == 64)
    err = launch_tw<64>(ma, mb, p, (int)grid, s);
  else
    err = launch_tw<128>(ma, mb, p, (int)grid, s);
  return static_cast<int>(err);
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
