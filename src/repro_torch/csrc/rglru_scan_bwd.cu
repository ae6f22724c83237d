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
// writes da_t and db_t, 20 B for two multiplies and an add; the walk is
// two dependent operations a step, a few microseconds over T = 2048, so
// the serial walk never limits the kernel. What does is bytes in flight: a
// walker that waits for its own loads takes a load's latency per block of
// steps, and its time grows with T and not with the bytes. So the loads
// run ahead of the walk through a ring, as in the forward:
//
// - A CTA of one warp owns a (batch row, strip of CH = 32 channels) pair
//   for all of T, a lane a channel (a step of the strip is one 128-byte
//   line). It walks T from the end in windows of TW steps, aligned to TW
//   from step 0, so the first window it walks is the ragged one.
// - Loads: a ring of `stages` slots in shared memory, each holding a
//   window's a and dy over [t0, t0 + TW) and y over [t0 - 1, t0 - 1 + TW),
//   one step earlier, so that a step's y_{t-1} lies in its slot. Where the
//   row stride (W x 4 bytes) and the bases are 16-byte aligned (the TMA
//   route), one thread issues three TMA tensor loads a window (completion
//   counted on an mbarrier; steps before 0 or past T and channels past W
//   are zero-filled); the walker puts h0 in the zero-filled row before
//   step 0. Otherwise (the cp.async route) each thread issues 4-byte
//   cp.async copies of its own channel's rows, zero-filled out of range,
//   one commit group a window, and reads only what it copied, so that
//   route needs no barrier.
// - The walk: each lane walks its window's steps in reverse from its carry
//   a_{t+1} g_{t+1}, in groups of U steps whose slot reads are issued
//   before the group walked ahead of them, so reads are in flight while
//   the carry walks. On the TMA route it writes db_t over dy_t and da_t
//   over a_t in the slot, and one thread writes the window's da and db by
//   two TMA tensor stores (rows past T and channels past W clipped); on
//   the H100 that took 7 % less time than each lane's two stores a step at
//   recurrentgemma-2b's training shape and half at T 2048 and batch 1. On
//   the cp.async route (W not a multiple of 4, which no tensor map takes)
//   each lane stores its own, a warp's stores whole lines. Once the slot
//   has been read (and, on the TMA route, stored from), the window
//   `stages` later is issued into it, so loads stay in flight through the
//   walks between.
// - The host picks TW and the ring's depth (kernels/rglru.py bwd_form)
//   so that the grid of one-warp CTAs takes the fewest waves of the
//   card's SMs (paper Eq. 3) and the shared memory left holds as many
//   steps in flight as fit. CTAs of four warps (128 channels) were
//   slower on the H100 than the fastest one-warp form in every case
//   timed but (4, 2048, 2560), where the best of them was 2.5 % faster
//   (PERF.md §6), and the host never picked them: they are not compiled.
//
// Every value comes from one walk in a fixed order (no atomics), so two
// launches on the same inputs are bit-equal. The kernel neither allocates
// nor synchronises; the tensor maps are kernel parameters, so a launch can
// be captured in a CUDA graph.

#include "rglru_common.cuh"

namespace {

using rglru::cp_async4;
using rglru::cp_async_commit;
using rglru::cp_async_wait;
using rglru::encode_btw;
using rglru::MAX_SMEM;
using sm90::bulk_wait_read;
using sm90::EncodeTiled;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::tma_load_3d;
using sm90::tma_store_3d;

constexpr int CH = 32;          // channels a CTA, a lane each
constexpr int MAX_STAGES = 4;

// Dynamic shared memory of a launch: 128 bytes to align the ring, the ring
// (stages x {a, dy, y} x tw x CH fp32) and an mbarrier a slot.
constexpr int smem_bytes(int tw, int stages) {
  return 128 + stages * 3 * tw * CH * 4 + 8 * MAX_STAGES;
}

struct Args {
  const float* a;
  const float* y;
  const float* h0;
  const float* dy;
  const float* dh_last;   // or null: zeros
  float* da;
  float* db;
  float* dh0;
  int T, W, strips, stages;
};

constexpr int U = 8;    // steps of a group of slot reads

// At least 16 CTAs (512 threads) an SM, so at most 128 registers a
// thread, the figure the host counts CTAs an SM with. TMA: the TMA route,
// else the cp.async route.
template <int TW, bool TMA>
__global__ void __launch_bounds__(CH, 512 / CH)
rglru_scan_bwd_kernel(__grid_constant__ const CUtensorMap map_a,
                      __grid_constant__ const CUtensorMap map_y,
                      __grid_constant__ const CUtensorMap map_dy,
                      __grid_constant__ const CUtensorMap map_da,
                      __grid_constant__ const CUtensorMap map_db,
                      const Args p) {
  constexpr int BOX = TW * CH;      // floats of one array's window
  constexpr int BUF = 3 * BOX;      // floats of a slot: a, dy, y
  static_assert(TW % U == 0, "a window is whole groups");
  extern __shared__ uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + p.stages * BUF);

  const int row = blockIdx.x / p.strips, strip = blockIdx.x % p.strips;
  const int c = strip * CH + threadIdx.x;
  const bool cv = c < p.W;
  const int T = p.T, W = p.W;
  const int nwin = (T + TW - 1) / TW;
  // (row, 0, c): the channel's first step
  const size_t base = (size_t)row * T * W + c;

  if (TMA && threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(smem_u32(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Fills ring slot j % stages with the j-th window walked, steps
  // [t0, t0 + TW) for t0 = (nwin - 1 - j) TW. TMA: one thread, three
  // boxes; cp.async: every thread its own channel, one commit group a
  // window (empty past the last, so the count of groups in flight stays
  // `stages`).
  auto issue = [&](int j) {
    float* dst = ring + (j % p.stages) * BUF;
    const int t0 = (nwin - 1 - j) * TW;
    if (TMA) {
      if (threadIdx.x == 0 && j < nwin) {
        const uint32_t bar = smem_u32(bars + j % p.stages);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect_tx(bar, BUF * 4);
        tma_load_3d(smem_u32(dst), &map_a, bar, strip * CH, t0, row);
        tma_load_3d(smem_u32(dst + BOX), &map_dy, bar, strip * CH, t0, row);
        tma_load_3d(smem_u32(dst + 2 * BOX), &map_y, bar, strip * CH,
                    t0 - 1, row);
      }
    } else {
      if (j < nwin) {
        for (int r = 0; r < TW; ++r) {
          const int t = t0 + r;
          const bool ok = cv && t < T, okp = ok && t > 0;
          const size_t off = ok ? base + (size_t)t * W : 0;
          const size_t offp = okp ? off - W : 0;
          const uint32_t d = smem_u32(dst + r * CH + threadIdx.x);
          cp_async4(d, p.a + off, ok);
          cp_async4(d + BOX * 4, p.dy + off, ok);
          cp_async4(d + 2 * BOX * 4, p.y + offp, okp);
        }
      }
      cp_async_commit();
    }
  };

  for (int j = 0; j < p.stages; ++j) issue(j);
  const size_t rc = (size_t)row * W + c;
  const float h0 = cv ? p.h0[rc] : 0.f;
  float ag = cv && p.dh_last ? p.dh_last[rc] : 0.f;   // a_{t+1} g_{t+1}

  for (int j = 0; j < nwin; ++j) {
    const int t0 = (nwin - 1 - j) * TW;
    const int n = min(TW, T - t0);    // the window's steps within T
    if (TMA)
      mbar_wait(smem_u32(bars + j % p.stages), (j / p.stages) & 1);
    else
      cp_async_wait(p.stages - 1);
    float* slot = ring + (j % p.stages) * BUF;
    float* sa = slot + threadIdx.x;
    float* sdy = sa + BOX;
    float* sy = sa + 2 * BOX;         // row r: y_{t0 + r - 1}
    if (t0 == 0) sy[0] = h0;          // the zero-filled row before step 0
    float* gp = p.db + base + (size_t)t0 * W;
    float* dp = p.da + base + (size_t)t0 * W;
    // The walk, in groups of U steps from the window's end, two groups'
    // reads in registers: the next group's reads are issued before this
    // group is walked, and none later than that (the compiler barrier at
    // a group's end). Steps past T (the ragged window's last rows) leave
    // the carry as it is and write nothing.
    float av[2][U], dv[2][U], yv[2][U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int r = TW - U + k;
      av[0][k] = sa[r * CH];
      dv[0][k] = sdy[r * CH];
      yv[0][k] = sy[r * CH];
    }
#pragma unroll
    for (int q = 0; q < TW / U; ++q) {
      const int b = q & 1, r0 = TW - U * (q + 1);
      if (q + 1 < TW / U) {
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int r = r0 - U + k;
          av[b ^ 1][k] = sa[r * CH];
          dv[b ^ 1][k] = sdy[r * CH];
          yv[b ^ 1][k] = sy[r * CH];
        }
      }
#pragma unroll
      for (int k = U - 1; k >= 0; --k) {
        const int r = r0 + k;
        const float g = __fadd_rn(dv[b][k], ag);
        const float d = __fmul_rn(g, yv[b][k]);
        if (r < n) {
          ag = __fmul_rn(av[b][k], g);
          if (TMA) {            // db over dy's row, da over a's
            sdy[r * CH] = g;
            sa[r * CH] = d;
          } else if (cv) {
            gp[(size_t)r * W] = g;
            dp[(size_t)r * W] = d;
          }
        }
      }
      asm volatile("" ::: "memory");
    }
    if (TMA) {
      // the staged rows to the async proxy; once every lane has written
      // its own, one thread stores both boxes and waits until they have
      // been read out of the slot, which is then refilled
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (threadIdx.x == 0) {
        tma_store_3d(&map_db, smem_u32(slot + BOX), strip * CH, t0, row);
        tma_store_3d(&map_da, smem_u32(slot), strip * CH, t0, row);
        bulk_wait_read();
      }
    }
    issue(j + p.stages);
  }
  if (cv) p.dh0[rc] = ag;
}

template <int TW, bool TMA>
cudaError_t set_smem_attr() {
  // the attributes hold per device; set once on each (setting them twice
  // from two threads is harmless). All of the SM's shared memory is
  // carved out for the ring, so that as many CTAs fit an SM as the host
  // counts.
  static bool attr_set[64];
  int device = -1;
  if (cudaGetDevice(&device) != cudaSuccess) device = -1;
  if (device >= 0 && device < 64 && attr_set[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_bwd_kernel<TW, TMA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        rglru_scan_bwd_kernel<TW, TMA>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && device >= 0 && device < 64)
    attr_set[device] = true;
  return err;
}

template <int TW, bool TMA>
cudaError_t launch_form(const CUtensorMap* maps, const Args& p, int grid,
                        cudaStream_t stream) {
  const cudaError_t attr = set_smem_attr<TW, TMA>();
  if (attr != cudaSuccess) return attr;
  rglru_scan_bwd_kernel<TW, TMA>
      <<<grid, CH, smem_bytes(TW, p.stages), stream>>>(
          maps[0], maps[1], maps[2], maps[3], maps[4], p);
  return cudaGetLastError();
}

template <int TW, bool TMA>
int attrs_form(int stages, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, rglru_scan_bwd_kernel<TW, TMA>);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = set_smem_attr<TW, TMA>();
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rglru_scan_bwd_kernel<TW, TMA>, CH,
      smem_bytes(TW, stages));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = CH;
  out[1] = attr.numRegs;
  out[2] = smem_bytes(TW, stages);
  out[3] = per_sm;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

template <bool TMA>
int attrs_route(int window, int stages, int* out) {
  return window == 32 ? attrs_form<32, TMA>(stages, out)
                      : attrs_form<64, TMA>(stages, out);
}

template <bool TMA>
cudaError_t launch_route(int window, const CUtensorMap* maps, const Args& p,
                         int grid, cudaStream_t s) {
  return window == 32 ? launch_form<32, TMA>(maps, p, grid, s)
                      : launch_form<64, TMA>(maps, p, grid, s);
}

// The compiled forms: windows of 32 or 64 steps, 1 to MAX_STAGES slots
// that fit a CTA's shared memory.
bool valid_form(int tw, int stages) {
  return (tw == 32 || tw == 64) && stages >= 1 && stages <= MAX_STAGES &&
         smem_bytes(tw, stages) <= MAX_SMEM;
}

}  // namespace

extern "C" {

int rglru_scan_bwd_channels() { return CH; }
int rglru_scan_bwd_max_stages() { return MAX_STAGES; }

// Dynamic shared memory bytes of the form (window steps, ring slots), or
// -1 where the kernel is not compiled for it.
int rglru_scan_bwd_smem(int window, int stages) {
  return valid_form(window, stages) ? smem_bytes(window, stages) : -1;
}

// The compiled kernel in a form on a route (tma != 0: the TMA route), into
// out[5]: threads a CTA, registers a thread, dynamic shared memory bytes,
// CTAs an SM holds, local (spilled) bytes a thread. Returns 0 or a
// cudaError_t.
int rglru_scan_bwd_attrs(int window, int stages, int tma, int* out) {
  if (!valid_form(window, stages))
    return static_cast<int>(cudaErrorInvalidValue);
  return tma ? attrs_route<true>(window, stages, out)
             : attrs_route<false>(window, stages, out);
}

// a, y, dy: (B, T, W) fp32; h0: (B, W) fp32; dh_last: (B, W) fp32 or null
// for zeros. Writes da, db (B, T, W) and dh0 (B, W) fp32. All contiguous;
// B, T, W >= 1. window: 32 or 64 steps; stages: 1-4 ring slots within a
// CTA's shared memory; tma != 0 loads and stores by TMA, which needs
// W % 4 == 0 and every (B, T, W) base 16-byte aligned.
int rglru_scan_backward(const void* a, const void* y, const void* h0,
                        const void* dy, const void* dh_last, void* da,
                        void* db, void* dh0, int B, int T, int W, int window,
                        int stages, int tma, void* stream) {
  if (B < 1 || T < 1 || W < 1 || !valid_form(window, stages))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tma && (W % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(dy) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(da) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(db) % 16 != 0))
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
  p.T = T;
  p.W = W;
  p.strips = (W + CH - 1) / CH;
  p.stages = stages;
  CUtensorMap maps[5];
  memset(maps, 0, sizeof(maps));
  if (tma) {
    const EncodeTiled fn = sm90::encode_tiled();
    if (!fn) return static_cast<int>(cudaErrorNotSupported);
    const void* ptrs[5] = {a, y, dy, da, db};
    for (int i = 0; i < 5; ++i)
      if (!encode_btw(fn, &maps[i], ptrs[i], B, T, W, CH, window))
        return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long grid = (long long)B * p.strips;
  if (grid >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      tma ? launch_route<true>(window, maps, p, (int)grid, s)
          : launch_route<false>(window, maps, p, (int)grid, s));
}

const char* rglru_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
