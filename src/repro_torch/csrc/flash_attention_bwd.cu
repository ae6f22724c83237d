// Flash attention's backward for Hopper: dQ, dK and dV of bf16 attention.
//
// The gradient of flash_attention.cu's function (causal or no mask; GQA
// with kv head h // (H / KV); scale 1/sqrt(dh)). flash_attention_pallas
// (src/repro/kernels/flash_attention.py) has no backward: repro trains
// through plain JAX, and this kernel is held to jax.grad of that plain
// attention (through attention_bwd_ref) on the CPU, and to
// attention_bwd_ref on the card.
//
// FlashAttention-2's recomputation scheme, from the forward's output O and
// its row log-sum-exp L (flash_attention_bf16 with a non-null lse, natural log, fp32):
//   D = rowsum(dO * O)                          (delta_kernel, a warp a row)
//   P = exp(S * scale - L), S = Q K^T           (recomputed, never stored)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D)
//   dK = scale * dS^T Q,  dQ = scale * dS K
// in two passes that share no output, so nothing is summed across CTAs
// and no atomics are used: two calls on the same inputs are bit-equal.
// - dkdv_kernel: one CTA per (batch x kv head, 64-key block). It keeps its
//   K and V tiles in shared memory and walks every query block of every
//   head of its GQA group, each warp owning 16 keys: S^T = K Q^T and
//   dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q with P^T and dS^T
//   taken from the accumulators as the A operand.
// - dq_kernel: one CTA per (batch x head, 64-query block), each warp
//   owning 16 queries: S = Q K^T and dP = dO V^T per key block, then
//   dQ += dS K.
// Under the causal mask a pass skips the blocks that no row of its block
// sees (keys after the query block's last row; query blocks before the key
// block's first key), which is exact.
//
// The products run on mma.sync m16n8k16 (bf16 operands, fp32
// accumulation): P and dS are rounded to bf16 as operands, as the forward
// rounds P before P V. Tiles are copied into shared memory with 16-byte
// loads, rows padded by 16 bytes so that a fragment's 32-bit loads hit 32
// banks; an operand read along rows (dO, Q or K as the B of a product over
// tokens) is gathered as pairs of 16-bit loads. Rows past Sq or Skv are
// zero-filled and masked by position.
//
// Bound: at the training shape (B 8, S 128, 16 heads, dh 64, causal) the
// work is five products over the visible pairs, 0.68 GFLOP, against 16.8
// MB to move: bytes bound it (5 us at 3.35 TB/s), and in practice the
// three launches and each CTA's serial walk over its blocks do. At long
// sequences it is bound by tensor-core operations, at the fraction of the
// card's peak that mma.sync fed from shared memory (no TMA, no wgmma)
// reaches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64, BKV = 64;
constexpr int THREADS = 128;              // 4 warps, 16 rows each
constexpr float LOG2E = 1.4426950408889634f;
enum MaskKind { MASK_NONE = 0, MASK_CAUSAL = 1 };

struct Args {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse;                       // (B, H, Sq), natural log
  float* delta;                           // (B, H, Sq) scratch
  bf16 *dq, *dk, *dv;
  int B, Sq, Skv, H, KV, mask_kind;
  float scale;
};

template <int DH>
struct Form {
  static constexpr int LD = DH + 8;       // padded row, in bf16
  static constexpr int TILE = 64 * LD;    // a 64-row tile, in bf16
  // four tiles, and 64 rows of L and D (the dK/dV pass)
  static constexpr int SMEM = 4 * TILE * 2 + 2 * 64 * 4;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// lo in the low half: the element with the lower k index
__device__ __forceinline__ uint32_t pair(const bf16* lo, const bf16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi))
          << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo = low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16 x 8, fp32) += a (16 x 16, row) b (16 x 8, col)
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 64 rows from row0 of one head of a contiguous (B, S, heads, DH) tensor
// into a padded shared tile; rows past S are zero
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int b,
                                          int row0, int S, int heads,
                                          int head) {
  constexpr int LD = Form<DH>::LD, VEC = DH / 8;
  for (int i = threadIdx.x; i < 64 * VEC; i += THREADS) {
    const int r = i / VEC, c = (i % VEC) * 8, row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S)
      val = *reinterpret_cast<const uint4*>(
          src + (((size_t)b * S + row) * heads + head) * DH + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// acc (16 x 64) = X[r0 .. r0 + 16) Y^T over DH: X's rows as A (row-major
// along DH), Y's 64 rows as the columns of B. acc[n][e]: row g + 8 (e / 2),
// column 8 n + 2 t + (e & 1).
template <int DH>
__device__ __forceinline__ void mma_xyt(float (&acc)[8][4], const bf16* x,
                                        int r0, const bf16* y, int g,
                                        int t) {
  constexpr int LD = Form<DH>::LD;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const bf16* xa = x + (r0 + g) * LD + kk * 16 + 2 * t;
    const uint32_t a0 = ld32(xa), a1 = ld32(xa + 8 * LD), a2 = ld32(xa + 8),
                   a3 = ld32(xa + 8 * LD + 8);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const bf16* yb = y + (n * 8 + g) * LD + kk * 16 + 2 * t;
      mma(acc[n], a0, a1, a2, a3, ld32(yb), ld32(yb + 8));
    }
  }
}

// the accumulator of a 16 x 64 product as the A fragments of its 4
// k-steps of 16 (n-tiles 2 kk and 2 kk + 1), rounded to bf16
__device__ __forceinline__ void to_a(uint32_t (&pa)[4][4],
                                     const float (&acc)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_f32(acc[2 * kk][0], acc[2 * kk][1]);
    pa[kk][1] = pack_f32(acc[2 * kk][2], acc[2 * kk][3]);
    pa[kk][2] = pack_f32(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
    pa[kk][3] = pack_f32(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
  }
}

// out (16 x DH) += A (16 x 64, fragments pa) Z (64 rows x DH, row-major):
// Z's rows are the k index, so each B register is two 16-bit loads
template <int DH>
__device__ __forceinline__ void mma_az(float (&out)[DH / 8][4],
                                       const uint32_t (&pa)[4][4],
                                       const bf16* z, int g, int t) {
  constexpr int LD = Form<DH>::LD;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* zb = z + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const bf16* p = zb + n * 8;
      mma(out[n], pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3],
          pair(p, p + LD), pair(p + 8 * LD, p + 9 * LD));
    }
  }
}

// a 16 x DH fp32 accumulator times `mul`, as bf16, into rows ra and ra + 8
// (below `rows`) of one head of a (B, rows, heads, DH) tensor
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[DH / 8][4],
                                           float mul, int b, int ra,
                                           int rows, int heads, int head,
                                           int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = ra + 8 * half;
    if (row >= rows) continue;
    bf16* p = dst + (((size_t)b * rows + row) * heads + head) * DH + 2 * t;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(p + 8 * n) =
          pack_f32(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
  }
}

// D = rowsum(dO * O) in fp32, a warp a (b, i, h) row, into (B, H, Sq)
template <int DH>
__global__ void __launch_bounds__(THREADS) delta_kernel(const Args a) {
  const int lane = threadIdx.x % 32;
  const size_t row = (size_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= (size_t)a.B * a.Sq * a.H) return;
  const bf16* o = a.o + row * DH;
  const bf16* d = a.dout + row * DH;
  float sum = 0.f;
#pragma unroll
  for (int c = 2 * lane; c < DH; c += 64) {
    const float2 of = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(o + c));
    const float2 df = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(d + c));
    sum += of.x * df.x + of.y * df.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int h = row % a.H, i = (row / a.H) % a.Sq;
    const int b = row / ((size_t)a.H * a.Sq);
    a.delta[((size_t)b * a.H + h) * a.Sq + i] = sum;
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(const Args a) {
  using F = Form<DH>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + F::TILE;
  bf16* sq = sv + F::TILE;
  bf16* sdo = sq + F::TILE;
  float* sl = reinterpret_cast<float*>(sdo + F::TILE);   // L * log2(e)
  float* sd = sl + 64;                                   // D
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / a.KV, kvh = blockIdx.y % a.KV;
  const int group = a.H / a.KV;
  const int kv0 = blockIdx.x * BKV, r0 = warp * 16;
  const int ka = kv0 + r0 + g;            // this thread's keys ka, ka + 8
  const float c2 = a.scale * LOG2E;
  const bool causal = a.mask_kind == MASK_CAUSAL;
  // the first query block that sees a key of this block
  const int q_begin = causal ? (kv0 / BQ) * BQ : 0;

  load_tile<DH>(sk, a.k, b, kv0, a.Skv, a.KV, kvh);
  load_tile<DH>(sv, a.v, b, kv0, a.Skv, a.KV, kvh);
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int hg = 0; hg < group; ++hg) {
    const int h = kvh * group + hg;
    const size_t rows = ((size_t)b * a.H + h) * a.Sq;
    for (int q0 = q_begin; q0 < a.Sq; q0 += BQ) {
      __syncthreads();                    // the last block's tiles are read
      load_tile<DH>(sq, a.q, b, q0, a.Sq, a.H, h);
      load_tile<DH>(sdo, a.dout, b, q0, a.Sq, a.H, h);
      if (threadIdx.x < 64) {
        const int qi = q0 + threadIdx.x;
        sl[threadIdx.x] = qi < a.Sq ? a.lse[rows + qi] * LOG2E : 0.f;
        sd[threadIdx.x] = qi < a.Sq ? a.delta[rows + qi] : 0.f;
      }
      __syncthreads();
      // P^T = exp(S^T scale - L) over (16 keys, 64 queries) a warp
      float s[8][4];
      mma_xyt<DH>(s, sk, r0, sq, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = ka + 8 * (e >> 1), col = n * 8 + 2 * t + (e & 1);
          const int qi = q0 + col;
          const bool seen = key < a.Skv && qi < a.Sq && (!causal || key <= qi);
          s[n][e] = seen ? exp2f(s[n][e] * c2 - sl[col]) : 0.f;
        }
      uint32_t pa[4][4];
      to_a(pa, s);
      mma_az<DH>(dv, pa, sdo, g, t);      // dV += P^T dO
      // dS^T = P^T (dP^T - D), dP^T = V dO^T
      float dp[8][4];
      mma_xyt<DH>(dp, sv, r0, sdo, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[n][e] = s[n][e] * (dp[n][e] - sd[n * 8 + 2 * t + (e & 1)]);
      to_a(pa, dp);
      mma_az<DH>(dk, pa, sq, g, t);       // dK += dS^T Q
    }
  }
  store_rows<DH>(a.dk, dk, a.scale, b, ka, a.Skv, a.KV, kvh, t);
  store_rows<DH>(a.dv, dv, 1.f, b, ka, a.Skv, a.KV, kvh, t);
}

template <int DH>
__global__ void __launch_bounds__(THREADS) dq_kernel(const Args a) {
  using F = Form<DH>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + F::TILE;
  bf16* sk = sdo + F::TILE;
  bf16* sv = sk + F::TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = blockIdx.x * BQ, r0 = warp * 16;
  const int qa = q0 + r0 + g;             // this thread's rows qa, qa + 8
  const float c2 = a.scale * LOG2E;
  const bool causal = a.mask_kind == MASK_CAUSAL;
  const size_t rows = ((size_t)b * a.H + h) * a.Sq;
  float l[2], d[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = qa + 8 * half;
    l[half] = qi < a.Sq ? a.lse[rows + qi] * LOG2E : 0.f;
    d[half] = qi < a.Sq ? a.delta[rows + qi] : 0.f;
  }
  load_tile<DH>(sq, a.q, b, q0, a.Sq, a.H, h);
  load_tile<DH>(sdo, a.dout, b, q0, a.Sq, a.H, h);
  float dq[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  // keys after the block's last row are masked for every row
  const int kv_hi = causal ? min(a.Skv, min(q0 + BQ, a.Sq)) : a.Skv;

  for (int kv0 = 0; kv0 < kv_hi; kv0 += BKV) {
    __syncthreads();                      // the last block's tiles are read
    load_tile<DH>(sk, a.k, b, kv0, a.Skv, a.KV, kvh);
    load_tile<DH>(sv, a.v, b, kv0, a.Skv, a.KV, kvh);
    __syncthreads();
    float s[8][4], dp[8][4];
    mma_xyt<DH>(s, sq, r0, sk, g, t);     // S = Q K^T
    mma_xyt<DH>(dp, sdo, r0, sv, g, t);   // dP = dO V^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1, qi = qa + 8 * half;
        const int key = kv0 + n * 8 + 2 * t + (e & 1);
        const bool seen = key < a.Skv && qi < a.Sq && (!causal || key <= qi);
        const float p = seen ? exp2f(s[n][e] * c2 - l[half]) : 0.f;
        dp[n][e] = p * (dp[n][e] - d[half]);
      }
    uint32_t pa[4][4];
    to_a(pa, dp);
    mma_az<DH>(dq, pa, sk, g, t);         // dQ += dS K
  }
  store_rows<DH>(a.dq, dq, a.scale, b, qa, a.Sq, a.H, h, t);
}

template <typename K>
cudaError_t smem_attr(K kernel, int bytes) {
  // above 48 KB of dynamic shared memory needs the attribute; setting it
  // at every launch costs one runtime call, far below the launches' time
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int DH>
cudaError_t launch_dh(const Args& a, cudaStream_t s) {
  using F = Form<DH>;
  cudaError_t err = smem_attr(dkdv_kernel<DH>, F::SMEM);
  if (err != cudaSuccess) return err;
  err = smem_attr(dq_kernel<DH>, F::SMEM);
  if (err != cudaSuccess) return err;
  const size_t rows = (size_t)a.B * a.Sq * a.H;
  const unsigned warps = THREADS / 32;
  delta_kernel<DH><<<(unsigned)((rows + warps - 1) / warps), THREADS, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<DH><<<dim3((a.Skv + BKV - 1) / BKV, a.B * a.KV), THREADS,
                    F::SMEM, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<DH><<<dim3((a.Sq + BQ - 1) / BQ, a.B * a.H), THREADS, F::SMEM,
                  s>>>(a);
  return cudaGetLastError();
}

template <int DH>
int form_dh(int* out) {
  cudaFuncAttributes kv, q;
  cudaError_t err = cudaFuncGetAttributes(&kv, dkdv_kernel<DH>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&q, dq_kernel<DH>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = THREADS;
  out[1] = Form<DH>::SMEM;
  out[2] = kv.numRegs;
  out[3] = static_cast<int>(kv.localSizeBytes);
  out[4] = q.numRegs;
  out[5] = static_cast<int>(q.localSizeBytes);
  return 0;
}

}  // namespace

extern "C" {

int flash_attention_bwd_block() { return BQ; }

// Both passes' form at head dim dh, into out[6]: threads a CTA, dynamic
// shared memory bytes, then registers and spilled bytes a thread of the
// dK/dV pass and of the dQ pass. Returns 0 or a cudaError_t.
int flash_attention_bwd_form(int dh, int* out) {
  if (dh == 64) return form_dh<64>(out);
  if (dh == 128) return form_dh<128>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// mask_kind: 0 none, 1 causal. q, o, dout, dq: (B, Sq, H, dh); k, v, dk,
// dv: (B, Skv, KV, dh); bf16, contiguous, 16-byte aligned; lse and delta
// (B, H, Sq) fp32 (delta is written). Three launches on `stream`.
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const float* lse, float* delta, void* dq,
                             void* dk, void* dv, int B, int Sq, int Skv,
                             int H, int KV, int dh, int mask_kind,
                             float scale, void* stream) {
  if ((dh != 64 && dh != 128) || (mask_kind != MASK_NONE &&
                                  mask_kind != MASK_CAUSAL))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
  a.H = H;
  a.KV = KV;
  a.mask_kind = mask_kind;
  a.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dh == 64 ? launch_dh<64>(a, s) : launch_dh<128>(a, s);
  return static_cast<int>(err);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
