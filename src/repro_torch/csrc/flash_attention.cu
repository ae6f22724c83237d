// Flash attention for Hopper: online-softmax attention over bf16 q, k, v.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py,
// body _flash_kernel): the same function (causal, local with a window, or no
// mask; GQA with kv head h // (H / KV); scale 1/sqrt(dh); masked scores set
// to -1e30; m, l and the output accumulator in fp32; l floored at 1e-30).
// The TPU kernel walks kv blocks as the sequential axis of its grid and
// carries m, l and acc in VMEM scratch; here one CTA owns a (b, h, 64-row
// query block) and loops over kv blocks itself, with the carry in registers.
//
// Layout: q and out are (B, Sq, H, dh), k and v (B, Skv, KV, dh), contiguous;
// the kernel reads the head's rows with strides, so nothing is transposed.
// Four warps each own 16 query rows. Scores and P @ V run on the tensor
// cores through mma.sync m16n8k16 (bf16 in, fp32 accumulate): the score
// fragment is the A operand of P @ V once packed to bf16, so P never leaves
// registers. K and V tiles (64 x dh) are staged in shared memory.
//
// Bound: at the prefill shape (B 4, S 128, 16 heads, dh 64) the work is
// small and the kernel is bound by launch and latency more than by bytes or
// operations; at long S it is bound by tensor-core operations. For causal
// and local masks the kernel skips kv blocks that no row of the query block
// can see, which is exact (the TPU kernel visits every block). Ragged Sq and
// Skv are masked by position: kv rows past Skv are excluded, query rows past
// Sq are not written. Rows with no visible key exist only for a local mask
// with Sq > Skv, which the wrapper refuses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BKV = 64;
constexpr int THREADS = 128;               // 4 warps x 16 query rows
constexpr float NEG = -1e30f;
enum MaskKind { MASK_NONE = 0, MASK_CAUSAL = 1, MASK_LOCAL = 2 };

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo = low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16, row) @ b (16x8, col); fragment layouts of the PTX ISA.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [row0, row0 + 64) of a (rows, stride) matrix into a 64 x DH tile;
// rows at or past nrows are zero.
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int row0, int nrows) {
  constexpr int LD = DH + 8, CH = DH / 8;
  for (int c = threadIdx.x; c < 64 * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride
                                            + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out, int Sq, int Skv,
                       int H, int KV, int mask_kind, int window, float scale) {
  constexpr int LD = DH + 8;     // padded rows: conflict-free fragment reads
  constexpr int KQ = DH / 16;    // k-steps of q @ k^T
  constexpr int ND = DH / 8;     // n-tiles of the output
  constexpr int NS = BKV / 8;    // n-tiles of the scores
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BKV * LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;    // mma group id, thread in group
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const size_t q_stride = (size_t)H * DH, kv_stride = (size_t)KV * DH;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * q_stride + (size_t)h * DH;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * kv_stride
                            + (size_t)kvh * DH;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * kv_stride
                            + (size_t)kvh * DH;

  // The query tile passes through Ks into registers (A fragments).
  load_tile<DH>(Ks, qb, q_stride, q0, Sq);
  __syncthreads();
  uint32_t qf[KQ][4];
  {
    const __nv_bfloat16* base = Ks + (warp * 16 + g) * LD + t * 2;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      qf[kk][0] = ld32(base + kk * 16);
      qf[kk][1] = ld32(base + 8 * LD + kk * 16);
      qf[kk][2] = ld32(base + kk * 16 + 8);
      qf[kk][3] = ld32(base + 8 * LD + kk * 16 + 8);
    }
  }
  __syncthreads();

  const int qa = q0 + warp * 16 + g, qb8 = qa + 8;   // this thread's 2 rows
  int kv_lo = 0, kv_hi = Skv;
  if (mask_kind != MASK_NONE)
    kv_hi = min(Skv, min(q0 + BQ, Sq));             // keys <= last row
  if (mask_kind == MASK_LOCAL && window > 0)
    kv_lo = (max(0, q0 - window + 1) / BKV) * BKV;  // keys > first row - w

  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += BKV) {
    load_tile<DH>(Ks, kb, kv_stride, kv0, Skv);
    load_tile<DH>(Vs, vb, kv_stride, kv0, Skv);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kp = Ks + (j * 8 + g) * LD + t * 2;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk)
        mma_bf16(s[j], qf[kk], ld32(kp + kk * 16), ld32(kp + kk * 16 + 8));
    }

    // scale, mask, and the running row max (rows qa: s[.][0..1],
    // qb8: s[.][2..3]; the 4 threads of a group share a row)
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = kv0 + j * 8 + t * 2 + e;
        float va = s[j][e] * scale, vb2 = s[j][2 + e] * scale;
        if (kpos >= Skv) {
          va = vb2 = -INFINITY;                     // not a key at all
        } else {
          if (mask_kind != MASK_NONE) {
            if (kpos > qa) va = NEG;
            if (kpos > qb8) vb2 = NEG;
          }
          if (mask_kind == MASK_LOCAL && window > 0) {
            if (kpos <= qa - window) va = NEG;
            if (kpos <= qb8 - window) vb2 = NEG;
          }
        }
        s[j][e] = va;
        s[j][2 + e] = vb2;
        mx_a = fmaxf(mx_a, va);
        mx_b = fmaxf(mx_b, vb2);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float corr_a = expf(m_a - mx_a), corr_b = expf(m_b - mx_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = expf(s[j][0] - mx_a);
      s[j][1] = expf(s[j][1] - mx_a);
      s[j][2] = expf(s[j][2] - mx_b);
      s[j][3] = expf(s[j][3] - mx_b);
      sum_a += s[j][0] + s[j][1];
      sum_b += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
    m_a = mx_a;
    m_b = mx_b;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr_a;
      o[n][1] *= corr_a;
      o[n][2] *= corr_b;
      o[n][3] *= corr_b;
    }

    // o += P @ V: the score fragments of n-tiles 2kk and 2kk+1 form the
    // A fragment of k-step kk.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                              pack_f32(s[2 * kk][2], s[2 * kk][3]),
                              pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vp = Vs + (kk * 16 + t * 2) * LD + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* c = vp + n * 8;
        mma_bf16(o[n], pa, pack_bf16(c[0], c[LD]),
                 pack_bf16(c[8 * LD], c[9 * LD]));
      }
    }
    __syncthreads();
  }

  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  __nv_bfloat16* ob = out + (size_t)b * Sq * q_stride + (size_t)h * DH
                      + t * 2;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (qa < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)qa * q_stride + n * 8) =
          pack_f32(o[n][0] / den_a, o[n][1] / den_a);
    if (qb8 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)qb8 * q_stride + n * 8) =
          pack_f32(o[n][2] / den_b, o[n][3] / den_b);
  }
}

}  // namespace

extern "C" {

int flash_attention_block_q() { return BQ; }

// mask_kind: 0 none, 1 causal, 2 local (window > 0). dh must be 64 or 128.
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Skv, int H, int KV,
                         int dh, int mask_kind, int window, float scale,
                         void* stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (dh == 64)
    flash_attention_kernel<64><<<grid, THREADS, 0, s>>>(
        qp, kp, vp, op, Sq, Skv, H, KV, mask_kind, window, scale);
  else if (dh == 128)
    flash_attention_kernel<128><<<grid, THREADS, 0, s>>>(
        qp, kp, vp, op, Sq, Skv, H, KV, mask_kind, window, scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
