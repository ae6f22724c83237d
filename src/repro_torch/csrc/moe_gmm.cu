// Grouped (per-expert) bf16 matmul for Hopper:
//   out[e] (C, F) = x[e] (C, D) @ w[e] (D, F),   e < E.
//
// Replaces moe_gmm_pallas (src/repro/kernels/moe_gmm.py, body _gmm_kernel):
// one CTA per (expert, output tile) with the D loop inside it, fp32
// accumulation, output cast to bf16. The TPU kernel's sequential D grid
// axis with its VMEM accumulator becomes that loop, since CTAs run in no
// order. The mainloop is gemm_sm90.cuh's, shared with matmul_tiled.cu,
// with an expert grid axis: a 4-stage TMA ring drained by wgmma. The grid
// is not persistent, so its size is the B of paper Eq. 3.
//
// x is read through an expert stride and a row stride (its D stride is 1):
// the dense MoE path hands the same (T, D) activations to every expert with
// expert stride 0, and its tensor map then holds the one (T, D) matrix that
// every expert reads, so no E copies are written. w (E, D, F) is a 3-D map,
// so a D tile past the expert's end is zero-filled, not read from the next
// expert. w and out are contiguous.
//
// Bound: at granite's dense prefill (E = 32, C = 512, D x F = 1024 x 512)
// gate and up do 17.2 GFLOP against 51 MB, above the H100's ridge of ~295
// bf16 ops/byte, and take the prefill form (128 x 64 tiles by default,
// m64n128k16, 1024 CTAs; 64 or 256 rows where the caller asks); down writes a 33.5 MB output and is bound by bytes. At decode (C = 4) every product is bound by reading the 33.5 MB of
// expert weights and takes the decode form: 64 x 64 tiles over D chunks of
// SPLIT_K = 256 (1024 CTAs for gate/up and for down), summed in chunk order
// by each tile's last CTA. The capacity buffers (C = 161) take the prefill
// form. Ragged C, D and F are masked in the kernel, with no host padding.
//
// The backward (moe_gmm_bwd_bf16; no Pallas counterpart) runs the same
// mainloop on the operands where they lie: dX = dY W^T reads w (E, D, F)
// as a K-major w, dW = X^T dY reads x as an MN-major x (a broadcast x
// through its one (C, D) map), so no transposed copy is made, on the
// backward's tiles.

#include "gemm_sm90.cuh"

extern "C" {

// The tiles and the chunk, so the Python side computes the schedule and
// the grid (paper Eq. 3's B) from the kernel itself.
int moe_gmm_block_c() { return gemm_sm90::PREFILL_BLOCK_M; }
// The prefill tiles' rows (of C), smallest first, into out (at most cap);
// returns their number.
int moe_gmm_tiles(int* out, int cap) {
  for (int i = 0; i < gemm_sm90::N_PREFILL_TILES && i < cap; ++i)
    out[i] = gemm_sm90::PREFILL_TILES[i];
  return gemm_sm90::N_PREFILL_TILES;
}
int moe_gmm_block_f() { return gemm_sm90::BN; }
int moe_gmm_decode_block_c() { return gemm_sm90::DECODE_BLOCK_M; }
int moe_gmm_split_k() { return gemm_sm90::SPLIT_K; }
int moe_gmm_block_k() { return gemm_sm90::BK; }

// The kernel's form on `device` (decode != 0: the decode form, block_m
// its 64; else the prefill tile of block_m rows) into out[5]: threads a
// CTA, registers a thread, dynamic shared memory bytes, CTAs an SM holds
// at once, local (spilled) bytes a thread. Returns 0 or a cudaError_t: the
// occupancy that paper Eq. 3's wave count divides by.
int moe_gmm_form(int decode, int block_m, int device, int* out) {
  return gemm_sm90::form(0, decode, block_m, gemm_sm90::BN, 0, 0, device,
                         out);
}

// The backward's prefill tiles as (rows of C, columns of F) pairs into out
// (at most cap pairs); returns their number.
int moe_gmm_bwd_tiles(int* out, int cap) {
  for (int i = 0; i < gemm_sm90::N_BWD_TILES && i < cap; ++i) {
    out[2 * i] = gemm_sm90::BWD_TILES[i][0];
    out[2 * i + 1] = gemm_sm90::BWD_TILES[i][1];
  }
  return gemm_sm90::N_BWD_TILES;
}

// The backward's form, as matmul_tiled_bwd_form.
int moe_gmm_bwd_form(int decode, int block_c, int block_f, int xm, int wk,
                     int device, int* out) {
  return gemm_sm90::form(1, decode, block_c, block_f, xm, wk, device, out);
}

// x: expert stride sx_e and row stride sx_r in elements, unit D stride;
// w (E, D, F) and out (E, C, F) contiguous. decode != 0: the decode form
// over `splits` chunks of D (ws: splits x E x C x F floats when splits > 1;
// counters: E x ceil(F / 64) zeroed ints), block_c 64; else the prefill
// tile of block_c rows (moe_gmm_tiles). vec != 0 promises D % 8 == 0,
// F % 8 == 0, strides that are multiples of 8 and 16-byte aligned x and w.
// Launches on `device`'s `stream`. Returns 1 (TMA loads) or 0 (element-wise
// loads), or minus a cudaError_t (cudaErrorInvalidValue for an unknown
// tile).
int moe_gmm_bf16(const void* x, const void* w, void* out, void* ws,
                 void* counters, int E, int C, int D, int F, long long sx_e,
                 long long sx_r, int decode, int splits, int vec,
                 int block_c, int device, void* stream) {
  return gemm_sm90::launch(x, w, out, ws, counters, E, C, F, D, sx_e, sx_r,
                           (long long)D * F, F, 0, 0, 0, decode, splits,
                           vec, block_c, gemm_sm90::BN, device, stream);
}

// A product of the backward, as matmul_tiled_bwd_bf16 with (C, D, F) for
// (M, K, N): x (E, C, D) and w (E, D, F) read where they lie.
int moe_gmm_bwd_bf16(const void* x, const void* w, void* out, void* ws,
                     void* counters, int E, int C, int F, int D,
                     long long sx_e, long long sx_r, long long sw_e,
                     long long sw_r, int xm, int wk, int decode, int splits,
                     int vec, int block_c, int block_f, int device,
                     void* stream) {
  return gemm_sm90::launch(x, w, out, ws, counters, E, C, F, D, sx_e, sx_r,
                           sw_e, sw_r, xm, wk, 1, decode, splits, vec,
                           block_c, block_f, device, stream);
}

const char* moe_gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
