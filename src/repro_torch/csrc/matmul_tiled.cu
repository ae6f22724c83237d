// Tile-quantized bf16 matmul for Hopper: out (M, N) = x (M, K) @ w (K, N).
//
// Replaces matmul_pallas (src/repro/kernels/matmul_tiled.py, body
// matmul_kernel): one CTA per output tile with the K loop inside it, fp32
// accumulation, output cast to bf16. The mainloop is gemm_sm90.cuh's, with
// one expert: a 4-stage ring of 128-byte-swizzled tiles filled by TMA (one
// producer warpgroup, mbarriers) and drained by wgmma (one consumer
// warpgroup, computing the tile transposed so that the tokens are wgmma's
// N). The grid is not persistent, so its size is the B of paper Eq. 3 and
// the wave tail over the SMs stays visible.
//
// Bound: at the MLP's prefill shapes (M = 512) the product does about 300
// operations per byte it must move, at the H100's ridge of ~295 bf16
// ops/byte, and takes the prefill form: BM x 64 tiles, BM 64, 128 (the
// default, m64n128k16) or 256 as the caller asks, the whole of K in each
// CTA, one CTA per SM (gemm_sm90.cuh says why). At
// decode (M = batch = 4) reading the weight bounds it; the decode form
// (64 x 64 tiles) cuts K into fixed chunks of SPLIT_K = 256, so
// qwen1.5-0.5b's products launch 176 CTAs and recurrentgemma-2b's 1200,
// more than one wave of 132 SMs, and the chunks' fp32 partials are summed
// in chunk order by the tile's last CTA.
// Ragged M, N and K are masked in the kernel (zero-filled by TMA, or by the
// element-wise loads where TMA cannot take the strides), with no host
// padding.
//
// The backward (matmul_tiled_bwd_bf16; no Pallas counterpart) runs the same
// mainloop on the operands where they lie: dX = dY W^T reads W (K, N) as a
// K-major w, dW = X^T dY reads X (M, K) as an MN-major x, so no transposed
// copy is made, on the backward's tiles (BWD_TILES, up to two consumer
// warpgroups on one x tile).

#include "gemm_sm90.cuh"

extern "C" {

// The tiles and the chunk, so the Python side computes the schedule and
// the grid (paper Eq. 3's B) from the kernel itself.
int matmul_tiled_block_m() { return gemm_sm90::PREFILL_BLOCK_M; }
// The prefill tiles' rows, smallest first, into out (at most cap); returns
// their number.
int matmul_tiled_tiles(int* out, int cap) {
  for (int i = 0; i < gemm_sm90::N_PREFILL_TILES && i < cap; ++i)
    out[i] = gemm_sm90::PREFILL_TILES[i];
  return gemm_sm90::N_PREFILL_TILES;
}
int matmul_tiled_block_n() { return gemm_sm90::BN; }
int matmul_tiled_decode_block_m() { return gemm_sm90::DECODE_BLOCK_M; }
int matmul_tiled_split_k() { return gemm_sm90::SPLIT_K; }
int matmul_tiled_block_k() { return gemm_sm90::BK; }

// The kernel's form on `device` (decode != 0: the decode form, block_m
// its 64; else the prefill tile of block_m rows) into out[5]: threads a
// CTA, registers a thread, dynamic shared memory bytes, CTAs an SM holds
// at once, local (spilled) bytes a thread. Returns 0 or a cudaError_t: the
// occupancy that paper Eq. 3's wave count divides by.
int matmul_tiled_form(int decode, int block_m, int device, int* out) {
  return gemm_sm90::form(0, decode, block_m, gemm_sm90::BN, 0, 0, device,
                         out);
}

// The backward's prefill tiles as (rows, columns) pairs into out (at most
// cap pairs); returns their number.
int matmul_tiled_bwd_tiles(int* out, int cap) {
  for (int i = 0; i < gemm_sm90::N_BWD_TILES && i < cap; ++i) {
    out[2 * i] = gemm_sm90::BWD_TILES[i][0];
    out[2 * i + 1] = gemm_sm90::BWD_TILES[i][1];
  }
  return gemm_sm90::N_BWD_TILES;
}

// The backward's form (decode != 0: the decode tile, 64 x 64; else one of
// the backward's tiles) with x MN-major (xm) or w K-major (wk), as
// matmul_tiled_form.
int matmul_tiled_bwd_form(int decode, int block_m, int block_n, int xm,
                          int wk, int device, int* out) {
  return gemm_sm90::form(1, decode, block_m, block_n, xm, wk, device, out);
}

// decode != 0: the decode form over `splits` chunks (ws: splits x M x N
// floats when splits > 1; counters: ceil(N / 64) zeroed ints), block_m 64;
// else the prefill tile of block_m rows (matmul_tiled_tiles). vec != 0
// promises K % 8 == 0, N % 8 == 0 and 16-byte aligned x and w. Launches
// on `device`'s `stream`. Returns 1 (TMA loads) or 0 (element-wise loads),
// or minus a cudaError_t (cudaErrorInvalidValue for an unknown tile).
int matmul_tiled_bf16(const void* x, const void* w, void* out, void* ws,
                      void* counters, int M, int N, int K, int decode,
                      int splits, int vec, int block_m, int device,
                      void* stream) {
  return gemm_sm90::launch(x, w, out, ws, counters, 1, M, N, K, 0, K,
                           (long long)K * N, N, 0, 0, 0, decode, splits,
                           vec, block_m, gemm_sm90::BN, device, stream);
}

// A product of the backward, out[e] (M, N) = x[e] (M, K) @ w[e] (K, N):
// x with expert stride sx_e (0: one x for every expert), unit K stride
// and row stride sx_r, or (xm) unit M stride and K stride sx_r; w with
// expert stride sw_e, unit N stride and row stride sw_r, or (wk) unit K
// stride and N stride sw_r; out (E, M, N) contiguous. The tile (block_m,
// block_n) is the decode tile (decode != 0) or one of
// matmul_tiled_bwd_tiles; vec != 0 promises 16-byte aligned x and w and
// strides that are multiples of 8. Otherwise as matmul_tiled_bf16.
int matmul_tiled_bwd_bf16(const void* x, const void* w, void* out, void* ws,
                          void* counters, int E, int M, int N, int K,
                          long long sx_e, long long sx_r, long long sw_e,
                          long long sw_r, int xm, int wk, int decode,
                          int splits, int vec, int block_m, int block_n,
                          int device, void* stream) {
  return gemm_sm90::launch(x, w, out, ws, counters, E, M, N, K, sx_e, sx_r,
                           sw_e, sw_r, xm, wk, 1, decode, splits, vec,
                           block_m, block_n, device, stream);
}

const char* matmul_tiled_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
