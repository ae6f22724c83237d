"""Tile-quantized matmul: the CUDA kernel's wrapper and its plain version.

Replaces ``matmul_pallas`` (``src/repro/kernels/matmul_tiled.py``, body
``matmul_kernel``) with ``csrc/matmul_tiled.cu``: one CTA per (64, 64)
output tile with the K loop inside the CTA, bf16 tiles in shared memory,
WMMA on the tensor cores, fp32 accumulation, bf16 output. At the MLP's
prefill shapes the product is bound by tensor-core operations, at decode by
reading the weight; this first kernel is simple and right, not yet fast.
Ragged M, N and K are masked in the kernel, so unlike ``repro``'s
``ops.matmul`` nothing is padded on the host. The grid is not persistent:
its CTA count (:func:`grid_blocks`) is the B of paper Eq. 3, and the wave
tail over the card's SMs shows in the kernel's time.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "matmul_tiled"
BLOCK_M = 64      # the kernel's tile; csrc/matmul_tiled.cu checks it
BLOCK_N = 64


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: (M, K) @ (K, N) accumulated in fp32, cast to x.dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def grid_blocks(m: int, n: int) -> int:
    """CTAs the kernel launches for an (m, n) output: paper Eq. 3's B.
    K does not count, since each CTA loops over it."""
    return -(-m // BLOCK_M) * -(-n // BLOCK_N)


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.matmul_tiled_bf16.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
    lib.matmul_tiled_bf16.restype = ci
    lib.matmul_tiled_error_string.argtypes = [ci]
    lib.matmul_tiled_error_string.restype = ctypes.c_char_p
    for fn in (lib.matmul_tiled_block_m, lib.matmul_tiled_block_n):
        fn.argtypes = []
        fn.restype = ci
    if (lib.matmul_tiled_block_m(), lib.matmul_tiled_block_n()) != (
            BLOCK_M, BLOCK_N):
        raise RuntimeError("matmul_tiled.cu tile differs from BLOCK_M/BLOCK_N")


def matmul_tiled(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: x (M, K) bf16 @ w (K, N) bf16 -> (M, N) bf16,
    on CUDA tensors, on the current stream."""
    if not (x.is_cuda and w.is_cuda) or x.device != w.device:
        raise ValueError(f"matmul_tiled: x and w must lie on one CUDA "
                         f"device, got {x.device} and {w.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"matmul_tiled: takes bf16, got {x.dtype} and "
                        f"{w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_tiled: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not multiply")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("matmul_tiled: x and w must be contiguous")
    m, k = x.shape
    n = w.shape[1]
    if -(-m // BLOCK_M) > 65535:
        raise ValueError(f"matmul_tiled: M={m} exceeds the grid's y limit")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    vec = int(k % 8 == 0 and n % 8 == 0 and x.data_ptr() % 16 == 0
              and w.data_ptr() % 16 == 0)
    lib = build.load(NAME, _bind)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.matmul_tiled_bf16(x.data_ptr(), w.data_ptr(),
                                    out.data_ptr(), m, n, k, vec, stream)
    if err:
        raise RuntimeError(f"matmul_tiled launch failed: "
                           f"{lib.matmul_tiled_error_string(err).decode()}")
    build.LAUNCHES[NAME] += 1
    return out
