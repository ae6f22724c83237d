"""Grouped (per-expert) matmul: the CUDA kernel's wrapper and its plain
version (``repro.kernels.moe_gmm``'s counterpart).

Both compute ``out[e] = x[e] @ w[e]`` for x (E, C, D) and w (E, D, F), with
fp32 accumulation and the output in x.dtype: the expert products of the MoE
layer, where C is the tokens (the dense strategy, x the same for every
expert) or an expert's capacity buffer (the capacity strategy).

``moe_gmm`` launches ``csrc/moe_gmm.cu``, which replaces ``moe_gmm_pallas``
(``src/repro/kernels/moe_gmm.py``, body ``_gmm_kernel``): one CTA per
(expert, 64-row C tile, 64-column F tile) with the D loop inside the CTA,
bf16 tiles in shared memory, WMMA on the tensor cores, fp32 accumulation,
bf16 output. It reads x through its expert and row strides, so a broadcast
x (``x.expand(E, T, D)``, expert stride 0) costs no copy. Ragged C, D and F
are masked in the kernel, so unlike ``repro``'s ``ops.moe_gmm`` nothing is
padded on the host. The grid is not persistent: its CTA count
(:func:`grid_blocks`) is the B of paper Eq. 3.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "moe_gmm"
BLOCK_C = 64      # the kernel's tile; csrc/moe_gmm.cu checks it
BLOCK_F = 64


def moe_gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: (E, C, D) @ (E, D, F) per expert, accumulated in
    fp32, cast to x.dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def grid_blocks(e: int, c: int, f: int) -> int:
    """CTAs the kernel launches for an (e, c, f) output: paper Eq. 3's B.
    D does not count, since each CTA loops over it."""
    return e * -(-c // BLOCK_C) * -(-f // BLOCK_F)


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.moe_gmm_bf16.argtypes = [vp, vp, vp, ci, ci, ci, ci, ll, ll, ci, vp]
    lib.moe_gmm_bf16.restype = ci
    lib.moe_gmm_error_string.argtypes = [ci]
    lib.moe_gmm_error_string.restype = ctypes.c_char_p
    for fn in (lib.moe_gmm_block_c, lib.moe_gmm_block_f):
        fn.argtypes = []
        fn.restype = ci
    if (lib.moe_gmm_block_c(), lib.moe_gmm_block_f()) != (BLOCK_C, BLOCK_F):
        raise RuntimeError("moe_gmm.cu tile differs from BLOCK_C/BLOCK_F")


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: x (E, C, D) bf16 @ w (E, D, F) bf16 -> (E, C, F)
    bf16, on CUDA tensors, on the current stream. x may have any expert
    and row strides (0 included) but a unit D stride; w is contiguous."""
    if not (x.is_cuda and w.is_cuda) or x.device != w.device:
        raise ValueError(f"moe_gmm: x and w must lie on one CUDA device, "
                         f"got {x.device} and {w.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"moe_gmm: takes bf16, got {x.dtype} and {w.dtype}")
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"moe_gmm: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not multiply per expert")
    if x.shape[2] > 1 and x.stride(2) != 1:
        raise ValueError(f"moe_gmm: x needs a unit stride on D, got strides "
                         f"{x.stride()}")
    if not w.is_contiguous():
        raise ValueError("moe_gmm: w must be contiguous")
    e, c, d = x.shape
    f = w.shape[2]
    if e > 65535 or -(-c // BLOCK_C) > 65535:
        raise ValueError(f"moe_gmm: E={e} or C={c} exceeds the grid's limit")
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if e == 0 or c == 0 or f == 0:
        return out
    if d == 0:
        return out.zero_()
    sx_e, sx_r = x.stride(0), x.stride(1)
    vec = int(d % 8 == 0 and f % 8 == 0 and sx_e % 8 == 0 and sx_r % 8 == 0
              and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    lib = build.load(NAME, _bind)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.moe_gmm_bf16(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                               e, c, d, f, sx_e, sx_r, vec, stream)
    if err:
        raise RuntimeError(f"moe_gmm launch failed: "
                           f"{lib.moe_gmm_error_string(err).decode()}")
    build.LAUNCHES[NAME] += 1
    return out
