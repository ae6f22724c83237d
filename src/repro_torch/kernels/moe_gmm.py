"""Grouped (per-expert) matmul: the CUDA kernel's wrapper and its plain
version (``repro.kernels.moe_gmm``'s counterpart).

Both compute ``out[e] = x[e] @ w[e]`` for x (E, C, D) and w (E, D, F), with
fp32 accumulation and the output in x.dtype: the expert products of the MoE
layer, where C is the tokens (the dense strategy, x the same for every
expert) or an expert's capacity buffer (the capacity strategy).

``moe_gmm`` launches ``csrc/moe_gmm.cu``, which replaces ``moe_gmm_pallas``
(``src/repro/kernels/moe_gmm.py``, body ``_gmm_kernel``). It runs
``matmul_tiled``'s mainloop (``csrc/gemm_sm90.cuh``: a TMA ring drained by
``wgmma``, fp32 accumulation, bf16 output) with an expert grid axis, and
takes its schedule (``matmul_tiled.schedule``) with C as M and D as K: the
prefill form, one CTA per (expert, C tile, 64-column F tile) over all of
D, for C > 64, on one of ``matmul_tiled.PREFILL_TILES`` (64, 128 or 256
rows of C; the caller's ``tile``, 128 rows when it names none; the tile
autotuner picks one by paper Eq. 3); else the decode form, one CTA per
(expert, 64 x 64 tile, D chunk of ``SPLIT_K``), the chunks' fp32 partials
summed in chunk order. It reads x through its expert and row strides, so a broadcast x
(``x.expand(E, T, D)``, expert stride 0) costs no copy. Ragged C, D and F
are masked in the kernel, so unlike ``repro``'s ``ops.moe_gmm`` nothing is
padded on the host. The grid is not persistent: its CTA count
(:func:`grid_blocks`) is the B of paper Eq. 3.

The backward (:func:`moe_gmm_bwd`) has no Pallas counterpart (``repro``
trains through plain JAX): dX_e = dY_e W_e^T and dW_e = X_e^T dY_e, each
one launch of the mainloop's backward forms (``matmul_tiled.launch_bwd``),
counted under ``NAME_BWD``, reading W^T and X^T where they lie (the views
``w.transpose(1, 2)``, a K-major w, and ``x.transpose(1, 2)``, an MN-major
x): no transposed copy. A broadcast x (expert stride 0) is read through
its one (C, D) matrix by every expert; its dX is returned per expert, (E,
C, D), each rounded to x's dtype, and the broadcast's own backward sums it
over E.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.matmul_tiled import (BLOCK_K, DECODE_BLOCK_M,
                                              SPLIT_K, bind_bwd, check_tiles,
                                              kernel_form, launch_bwd,
                                              launch_tile, raw_stream,
                                              read_bwd_form, read_form,
                                              schedule, workspace)
from repro_torch.kernels.matmul_tiled import BLOCK_M as BLOCK_C
from repro_torch.kernels.matmul_tiled import BLOCK_N as BLOCK_F

NAME = "moe_gmm"
NAME_BWD = "moe_gmm_bwd"   # the backward's dX and dW products
DECODE_BLOCK_C = DECODE_BLOCK_M
# the loads the last launch took ("tma" or "elementwise"); ``ops.TILES``
# records its tile
LAST = {"loads": None}


def moe_gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: (E, C, D) @ (E, D, F) per expert, accumulated in
    fp32, cast to x.dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def moe_gmm_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """Plain version of the backward of ``x @ w`` per expert: (dX = dY
    W^T (E, C, D), dW = X^T dY (E, D, F)), each accumulated in fp32 and
    cast to its input's dtype."""
    dyf = dy.float()
    return ((dyf @ w.float().transpose(1, 2)).to(x.dtype),
            (x.float().transpose(1, 2) @ dyf).to(w.dtype))


def moe_gmm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                need=(True, True)):
    """The backward of ``x @ w`` per expert on the kernel: dX = dY @ W^T
    and dW = X^T @ dY (where ``need`` asks for them), each one launch of
    the backward forms (``matmul_tiled.launch_bwd``) counted under
    ``NAME_BWD``: W^T and X^T are the views ``w.transpose(1, 2)`` and
    ``x.transpose(1, 2)`` (a broadcast x's keeps its expert stride 0),
    read where they lie."""
    dy = dy.contiguous()
    dx = launch_bwd(NAME, _bind, dy, w.transpose(1, 2), NAME_BWD) \
        if need[0] else None
    dw = launch_bwd(NAME, _bind, x.transpose(1, 2), dy, NAME_BWD) \
        if need[1] else None
    return dx, dw


def grid_blocks(e: int, c: int, f: int, d: int, tile=None) -> int:
    """CTAs the kernel launches for an (e, c, f) output over D = d on
    ``tile`` (``matmul_tiled.launch_tile`` resolves it): paper Eq. 3's B,
    the decode form's D chunks included."""
    _, chunks = schedule(c, f, d)
    bc, bf = launch_tile(c, tile)
    return e * -(-c // bc) * -(-f // bf) * len(chunks)


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.moe_gmm_bf16.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ll, ll,
                                 ci, ci, ci, ci, ci, vp]
    lib.moe_gmm_bf16.restype = ci
    lib.moe_gmm_error_string.argtypes = [ci]
    lib.moe_gmm_error_string.restype = ctypes.c_char_p
    lib.moe_gmm_form.argtypes = [ci, ci, ci, ctypes.c_void_p]
    lib.moe_gmm_form.restype = ci
    check_tiles(lib, "moe_gmm")
    bind_bwd(lib, "moe_gmm")
    got = []
    for fn in (lib.moe_gmm_block_c, lib.moe_gmm_block_f,
               lib.moe_gmm_decode_block_c, lib.moe_gmm_split_k,
               lib.moe_gmm_block_k):
        fn.argtypes = []
        fn.restype = ci
        got.append(fn())
    if got != [BLOCK_C, BLOCK_F, DECODE_BLOCK_C, SPLIT_K, BLOCK_K]:
        raise RuntimeError(f"moe_gmm.cu tiles {got} differ from BLOCK_C, "
                           f"BLOCK_F, DECODE_BLOCK_C, SPLIT_K, BLOCK_K")


def form(kind: str, device="cuda", tile=None) -> dict:
    """The kernel's form ``kind`` ("prefill" or "decode") on ``tile`` on
    ``device``, as ``matmul_tiled.form``: the same mainloop, so the same
    ``matmul_tiled.FORMS`` on the CPU."""
    return read_form(NAME, _bind, kind, device, tile)


def bwd_form(tile, x_mn: bool = False, w_k: bool = False,
             device="cuda") -> dict:
    """The backward form on ``tile`` in the given layout on ``device``, as
    ``matmul_tiled.bwd_form``."""
    return read_bwd_form(NAME, _bind, tile, x_mn, w_k, device)


def moe_gmm(x: torch.Tensor, w: torch.Tensor, tile=None, *,
            count: str = NAME) -> torch.Tensor:
    """Launch the kernel: x (E, C, D) bf16 @ w (E, D, F) bf16 -> (E, C, F)
    bf16, on CUDA tensors, on the current stream, on ``tile`` (rows of C,
    columns of F: one of ``matmul_tiled.PREFILL_TILES``, (128, 64) when
    None; the decode form's one tile at C <= 64; another raises). x may
    have any expert and row strides (0 included) but a unit D stride; w is
    contiguous. Launches on one stream at a time per device: the decode
    form's scratch is shared with ``matmul_tiled``. The launch counts under
    ``count`` in ``build.LAUNCHES`` (``NAME_BWD`` for the backward's
    products)."""
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
    decode, splits = kernel_form(c, d)
    bc = launch_tile(c, tile)[0]
    if e > 65535 or -(-c // bc) * splits > 65535:
        raise ValueError(f"moe_gmm: E={e}, or C={c} and D={d}, exceed the "
                         f"grid's limits")
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if e == 0 or c == 0 or f == 0:
        return out
    if d == 0:
        return out.zero_()
    dev = x.get_device()
    ws_p = cnt_p = 0
    if splits > 1:
        ws, cnt = workspace(dev, splits * e * c * f, e * -(-f // BLOCK_F))
        ws_p, cnt_p = ws.data_ptr(), cnt.data_ptr()
    sx_e, sx_r = x.stride(0), x.stride(1)
    vec = int(d % 8 == 0 and f % 8 == 0 and sx_e % 8 == 0 and sx_r % 8 == 0
              and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    lib = build.load(NAME, _bind)
    r = lib.moe_gmm_bf16(x.data_ptr(), w.data_ptr(), out.data_ptr(), ws_p,
                         cnt_p, e, c, d, f, sx_e, sx_r, int(decode), splits,
                         vec, bc, dev, raw_stream(dev))
    if r < 0:
        raise RuntimeError(f"moe_gmm launch failed: "
                           f"{lib.moe_gmm_error_string(-r).decode()}")
    LAST["loads"] = "tma" if r else "elementwise"
    build.LAUNCHES[count] += 1
    return out
