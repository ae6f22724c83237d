"""Fused staircase sweep: the whole candidate-table build as one kernel
(``repro.kernels.staircase_fused``'s counterpart).

For a fixed layer every staircase quantity is a function of the wave count
alone (paper Eq. 3), so the sweep over a (layers, candidates) width matrix
with per-layer (L, 1) coefficient columns is one elementwise pass::

    per_dev   = ceil(width / shard_out)
    waves     = ceil(per_dev / lane)
    latency   = max(ca * waves, mb * waves + mc)
    occupancy = per_dev / (waves * lane)

``fused_coeffs`` and ``fused_columns`` are ``repro``'s NumPy helpers,
copied: they turn layer shapes into the kernel's columns.
``staircase_ref`` is the kernel's plain PyTorch version, in float64 like
``repro``'s reference dispatch (``fused_staircase_reference``).
``staircase_fused`` launches the Triton kernel that replaces
``staircase_fused_pallas`` (``src/repro/kernels/staircase_fused.py``, body
``kernel``).

The kernel is bound by bytes: per cell it reads one int32 width and writes
an fp32 latency, an int32 wave count and an fp32 occupancy (16 B), per row
it reads four 4-byte columns, and it does a handful of integer and fp32
operations per cell. There is no operand reuse and no tensor-core work, so
it is one pass of masked block loads and stores: each program takes a
(BLOCK_R, BLOCK_C) tile and the row columns broadcast over it. Masked
loads cover the ragged edges that the TPU version pads on the host. Like
the TPU kernel it computes in int32 and fp32, so ``mb * waves + mc`` may be
one FMA and the latency may differ from the fp64 plain version by an ulp.

Triton is imported, and the kernel compiled, at the first launch
(``build.import_triton``), never when this module is imported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import build

__all__ = ["fused_coeffs", "fused_columns", "staircase_ref",
           "staircase_fused"]

NAME = "staircase_fused"
BLOCK_R = 8       # rows per program (the TPU kernel's block_r)
BLOCK_C = 128     # candidates per program (the TPU kernel's block_c)


def fused_coeffs(hw, *, two_mk, mk, k_plus_m, fm, bits):
    """Per-layer staircase constants -> affine-in-waves coefficients.

    Accepts scalars or broadcastable arrays (e.g. the (L, 1) columns of
    ``tail_model._LayerColumns``).  ``bits`` must be byte-aligned — the
    exact integer ``elems * bits // 8`` of the reference path only
    factors per-element when ``bits % 8 == 0``.
    """
    bpe = bits // 8
    ca = (two_mk * fm / hw.peak_flops_bf16) * hw.lane
    mb = (k_plus_m * bpe / hw.hbm_bandwidth) * hw.lane
    mc = (mk * bpe) / hw.hbm_bandwidth
    return ca, mb, mc


def fused_columns(hw, layers):
    """(shard_out, ca, mb, mc) as (L, 1) columns for a list of
    ``LayerShape``-like objects (tokens / d_in / shard_in / shard_out /
    dtype_bits / flop_multiplier attributes)."""
    def col(vals, dtype):
        return np.asarray(vals, dtype=dtype)[:, None]

    tokens = col([l.tokens for l in layers], np.int64)
    d_in = col([l.d_in for l in layers], np.int64)
    shard_in = col([l.shard_in for l in layers], np.int64)
    shard_out = col([l.shard_out for l in layers], np.int64)
    bits = col([l.dtype_bits for l in layers], np.int64)
    fm = col([l.flop_multiplier for l in layers], np.float64)
    sub = np.where(bits >= 32, hw.sublane_fp32, hw.sublane_bf16)
    m_pad = -(-tokens // sub) * sub
    k_pad = -(-(-(-d_in // shard_in)) // hw.lane) * hw.lane
    ca, mb, mc = fused_coeffs(hw, two_mk=(2.0 * m_pad) * k_pad,
                              mk=m_pad * k_pad, k_plus_m=k_pad + m_pad,
                              fm=fm, bits=bits)
    return shard_out, ca, mb, mc


def staircase_ref(widths, shard_out, ca, mb, mc, *, lane: int):
    """Plain version of the kernel: (latency float64, waves int64,
    occupancy float64) over (L, C) widths and (L, 1) columns, on their
    device. Occupancy is the fraction of the last wave's lanes doing
    useful work. The same float64 operations as ``repro``'s
    ``fused_staircase_reference``, so on the CPU it equals that reference
    bit for bit."""
    w = widths.to(torch.int64)
    so = shard_out.to(torch.int64)
    per_dev = -torch.div(-w, so, rounding_mode="floor")
    n_waves = -torch.div(-per_dev, lane, rounding_mode="floor")
    nwf = n_waves.to(torch.float64)
    latency = torch.maximum(ca.to(torch.float64) * nwf,
                            mb.to(torch.float64) * nwf
                            + mc.to(torch.float64))
    occupancy = per_dev.to(torch.float64) / (n_waves * lane).to(
        torch.float64)
    return latency, n_waves, occupancy


# triton.language, bound by ``_kernel`` before the kernel is compiled: the
# kernel's body reads it as a module global, and importing it here would
# import triton with this module. The ``tl.constexpr`` annotations stay
# strings (``from __future__ import annotations``), which Triton reads.
tl = None


def _staircase_kernel(w_ptr, so_ptr, ca_ptr, mb_ptr, mc_ptr,
                      lat_ptr, wv_ptr, occ_ptr, rows, cols, lane,
                      BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    c = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    rmask = r < rows
    mask = rmask[:, None] & (c < cols)[None, :]
    offs = r[:, None] * cols + c[None, :]
    # masked lanes still compute: width 1 and shard 1 keep them finite
    w = tl.load(w_ptr + offs, mask=mask, other=1)
    so = tl.load(so_ptr + r, mask=rmask, other=1)[:, None]
    ca = tl.load(ca_ptr + r, mask=rmask, other=0.0)[:, None]
    mb = tl.load(mb_ptr + r, mask=rmask, other=0.0)[:, None]
    mc = tl.load(mc_ptr + r, mask=rmask, other=0.0)[:, None]
    # integer division truncates toward zero here (the reference's
    # -(-a // b) would be the floor), so ceil(a / b) for a >= 0 is the
    # quotient plus one for a remainder: unlike (a + b - 1) // b it cannot
    # overflow int32 near the top of the range
    per_dev = w // so + (w % so != 0).to(tl.int32)
    nw = per_dev // lane + (per_dev % lane != 0).to(tl.int32)
    nwf = nw.to(tl.float32)
    tl.store(lat_ptr + offs, tl.maximum(ca * nwf, mb * nwf + mc), mask=mask)
    tl.store(wv_ptr + offs, nw, mask=mask)
    tl.store(occ_ptr + offs, per_dev.to(tl.float32) / (nwf * lane),
             mask=mask)


@functools.lru_cache(maxsize=None)
def _kernel():
    global tl
    triton = build.import_triton()
    import triton.language
    tl = triton.language
    return triton.jit(_staircase_kernel)


def staircase_fused(widths: torch.Tensor, shard_out: torch.Tensor,
                    ca: torch.Tensor, mb: torch.Tensor, mc: torch.Tensor, *,
                    lane: int):
    """Launch the kernel on the current stream: (L, C) int32 widths, (L, 1)
    int32 ``shard_out`` and (L, 1) fp32 ``ca``/``mb``/``mc``, contiguous, on
    one CUDA device -> (latency fp32, waves int32, occupancy fp32), (L, C).

    Widths must be >= 0 and ``shard_out`` >= 1, the whole int32 range of
    the TPU kernel; the kernel does not check the values
    (``ops.staircase_latency`` does, before it casts)."""
    args = (widths, shard_out, ca, mb, mc)
    if not all(t.is_cuda and t.device == widths.device for t in args):
        raise ValueError("staircase_fused: every input must lie on one "
                         "CUDA device")
    if widths.dtype != torch.int32 or shard_out.dtype != torch.int32 \
            or any(t.dtype != torch.float32 for t in (ca, mb, mc)):
        raise TypeError("staircase_fused: takes int32 widths and shard_out "
                        "and fp32 ca, mb, mc")
    if widths.dim() != 2:
        raise ValueError(f"staircase_fused: widths must be 2-D (layers, "
                         f"candidates), got shape {tuple(widths.shape)}")
    rows, cols = widths.shape
    if any(tuple(t.shape) != (rows, 1) for t in args[1:]):
        raise ValueError(f"staircase_fused: columns must be ({rows}, 1)")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("staircase_fused: inputs must be contiguous")
    if rows * cols >= 2 ** 31 or lane < 1:
        raise ValueError(f"staircase_fused: {rows}x{cols} cells or lane "
                         f"{lane} out of range")
    lat = torch.empty((rows, cols), dtype=torch.float32, device=widths.device)
    waves = torch.empty((rows, cols), dtype=torch.int32, device=widths.device)
    occ = torch.empty((rows, cols), dtype=torch.float32, device=widths.device)
    if rows == 0 or cols == 0:
        return lat, waves, occ
    kernel = _kernel()
    grid = (-(-rows // BLOCK_R), -(-cols // BLOCK_C))
    with torch.cuda.device(widths.device):
        kernel[grid](widths, shard_out, ca, mb, mc, lat, waves, occ,
                     rows, cols, int(lane), BLOCK_R=BLOCK_R, BLOCK_C=BLOCK_C,
                     num_warps=4)
    build.LAUNCHES[NAME] += 1
    return lat, waves, occ
