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

The GPU form of the tail model (``tail_model.CtaWaveModel``, paper Eq. 3
over the GEMM's CTA grid) sweeps through a second kernel of the same kind,
``staircase_cta``, with per-row ``g`` (CTAs per column tile: row tiles x K
chunks x experts) and ``slots`` (CTAs a wave) columns::

    tiles     = ceil(ceil(width / shard_out) / block_n)
    waves     = ceil(g * tiles / slots)
    latency   = max(ca * waves, mb * tiles + mc)

``staircase_cta_ref`` is its plain fp64 version. It is one elementwise pass
too (4 B read and 12 B written a cell, six 4-byte columns a row), and has
no counterpart in ``repro``, whose model is the TPU form.

Triton is imported, and the kernels compiled, at the first launch
(``build.import_triton``), never when this module is imported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import build

__all__ = ["fused_coeffs", "fused_columns", "staircase_ref",
           "staircase_fused", "staircase_cta_ref", "staircase_cta"]

NAME = "staircase_fused"
CTA_NAME = "staircase_cta"
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


def _staircase_cta_kernel(w_ptr, so_ptr, g_ptr, sl_ptr, ca_ptr, mb_ptr,
                          mc_ptr, lat_ptr, wv_ptr, tl_ptr, rows, cols,
                          block_n, BLOCK_R: tl.constexpr,
                          BLOCK_C: tl.constexpr):
    r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    c = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    rmask = r < rows
    mask = rmask[:, None] & (c < cols)[None, :]
    offs = r[:, None] * cols + c[None, :]
    # masked lanes still compute: width 1, shard 1 and one slot keep them
    # finite
    w = tl.load(w_ptr + offs, mask=mask, other=1)
    so = tl.load(so_ptr + r, mask=rmask, other=1)[:, None]
    g = tl.load(g_ptr + r, mask=rmask, other=0)[:, None]
    sl = tl.load(sl_ptr + r, mask=rmask, other=1)[:, None]
    ca = tl.load(ca_ptr + r, mask=rmask, other=0.0)[:, None]
    mb = tl.load(mb_ptr + r, mask=rmask, other=0.0)[:, None]
    mc = tl.load(mc_ptr + r, mask=rmask, other=0.0)[:, None]
    # ceil as quotient plus one for a remainder (truncating division,
    # operands >= 0); g * tiles < 2**31 is checked by the dispatch
    per_dev = w // so + (w % so != 0).to(tl.int32)
    tiles = per_dev // block_n + (per_dev % block_n != 0).to(tl.int32)
    b = g * tiles
    nw = b // sl + (b % sl != 0).to(tl.int32)
    lat = tl.maximum(ca * nw.to(tl.float32), mb * tiles.to(tl.float32) + mc)
    tl.store(lat_ptr + offs, lat, mask=mask)
    tl.store(wv_ptr + offs, nw, mask=mask)
    tl.store(tl_ptr + offs, tiles, mask=mask)


def _jit(fn):
    global tl
    triton = build.import_triton()
    import triton.language
    tl = triton.language
    return triton.jit(fn)


def _check_sweep(name: str, args: tuple, n_int: int, quantum: int):
    """A sweep kernel's inputs: (L, C) widths then (L, 1) columns, the
    first ``n_int`` int32 and the rest fp32, contiguous, on one CUDA
    device; fewer than 2**31 cells and a quantum (lane or block_n) >= 1.
    Returns (L, C)."""
    widths = args[0]
    if not all(t.is_cuda and t.device == widths.device for t in args):
        raise ValueError(f"{name}: every input must lie on one CUDA "
                         f"device")
    if any(t.dtype != torch.int32 for t in args[:n_int]) \
            or any(t.dtype != torch.float32 for t in args[n_int:]):
        raise TypeError(f"{name}: takes {n_int} int32 then "
                        f"{len(args) - n_int} fp32 inputs, got "
                        f"{[t.dtype for t in args]}")
    if widths.dim() != 2:
        raise ValueError(f"{name}: widths must be 2-D (layers, "
                         f"candidates), got shape {tuple(widths.shape)}")
    rows, cols = widths.shape
    if any(tuple(t.shape) != (rows, 1) for t in args[1:]):
        raise ValueError(f"{name}: columns must be ({rows}, 1)")
    if not all(t.is_contiguous() for t in args):
        raise ValueError(f"{name}: inputs must be contiguous")
    if rows * cols >= 2 ** 31 or quantum < 1:
        raise ValueError(f"{name}: {rows}x{cols} cells or quantum "
                         f"{quantum} out of range")
    return rows, cols


@functools.lru_cache(maxsize=None)
def _kernel():
    return _jit(_staircase_kernel)


@functools.lru_cache(maxsize=None)
def _cta_kernel():
    return _jit(_staircase_cta_kernel)


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
    rows, cols = _check_sweep(NAME, args, 2, lane)
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


def staircase_cta_ref(widths, shard_out, g, slots, ca, mb, mc, *,
                      block_n: int):
    """Plain version of the CTA-wave kernel: (latency float64, waves
    int64, tiles int64) over (L, C) widths and (L, 1) ``shard_out``,
    ``g``, ``slots``, ``ca``, ``mb``, ``mc``, on their device."""
    w = widths.to(torch.int64)
    per_dev = -torch.div(-w, shard_out.to(torch.int64),
                         rounding_mode="floor")
    tiles = -torch.div(-per_dev, block_n, rounding_mode="floor")
    n_waves = -torch.div(-(g.to(torch.int64) * tiles),
                         slots.to(torch.int64), rounding_mode="floor")
    latency = torch.maximum(
        ca.to(torch.float64) * n_waves.to(torch.float64),
        mb.to(torch.float64) * tiles.to(torch.float64)
        + mc.to(torch.float64))
    return latency, n_waves, tiles


def staircase_cta(widths: torch.Tensor, shard_out: torch.Tensor,
                  g: torch.Tensor, slots: torch.Tensor, ca: torch.Tensor,
                  mb: torch.Tensor, mc: torch.Tensor, *, block_n: int):
    """Launch the CTA-wave kernel on the current stream: (L, C) int32
    widths, (L, 1) int32 ``shard_out``/``g``/``slots`` and (L, 1) fp32
    ``ca``/``mb``/``mc``, contiguous, on one CUDA device -> (latency fp32,
    waves int32, tiles int32), (L, C).

    Widths must be >= 0, ``shard_out`` and ``slots`` >= 1, ``g`` >= 0 and
    ``g`` times a row's most tiles below 2**31; the kernel does not check
    the values (``ops.staircase_cta_latency`` does, before it casts)."""
    args = (widths, shard_out, g, slots, ca, mb, mc)
    rows, cols = _check_sweep(CTA_NAME, args, 4, block_n)
    dev = widths.device
    lat = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    waves = torch.empty((rows, cols), dtype=torch.int32, device=dev)
    tiles = torch.empty((rows, cols), dtype=torch.int32, device=dev)
    if rows == 0 or cols == 0:
        return lat, waves, tiles
    kernel = _cta_kernel()
    grid = (-(-rows // BLOCK_R), -(-cols // BLOCK_C))
    with torch.cuda.device(dev):
        kernel[grid](*args, lat, waves, tiles, rows, cols, int(block_n),
                     BLOCK_R=BLOCK_R, BLOCK_C=BLOCK_C, num_warps=4)
    build.LAUNCHES[CTA_NAME] += 1
    return lat, waves, tiles
