"""Fused staircase sweep: the whole candidate-table build as one kernel
(``repro.kernels.staircase_fused``'s counterpart).

For a fixed layer every staircase quantity is a function of the wave count
alone (paper Eq. 3), so the sweep over a (layers, candidates) width matrix
with per-layer (L, 1) columns is one elementwise pass::

    per_dev   = ceil(width / shard_out)
    waves     = ceil(per_dev / lane)
    n_pad     = waves * lane
    compute   = two_mk * n_pad * fm / peak
    memory    = (mk + kpm * n_pad) * bpe / bandwidth
    latency   = max(compute, memory)
    occupancy = per_dev / (waves * lane)

with ``two_mk`` = 2 x the padded tokens x the padded d_in (float64),
``fm`` the layer's FLOP multiplier, ``mk`` and ``kpm`` their product and
sum and ``bpe`` its bytes an element (int64), and ``rates`` = (peak
FLOP/s, bandwidth bytes/s). That is the tail model's own numpy expression
(``tail_model.WaveQuantizationModel``), operand for operand in float64 and
int64, so each latency is bit for bit the numpy engine's and Algorithm 2
decides the same on either engine, ties included. (``repro``'s TPU kernel
factors the same staircase as ``max(ca * waves, mb * waves + mc)`` in
fp32; its values agree to rtol 1e-6, but Algorithm 2 ranks layers by
differences of latencies that are equal in exact arithmetic, and each
factoring breaks those ties in its own last bits: the fp32 sweep, and
even that factoring in fp64, picked another plan than the numpy engine for
tpu_v5p and tpu_v4 in paper Tables 4/5.)

``sweep_columns`` and ``sweep_rates`` turn layer shapes and a spec into
the kernel's inputs. ``staircase_ref`` is the kernel's plain PyTorch
version, the same operations on the CPU. ``staircase_fused`` launches the
Triton kernel that replaces ``staircase_fused_pallas``
(``src/repro/kernels/staircase_fused.py``, body ``kernel``).

The kernel is bound by bytes: per cell it reads one int32 width and writes
a float64 latency, an int32 wave count and a float64 occupancy (20 B), per
row it reads one 4-byte and five 8-byte columns, and it does a handful of
integer and float64 operations per cell. There is no operand reuse and no
tensor-core work, so it is one pass of masked block loads and stores:
each program takes a (BLOCK_R, BLOCK_C) tile and the row columns broadcast
over it. Masked loads cover the ragged edges that the TPU version pads on
the host. Its float64 operations are products and correctly rounded
divisions only (no sum, so nothing for the compiler to fuse), as numpy
does them.

The GPU form of the tail model (``tail_model.CtaWaveModel``, paper Eq. 3
over the GEMM's CTA grid) sweeps through a second kernel of the same kind,
``staircase_cta``, with per-row ``g`` (CTAs per column tile: row tiles x K
chunks x experts), ``slots`` (CTAs a wave) and ``dl`` (one wave's time)
columns, its ``bpe`` the bytes an element times the experts, and of the
rates only the bandwidth (``dl`` already carries the peak)::

    tiles     = ceil(ceil(width / shard_out) / block_n)
    waves     = ceil(g * tiles / slots)
    latency   = max(waves * dl, (mk + kpm * tiles * block_n) * bpe
                    / bandwidth)

again ``CtaWaveModel``'s numpy expression. ``staircase_cta_ref`` is its
plain version. It is one elementwise pass too (4 B read and 16 B written a
cell, three 4-byte and four 8-byte columns a row), and has no counterpart
in ``repro``, whose model is the TPU form.

Triton is imported, and the kernels compiled, at the first launch
(``build.import_triton``), never when this module is imported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import build

__all__ = ["sweep_columns", "sweep_rates", "staircase_ref",
           "staircase_fused", "staircase_cta_ref", "staircase_cta"]

NAME = "staircase_fused"
CTA_NAME = "staircase_cta"
BLOCK_R = 8       # rows per program (the TPU kernel's block_r)
BLOCK_C = 128     # candidates per program (the TPU kernel's block_c)
I32, I64, F64 = torch.int32, torch.int64, torch.float64
# the inputs' types, widths first: the TPU form's columns (shard_out,
# two_mk, fm, mk, kpm, bpe), the GPU form's (shard_out, g, slots, dl, mk,
# kpm, bpe), then the rates: (peak, bandwidth) for the TPU form, the
# bandwidth alone for the GPU form
SWEEP_TYPES = (I32, I32, F64, F64, I64, I64, I64, F64)
CTA_TYPES = (I32, I32, I32, I32, F64, I64, I64, I64, F64)


def sweep_rates(hw) -> np.ndarray:
    """(peak FLOP/s, bandwidth bytes/s) of ``hw`` as float64."""
    return np.array([hw.peak_flops_bf16, hw.hbm_bandwidth], np.float64)


def sweep_columns(hw, layers):
    """(shard_out, two_mk, fm, mk, kpm, bpe) as (L, 1) columns for a list of
    ``LayerShape``-like objects (tokens / d_in / shard_in / shard_out /
    dtype_bits / flop_multiplier attributes) on ``hw``, as the tail model's
    stacked sweep computes them. ``dtype_bits`` must be whole bytes."""
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
    return (shard_out, (2.0 * m_pad) * k_pad, fm, m_pad * k_pad,
            k_pad + m_pad, bits // 8)


def _ceil(a, b):
    return -torch.div(-a, b, rounding_mode="floor")


def staircase_ref(widths, shard_out, two_mk, fm, mk, kpm, bpe, rates, *,
                  lane: int):
    """Plain version of the kernel: (latency float64, waves int64,
    occupancy float64) over (L, C) widths and the (L, 1) columns, on their
    device: ``WaveQuantizationModel``'s numpy expression, so on the CPU it
    equals that engine bit for bit."""
    per_dev = _ceil(widths.to(I64), shard_out.to(I64))
    n_waves = _ceil(per_dev, lane)
    n_pad = n_waves * lane
    rates = rates.to(F64)
    compute = two_mk.to(F64) * n_pad.to(F64) * fm.to(F64) / rates[0]
    memory = ((mk.to(I64) + kpm.to(I64) * n_pad) * bpe.to(I64)).to(F64) \
        / rates[1]
    occupancy = per_dev.to(F64) / n_pad.to(F64)
    return torch.maximum(compute, memory), n_waves, occupancy


# triton.language, bound by ``_kernel`` before the kernel is compiled: the
# kernel's body reads it as a module global, and importing it here would
# import triton with this module. The ``tl.constexpr`` annotations stay
# strings (``from __future__ import annotations``), which Triton reads.
tl = None


def _staircase_kernel(w_ptr, so_ptr, tmk_ptr, fm_ptr, mk_ptr, kpm_ptr,
                      bpe_ptr, rate_ptr, lat_ptr, wv_ptr, occ_ptr, rows,
                      cols, lane, BLOCK_R: tl.constexpr,
                      BLOCK_C: tl.constexpr):
    r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    c = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    rmask = r < rows
    mask = rmask[:, None] & (c < cols)[None, :]
    offs = r[:, None] * cols + c[None, :]
    # masked lanes still compute: width 1 and shard 1 keep them finite
    w = tl.load(w_ptr + offs, mask=mask, other=1)
    so = tl.load(so_ptr + r, mask=rmask, other=1)[:, None]
    two_mk = tl.load(tmk_ptr + r, mask=rmask, other=0.0)[:, None]
    fm = tl.load(fm_ptr + r, mask=rmask, other=1.0)[:, None]
    mk = tl.load(mk_ptr + r, mask=rmask, other=0)[:, None]
    kpm = tl.load(kpm_ptr + r, mask=rmask, other=0)[:, None]
    bpe = tl.load(bpe_ptr + r, mask=rmask, other=0)[:, None]
    peak = tl.load(rate_ptr)
    bw = tl.load(rate_ptr + 1)
    # integer division truncates toward zero here (the reference's
    # -(-a // b) would be the floor), so ceil(a / b) for a >= 0 is the
    # quotient plus one for a remainder: unlike (a + b - 1) // b it cannot
    # overflow int32 near the top of the range
    per_dev = w // so + (w % so != 0).to(tl.int32)
    nw = per_dev // lane + (per_dev % lane != 0).to(tl.int32)
    n_pad = nw.to(tl.int64) * lane
    # the numpy engine's operands in its order: products and one division
    # each side, float64, integers exact in int64
    compute = two_mk * n_pad.to(tl.float64) * fm / peak
    memory = ((mk + kpm * n_pad) * bpe).to(tl.float64) / bw
    tl.store(lat_ptr + offs, tl.maximum(compute, memory), mask=mask)
    tl.store(wv_ptr + offs, nw, mask=mask)
    tl.store(occ_ptr + offs, per_dev.to(tl.float64) / n_pad.to(tl.float64),
             mask=mask)


def _staircase_cta_kernel(w_ptr, so_ptr, g_ptr, sl_ptr, dl_ptr, mk_ptr,
                          kpm_ptr, bpe_ptr, bw_ptr, lat_ptr, wv_ptr,
                          tl_ptr, rows, cols, block_n, BLOCK_R: tl.constexpr,
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
    dl = tl.load(dl_ptr + r, mask=rmask, other=0.0)[:, None]
    mk = tl.load(mk_ptr + r, mask=rmask, other=0)[:, None]
    kpm = tl.load(kpm_ptr + r, mask=rmask, other=0)[:, None]
    bpe = tl.load(bpe_ptr + r, mask=rmask, other=0)[:, None]
    bw = tl.load(bw_ptr)
    # ceil as quotient plus one for a remainder (truncating division,
    # operands >= 0); g * tiles < 2**31 is checked by the dispatch
    per_dev = w // so + (w % so != 0).to(tl.int32)
    tiles = per_dev // block_n + (per_dev % block_n != 0).to(tl.int32)
    b = g * tiles
    nw = b // sl + (b % sl != 0).to(tl.int32)
    # CtaWaveModel's numpy expression, float64 and exact int64
    n_cols = tiles.to(tl.int64) * block_n
    memory = ((mk + kpm * n_cols) * bpe).to(tl.float64) / bw
    lat = tl.maximum(nw.to(tl.float64) * dl, memory)
    tl.store(lat_ptr + offs, lat, mask=mask)
    tl.store(wv_ptr + offs, nw, mask=mask)
    tl.store(tl_ptr + offs, tiles, mask=mask)


def _jit(fn):
    global tl
    triton = build.import_triton()
    import triton.language
    tl = triton.language
    return triton.jit(fn)


def _check_sweep(name: str, args: tuple, types: tuple, quantum: int,
                 n_rates: int):
    """A sweep kernel's inputs: (L, C) widths, then (L, 1) columns, then
    the (``n_rates``,) rates, of ``types``, contiguous, on one CUDA device;
    fewer than 2**31 cells and a quantum (lane or block_n) >= 1. Returns
    (L, C)."""
    widths = args[0]
    if not all(t.is_cuda and t.device == widths.device for t in args):
        raise ValueError(f"{name}: every input must lie on one CUDA "
                         f"device")
    if tuple(t.dtype for t in args) != types:
        raise TypeError(f"{name}: takes inputs of {types}, got "
                        f"{[t.dtype for t in args]}")
    if widths.dim() != 2:
        raise ValueError(f"{name}: widths must be 2-D (layers, "
                         f"candidates), got shape {tuple(widths.shape)}")
    rows, cols = widths.shape
    if any(tuple(t.shape) != (rows, 1) for t in args[1:-1]) \
            or tuple(args[-1].shape) != (n_rates,):
        raise ValueError(f"{name}: columns must be ({rows}, 1) and the "
                         f"rates ({n_rates},)")
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
                    two_mk: torch.Tensor, fm: torch.Tensor, mk: torch.Tensor,
                    kpm: torch.Tensor, bpe: torch.Tensor, rates: torch.Tensor,
                    *, lane: int):
    """Launch the kernel on the current stream: (L, C) int32 widths, (L, 1)
    int32 ``shard_out``, float64 ``two_mk`` and ``fm``, int64 ``mk``,
    ``kpm`` and ``bpe`` and the (2,) float64 rates, contiguous, on one CUDA
    device -> (latency float64, waves int32, occupancy float64), (L, C).

    Widths must be >= 0 and ``shard_out`` >= 1, the whole int32 range of
    the TPU kernel, and a row's bytes below 2**62; the kernel does not
    check the values (``ops.staircase_latency`` does, before it casts)."""
    args = (widths, shard_out, two_mk, fm, mk, kpm, bpe, rates)
    rows, cols = _check_sweep(NAME, args, SWEEP_TYPES, lane, 2)
    dev = widths.device
    lat = torch.empty((rows, cols), dtype=F64, device=dev)
    waves = torch.empty((rows, cols), dtype=I32, device=dev)
    occ = torch.empty((rows, cols), dtype=F64, device=dev)
    if rows == 0 or cols == 0:
        return lat, waves, occ
    kernel = _kernel()
    grid = (-(-rows // BLOCK_R), -(-cols // BLOCK_C))
    with torch.cuda.device(dev):
        kernel[grid](*args, lat, waves, occ, rows, cols, int(lane),
                     BLOCK_R=BLOCK_R, BLOCK_C=BLOCK_C, num_warps=4)
    build.LAUNCHES[NAME] += 1
    return lat, waves, occ


def staircase_cta_ref(widths, shard_out, g, slots, dl, mk, kpm, bpe,
                      bandwidth, *, block_n: int):
    """Plain version of the CTA-wave kernel: (latency float64, waves
    int64, tiles int64) over (L, C) widths and the (L, 1) columns, on their
    device: ``CtaWaveModel``'s numpy expression, bit for bit on the CPU."""
    per_dev = _ceil(widths.to(I64), shard_out.to(I64))
    tiles = _ceil(per_dev, block_n)
    n_waves = _ceil(g.to(I64) * tiles, slots.to(I64))
    memory = ((mk.to(I64) + kpm.to(I64) * (tiles * block_n))
              * bpe.to(I64)).to(F64) / bandwidth.to(F64)[0]
    latency = torch.maximum(n_waves.to(F64) * dl.to(F64), memory)
    return latency, n_waves, tiles


def staircase_cta(widths: torch.Tensor, shard_out: torch.Tensor,
                  g: torch.Tensor, slots: torch.Tensor, dl: torch.Tensor,
                  mk: torch.Tensor, kpm: torch.Tensor, bpe: torch.Tensor,
                  bandwidth: torch.Tensor, *, block_n: int):
    """Launch the CTA-wave kernel on the current stream: (L, C) int32
    widths, (L, 1) int32 ``shard_out``/``g``/``slots``, float64 ``dl``,
    int64 ``mk``/``kpm``/``bpe`` and the (1,) float64 bandwidth,
    contiguous, on one CUDA device -> (latency float64, waves int32, tiles int32), (L, C).

    Widths must be >= 0, ``shard_out`` and ``slots`` >= 1, ``g`` >= 0,
    ``g`` times a row's most tiles below 2**31 and a row's bytes below
    2**62; the kernel does not check the values
    (``ops.staircase_cta_latency`` does, before it casts)."""
    args = (widths, shard_out, g, slots, dl, mk, kpm, bpe, bandwidth)
    rows, cols = _check_sweep(CTA_NAME, args, CTA_TYPES, block_n, 1)
    dev = widths.device
    lat = torch.empty((rows, cols), dtype=F64, device=dev)
    waves = torch.empty((rows, cols), dtype=I32, device=dev)
    tiles = torch.empty((rows, cols), dtype=I32, device=dev)
    if rows == 0 or cols == 0:
        return lat, waves, tiles
    kernel = _cta_kernel()
    grid = (-(-rows // BLOCK_R), -(-cols // BLOCK_C))
    with torch.cuda.device(dev):
        kernel[grid](*args, lat, waves, tiles, rows, cols, int(block_n),
                     BLOCK_R=BLOCK_R, BLOCK_C=BLOCK_C, num_warps=4)
    build.LAUNCHES[CTA_NAME] += 1
    return lat, waves, tiles
