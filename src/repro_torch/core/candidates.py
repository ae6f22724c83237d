"""Optimal width-candidate generation — paper Eq. 4.

    C_i[m] = argmax_m ( U_i x T_i )

The paper identifies, per layer, the width configurations that maximize
(SM utilization x GPU throughput): these are the right edges of the latency
staircase (Fig. 6).  We provide two generators:

  * ``analytic_candidates`` — from the wave-quantization model: the right
    edges are exactly the multiples of the quantum Q = shard_out * lane.
    On a GPU spec (``gpu.GpuSpec``) the model is ``CtaWaveModel``, whose
    stairs are CTA waves over the SMs, and the edges are found by
    ``staircase_edges`` over a sweep at steps of Q (the port's addition).
  * ``profile_candidates`` — from a profiled/derived (width, U, T, L) table,
    exactly the paper's procedure, so the optimizer also works when fed
    measured tables (e.g. on hardware we do not have a closed form for).

(``repro.core.candidates``'s counterpart.)

Both return sorted unique widths.  ``profile_candidates`` on a table produced
by the analytic model must agree with ``analytic_candidates`` — this is a
property test in tests/test_tail_model.py.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.gpu import is_gpu
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.tail_model import (
    LayerShape, ModelStairTable, model_for, staircase_edges,
)


def analytic_candidates(
    hw: HardwareSpec,
    layer: LayerShape,
    max_width: int | None = None,
    min_width: int = 1,
) -> np.ndarray:
    """Multiples of the width quantum Q = shard_out * lane, in range; on a
    GPU spec, the right edges of the CTA-wave stairs among them (the
    widest width of each wave count, at ``layer``'s tokens)."""
    gpu = is_gpu(hw)
    model = model_for(hw)
    q = model.width_quantum(layer.shard_out)
    hi = max_width if max_width is not None else layer.width
    first = max(q, ((min_width + q - 1) // q) * q)
    if gpu:
        sweep = np.arange(q, hi + 1, q, dtype=np.int64)
        edges = staircase_edges(sweep, model.latency_batch(layer, sweep)) \
            if sweep.size else sweep
        cands = edges[edges >= first]
    else:
        cands = np.arange(first, hi + 1, q, dtype=np.int64)
    if cands.size == 0:  # layer narrower than one quantum: only choice is Q
        cands = np.array([max(q, first) if gpu else q], dtype=np.int64)
    return cands


def realizable_candidates(
    hw: HardwareSpec,
    layer: LayerShape,
    *,
    realize_quantum: int = 1,
    max_width: int | None = None,
    min_width: int = 1,
) -> np.ndarray:
    """Analytic stair edges snapped DOWN onto the realizable grid.

    The staircase grid (multiples of Q = shard_out * lane) and the grid a
    swapper can actually materialize disagree at some sites: attention
    widths are only realizable as whole GQA head groups
    (``realize_quantum = g * head_dim``), while FFN widths realize at any
    lane multiple (``realize_quantum = 1`` degenerates to
    ``analytic_candidates``).  Planning on the staircase grid and
    re-snapping at swap time silently changes the width — and therefore
    the latency the plan was ranked by.  Instead, floor each stair edge
    to the realizable grid: the result is the widest realizable width
    inside each stair (same wave count, so the modeled latency of the
    snapped width is the stair's own), and every returned candidate is
    materializable as-is.
    """
    if realize_quantum <= 1:
        return analytic_candidates(hw, layer, max_width=max_width,
                                   min_width=min_width)
    edges = analytic_candidates(hw, layer, max_width=max_width,
                                min_width=min_width)
    rq = int(realize_quantum)
    lo = max(rq, ((min_width + rq - 1) // rq) * rq)
    snapped = np.unique(edges // rq * rq)
    snapped = snapped[snapped >= lo]
    if max_width is not None:
        snapped = snapped[snapped <= max_width]
    if snapped.size == 0:  # every edge below one realizable quantum
        snapped = np.array([lo], dtype=np.int64)
    return snapped.astype(np.int64)


def profile_candidates(
    widths: Sequence[int],
    utilization: Sequence[float],
    throughput: Sequence[float],
    top_per_wave: int = 1,
) -> np.ndarray:
    """Paper Eq. 4 on a profiled table: argmax(U x T) within each stair.

    Stairs are segmented by strictly-increasing throughput runs: within one
    wave, throughput rises monotonically with width (same latency, more
    useful FLOPs) and drops when a new wave starts.  The argmax of U*T in
    each segment is the stair's right edge.
    """
    w = np.asarray(widths)
    score = np.asarray(utilization, dtype=np.float64) * np.asarray(
        throughput, dtype=np.float64
    )
    if w.size == 0:
        return np.array([], dtype=np.int64)

    # Segment boundaries: where the score drops (a new, mostly-idle wave).
    # Vectorized: one comparison over the diff'd table instead of a Python
    # scan per point.
    drops = np.flatnonzero(score[1:] < score[:-1] * (1 - 1e-9)) + 1
    seg_starts = [0] + drops.tolist() + [len(w)]

    out: list[int] = []
    prev_best = -np.inf
    segs = list(zip(seg_starts[:-1], seg_starts[1:]))
    for si, (a, b) in enumerate(segs):
        best = float(score[a:b].max())
        # A trailing segment that never recovers the previous wave's best
        # score is an incomplete wave (the sweep ended mid-stair): its
        # "edge" is an artifact of where sampling stopped, not a candidate.
        if si == len(segs) - 1 and si > 0 and best < prev_best:
            break
        seg = np.argsort(score[a:b])[::-1][:top_per_wave]
        out.extend(int(w[a + i]) for i in seg)
        prev_best = best
    return np.array(sorted(set(out)), dtype=np.int64)


def model_profile_candidates(
    table: ModelStairTable,
    top_per_wave: int = 1,
) -> list[np.ndarray]:
    """Paper Eq. 4 over a whole model's stacked sweep at once.

    One ``evaluate_model_batch`` table in, one candidate vector per layer
    out — each row identical to running ``profile_candidates`` on that
    layer's own sweep.  This is the model-level front half of the paper's
    pre-analysis: stacked sweep -> per-layer candidate sets -> Algorithm 2.
    """
    out = []
    for i in range(len(table)):
        t = table.layer_table(i)
        out.append(profile_candidates(t.widths, t.utilization,
                                      t.throughput,
                                      top_per_wave=top_per_wave))
    return out


def snap_down(candidates: np.ndarray, width: int) -> int | None:
    """Paper Eq. 8a: max candidate strictly below ``width`` (scale down).

    ``candidates`` must be sorted ascending (both generators return sorted
    arrays); the snap is then one binary search, not a mask scan.
    """
    i = int(np.searchsorted(candidates, width, side="left"))
    return int(candidates[i - 1]) if i > 0 else None


def snap_up(candidates: np.ndarray, width: int) -> int | None:
    """Paper Eq. 8b: min candidate strictly above ``width`` (scale up).

    ``candidates`` must be sorted ascending.
    """
    i = int(np.searchsorted(candidates, width, side="right"))
    return int(candidates[i]) if i < len(candidates) else None


def snap_nearest(candidates: np.ndarray, width: int) -> int:
    """Nearest candidate (used by pruning-space discretization, section 4.4)."""
    idx = int(np.argmin(np.abs(candidates - width)))
    return int(candidates[idx])


def kernel_tail_free(hw, tokens: int, d_in: int, width: int, *,
                     dtype_bits: int = 16, cache=None) -> bool:
    """True when the autotuned matmul grid for a (tokens x d_in) @ (d_in
    x width) projection lands on a full-wave boundary (paper Eq. 3: no
    partial wave, no padded tail).  This is the *kernel-level* tail
    check — the staircase model scores the layer, this scores the tile
    grid the layer would actually run on (on a GPU spec, the port's CUDA
    tiles over the card's SMs) — and is what
    ``ServingWidthPlanner``/``DegradationLadder`` use to prefer widths
    whose executables waste no wave.  Memoized per (hw, shape) by the
    autotuner."""
    from repro_torch.kernels.autotune import autotune_matmul
    cfg = autotune_matmul(hw, int(tokens), int(width), int(d_in),
                          dtype_bits=dtype_bits, cache=cache)
    return bool(cfg.tail_free)
