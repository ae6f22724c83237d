"""Frozen scalar reference paths — the seed implementation, kept verbatim
(``repro.core.scalar_ref``, copied: ``tests/test_torch_gpu_model.py``
holds it to ``repro``'s and the port's table-driven engine to it).

The table-driven engine in ``tail_model``/``tail_optimizer`` replaced a
scalar hot path: per-width ``evaluate()`` calls inside Python loops, sorted
lists popped from both ends, and O(layers) parameter rescans.  This module
preserves that seed implementation unchanged, for two purposes only:

  * ground truth for the batched-vs-scalar equivalence tests
    (tests/test_batched_equivalence.py): ``scalar_evaluate`` must match
    ``WaveQuantizationModel.evaluate_batch`` bit-for-bit, and
    ``ScalarTailEffectOptimizer`` must return the same widths/moves as the
    table-driven ``TailEffectOptimizer``;
  * the "before" side of ``benchmarks/optimizer_scale.py``, so the speedup
    of the table-driven engine stays measured, not asserted.

Do not "optimize" this file — its value is being the slow, known-good path.

One deliberate deviation from the seed: ``_one_latency_round``'s revert
used to pop the *last* Move, which could be a balancing up-move rather
than the down-move being reverted, so ``OptimizationResult.moves`` could
disagree with ``new_widths``.  Both this reference and the table-driven
path now delete the down-Move itself (coordinated behavior change; the
replay-consistency test in tests/test_batched_equivalence.py pins it).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.tail_model import LayerShape, StairPoint, ceil_div
from repro_torch.core.tail_optimizer import Move, OptimizationResult, \
    TunableLayer


def _snap_down(candidates: np.ndarray, width: int) -> int | None:
    below = candidates[candidates < width]
    return int(below.max()) if below.size else None


def _snap_up(candidates: np.ndarray, width: int) -> int | None:
    above = candidates[candidates > width]
    return int(above.min()) if above.size else None


class ScalarWaveModel:
    """Seed ``WaveQuantizationModel``: one width per ``evaluate`` call."""

    def __init__(self, hw: HardwareSpec):
        self.hw = hw
        self.eval_calls = 0
        self.eval_points = 0

    def width_quantum(self, shard_out: int) -> int:
        return shard_out * self.hw.lane

    def padded_dim(self, d: int, shard: int, tile: int) -> int:
        per_dev = ceil_div(d, shard)
        return ceil_div(per_dev, tile) * tile

    def waves(self, layer: LayerShape) -> int:
        per_dev = ceil_div(layer.width, layer.shard_out)
        return ceil_div(per_dev, self.hw.lane)

    def evaluate(self, layer: LayerShape) -> StairPoint:
        hw = self.hw
        self.eval_calls += 1
        self.eval_points += 1
        sub = hw.sublane(layer.dtype_bits)
        m_pad = ceil_div(layer.tokens, sub) * sub
        k_pad = self.padded_dim(layer.d_in, layer.shard_in, hw.lane)
        n_waves = self.waves(layer)
        n_pad = n_waves * hw.lane

        useful = 2.0 * layer.tokens * layer.d_in * layer.width \
            * layer.flop_multiplier
        padded_per_dev = 2.0 * m_pad * k_pad * n_pad * layer.flop_multiplier
        padded_total = padded_per_dev * layer.shard_in * layer.shard_out

        compute_s = padded_per_dev / hw.peak_flops_bf16
        bytes_per_dev = (
            m_pad * k_pad + k_pad * n_pad + m_pad * n_pad
        ) * layer.dtype_bits // 8
        memory_s = bytes_per_dev / hw.hbm_bandwidth
        latency = max(compute_s, memory_s)

        util = useful / padded_total if padded_total else 0.0
        return StairPoint(
            width=layer.width,
            latency_s=latency,
            utilization=util,
            throughput=useful / latency if latency else 0.0,
            waves=n_waves,
            flops=useful,
            padded_flops=padded_total,
        )


def scalar_evaluate(hw: HardwareSpec, layer: LayerShape) -> StairPoint:
    """Seed scalar staircase evaluation for one layer at ``layer.width``."""
    return ScalarWaveModel(hw).evaluate(layer)


class ScalarTailEffectOptimizer:
    """Seed Algorithm 2: sorted-list queues, O(layers) ``pg_total`` rescans,
    per-move re-ranking in accuracy pass 2 — every latency read is a fresh
    ``evaluate`` call."""

    def __init__(self, model: ScalarWaveModel):
        self.model = model

    # ---- helpers ---------------------------------------------------------
    def _latency(self, tl: TunableLayer, width: int) -> float:
        return self.model.evaluate(tl.layer.with_width(width)).latency_s

    def _total_latency(self, layers: Sequence[TunableLayer],
                       widths: dict[str, int]) -> float:
        return sum(self._latency(tl, widths[tl.layer.name]) for tl in layers)

    def _total_params(self, layers: Sequence[TunableLayer],
                      widths: dict[str, int]) -> float:
        return sum(tl.params(widths[tl.layer.name]) for tl in layers)

    def _down(self, tl: TunableLayer, width: int) -> int | None:
        w = _snap_down(tl.candidates, width)
        if w is not None and w < tl.min_width:
            return None
        return w

    def _up(self, tl: TunableLayer, width: int) -> int | None:
        w = _snap_up(tl.candidates, width)
        if w is not None and tl.max_width is not None and w > tl.max_width:
            return None
        return w

    # ---- latency-oriented (Eq. 7, Algorithm 2) ----------------------------
    def optimize_latency(
        self,
        layers: Sequence[TunableLayer],
        tau: float,
        delta: float = 0.9,
        max_rounds: int = 8,
    ) -> OptimizationResult:
        old_widths = {tl.layer.name: tl.layer.width for tl in layers}
        l_old = self._total_latency(layers, old_widths)
        p_old = self._total_params(layers, old_widths)

        best: OptimizationResult | None = None
        cur_tau = tau
        for _ in range(max_rounds):
            res = self._one_latency_round(layers, old_widths, l_old, p_old,
                                          cur_tau, delta)
            if best is None or res.latency_new_s < best.latency_new_s:
                best = res
            if res.satisfied:
                return res
            cur_tau *= 2.0
        assert best is not None
        return best

    def _one_latency_round(self, layers, old_widths, l_old, p_old, tau,
                           delta) -> OptimizationResult:
        widths = dict(old_widths)
        moves: list[Move] = []

        lg: dict[str, float] = {}
        for tl in layers:
            name = tl.layer.name
            down = self._down(tl, widths[name])
            lg[name] = (self._latency(tl, widths[name])
                        - self._latency(tl, down)) if down is not None else 0.0

        by_name = {tl.layer.name: tl for tl in layers}
        queue = sorted(lg, key=lambda n: lg[n], reverse=True)

        def pg_total() -> float:
            return (self._total_params(layers, widths) - p_old)

        while queue:
            j = queue.pop(0)
            tl = by_name[j]
            down = self._down(tl, widths[j])
            applied_down = False
            old_w = widths[j]
            down_move_at = len(moves)
            if down is not None and lg[j] > 0:
                gain = self._latency(tl, widths[j]) - self._latency(tl, down)
                dp = tl.params(down) - tl.params(widths[j])
                moves.append(Move(j, "down", widths[j], down, gain, dp))
                widths[j] = down
                applied_down = True

            while queue and not (-tau < pg_total() < tau):
                k = queue.pop(-1)
                tk = by_name[k]
                up = self._up(tk, widths[k])
                if up is None:
                    continue
                dp = tk.params(up) - tk.params(widths[k])
                if abs(pg_total() + dp) >= abs(pg_total()):
                    continue
                extra = self._latency(tk, up) - self._latency(tk, widths[k])
                moves.append(Move(k, "up", widths[k], up, -extra, dp))
                widths[k] = up

            # Revert removes the down-Move itself (up-moves appended after
            # it stay applied).  The seed popped the LAST move here, which
            # could be a balancing up-move, leaving ``moves`` inconsistent
            # with ``new_widths``; fixed in lockstep with the table-driven
            # path (the one deliberate deviation from the seed — see the
            # module docstring).
            if applied_down and not (-tau < pg_total() < tau):
                widths[j] = old_w
                del moves[down_move_at]

        l_new = self._total_latency(layers, widths)
        return OptimizationResult(
            old_widths=dict(old_widths), new_widths=widths,
            latency_old_s=l_old, latency_new_s=l_new,
            params_old=p_old, params_new=self._total_params(layers, widths),
            moves=moves, tau_final=tau,
            satisfied=l_new <= l_old * delta,
        )

    # ---- accuracy-oriented (Eq. 6) ----------------------------------------
    def optimize_accuracy(
        self,
        layers: Sequence[TunableLayer],
        latency_slack: float = 0.0,
    ) -> OptimizationResult:
        old_widths = {tl.layer.name: tl.layer.width for tl in layers}
        l_old = self._total_latency(layers, old_widths)
        p_old = self._total_params(layers, old_widths)
        budget = latency_slack * l_old

        widths = dict(old_widths)
        moves: list[Move] = []
        for tl in layers:
            name = tl.layer.name
            up = self._up(tl, widths[name])
            if up is None:
                continue
            extra = self._latency(tl, up) - self._latency(tl, widths[name])
            if extra <= 1e-15:
                dp = tl.params(up) - tl.params(widths[name])
                moves.append(Move(name, "up", widths[name], up, -extra, dp))
                widths[name] = up

        improved = True
        while improved and budget > 0:
            improved = False
            ranked: list[tuple[float, TunableLayer, int, float]] = []
            for tl in layers:
                name = tl.layer.name
                up = self._up(tl, widths[name])
                if up is None:
                    continue
                extra = self._latency(tl, up) - self._latency(tl, widths[name])
                dp = tl.params(up) - tl.params(widths[name])
                if extra <= budget and dp > 0:
                    ranked.append((dp / max(extra, 1e-15), tl, up, extra))
            if ranked:
                ranked.sort(key=lambda t: t[0], reverse=True)
                _, tl, up, extra = ranked[0]
                name = tl.layer.name
                dp = tl.params(up) - tl.params(widths[name])
                moves.append(Move(name, "up", widths[name], up, -extra, dp))
                widths[name] = up
                budget -= extra
                improved = True

        l_new = self._total_latency(layers, widths)
        return OptimizationResult(
            old_widths=old_widths, new_widths=widths,
            latency_old_s=l_old, latency_new_s=l_new,
            params_old=p_old, params_new=self._total_params(layers, widths),
            moves=moves, tau_final=0.0,
            satisfied=l_new <= l_old * (1 + latency_slack) + 1e-12,
        )
