"""Width-downshift graceful degradation: the overload response ladder
(``repro.serving.degradation``'s counterpart, the same code on the port's
planner and engines).

Queueing stacks latency without bound as arrival rate approaches service
rate — near saturation every queued batch pushes the tail out further, so
the p99 of an overloaded server is set by the queue, not the model.  The
paper's Algorithm 2 hands us a better lever than queueing: every
``WidthPlan`` carries a *predicted* ``latency_reduction``, so under
overload the correct response is to serve at a narrower, faster width
(trading accuracy the same way HALP's latency/accuracy pareto does
statically) and return to full width when the burst passes.

Two pieces:

  * :class:`DegradationLadder` — per traffic class, an ordered list of
    rungs from full width (level 0, the canonical tree, zero accuracy
    loss) through successively tighter Algorithm 2 targets, ranked by
    predicted ``latency_reduction`` from the existing stacked tables.
    Building the ladder is just repeated planning at tighter ``delta``
    targets — no new latency model, the same persistent profile tables.
  * :class:`DegradationController` — the runtime policy: consumes the
    engine's overload signal (queue depth + batch-latency EWMA, see
    ``engine.AdmissionControl.signal``) once per batch and downshifts /
    upshifts the active level with hysteresis (separate thresholds and
    patience counters per direction), so a single slow batch cannot
    thrash the width back and forth.  ``select`` is the boundary-time
    lookup the engine calls instead of ``planner.select`` when a
    controller is attached.

Every shift is recorded in ``shift_log`` — the serving telemetry that,
together with ``ServeEngine.swap_log`` outcomes, makes a chaos run
auditable after the fact.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.serving.engine import (
    ServingWidthPlanner, TrafficClass, WidthPlan,
)


@dataclasses.dataclass(frozen=True)
class LadderRung:
    """One degradation level: a plan per traffic class at one target."""

    level: int                      # 0 = full width, higher = narrower
    plans: dict                     # traffic-class name -> WidthPlan
    reduction: float                # max predicted latency_reduction

    def plan_for(self, tokens: int) -> WidthPlan:
        """Nearest class (log-scale token distance, like
        ``ServingWidthPlanner.select``) at this rung."""
        return min(
            self.plans.values(),
            key=lambda p: abs(np.log(max(tokens, 1))
                              - np.log(max(p.traffic.tokens, 1))))


@dataclasses.dataclass(frozen=True)
class Shift:
    """One ladder move, as recorded in ``shift_log``."""

    direction: str      # "down" | "up"
    level: int          # level AFTER the shift
    signal: float       # overload signal that triggered it
    batch_index: int    # observe() call count at the shift


class DegradationLadder:
    """Ordered width-plan rungs per traffic class, full width first."""

    def __init__(self, rungs: Sequence[LadderRung]):
        if not rungs:
            raise ValueError("empty degradation ladder")
        self.rungs = list(rungs)

    def __len__(self) -> int:
        return len(self.rungs)

    def rung(self, level: int) -> LadderRung:
        """Rung at ``level``, clamped to the ladder's range."""
        return self.rungs[max(0, min(level, len(self.rungs) - 1))]

    @classmethod
    def build(cls, planner: ServingWidthPlanner,
              traffic: Sequence[TrafficClass],
              deltas: Sequence[float] = (0.85, 0.7, 0.55),
              tile_hw=None) -> "DegradationLadder":
        """One Algorithm 2 pass per (traffic class, delta target).

        Level 0 is always the canonical full width (``widths={}`` — the
        swapper returns the retained original tree, so recovery is
        bit-for-bit); each ``delta`` adds one rung.  Rungs are ranked by
        their predicted ``latency_reduction`` — deltas may be given in
        any order, and a delta whose plan reduces nothing beyond the
        previous rung still gets a rung (downshifting to it is a no-op
        swap, which is correct: the ladder never *adds* latency).  All
        table builds go through the planner's optimizer, so a warm
        profile-table cache makes ladder construction sweep-free.

        With ``tile_hw``, equal-reduction rungs are ordered tail-free
        grids first (``planner.plan_tail_free`` on a planner carrying
        the same spec): the ladder reaches for a wave-aligned width
        before an equally-fast tail-heavy one.  ``tile_hw=None``
        preserves the historical ordering bit-for-bit.
        """
        traffic = list(traffic)
        if not traffic:
            raise ValueError("need at least one traffic class")
        full = {
            tc.name: WidthPlan(
                traffic=tc, widths={}, latency_s=0.0,
                baseline_latency_s=0.0, satisfied=True,
                modules=planner.modules)
            for tc in traffic
        }
        rungs = [LadderRung(level=0, plans=full, reduction=0.0)]
        planned = []
        for delta in deltas:
            plans = dict(planner.plan([
                dataclasses.replace(tc, delta=float(delta))
                for tc in traffic]))
            red = max(p.latency_reduction for p in plans.values())
            if tile_hw is None:
                tail_penalty = 0
            else:
                # Score through the planner's helper under the ladder's
                # tile spec (restored afterwards — build() must not
                # change the planner's own select() behavior).
                prev_hw, planner.tile_hw = planner.tile_hw, tile_hw
                try:
                    tail_penalty = int(not all(
                        planner.plan_tail_free(p) for p in plans.values()
                        if p.widths))
                finally:
                    planner.tile_hw = prev_hw
            planned.append((red, tail_penalty, plans))
        planned.sort(key=lambda rp: (rp[0], rp[1]))
        for i, (red, _, plans) in enumerate(planned):
            rungs.append(LadderRung(level=i + 1, plans=plans,
                                    reduction=red))
        return cls(rungs)


class DegradationController:
    """Hysteresis-gated walk over a :class:`DegradationLadder`.

    ``observe(signal)`` is called once per completed batch with the
    engine's overload signal (1.0 = at the configured limit).  The
    controller downshifts one level after ``down_patience`` consecutive
    observations at or above ``down_threshold``, and upshifts one level
    after ``up_patience`` consecutive observations at or below
    ``up_threshold``; signals in the dead band between the thresholds
    reset both streaks.  Separate patience per direction biases the
    policy the right way for tails: degrade fast (one hot batch streak),
    recover slowly (sustained calm), and never oscillate on a single
    boundary-straddling observation.
    """

    def __init__(self, ladder: DegradationLadder, *,
                 down_threshold: float = 1.0, up_threshold: float = 0.5,
                 down_patience: int = 2, up_patience: int = 4,
                 observe_every: int = 1):
        if up_threshold >= down_threshold:
            raise ValueError(
                f"hysteresis requires up_threshold < down_threshold "
                f"(got {up_threshold} >= {down_threshold})")
        self.ladder = ladder
        # The batch engine observes once per batch; the continuous
        # engine observes once per *decode step*, which at the same
        # patience would shift a ladder an order of magnitude faster.
        # observe_every coalesces: only every Nth observe() is scored.
        self.observe_every = max(int(observe_every), 1)
        self._observe_calls = 0
        self.down_threshold = down_threshold
        self.up_threshold = up_threshold
        self.down_patience = max(int(down_patience), 1)
        self.up_patience = max(int(up_patience), 1)
        self.level = 0
        self.shift_log: List[Shift] = []
        self._hot = 0
        self._cool = 0
        self._batches = 0
        # Level floors pinned from outside the hysteresis loop (request
        # hedging runs backup executions on a lower rung regardless of
        # the controller's own overload state).  Pins stack: the
        # effective floor is the max of all active pins, and observe()
        # keeps walking self.level underneath them, so releasing the
        # last pin restores exactly the state the controller would have
        # reached on its own.
        self._pins: List[int] = []

    def observe(self, signal: float) -> int:
        """Feed one per-batch overload signal; returns the (possibly
        shifted) active level."""
        self._observe_calls += 1
        if self._observe_calls % self.observe_every != 0:
            return self.level
        self._batches += 1
        if signal >= self.down_threshold:
            self._hot += 1
            self._cool = 0
        elif signal <= self.up_threshold:
            self._cool += 1
            self._hot = 0
        else:                       # dead band: no evidence either way
            self._hot = 0
            self._cool = 0
        if self._hot >= self.down_patience \
                and self.level < len(self.ladder) - 1:
            self.level += 1
            self._hot = 0
            self.shift_log.append(Shift("down", self.level, signal,
                                        self._batches))
        elif self._cool >= self.up_patience and self.level > 0:
            self.level -= 1
            self._cool = 0
            self.shift_log.append(Shift("up", self.level, signal,
                                        self._batches))
        return self.level

    def pin_floor(self, level: int) -> None:
        """Pin a minimum degradation level (clamped to the ladder).
        While any pin is active, :meth:`select` serves from at least the
        highest pinned rung — the width-variant hedging hook: a hedge
        backup's replica is pinned to a narrower, faster rung for the
        backup's lifetime.  Pins nest (LIFO with :meth:`release_floor`)."""
        self._pins.append(max(0, min(int(level), len(self.ladder) - 1)))

    def release_floor(self) -> None:
        """Release the most recent :meth:`pin_floor` (no-op when none)."""
        if self._pins:
            self._pins.pop()

    @property
    def effective_level(self) -> int:
        """The level :meth:`select` serves from: the controller's own
        hysteresis level, raised to any pinned floor."""
        return max([self.level] + self._pins)

    def select(self, tokens: int) -> WidthPlan:
        """The active rung's plan for a batch's token volume — the
        boundary-time lookup the engine performs in place of
        ``planner.select`` when degradation is enabled."""
        return self.ladder.rung(self.effective_level).plan_for(tokens)
