"""Width-variant request hedging: tail latency bought with narrow width
(``repro.serving.hedging``'s counterpart).

Classic hedged requests (Dean & Barroso, "The Tail at Scale") send a
duplicate of a slow request to a second server once the original has
outlived a high quantile of the latency distribution, and take whichever
copy finishes first. The paper's width planner lets the backup run a
*narrower* model: every :class:`~repro_torch.serving.degradation.
DegradationLadder` rung is a width plan with a predicted latency
reduction, so the backup can be pinned to a faster rung
(``DegradationController.pin_floor``) for exactly its lifetime.

This module is policy only: *when* to hedge and *at what rung*. The
mechanics (which replica, slot-exact cancellation of the losing leg, one
ledger entry for the pair) live in
:class:`~repro_torch.serving.router.ReplicaRouter`:

  * the hedge delay is the observed latency quantile of the request's
    traffic class (``ServingWidthPlanner.observed_percentile``), with a
    fixed fallback before any data exists;
  * ``should_hedge`` gates on elapsed time, an outstanding-hedge cap (a
    hedge must never amplify an overload: the cap bounds the extra load),
    and optionally on requests that carry deadlines at all.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.serving.engine import Request, ServingWidthPlanner


@dataclasses.dataclass(frozen=True)
class HedgeEvent:
    """One hedge launch, in ``ReplicaRouter.hedge_log``."""

    lid: int                  # logical request id (router-level)
    launched_t: float         # backup replica's clock at launch
    delay_s: float            # hedge delay that was exceeded
    rung: int                 # degradation floor pinned for the backup
    replica: str              # replica the backup landed on
    winner: str = ""          # "primary" | "backup" (filled at resolve)


@dataclasses.dataclass(frozen=True)
class HedgePolicy:
    """When to launch a backup, and how degraded it runs.

    ``quantile`` is the per-class observed-latency percentile used as the
    hedge delay (95: at most about 5 % of requests hedge).
    ``default_delay_s`` serves until the planner has data for the class;
    ``min_delay_s`` floors the delay, so that a cold, fast class cannot
    hedge everything. ``rung`` is the ladder floor pinned on the backup
    replica's controller (0: same width, a plain hedge).
    ``max_outstanding`` caps concurrent hedge pairs, and
    ``hedge_deadline_only`` hedges only requests that carry a deadline.
    """

    quantile: float = 95.0
    default_delay_s: float = 0.5
    min_delay_s: float = 0.0
    rung: int = 1
    max_outstanding: int = 4
    hedge_deadline_only: bool = False

    def __post_init__(self):
        if not 0.0 < self.quantile <= 100.0:
            raise ValueError(f"quantile must be in (0, 100], "
                             f"got {self.quantile}")
        if self.rung < 0:
            raise ValueError("rung must be >= 0")
        if self.max_outstanding < 1:
            raise ValueError("max_outstanding must be >= 1")

    def hedge_delay(self, planner: Optional[ServingWidthPlanner],
                    klass: str) -> float:
        """Delay before a request becomes hedge-eligible: the observed
        ``quantile`` of its class's finished-request latencies, else the
        configured default while no telemetry exists."""
        delay = None
        if planner is not None:
            delay = planner.observed_percentile(klass or "default",
                                                self.quantile)
        if delay is None:
            delay = self.default_delay_s
        return max(float(delay), self.min_delay_s)

    def should_hedge(self, *, elapsed_s: float, delay_s: float,
                     outstanding: int, request: Request) -> bool:
        """Gate one candidate: old enough, under the concurrency cap, and
        (optionally) deadline-carrying."""
        if outstanding >= self.max_outstanding:
            return False
        if self.hedge_deadline_only and request.deadline_s is None:
            return False
        return elapsed_s >= delay_s
