"""Health-aware replica routing with hedging and zero-loss failover
(``repro.serving.router``'s counterpart).

One :class:`~repro_torch.serving.continuous.ContinuousServeEngine` is a
single point of failure: a stalled device stalls every slot, and a crash
loses every in-flight request. :class:`ReplicaRouter` fronts N engines and
turns replica failures into latency, never into loss:

  * **Discrete-event scheduling** — every replica runs its own
    ``VirtualClock``; the router always steps the furthest-behind healthy
    replica with outstanding work (ties break on replica index), so the
    fleet's clocks stay loosely synchronized and the whole interleaving is
    a function of the seeds: two runs give the identical trace.
  * **Health from existing telemetry** — a per-replica EWMA of per-step
    time (heartbeats) marks a replica *slow* when it exceeds
    ``slow_factor`` x the fleet's fastest EWMA (after ``min_beats``
    observations), or when its ``boundary_log`` shows ``max_aborts``
    failed boundary crossings; a replica whose ``step()`` raises is
    *dead*.
  * **Zero-loss failover** — a slow or dead replica is drained through
    ``evict_in_flight()``: every non-terminal request leaves with its
    generated tokens and chunked-prefill checkpoint intact and is
    ``adopt()``-ed by the least-loaded healthy replica under its original
    arrival time. Migrations are bounded (``max_migrations``); a request
    out of moves fails *accountably* (a terminal ``Result``, counted in
    the ledger), never silently.
  * **Width-variant hedging** — with a :class:`.hedging.HedgePolicy`, a
    request that outlives the observed latency quantile of its class gets
    a backup leg on a sibling replica, optionally pinned to a narrower
    ``DegradationLadder`` rung (``pin_floor``) for the backup's lifetime.
    The first completed leg wins; the loser is cancelled slot-exactly
    (``ContinuousServeEngine.cancel``) and the pair resolves to one
    logical :class:`~repro_torch.serving.engine.Result` with
    ``hedged=True`` / ``won_by``: one ledger entry, not two.

``RouterLedger`` accounts *logical* requests: a hedge pair is one request,
a migrated request is one request, and ``submitted == finished + shed +
failed`` holds exactly after every run.

Two rules are the port's own. Each replica needs a step cache of its own
(``WidthVariantCompileCache.claim``: a decode entry's static states are
one engine's slot state), where ``repro``'s fleet may share one. And on
the card every replica shares one CUDA context, so a fault of the device
(a CUDA or accelerator error, a failed kernel launch, an out-of-memory)
poisons them all: the router re-raises it (:func:`is_device_fault`)
instead of taking it for one replica's death. Every other exception out
of ``step()``, an injected crash among them, demotes the replica, as in
``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serving.chaos import InjectedFault
from repro_torch.serving.continuous import Arrival, ContinuousServeEngine
from repro_torch.serving.engine import Request, Result
from repro_torch.serving.hedging import HedgeEvent, HedgePolicy

# Exception types and message fragments of a device fault: torch's CUDA
# and accelerator errors, the CUDA runtime's and libraries' messages, and
# the port's kernel wrappers' ("<kernel> launch failed: <CUDA message>").
_DEVICE_FAULT_TYPES = tuple(
    t for t in (getattr(torch, "AcceleratorError", None),
                getattr(torch.cuda, "CudaError", None),
                getattr(torch.cuda, "DeferredCudaCallError", None),
                getattr(torch.cuda, "OutOfMemoryError", None))
    if t is not None)
_DEVICE_FAULT_TEXT = (
    "CUDA error", "CUDA driver error", "CUDA out of memory",
    "CUBLAS_STATUS", "CUDNN_STATUS", "device-side assert",
    "illegal memory access", "unspecified launch failure", "launch failed:")


def is_device_fault(e: BaseException) -> bool:
    """True when ``e`` (or an exception it was raised from) is a fault of
    the device rather than of one replica's host-side work. An
    :class:`~repro_torch.serving.chaos.InjectedFault` never is."""
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if isinstance(e, InjectedFault):
            return False
        if isinstance(e, _DEVICE_FAULT_TYPES):
            return True
        if isinstance(e, RuntimeError) and any(
                t in str(e) for t in _DEVICE_FAULT_TEXT):
            return True
        e = e.__cause__ or e.__context__
    return False


@dataclasses.dataclass(frozen=True)
class RouterLedger:
    """Logical-request accounting across the fleet (hedge pair = one)."""

    submitted: int
    finished: int
    shed: int
    failed: int
    hedged: int               # logical requests that launched a backup
    hedge_wins_backup: int    # hedged requests won by the backup leg
    migrated: int             # logical requests that survived >=1 failover
    in_flight: int            # unresolved logicals (0 after run())

    @property
    def accounted(self) -> int:
        return self.finished + self.shed + self.failed

    @property
    def complete(self) -> bool:
        return self.accounted == self.submitted and self.in_flight == 0


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    """One replica state transition, in ``health_log``."""

    t: float                  # the replica's clock at the transition
    replica: str
    state: str                # "slow" | "dead"
    reason: str


@dataclasses.dataclass
class Replica:
    """One engine behind the router, with its health bookkeeping."""

    name: str
    engine: ContinuousServeEngine
    index: int = 0
    state: str = "healthy"    # "healthy" | "slow" | "dead"
    ewma: float = 0.0         # per-step time EWMA (heartbeats)
    beats: int = 0

    def outstanding(self) -> int:
        led = self.engine.ledger()
        return led.in_flight + led.queued


@dataclasses.dataclass
class _Logical:
    """Router-level request: one entry per arrival, across all legs."""

    lid: int
    request: Request
    klass: str
    arrival_t: float
    legs: Dict[str, Tuple[str, int]] = dataclasses.field(
        default_factory=dict)          # leg -> (replica name, engine rid)
    results: Dict[str, Result] = dataclasses.field(default_factory=dict)
    hedged: bool = False
    hedge_delay_s: float = 0.0
    hedge_event: int = -1              # index into hedge_log
    pin_replica: str = ""              # replica whose degrader is pinned
    migrations: int = 0
    done: Optional[Result] = None


class ReplicaRouter:
    """Route an open-loop workload over N continuous engines.

    ``replicas`` maps name -> engine (insertion order fixes the replica
    index used in every deterministic tie-break); each engine needs its
    own step cache, if any. ``hedge`` enables width-variant hedging;
    ``planner`` supplies its latency telemetry (pass the planner the
    engines record into). ``slow_factor=None`` disables EWMA slow
    detection (crash detection stays on)."""

    def __init__(self, replicas: Dict[str, ContinuousServeEngine], *,
                 hedge: Optional[HedgePolicy] = None, planner=None,
                 slow_factor: Optional[float] = 4.0, min_beats: int = 8,
                 ewma_alpha: float = 0.3, max_migrations: int = 2,
                 max_aborts: int = 3):
        if not replicas:
            raise ValueError("need at least one replica")
        self.replicas = [Replica(name=n, engine=e, index=i)
                         for i, (n, e) in enumerate(replicas.items())]
        self._by_name = {r.name: r for r in self.replicas}
        self.hedge = hedge
        self.planner = planner
        self.slow_factor = None if slow_factor is None else float(slow_factor)
        self.min_beats = max(int(min_beats), 1)
        self.ewma_alpha = float(ewma_alpha)
        self.max_migrations = max(int(max_migrations), 0)
        self.max_aborts = max(int(max_aborts), 1)
        self._logicals: List[_Logical] = []
        self._legmap: Dict[Tuple[str, int], Tuple[int, str]] = {}
        self._consumed: set = set()
        self.health_log: List[HealthEvent] = []
        self.hedge_log: List[HedgeEvent] = []

    # ------------------------------------------------------------------
    # replica selection
    # ------------------------------------------------------------------
    def _healthy(self) -> List[Replica]:
        return [r for r in self.replicas if r.state == "healthy"]

    def _least_loaded(self, exclude: Sequence[str] = ()) -> Optional[Replica]:
        cands = [r for r in self._healthy() if r.name not in exclude]
        if not cands:
            cands = self._healthy()
        if not cands:
            return None
        return min(cands, key=lambda r: (r.outstanding(), r.index))

    # ------------------------------------------------------------------
    # leg bookkeeping
    # ------------------------------------------------------------------
    def _attach(self, lg: _Logical, leg: str, r: Replica, rid: int) -> None:
        lg.legs[leg] = (r.name, rid)
        self._legmap[(r.name, rid)] = (lg.lid, leg)

    def _submit_leg(self, lg: _Logical, leg: str, r: Replica) -> None:
        rid = r.engine.submit(lg.request, arrival_t=lg.arrival_t,
                              klass=lg.klass)
        self._attach(lg, leg, r, rid)

    def _poll(self) -> None:
        """Collect newly-terminal leg results and resolve logicals."""
        for (name, rid), (lid, leg) in list(self._legmap.items()):
            if (name, rid) in self._consumed:
                continue
            res = self._by_name[name].engine.result(rid)
            if res is None:
                continue
            self._consumed.add((name, rid))
            lg = self._logicals[lid]
            lg.results[leg] = res
            if lg.done is None:
                self._resolve(lg)

    def _resolve(self, lg: _Logical) -> None:
        """First successful leg wins; the other leg is cancelled
        slot-exactly. With every leg terminal and none successful the
        pair resolves failed (preferred over shed: the stronger verdict)."""
        winner = None
        for leg in ("primary", "backup"):
            res = lg.results.get(leg)
            if res is not None and not res.shed and not res.failed:
                winner = leg
                break
        if winner is None:
            if len(lg.results) < len(lg.legs):
                return                  # a leg is still running
            pick = next((l for l in ("primary", "backup")
                         if lg.results.get(l) is not None
                         and lg.results[l].failed), None)
            pick = pick or next(l for l in ("primary", "backup")
                                if l in lg.results)
            lg.done = dataclasses.replace(
                lg.results[pick], hedged=lg.hedged,
                won_by="", migrations=lg.migrations)
            self._release_pin(lg)
            return
        for leg, (name, rid) in lg.legs.items():
            if leg != winner and leg not in lg.results:
                self._by_name[name].engine.cancel(rid)
                self._consumed.add((name, rid))
        lg.done = dataclasses.replace(
            lg.results[winner], hedged=lg.hedged,
            won_by=(winner if lg.hedged else ""),
            migrations=lg.migrations)
        self._release_pin(lg)
        if lg.hedged and lg.hedge_event >= 0:
            self.hedge_log[lg.hedge_event] = dataclasses.replace(
                self.hedge_log[lg.hedge_event], winner=winner)

    def _release_pin(self, lg: _Logical) -> None:
        if lg.pin_replica:
            r = self._by_name[lg.pin_replica]
            if r.engine.degrader is not None:
                r.engine.degrader.release_floor()
            lg.pin_replica = ""

    # ------------------------------------------------------------------
    # hedging
    # ------------------------------------------------------------------
    def _hedge_check(self) -> None:
        if self.hedge is None:
            return
        outstanding = sum(1 for lg in self._logicals
                          if lg.hedged and lg.done is None)
        for lg in self._logicals:
            if lg.done is not None or lg.hedged or "primary" not in lg.legs:
                continue
            pname, _ = lg.legs["primary"]
            primary = self._by_name[pname]
            if primary.state == "dead":
                continue                # failover path owns this one
            delay = self.hedge.hedge_delay(self.planner, lg.klass)
            elapsed = primary.engine.clock() - lg.arrival_t
            if not self.hedge.should_hedge(
                    elapsed_s=elapsed, delay_s=delay,
                    outstanding=outstanding, request=lg.request):
                continue
            backup = self._least_loaded(exclude=(pname,))
            if backup is None:
                continue
            lg.hedged = True
            lg.hedge_delay_s = delay
            outstanding += 1
            if self.hedge.rung > 0 and backup.engine.degrader is not None:
                backup.engine.degrader.pin_floor(self.hedge.rung)
                lg.pin_replica = backup.name
            self._submit_leg(lg, "backup", backup)
            lg.hedge_event = len(self.hedge_log)
            self.hedge_log.append(HedgeEvent(
                lid=lg.lid, launched_t=backup.engine.clock(),
                delay_s=delay, rung=self.hedge.rung, replica=backup.name))

    # ------------------------------------------------------------------
    # health + failover
    # ------------------------------------------------------------------
    def _demote(self, r: Replica, state: str, reason: str) -> None:
        r.state = state
        self.health_log.append(HealthEvent(
            t=r.engine.clock(), replica=r.name, state=state, reason=reason))
        for tr in r.engine.evict_in_flight():
            key = (r.name, tr.rid)
            mapped = self._legmap.pop(key, None)
            if mapped is None:
                continue
            lid, leg = mapped
            lg = self._logicals[lid]
            if lg.done is not None:
                continue
            self._rehome(lg, leg, tr)
        self._poll()

    def _rehome(self, lg: _Logical, leg: str, tr) -> None:
        lg.migrations += 1
        target = self._least_loaded()
        if target is None or lg.migrations > self.max_migrations:
            # Out of moves (or out of fleet): terminal failure with the
            # partial tokens, accounted, never dropped.
            lg.results[leg] = Result(
                tokens=np.asarray(tr.generated, dtype=np.int32),
                steps=len(tr.generated), failed=True, retries=tr.retries,
                latency_s=max(t.engine.clock() for t in self.replicas)
                - lg.arrival_t)
            lg.legs.setdefault(leg, ("", -1))
            if lg.done is None:
                self._resolve(lg)
            return
        rid = target.engine.adopt(tr)
        self._attach(lg, leg, target, rid)

    def _health_check(self, r: Replica) -> None:
        if r.state != "healthy":
            return
        aborts = sum(1 for ev in r.engine.boundary_log
                     if ev.outcome != "ok")
        if aborts >= self.max_aborts:
            self._demote(r, "slow", f"{aborts} boundary aborts")
            return
        if self.slow_factor is None or r.beats < self.min_beats:
            return
        floor = min((x.ewma for x in self._healthy()
                     if x.beats >= self.min_beats), default=r.ewma)
        if floor > 0 and r.ewma > self.slow_factor * floor:
            self._demote(r, "slow",
                         f"ewma {r.ewma:.4g}s > {self.slow_factor:g}x "
                         f"fleet floor {floor:.4g}s")

    # ------------------------------------------------------------------
    # the event loop
    # ------------------------------------------------------------------
    def run(self, arrivals: Sequence, *, max_steps: int = 1_000_000
            ) -> List[Result]:
        """Serve ``arrivals`` (``Arrival``s or bare ``Request``s) across
        the fleet to completion. Results align with the input order; every
        logical request resolves (the ledger is complete) even under
        replica crashes, or the run raises (a device fault re-raises)."""
        for a in arrivals:
            if isinstance(a, Arrival):
                lg = _Logical(lid=len(self._logicals), request=a.request,
                              klass=a.klass, arrival_t=float(a.t))
            else:
                lg = _Logical(lid=len(self._logicals), request=a,
                              klass="", arrival_t=0.0)
            self._logicals.append(lg)
        todo = sorted(self._logicals, key=lambda lg: (lg.arrival_t, lg.lid))
        pending = list(todo)
        steps = 0
        while any(lg.done is None for lg in self._logicals):
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"router exceeded {max_steps} steps")
            healthy = self._healthy()
            if not healthy:
                # Whole fleet down: fail every unresolved logical.
                now = max(r.engine.clock() for r in self.replicas)
                for lg in self._logicals:
                    if lg.done is None:
                        lg.done = Result(
                            tokens=np.zeros(0, np.int32), steps=0,
                            failed=True, hedged=lg.hedged,
                            migrations=lg.migrations,
                            latency_s=max(now - lg.arrival_t, 0.0))
                break
            # Deliver arrivals the fleet has reached.
            horizon = max(r.engine.clock() for r in healthy)
            while pending and pending[0].arrival_t <= horizon:
                lg = pending.pop(0)
                r = self._least_loaded()
                self._submit_leg(lg, "primary", r)
            self._hedge_check()
            workers = [r for r in healthy if r.engine._outstanding()]
            if not workers:
                if pending:
                    nxt = pending[0].arrival_t
                    for r in healthy:
                        adv = getattr(r.engine.clock, "advance", None)
                        if adv is not None and r.engine.clock() < nxt:
                            adv(nxt - r.engine.clock())
                    if all(getattr(r.engine.clock, "advance", None) is None
                           for r in healthy):
                        # wall clocks: deliver the next arrival at once
                        lg = pending.pop(0)
                        self._submit_leg(lg, "primary", self._least_loaded())
                    continue
                self._poll()
                if any(lg.done is None for lg in self._logicals):
                    # Legs all terminal but unresolved pairs remain.
                    for lg in self._logicals:
                        if lg.done is None and lg.results:
                            self._resolve(lg)
                    if any(lg.done is None for lg in self._logicals):
                        raise RuntimeError(
                            "router stalled with unresolved requests")
                continue
            # Step the furthest-behind worker (tie -> lowest index).
            r = min(workers, key=lambda x: (x.engine.clock(), x.index))
            t0 = r.engine.clock()
            try:
                r.engine.step()
            except Exception as e:  # noqa: BLE001 — crash = dead replica
                if is_device_fault(e):
                    raise           # the card, not the replica: fail loudly
                self._demote(r, "dead", f"{type(e).__name__}: {e}")
                continue
            dt = r.engine.clock() - t0
            r.beats += 1
            r.ewma = dt if r.beats == 1 else (
                self.ewma_alpha * dt + (1 - self.ewma_alpha) * r.ewma)
            self._poll()
            self._health_check(r)
        self._poll()
        return [lg.done for lg in self._logicals]

    def ledger(self) -> RouterLedger:
        fin = shed = failed = wins = 0
        for lg in self._logicals:
            if lg.done is None:
                continue
            if lg.done.failed:
                failed += 1
            elif lg.done.shed:
                shed += 1
            else:
                fin += 1
            if lg.done.hedged and lg.done.won_by == "backup":
                wins += 1
        return RouterLedger(
            submitted=len(self._logicals), finished=fin, shed=shed,
            failed=failed,
            hedged=sum(1 for lg in self._logicals if lg.hedged),
            hedge_wins_backup=wins,
            migrated=sum(1 for lg in self._logicals
                         if lg.migrations > 0 and lg.done is not None),
            in_flight=sum(1 for lg in self._logicals if lg.done is None))
