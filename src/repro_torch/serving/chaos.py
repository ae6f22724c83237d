"""Seeded fault injection and open-loop load for the serving stack
(``repro.serving.chaos``'s counterpart).

  * :class:`SwapFailureInjector` — a ``WidthSwapper.fault_hook`` raising
    :class:`InjectedFault` at the named swap checkpoints
    (``width_swap.SWAP_STEPS``) at a seeded rate.
  * :class:`ReshapeFailureInjector` — a ``WidthSwapper.reshape_fault_hook``
    faulting ``reshape_states`` mid-boundary (params committed, KV caches
    mid-rewrite), the window the continuous engine's transaction covers.
  * :class:`CompileFailureInjector` — a ``WidthVariantCompileCache``
    ``fault_hook`` breaking capture or the serve-time lookup.
  * :class:`ChunkFaultInjector` — a ``ContinuousServeEngine``
    ``chunk_fault_hook`` faulting a prefill chunk.
  * :class:`SlowBatchInjector` — wraps a batch cost; a seeded fraction of
    batches pay an extra latency (straggler batches).
  * :class:`ReplicaStallInjector` / :class:`ReplicaCrashInjector` — wrap
    one replica's batch cost: every step in a window pays ``factor`` x (a
    machine going slow), or a costed step raises :class:`InjectedFault`
    (a replica dying mid-step), the failures ``serving/router.py`` turns
    into latency rather than loss.
  * :class:`CacheCorruptor` — overwrites a seeded fraction of a
    ``core.table_cache.ProfileTableCache``'s entries with garbage, driving
    its retry-then-quarantine path.
  * :class:`VirtualClock` + :func:`modeled_batch_cost` — a simulated time
    base that advances only by modeled step costs, so shed sets, deadline
    misses and percentiles are exactly reproducible from the seed.
  * :func:`burst_requests`, :class:`TrafficLoad` +
    :func:`open_loop_arrivals` — seeded open-loop traffic, reported per
    class by :class:`TailReport` via :func:`class_tail_reports`, or as a
    whole by :class:`LoadReport`.

Every injector and schedule draws from its own ``numpy`` Generator
(``np.random.default_rng``, as ``repro`` does), so for one seed the
arrivals and the injectors' decisions are bit-equal to ``repro``'s.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.serving.compile_cache import COMPILE_STEPS
from repro_torch.serving.continuous import Arrival
from repro_torch.serving.engine import Request
from repro_torch.serving.width_swap import SWAP_STEPS


class InjectedFault(RuntimeError):
    """A deliberately injected failure — never raised by real code."""


class VirtualClock:
    """Deterministic time base: callable like ``time.monotonic`` but
    only advances when told to (the engine advances it by each batch's
    simulated cost when a ``batch_cost_fn`` is attached)."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        dt = float(dt)
        if dt < 0:
            # A monotonic clock cannot run backwards.  A negative dt is
            # always a harness bug (a mis-ordered event or a bad cost
            # model) and used to corrupt every downstream latency and
            # deadline silently — fail loudly instead.
            raise ValueError(
                f"VirtualClock.advance(dt={dt}): negative dt would make "
                f"the monotonic clock run backwards")
        self.now += dt
        return self.now


class SwapFailureInjector:
    """Seeded ``fault_hook`` raising :class:`InjectedFault` mid-swap.

    ``rate`` is the per-swap failure probability; the Bernoulli draw
    happens once per matching step, so a rate of 1.0 fails every swap at
    the first matching step and 0.0 never fires.  ``steps`` defaults to
    the materialize checkpoint (the widest window in a real swap); pass
    any subset of ``width_swap.SWAP_STEPS`` to move the failure point.
    """

    def __init__(self, rate: float, *, seed: int = 0,
                 steps: Sequence[str] = ("materialize",)):
        for s in steps:
            if s not in SWAP_STEPS:
                raise ValueError(f"unknown swap step {s!r}; expected "
                                 f"a subset of {SWAP_STEPS}")
        self.rate = float(rate)
        self.steps = tuple(steps)
        self.rng = np.random.default_rng(seed)
        self.calls = 0          # matching-step evaluations
        self.injected = 0       # faults actually raised

    def __call__(self, step: str) -> None:
        if step not in self.steps:
            return
        self.calls += 1
        if self.rng.random() < self.rate:
            self.injected += 1
            raise InjectedFault(
                f"injected swap failure #{self.injected} at {step!r}")


class ReshapeFailureInjector:
    """Seeded ``WidthSwapper.reshape_fault_hook`` — faults the *state*
    half of a boundary crossing.

    ``SwapFailureInjector`` breaks the parameter swap, which
    ``apply_guarded`` rolls back before any live state is touched.  This
    injector fires inside ``reshape_states`` instead: the params have
    already committed, the KV caches are mid-rewrite — the exact window
    where a naive engine strands its in-flight requests.  The continuous
    engine treats it as a transaction abort (canonical tree restored,
    every in-flight request requeued with its tokens intact), which is
    what the chaos tier proves.
    """

    def __init__(self, rate: float, *, seed: int = 0):
        self.rate = float(rate)
        self.rng = np.random.default_rng(seed)
        self.calls = 0          # reshape attempts evaluated
        self.injected = 0       # faults actually raised

    def __call__(self) -> None:
        self.calls += 1
        if self.rng.random() < self.rate:
            self.injected += 1
            raise InjectedFault(
                f"injected KV-reshape failure #{self.injected}")


class CompileFailureInjector:
    """Seeded ``WidthVariantCompileCache.fault_hook`` — faults the step
    cache's layer of a boundary crossing.

    ``steps`` selects which ``compile_cache.COMPILE_STEPS`` checkpoints
    can fire: ``"lower"``/``"compile"`` break plan-time capture (the
    entry is never built), ``"lookup"`` breaks the serve-time fetch (a
    warm entry becomes unreachable).  In every case the cache's contract
    is to run the step eagerly — requests must finish with identical
    tokens and zero losses.
    """

    def __init__(self, rate: float, *, seed: int = 0,
                 steps: Sequence[str] = ("lookup",)):
        for s in steps:
            if s not in COMPILE_STEPS:
                raise ValueError(f"unknown compile step {s!r}; expected "
                                 f"a subset of {COMPILE_STEPS}")
        self.rate = float(rate)
        self.steps = tuple(steps)
        self.rng = np.random.default_rng(seed)
        self.calls = 0          # matching-step evaluations
        self.injected = 0       # faults actually raised

    def __call__(self, step: str) -> None:
        if step not in self.steps:
            return
        self.calls += 1
        if self.rng.random() < self.rate:
            self.injected += 1
            raise InjectedFault(
                f"injected compile-cache failure #{self.injected} "
                f"at {step!r}")


class SlowBatchInjector:
    """Seeded straggler batches: wraps a base batch cost, adding
    ``extra_s`` with probability ``rate`` per batch."""

    def __init__(self, rate: float, extra_s: float, *, seed: int = 0):
        self.rate = float(rate)
        self.extra_s = float(extra_s)
        self.rng = np.random.default_rng(seed)
        self.injected = 0

    def __call__(self, base_s: float) -> float:
        if self.rng.random() < self.rate:
            self.injected += 1
            return base_s + self.extra_s
        return base_s


def modeled_batch_cost(per_token_s: float, *, overhead_s: float = 0.0,
                       slow: "Callable[[float], float] | None" = None
                       ) -> Callable:
    """A ``ServeEngine.batch_cost_fn`` driven by the plan's own model.

    Cost = ``overhead_s + per_token_s * tokens * ratio`` where ``ratio``
    is the plan's modeled ``latency_s / baseline_latency_s`` (1.0 for
    full width / no plan).  This is exactly the counterfactual the
    paper's tables promise — a narrower plan speeds a batch by its
    predicted reduction — which makes the degraded-vs-full p99 gap in a
    chaos run a direct measurement of the ladder's modeled win, free of
    host noise.  An optional ``slow(base_s) -> s`` composes on top.
    """

    def cost(plan, tokens: int) -> float:
        ratio = 1.0
        if plan is not None and getattr(plan, "baseline_latency_s", 0.0):
            ratio = plan.latency_s / plan.baseline_latency_s
        base = overhead_s + per_token_s * float(tokens) * ratio
        return slow(base) if slow is not None else base

    return cost


class ReplicaStallInjector:
    """Gray-failure straggler replica: wraps one replica's base batch
    cost (compose via ``modeled_batch_cost(..., slow=...)``), multiplying
    every costed step inside a deterministic step window by ``factor``
    (optionally thinned by a seeded ``rate``). Unlike
    :class:`SlowBatchInjector` (an occasional straggler *batch*) this
    models a *machine* going slow: every step of one replica pays, the
    failure that replica routing and hedging exist to bound."""

    def __init__(self, factor: float, *, start_step: int = 0,
                 n_steps: int = 10 ** 9, rate: float = 1.0, seed: int = 0):
        if factor < 1.0:
            raise ValueError(f"stall factor must be >= 1 (got {factor})")
        self.factor = float(factor)
        self.start_step = max(int(start_step), 0)
        self.n_steps = max(int(n_steps), 0)
        self.rate = float(rate)
        self.rng = np.random.default_rng(seed)
        self.calls = 0          # costed steps evaluated
        self.injected = 0       # steps actually slowed

    def __call__(self, base_s: float) -> float:
        i = self.calls
        self.calls += 1
        if self.start_step <= i < self.start_step + self.n_steps \
                and self.rng.random() < self.rate:
            self.injected += 1
            return base_s * self.factor
        return base_s


class ReplicaCrashInjector:
    """Replica death: raises :class:`InjectedFault` out of the replica's
    batch-cost call (mid-step: after the step's tokens were appended,
    before the clock advanced, the worst spot) on the ``at_step``-th
    costed step and/or at a seeded ``rate``. The router's contract is to
    mark the replica dead, evict its in-flight work and hand it to healthy
    replicas with generated tokens intact: zero lost requests. Compose via
    ``modeled_batch_cost(..., slow=...)``."""

    def __init__(self, *, at_step: Optional[int] = None, rate: float = 0.0,
                 seed: int = 0):
        self.at_step = None if at_step is None else int(at_step)
        self.rate = float(rate)
        self.rng = np.random.default_rng(seed)
        self.calls = 0          # costed steps evaluated
        self.injected = 0       # crashes raised

    def __call__(self, base_s: float) -> float:
        i = self.calls
        self.calls += 1
        if (self.at_step is not None and i == self.at_step) or (
                self.rate > 0 and self.rng.random() < self.rate):
            self.injected += 1
            raise InjectedFault(
                f"injected replica crash at costed step {i}")
        return base_s


class ChunkFaultInjector:
    """Seeded ``ContinuousServeEngine.chunk_fault_hook`` — faults a
    prefill *chunk* mid-prefill.  The engine's contract is that chunk
    boundaries are recovery checkpoints: the request requeues holding
    every committed chunk and resumes from the last one — never from
    token zero — within its retry budget."""

    def __init__(self, rate: float, *, seed: int = 0):
        self.rate = float(rate)
        self.rng = np.random.default_rng(seed)
        self.calls = 0          # chunk executions evaluated
        self.injected = 0       # faults actually raised

    def __call__(self) -> None:
        self.calls += 1
        if self.rng.random() < self.rate:
            self.injected += 1
            raise InjectedFault(
                f"injected prefill-chunk failure #{self.injected}")


class CacheCorruptor:
    """Seeded on-disk corruption of ``ProfileTableCache`` entries.

    ``strike()`` walks the live ``*.npz`` entries in sorted order (so the
    seed fully determines which files are hit) and, at ``rate``,
    overwrites each with garbage bytes: the torn-write or bit-rot case the
    cache's quarantine path exists for. Returns the corrupted paths."""

    def __init__(self, cache, rate: float = 1.0, *, seed: int = 0):
        self.cache = cache
        self.rate = float(rate)
        self.rng = np.random.default_rng(seed)
        self.corrupted: List[Path] = []

    def strike(self) -> List[Path]:
        hit = []
        for path in sorted(self.cache.root.glob("??/*.npz")):
            if self.rng.random() >= self.rate:
                continue
            garbage = self.rng.integers(0, 256, size=64,
                                        dtype=np.uint8).tobytes()
            try:
                path.write_bytes(b"\x00CHAOS" + garbage)
            except OSError:
                continue
            hit.append(path)
        self.corrupted.extend(hit)
        return hit


def burst_requests(vocab_size: int, *, n: int, prompt_len: int = 8,
                   max_new_tokens: int = 4,
                   deadline_s: Optional[float] = None,
                   seed: int = 0) -> list:
    """An open-loop burst: ``n`` requests, all arriving at once (the
    engine stamps arrival at ``generate`` time), each carrying the same
    completion deadline.  Prompts are seeded random tokens."""
    rng = np.random.default_rng(seed)
    return [
        Request(prompt=rng.integers(0, vocab_size, size=(prompt_len,))
                .astype(np.int32),
                max_new_tokens=max_new_tokens, deadline_s=deadline_s)
        for _ in range(n)
    ]


@dataclasses.dataclass(frozen=True)
class TrafficLoad:
    """One traffic class of an open-loop workload: ``rate_rps`` Poisson
    arrivals per second for ``duration_s``, each request drawn with this
    class's shape.  ``burst_at``/``burst_n`` optionally drop an
    instantaneous burst on top (the 4x-spike scenario)."""

    name: str
    rate_rps: float
    duration_s: float
    prompt_len: int = 8
    max_new_tokens: int = 8
    deadline_s: Optional[float] = None
    burst_at: Optional[float] = None
    burst_n: int = 0


def open_loop_arrivals(loads: Sequence[TrafficLoad], vocab_size: int,
                       *, seed: int = 0) -> list:
    """Seeded open-loop arrival schedule across traffic classes.

    Per class, inter-arrival gaps are exponential at ``rate_rps``
    (Poisson process) over ``duration_s``; an optional burst adds
    ``burst_n`` simultaneous arrivals at ``burst_at``.  Classes are
    merged and sorted by time.  Open-loop: arrival times never depend on
    the server, so a saturated engine sees the queue it would see in
    production rather than a politely back-pressured one.  The schedule
    is a pure function of ``seed``.
    """
    # Spike-schedule validation.  Both defects used to pass silently and
    # only surface downstream as inexplicable tails: a burst outside its
    # load's [0, duration_s] window extends the run past the schedule
    # the caller asked for, and two classes spiking at the *same
    # instant* interleave purely by list order — the per-class arrival
    # ordering (and therefore the whole deterministic run) silently
    # depends on how the loads were listed rather than on the seed.
    spikes: dict = {}
    for load in loads:
        if load.burst_at is None or load.burst_n <= 0:
            continue
        t = float(load.burst_at)
        if not 0.0 <= t <= load.duration_s:
            raise ValueError(
                f"load {load.name!r}: burst_at={t} outside its "
                f"[0, duration_s={load.duration_s}] window")
        if t in spikes:
            raise ValueError(
                f"overlapping spike schedules: loads {spikes[t]!r} and "
                f"{load.name!r} both burst at t={t}")
        spikes[t] = load.name

    out = []
    for k, load in enumerate(loads):
        rng = np.random.default_rng(seed + 7919 * k)

        def req():
            return Request(
                prompt=rng.integers(0, vocab_size,
                                    size=(load.prompt_len,))
                .astype(np.int32),
                max_new_tokens=load.max_new_tokens,
                deadline_s=load.deadline_s)

        t = 0.0
        if load.rate_rps > 0:
            while True:
                t += float(rng.exponential(1.0 / load.rate_rps))
                if t >= load.duration_s:
                    break
                out.append(Arrival(t=t, request=req(), klass=load.name))
        if load.burst_at is not None:
            for _ in range(load.burst_n):
                out.append(Arrival(t=float(load.burst_at), request=req(),
                                   klass=load.name))
    out.sort(key=lambda a: a.t)
    return out


@dataclasses.dataclass
class TailReport:
    """Latency tail for one traffic class of an open-loop run."""

    name: str
    completed: int
    shed: int
    failed: int
    recovered: int
    p50_s: float
    p99_s: float
    p999_s: float

    @classmethod
    def build(cls, name: str, results) -> "TailReport":
        done = [r for r in results if not r.shed and not r.failed]
        lats = np.array([r.latency_s for r in done])
        nan = float("nan")
        return cls(
            name=name, completed=len(done),
            shed=sum(r.shed for r in results),
            failed=sum(getattr(r, "failed", False) for r in results),
            recovered=sum(getattr(r, "recovered", False)
                          for r in results),
            p50_s=float(np.percentile(lats, 50)) if lats.size else nan,
            p99_s=float(np.percentile(lats, 99)) if lats.size else nan,
            p999_s=float(np.percentile(lats, 99.9)) if lats.size else nan,
        )


def class_tail_reports(arrivals, results) -> dict:
    """Per-class :class:`TailReport` for a run of ``open_loop_arrivals``
    output through ``ContinuousServeEngine.run`` (results align with
    arrivals by position)."""
    by_class: dict = {}
    for a, r in zip(arrivals, results):
        by_class.setdefault(a.klass, []).append(r)
    return {k: TailReport.build(k, rs) for k, rs in by_class.items()}


@dataclasses.dataclass
class LoadReport:
    """Tail summary of one open-loop run (non-shed request latencies)."""

    completed: int
    shed: int
    deadline_missed: int
    p50_s: float
    p99_s: float

    @classmethod
    def from_results(cls, results) -> "LoadReport":
        lats = np.array([r.latency_s for r in results if not r.shed])
        if lats.size == 0:
            return cls(0, len(results), 0, float("nan"), float("nan"))
        return cls(
            completed=int(lats.size),
            shed=sum(r.shed for r in results),
            deadline_missed=sum(r.deadline_missed for r in results),
            p50_s=float(np.percentile(lats, 50)),
            p99_s=float(np.percentile(lats, 99)),
        )
