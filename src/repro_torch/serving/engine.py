"""Static-batch serving engine with per-class width plans
(``repro.serving.engine``'s counterpart).

``ServeEngine.generate`` forms batches of ``batch_slots`` requests in order,
left-pads each batch's prompts with token 0 (the pad rows are attended, and
run through the recurrences, as in ``repro``), prefills with
``transformer.forward(mode="prefill")``, grows the global-attention caches
to ``max_len`` and decodes all rows in lockstep with ``decode_step``. On a
CUDA device the MLP projections, the MoE expert products (dense, as
``repro`` serves them), causal prefill attention and the prefill
recurrences (RG-LRU, RWKV6) run on the port's kernels. fp32 products
(decode scores, RWKV6's decays) assume TF32 is off, PyTorch's default; the
entry points set it so.

Width planning and live swapping, as in ``repro``: ``ServingWidthPlanner``
runs the paper's Algorithm 2 once per traffic class (token-volume bucket)
over the stacked staircase tables — on the card that sweep is one launch of
a Triton staircase kernel per class (on a GPU spec the CTA-wave one, paper
Eq. 3 over the GEMM's grid) — and at each batch boundary the
engine selects the class nearest the batch's token volume (``plan_log``)
and, with a ``width_swap.WidthSwapper`` attached, serves the batch on the
plan's sliced params (``swap_log``; a warm swap is a cache lookup).
``AdmissionControl`` sheds requests whose projected completion misses
their deadline; ``clock`` and ``batch_cost_fn`` let a run advance a
virtual clock by modeled batch costs, so shed sets and deadline misses
are reproducible. A ``degradation.DegradationController`` (``degrader=``,
which needs an ``AdmissionControl`` as its signal source) replaces
``planner.select`` at batch boundaries: under a sustained overload signal
it downshifts to narrower, faster plans and recovers to full width when
the burst passes (``BatchStats.level``).

With a ``compile_cache.WidthVariantCompileCache`` attached
(``compile_cache=``), every prefill and decode step goes through it: a
warm step is one CUDA-graph replay, a cold one runs eagerly as without a
cache. ``warm_compile`` captures the steps of given plans and batch shapes
ahead of serving, and each boundary points the cache at the realized
plan, as in ``repro``.

With ``tile_hw`` (a spec), the planner's ``select`` breaks log-distance
ties toward plans whose autotuned GEMM grids are tail-free
(``candidates.kernel_tail_free``: on a GPU spec the port's CUDA tiles over
the card's SMs), then toward plans whose steps are already captured; on a
GPU spec its tail model then prices every width on the autotuned tile.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan_address import ModuleRef
from repro_torch.models import transformer as tfm
from repro_torch.serving.compile_cache import (
    decode_state_struct, leaves, realized_exec_key)


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16
    eos_id: int = -1            # -1: never stop early
    temperature: float = 0.0    # 0 = greedy
    # Completion budget in seconds from submission; None = best-effort.
    # Admission control sheds the request when its projected completion
    # exceeds the budget (see AdmissionControl).
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class Result:
    tokens: np.ndarray
    steps: int
    shed: bool = False              # rejected by admission control
    deadline_missed: bool = False   # completed, but past its budget
    latency_s: float = 0.0          # submission -> completion (engine clock)
    # continuous engine (serving/continuous.py): boundary or chunk-fault
    # requeues survived, whether the request finished after one, terminal
    # failure (retries exhausted, or it cannot fit max_len), and
    # cancellation (ContinuousServeEngine.cancel, a hedge's losing leg)
    retries: int = 0
    recovered: bool = False
    failed: bool = False
    cancelled: bool = False
    # router (serving/router.py): served as a hedge pair, the leg that won
    # ("primary" | "backup"), and the replica failovers survived
    hedged: bool = False
    won_by: str = ""
    migrations: int = 0


def _shed_result() -> "Result":
    return Result(tokens=np.zeros(0, np.int32), steps=0, shed=True)


class AdmissionControl:
    """Deadline-aware admission + load shedding on an overload signal.

    Two inputs form the overload signal (both normalized so 1.0 = at the
    configured limit):

      * **queue depth** — batches waiting, over ``max_queue_batches``;
      * **batch latency** — an EWMA of observed batch wall times
        (``observe`` is fed by the engine after every batch), over
        ``target_batch_s``.

    ``signal`` is the max of the two: queueing stacks latency near
    saturation, so depth alone predicts the tail even before the EWMA
    catches up, and a latency regression (slow batches at low depth)
    still registers.  Admission is per request at batch-formation time:
    a deadline-carrying request is shed when its elapsed wait plus
    ``headroom`` EWMA-predicted batch times exceeds the budget (it
    would miss anyway — serving it would only push every later request
    closer to missing too); a deadline-less request is shed only behind
    a queue deeper than ``max_queue_batches`` at its arrival.
    """

    def __init__(self, *, max_queue_batches: int = 8,
                 target_batch_s: Optional[float] = None,
                 ewma_alpha: float = 0.3, headroom: float = 1.5):
        self.max_queue_batches = max(int(max_queue_batches), 1)
        self.target_batch_s = target_batch_s
        self.ewma_alpha = float(ewma_alpha)
        self.headroom = float(headroom)
        self.batch_ewma: Optional[float] = None
        self.admitted = 0
        self.shed = 0

    def observe(self, batch_s: float) -> None:
        """Feed one completed batch's wall time into the EWMA."""
        if self.batch_ewma is None:
            self.batch_ewma = float(batch_s)
        else:
            self.batch_ewma = (self.ewma_alpha * float(batch_s)
                               + (1.0 - self.ewma_alpha) * self.batch_ewma)

    def signal(self, queue_batches: int) -> float:
        """Overload signal: max of queue-depth and batch-EWMA ratios."""
        depth = queue_batches / self.max_queue_batches
        lat = 0.0
        if self.batch_ewma is not None and self.target_batch_s:
            lat = self.batch_ewma / self.target_batch_s
        return max(depth, lat)

    def admit(self, request: Request, *, now: float, arrival: float,
              backlog_batches: int) -> bool:
        """Admit or shed one request at batch-formation time.

        ``backlog_batches`` is the queue depth (in batches) ahead of the
        request when it arrived — the arrival-time congestion a real
        admission gate would see."""
        if request.deadline_s is not None and self.batch_ewma is not None:
            projected = (now - arrival) + self.headroom * self.batch_ewma
            ok = projected <= request.deadline_s
        else:
            # no deadline to project against (or cold EWMA): hard cap
            ok = backlog_batches <= self.max_queue_batches
        if ok:
            self.admitted += 1
        else:
            self.shed += 1
        return ok


@dataclasses.dataclass(frozen=True)
class BatchStats:
    """Per-batch telemetry, appended to ``ServeEngine.batch_log``."""

    tokens: int         # batch x (prompt length + new tokens)
    latency_s: float    # batch wall time, ending in a device-to-host copy,
    #                     or the simulated cost from ``batch_cost_fn``
    plan_name: str      # traffic class served, "" without a planner
    level: int          # degradation level, -1 without a degrader
    signal: float       # overload signal after this batch


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One serving traffic bucket: a typical per-device token volume
    (batch x padded sequence) and a latency-reduction target."""

    name: str
    tokens: int
    delta: float = 0.95       # Algorithm 2 target: L_new <= delta * L_old


@dataclasses.dataclass
class WidthPlan:
    """Per-traffic-class output of Algorithm 2: the width config to swap
    in at a batch boundary, plus its modeled latency.

    ``modules`` maps each planned layer name to its
    :class:`core.plan_address.ModuleRef` pytree address — the
    hook ``width_swap.WidthSwapper`` needs to materialize the plan onto
    real params.  Plans built from planner templates without a module
    mapping stay record-only (``None``)."""

    traffic: TrafficClass
    widths: dict[str, int]
    latency_s: float
    baseline_latency_s: float
    satisfied: bool
    modules: "dict[str, ModuleRef] | None" = None

    @property
    def latency_reduction(self) -> float:
        if self.baseline_latency_s == 0:
            return 0.0
        return 1.0 - self.latency_s / self.baseline_latency_s


class ServingWidthPlanner:
    """Plans tail-free width configs per traffic class on the stacked
    table engine (paper Algorithm 2, latency-oriented).

    ``layers`` are ``TunableLayer`` templates at a reference token count;
    each traffic class re-tokens the shapes and runs one optimize pass.
    All per-class table builds go through the same
    ``TailEffectOptimizer`` — one stacked sweep per class, through the
    staircase kernel on ``device`` (its plain version on the CPU; on a GPU
    spec, the tail model's GPU form, ``CtaWaveModel``, through the
    CTA-wave kernel, or its exact numpy engine on the CPU) — and,
    when a ``table_cache.ProfileTableCache`` is supplied, tables persist
    across planner restarts (a warm planner performs zero model sweeps).

    ``compile_cache``, when given, answers :meth:`plan_is_warm`. With a
    ``tile_hw`` spec, ``select`` breaks log-distance ties toward plans
    whose autotuned matmul grids are tail-free (:meth:`plan_tail_free`),
    then toward warm ones; without it the first-planned class wins. On a
    GPU spec a GPU ``tile_hw`` also makes the model price each width on
    the tile the autotuner picks for it on ``tile_hw`` (the tile a step
    cache with ``hw=tile_hw`` launches; ``CtaWaveModel``), so a plan's
    reduction is that of the grids that run.
    """

    def __init__(self, hw, layers: Sequence, *, cache=None,
                 tau_frac: float = 0.02,
                 modules: "dict[str, ModuleRef] | None" = None,
                 tile_hw=None, device="cuda", compile_cache=None):
        from repro_torch.core.gpu import is_gpu
        from repro_torch.core.tail_model import model_for
        from repro_torch.core.tail_optimizer import TailEffectOptimizer

        self.hw = hw
        self.layers = list(layers)
        device = require_device(device)
        # the GPU form plans on the CTA-wave kernel on the card and on the
        # exact numpy engine on the CPU; the TPU form on its staircase
        # kernel, or that kernel's fp64 plain version on the CPU
        backend = "numpy" if is_gpu(hw) and device.type == "cpu" \
            else "kernel"
        # on a GPU spec with a GPU tile_hw, the model prices each width on
        # the tile the autotuner picks for it (what a step cache with
        # hw=tile_hw launches); it keeps the tiles it is built with
        self.model = model_for(hw, backend=backend, device=device,
                               tile_hw=tile_hw)
        self.opt = TailEffectOptimizer(self.model, cache=cache)
        self.tau_frac = tau_frac
        # Kernel-grid tail awareness (optional): with a tile_hw spec,
        # `select` breaks log-distance ties toward plans whose autotuned
        # matmul grids are tail-free (core.candidates.kernel_tail_free)
        # and, with a compile cache attached, whose steps are captured.
        # With tile_hw=None the first-planned tie-break is unchanged.
        self.tile_hw = tile_hw
        self._layer_by_name = {tl.layer.name: tl.layer
                               for tl in self.layers}
        self.compile_cache = compile_cache
        # name -> pytree address; stamped on every WidthPlan so a
        # WidthSwapper can materialize it (width_swap.serving_templates
        # builds layers and modules as a matched pair).
        self.modules = modules
        self.plans: dict[str, WidthPlan] = {}
        # Telemetry: observed per-class latencies, fed by the engines
        # (`record`: a static batch's, a continuous request's); the hedge
        # policy reads its delay from them (`observed_percentile`). A
        # sliding window bounds the memory of a long-running server.
        self.telemetry: dict[str, List[float]] = {}
        self.telemetry_window = 4096

    def record(self, class_name: str, latency_s: float) -> None:
        """Observe one latency for a traffic class; only the latest
        ``telemetry_window`` samples per class are kept."""
        lats = self.telemetry.setdefault(class_name, [])
        lats.append(float(latency_s))
        if len(lats) > self.telemetry_window:
            del lats[:-self.telemetry_window]

    def observed_percentile(self, class_name: str,
                            q: float) -> Optional[float]:
        """q-th percentile (numpy's linear rule) of a class's observed
        latencies, or None before any observation; ``q`` is clamped to
        [0, 100]."""
        lats = self.telemetry.get(class_name)
        if not lats:
            return None
        q = min(max(float(q), 0.0), 100.0)
        return float(np.percentile(np.asarray(lats), q))

    def _retokened(self, tokens: int) -> list:
        out = []
        for tl in self.layers:
            if tl.layer.tokens == tokens:
                out.append(tl)
                continue
            layer = dataclasses.replace(tl.layer, tokens=tokens)
            # A measured profile is only valid at the token count it was
            # profiled with — re-tokened classes must fall back to the
            # analytic model rather than silently reuse stale latencies.
            out.append(dataclasses.replace(tl, layer=layer, measured=None))
        return out

    def plan(self, traffic: Sequence[TrafficClass]) -> dict[str, WidthPlan]:
        """One Algorithm 2 pass per traffic class; results are kept on the
        planner for ``select`` and returned keyed by class name."""
        total_p = sum(tl.params(tl.layer.width) for tl in self.layers)
        for tc in traffic:
            res = self.opt.optimize_latency(
                self._retokened(tc.tokens),
                tau=self.tau_frac * total_p,
                delta=tc.delta)
            self.plans[tc.name] = WidthPlan(
                traffic=tc,
                widths=res.new_widths,
                latency_s=res.latency_new_s,
                baseline_latency_s=res.latency_old_s,
                satisfied=res.satisfied,
                modules=self.modules)
        return self.plans

    def plan_tail_free(self, plan: WidthPlan) -> bool:
        """True when every planned width's autotuned matmul grid is
        tail-free on ``tile_hw`` (trivially True without one).  Widths
        naming layers outside the template set are skipped — a hand
        -injected plan can't be scored, only compared by distance."""
        if self.tile_hw is None:
            return True
        from repro_torch.core.candidates import kernel_tail_free
        for name, w in plan.widths.items():
            layer = self._layer_by_name.get(name)
            if layer is None:
                continue
            if not kernel_tail_free(self.tile_hw, plan.traffic.tokens,
                                    layer.d_in, w):
                return False
        return True

    def plan_is_warm(self, plan: WidthPlan) -> bool:
        """True when a compile cache is attached and holds captured steps
        for the plan's widths."""
        return self.compile_cache is not None \
            and self.compile_cache.plan_is_warm(plan)

    def select(self, tokens: int) -> WidthPlan:
        """The planned class nearest (log-scale) to a batch's token
        volume — the boundary-time lookup ``ServeEngine`` performs.
        ``tokens`` is clamped to >= 1 (an empty batch selects the
        smallest class).  Without ``tile_hw``, an exact log-distance tie
        resolves to the class planned first (``min`` is stable over
        insertion order).  With ``tile_hw``, ties instead prefer plans
        whose autotuned kernel grids are tail-free, then plans whose steps
        are already captured."""
        if not self.plans:
            raise ValueError("no plans yet: call plan() first")
        log_t = np.log(max(tokens, 1))
        if self.tile_hw is None:
            return min(self.plans.values(),
                       key=lambda p: abs(log_t
                                         - np.log(max(p.traffic.tokens,
                                                      1))))
        return min(
            self.plans.values(),
            key=lambda p: (abs(log_t - np.log(max(p.traffic.tokens, 1))),
                           not self.plan_tail_free(p),
                           not self.plan_is_warm(p)))


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device and
    no card is present, instead of running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was asked for but torch.cuda.is_available() is "
            f"False: no CUDA device; pass device='cpu' to run the plain "
            f"path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _same_leaves(a: dict, b: dict) -> bool:
    """True when two trees hold the very same tensors, leaf for leaf."""
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(x is y for x, y in zip(la, lb))


class ServeEngine:
    """Pads requests to a slot batch, prefills, then decodes all slots in
    lockstep. ``params`` are fp32 in ``repro``'s layout on any device; the
    engine keeps them on ``device`` with the weights cast to bf16 once.

    A ``swapper`` must hold that cast tree: build it as
    ``WidthSwapper(engine.params, cfg)``, or cast first
    (``transformer.cast_params(params, device)``) and hand the same tree
    to both; the engine refuses one that would re-cast at every swap.

    With a ``compile_cache`` (built for ``cfg``), prefill and decode go
    through its captured steps; plans whose modeled saving cannot pay for
    a capture realize as zero-masked full-shape params (``decide``), which
    replay the full-width steps on their own weights."""

    def __init__(self, params: dict, cfg: ModelConfig, *, max_len: int = 512,
                 batch_slots: int = 4, rng_seed: int = 0, device="cuda",
                 planner: "ServingWidthPlanner | None" = None,
                 swapper=None, admission: "AdmissionControl | None" = None,
                 degrader=None,
                 clock: Callable[[], float] = time.monotonic,
                 batch_cost_fn=None, compile_cache=None):
        if cfg.is_encdec:
            # repro's engine prefills from tokens alone and trips an
            # assert on an encoder-decoder; the model API serves it
            raise ValueError(f"{cfg.name}: ServeEngine serves decoder-only "
                             f"models (an encoder-decoder's prefill needs "
                             f"src_embeds; use transformer.forward and "
                             f"decode_step)")
        self.device = require_device(device)
        self.cfg = cfg
        self.params = tfm.cast_params(params, self.device)
        self.max_len = max_len
        self.slots = batch_slots
        self.gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self.planner = planner
        if swapper is not None and not _same_leaves(swapper.full_params,
                                                    self.params):
            raise ValueError(
                "the swapper must hold the engine's cast params: build it "
                "as WidthSwapper(engine.params, cfg), or pass "
                "transformer.cast_params(params, device) to both")
        self.swapper = swapper
        # A degradation controller walks width plans under the admission
        # controller's overload signal, so it needs one. `clock` is any
        # time.monotonic-like callable; `batch_cost_fn(plan, tokens)`, when
        # set, replaces the measured batch wall time with a simulated cost
        # (advancing the clock if it has .advance).
        if degrader is not None and admission is None:
            raise ValueError(
                "a degradation controller needs an AdmissionControl as "
                "its overload-signal source; pass admission= too")
        self.admission = admission
        self.degrader = degrader
        self.clock = clock
        self.batch_cost_fn = batch_cost_fn
        self.plan_log: List[WidthPlan] = []
        self.swap_log: List = []
        self.batch_log: List[BatchStats] = []

        # Captured steps (serving/compile_cache.py): with a cache attached
        # every prefill/decode goes through its replay-or-eager entry
        # points, and the boundary swap sets the active realized key.
        self.compile_cache = compile_cache
        if compile_cache is not None:
            if compile_cache.cfg is not cfg and compile_cache.cfg != cfg:
                raise ValueError("compile_cache was built for a different "
                                 "ModelConfig than this engine")
            compile_cache.claim(self, continuous=False)
            self._prefill = compile_cache.prefill
            self._decode = compile_cache.decode
        else:
            self._prefill = lambda p, toks: tfm.forward(
                p, cfg, tokens=toks, mode="prefill")
            self._decode = lambda p, t, pos, st: tfm.decode_step(
                p, cfg, t, pos, st)

    def warm_compile(self, plans: Sequence[WidthPlan],
                     batch_shapes: Sequence[tuple]) -> int:
        """Plan-time capture: for every plan x (batch, prompt length)
        shape, capture the prefill and decode steps, so that the batch
        boundary to that plan is a table lookup and each step a replay.
        Masked-crossover plans (``decide() == "masked"``) warm the
        full-width key instead, whose steps replay on whatever tree is
        passed. Returns the number of warm entries (one already warm
        counts); a capture fault is absorbed (eager fallback). Without a
        swapper the plans cannot be realized and only the full-width
        baseline, the one tree such an engine serves, is captured
        (``repro`` captures nothing then)."""
        cache = self.compile_cache
        if cache is None:
            return 0
        prev_key = cache.active_key
        n = 0
        todo = (list(plans) if self.swapper is not None else []) + [None]
        for plan in todo:          # None: the full-width baseline
            if plan is None:
                key, heads = cache.full_key, None
                params = self.params if self.swapper is None \
                    else self.swapper.full_params
            else:
                masked = bool(plan.widths) \
                    and cache.decide(plan) == "masked"
                params, event = self.swapper.apply_guarded(
                    plan, masked=masked)
                if event.outcome != "ok":
                    continue
                mlp_w, heads_to = self.swapper.realize_plan(plan)
                if masked:
                    key, heads = cache.full_key, None
                else:
                    key, heads = realized_exec_key(mlp_w, heads_to), heads_to
            for (b, plen) in batch_shapes:
                b, plen = int(b), int(plen)
                cache.set_active(key)
                toks = torch.zeros((b, plen), dtype=torch.long,
                                   device=self.device)
                n += cache.precompile("prefill", key, (b, plen),
                                      (params, toks))
                st = decode_state_struct(self.cfg, b, self.max_len,
                                         swapper=self.swapper, heads=heads,
                                         device=self.device)
                cur = torch.zeros((b,), dtype=torch.long, device=self.device)
                n += cache.precompile("decode", key, (b,),
                                      (params, cur, 0, st))
            if plan is not None:
                cache.mark_plan_warm(plan)
        cache.set_active(prev_key)
        return n

    def generate(self, requests: List[Request]) -> List[Result]:
        """Serve an open-loop burst: all requests arrive now; batches of
        ``batch_slots`` are formed in order, with admission control (when
        attached) shedding requests at batch-formation time."""
        results: List[Optional[Result]] = [None] * len(requests)
        arrival = self.clock()
        queue = deque(enumerate(requests))
        while queue:
            batch_idx: List[int] = []
            batch: List[Request] = []
            while queue and len(batch) < self.slots:
                i, r = queue.popleft()
                if self.admission is not None and not self.admission.admit(
                        r, now=self.clock(), arrival=arrival,
                        backlog_batches=i // self.slots):
                    results[i] = _shed_result()
                    continue
                batch_idx.append(i)
                batch.append(r)
            if not batch:
                continue
            t0 = self.clock()
            out, plan = self._generate_batch(batch)
            self._account_batch(plan, batch, t0, queue_len=len(queue))
            end = self.clock()
            for i, res in zip(batch_idx, out):
                res.latency_s = end - arrival
                d = requests[i].deadline_s
                res.deadline_missed = d is not None and res.latency_s > d
                results[i] = res
        return [r for r in results if r is not None]

    def _account_batch(self, plan, reqs: List[Request], t0: float,
                       *, queue_len: int) -> float:
        """Close out one batch: latency (measured, or simulated through
        ``batch_cost_fn`` + a virtual clock), the admission EWMA, the
        degradation controller's overload observation and the batch
        log."""
        plen = max(len(r.prompt) for r in reqs)
        tokens = len(reqs) * (plen + max(r.max_new_tokens for r in reqs))
        if self.batch_cost_fn is not None:
            dt = self.batch_cost_fn(plan, tokens)
            advance = getattr(self.clock, "advance", None)
            if advance is not None:
                advance(dt)
        else:
            dt = self.clock() - t0
        sig = 0.0
        if self.admission is not None:
            self.admission.observe(dt)
            sig = self.admission.signal(
                (queue_len + self.slots - 1) // self.slots)
            if self.degrader is not None:
                self.degrader.observe(sig)
        if self.planner is not None and plan is not None:
            self.planner.record(plan.traffic.name, dt)
        self.batch_log.append(BatchStats(
            tokens=tokens, latency_s=dt,
            plan_name=plan.traffic.name if plan is not None else "",
            level=self.degrader.level if self.degrader is not None else -1,
            signal=sig))
        return dt

    def _generate_batch(self, reqs: List[Request]):
        """Select the batch's plan and swap it in (the batch boundary),
        then serve the batch on those params."""
        params = self.params
        plan = None
        cache = self.compile_cache
        tokens = len(reqs) * max(len(r.prompt) for r in reqs)
        if self.degrader is not None:
            # the active ladder rung picks the plan for this token volume
            plan = self.degrader.select(tokens)
        elif self.planner is not None:
            plan = self.planner.select(tokens)
        if plan is not None:
            self.plan_log.append(plan)
            if self.swapper is not None:
                # Guarded: a mid-swap failure rolls back to the full-width
                # tree (recorded on the SwapEvent) instead of dropping the
                # batch. A plan without a module mapping still raises.
                masked = (cache is not None and bool(plan.widths)
                          and cache.decide(plan) == "masked")
                params, event = self.swapper.apply_guarded(plan,
                                                           masked=masked)
                self.swap_log.append(event)
                if cache is not None:
                    if event.outcome == "ok" and not masked:
                        cache.set_active(realized_exec_key(
                            *self.swapper.realize_plan(plan)))
                    else:
                        # masked or rolled back: canonical shapes
                        cache.set_active(None)
        elif cache is not None:
            cache.set_active(None)
        return self._decode_batch(params, reqs), plan

    @torch.inference_mode()
    def _decode_batch(self, params: dict,
                      reqs: List[Request]) -> List[Result]:
        cfg, dev = self.cfg, self.device
        b = len(reqs)
        plen = max(len(r.prompt) for r in reqs)
        max_new = max(r.max_new_tokens for r in reqs)
        if plen + max_new - 1 > self.max_len:
            raise ValueError(f"prompt {plen} + {max_new} new tokens need "
                             f"{plen + max_new - 1} cache rows; max_len is "
                             f"{self.max_len}")
        toks = np.zeros((b, plen), np.int64)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt   # left-pad
        logits, states = self._prefill(params,
                                       torch.from_numpy(toks).to(dev))
        states = self._ensure_states(states)

        cur = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)
        generated = [cur]
        done = np.zeros(b, bool)
        steps = 0
        any_temp = any(r.temperature > 0 for r in reqs)
        if any_temp:
            temp = torch.tensor([max(r.temperature, 1e-6) for r in reqs],
                                device=dev)[:, None]
            use_t = torch.tensor([r.temperature > 0 for r in reqs],
                                 device=dev)
        track_eos = any(r.eos_id >= 0 for r in reqs)
        for t in range(max_new - 1):
            logits, states = self._decode(params, cur, plen + t, states)
            logits = logits[:, :cfg.vocab_size]
            greedy = torch.argmax(logits, dim=-1)
            if any_temp:
                probs = torch.softmax(logits.float() / temp, dim=-1)
                drawn = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
                cur = torch.where(use_t, drawn, greedy)
            else:
                cur = greedy
            generated.append(cur)
            steps += 1
            if track_eos:
                host = cur.cpu().numpy()
                for i, r in enumerate(reqs):
                    if r.eos_id >= 0 and host[i] == r.eos_id:
                        done[i] = True
                if done.all():
                    break

        gen = torch.stack(generated, dim=1).cpu().numpy().astype(np.int32)
        results = []
        for i, r in enumerate(reqs):
            row = gen[i][: r.max_new_tokens]
            if r.eos_id >= 0 and (row == r.eos_id).any():
                row = row[: int(np.argmax(row == r.eos_id)) + 1]
            results.append(Result(tokens=row, steps=steps + 1))
        return results

    def _ensure_states(self, states: dict) -> dict:
        """Grow the prefill KV caches of the global-attention layers (their
        sequence axis third from the end) to ``max_len`` rows of decode
        capacity. The layer kind decides, not a shape: a local layer's ring
        stays ``window`` rows, and recurrent states and shift or conv
        carries stay as they are. The returned tree shares every other
        tensor with ``states``."""
        out = {g: dict(sub) for g, sub in states.items()}
        for group, key in {(r["group"], r["key"])
                           for r in tfm.decoder_layer_refs(self.cfg)
                           if r["kind"] == "attn"}:
            cache = dict(out[group][key])
            for name in ("k", "v"):
                pad = self.max_len - cache[name].shape[-3]
                if pad > 0:
                    cache[name] = F.pad(cache[name], (0, 0, 0, 0, 0, pad))
            out[group][key] = cache
        return out
