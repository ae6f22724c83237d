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
the Triton staircase kernel per class — and at each batch boundary the
engine selects the class nearest the batch's token volume (``plan_log``)
and, with a ``width_swap.WidthSwapper`` attached, serves the batch on the
plan's sliced params (``swap_log``; a warm swap is a cache lookup).
``AdmissionControl`` sheds requests whose projected completion misses
their deadline; ``clock`` and ``batch_cost_fn`` let a run advance a
virtual clock by modeled batch costs, so shed sets and deadline misses
are reproducible.

The degrader, the compile cache and the planner's kernel-grid tie-break
(``tile_hw``) of ``repro``'s engine are later slices of the port.
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
    staircase kernel on ``device`` (its plain version on the CPU) — and,
    when a ``table_cache.ProfileTableCache`` is supplied, tables persist
    across planner restarts (a warm planner performs zero model sweeps).
    """

    def __init__(self, hw, layers: Sequence, *, cache=None,
                 tau_frac: float = 0.02,
                 modules: "dict[str, ModuleRef] | None" = None,
                 device="cuda"):
        from repro_torch.core.tail_model import WaveQuantizationModel
        from repro_torch.core.tail_optimizer import TailEffectOptimizer

        self.hw = hw
        self.layers = list(layers)
        self.model = WaveQuantizationModel(hw, backend="kernel",
                                           device=require_device(device))
        self.opt = TailEffectOptimizer(self.model, cache=cache)
        self.tau_frac = tau_frac
        # name -> pytree address; stamped on every WidthPlan so a
        # WidthSwapper can materialize it (width_swap.serving_templates
        # builds layers and modules as a matched pair).
        self.modules = modules
        self.plans: dict[str, WidthPlan] = {}

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

    def select(self, tokens: int) -> WidthPlan:
        """The planned class nearest (log-scale) to a batch's token
        volume — the boundary-time lookup ``ServeEngine`` performs.
        ``tokens`` is clamped to >= 1 (an empty batch selects the
        smallest class); an exact log-distance tie resolves to the class
        planned first (``min`` is stable over insertion order)."""
        if not self.plans:
            raise ValueError("no plans yet: call plan() first")
        log_t = np.log(max(tokens, 1))
        return min(self.plans.values(),
                   key=lambda p: abs(log_t
                                     - np.log(max(p.traffic.tokens, 1))))


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


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _same_leaves(a: dict, b: dict) -> bool:
    """True when two trees hold the very same tensors, leaf for leaf."""
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(x is y for x, y in zip(la, lb))


class ServeEngine:
    """Pads requests to a slot batch, prefills, then decodes all slots in
    lockstep. ``params`` are fp32 in ``repro``'s layout on any device; the
    engine keeps them on ``device`` with the weights cast to bf16 once.

    A ``swapper`` must hold that cast tree: build it as
    ``WidthSwapper(engine.params, cfg)``, or cast first
    (``transformer.cast_params(params, device)``) and hand the same tree
    to both; the engine refuses one that would re-cast at every swap."""

    def __init__(self, params: dict, cfg: ModelConfig, *, max_len: int = 512,
                 batch_slots: int = 4, rng_seed: int = 0, device="cuda",
                 planner: "ServingWidthPlanner | None" = None,
                 swapper=None, admission: "AdmissionControl | None" = None,
                 clock: Callable[[], float] = time.monotonic,
                 batch_cost_fn=None):
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
        # `clock` is any time.monotonic-like callable; `batch_cost_fn(plan,
        # tokens)`, when set, replaces the measured batch wall time with a
        # simulated cost (advancing the clock if it has .advance).
        self.admission = admission
        self.clock = clock
        self.batch_cost_fn = batch_cost_fn
        self.plan_log: List[WidthPlan] = []
        self.swap_log: List = []
        self.batch_log: List[BatchStats] = []

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
        ``batch_cost_fn`` + a virtual clock), the admission EWMA and the
        batch log."""
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
        self.batch_log.append(BatchStats(
            tokens=tokens, latency_s=dt,
            plan_name=plan.traffic.name if plan is not None else "",
            signal=sig))
        return dt

    def _generate_batch(self, reqs: List[Request]):
        """Select the batch's plan and swap it in (the batch boundary),
        then serve the batch on those params."""
        params = self.params
        plan = None
        if self.planner is not None:
            plan = self.planner.select(
                len(reqs) * max(len(r.prompt) for r in reqs))
            self.plan_log.append(plan)
            if self.swapper is not None:
                # Guarded: a mid-swap failure rolls back to the full-width
                # tree (recorded on the SwapEvent) instead of dropping the
                # batch. A plan without a module mapping still raises.
                params, event = self.swapper.apply_guarded(plan)
                self.swap_log.append(event)
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
        logits, states = tfm.forward(params, cfg,
                                     tokens=torch.from_numpy(toks).to(dev),
                                     mode="prefill")
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
            logits, states = tfm.decode_step(params, cfg, cur, plen + t,
                                             states)
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
