"""Continuous-batching serve engine with in-flight fault recovery
(``repro.serving.continuous``'s counterpart).

``ServeEngine`` (engine.py) serves static batches: a short request queued
behind a long one pays the long one's decode tail (head-of-line blocking),
and ``WidthSwapper.reshape_states`` never meets live state, since every
batch starts from a fresh prefill. This engine serves an open stream:

  * **Slot-based continuous batching** — the engine owns ``batch_slots``
    decode slots over one shared decode state; requests *join in flight*
    (a one-request prefill written into a free slot's rows) and *leave in
    flight* when they finish, freeing the slot for the next queued
    request. Decode steps are ragged: every slot sits at its own position
    (a (B,) ``pos``, ``transformer.decode_step``).
  * **Joins** are whole-prompt prefills, right-padded to pow2 buckets when
    a step cache is attached (``prefill_bucketing``), or chunked prefills
    (``prefill_chunk``): the prompt runs ``prefill_chunk`` tokens at a time
    from each step's token budget, interleaved with the other slots'
    decode steps, each committed chunk a recovery checkpoint.
  * **Admission + watchdogs** — joins go through
    :class:`~repro_torch.serving.engine.AdmissionControl`; once decoding, a
    request past its deadline is shed with its partial tokens.
  * **Recoverable boundary transactions** — at a width-plan boundary the
    engine swaps params through ``WidthSwapper.apply_guarded`` and carries
    the live KV caches across through ``reshape_states`` (exact when the
    plan shrinks heads). A rolled-back swap or a faulted reshape restores
    the canonical tree and fresh state and requeues every in-flight
    request with its tokens intact, within ``max_retries``; a boundary that
    would grow KV heads requeues live requests so that they re-prefill at
    the new width.
  * **Graceful drain** — :meth:`ContinuousServeEngine.drain` returns a
    :class:`Ledger` in which every submitted request is finished, shed,
    failed or evicted.

With a ``compile_cache.WidthVariantCompileCache`` attached, every prefill,
chunk and decode step goes through it: a warm step replays a CUDA graph
(``warm_compile`` captures the decode step, the prefill buckets and the
chunk shapes of every plan). The shared slot state stays the decode
entry's static states: a join writes its rows into it in place, so a
decode step copies no KV cache, and each prefilling request keeps a
checkpoint of its own (the cache copies it in and out around a chunk's
replay). So the cache serves this engine alone while it lives
(``WidthVariantCompileCache.claim``): a fleet gives each replica its own.

Behind ``serving/router.py``'s ``ReplicaRouter`` the engine is one replica:
``cancel`` frees a hedge's losing leg slot-exactly, ``evict_in_flight`` and
``adopt`` move requests (tokens and chunk checkpoints intact) off a dead or
slow replica, and with a ``planner`` every finished request's latency is
recorded per traffic class (``ServingWidthPlanner.record``), the telemetry
the hedge delay is read from.

Determinism: with a ``chaos.VirtualClock`` and a ``batch_cost_fn`` every
join, shed, boundary crossing and requeue is a function of the seeds, as
in ``repro``; greedy tokens are the model's.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.serving.compile_cache import (
    leaves, pow2_bucket, realized_exec_key)
from repro_torch.serving.engine import (
    Request, Result, WidthPlan, _same_leaves, require_device)


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One open-loop arrival: a request hitting the server at time ``t``
    (engine-clock seconds), tagged with its traffic class for per-class
    tail reporting."""

    t: float
    request: Request
    klass: str = ""


@dataclasses.dataclass(frozen=True)
class BoundaryEvent:
    """One width-plan boundary crossing attempt, in ``boundary_log``."""

    step: int                 # engine step index at the crossing
    plan_name: str            # traffic class of the target plan
    outcome: str              # "ok" | "swap_rolled_back" |
    #                           "reshape_failed" | "requeued_grow"
    requeued: int             # in-flight requests sent back to the queue
    error: str = ""           # repr of the mid-boundary exception, if any


@dataclasses.dataclass(frozen=True)
class ChunkEvent:
    """One chunked-prefill fault, in ``chunk_log``: the request requeued
    holding ``committed`` prefilled tokens — its recovery checkpoint."""

    step: int                 # engine step index at the fault
    rid: int                  # faulted request
    committed: int            # prefill tokens surviving as checkpoint
    error: str = ""           # repr of the chunk exception


@dataclasses.dataclass(frozen=True)
class Ledger:
    """Complete accounting of a serve run: every submitted request ends
    in exactly one terminal state. ``evicted`` counts requests handed off
    to another replica by ``evict_in_flight``: terminal on this engine,
    so they count toward ``accounted`` here."""

    submitted: int
    finished: int
    shed: int
    failed: int
    in_flight: int            # non-terminal (0 after drain())
    queued: int               # non-terminal (0 after drain())
    evicted: int = 0          # migrated off this engine (router failover)

    @property
    def accounted(self) -> int:
        return self.finished + self.shed + self.failed + self.evicted

    @property
    def complete(self) -> bool:
        """True when every submitted request reached a terminal state."""
        return self.accounted == self.submitted \
            and self.in_flight == 0 and self.queued == 0


@dataclasses.dataclass
class _Tracked:
    """Engine-internal per-request bookkeeping.

    The three ``chunk_*`` fields are the chunked-prefill checkpoint: a
    batch-1 decode state holding every committed chunk's KV rows (tensors
    of the request's own), plus the shape and effective head vectors it
    was built under. It travels with the request through requeues and
    migrations, and resumes exactly when both head vectors still match
    the engine's active ones (otherwise the prefill restarts)."""

    rid: int
    request: Request
    klass: str
    arrival_t: float
    generated: List[int] = dataclasses.field(default_factory=list)
    retries: int = 0
    join_t: float = 0.0
    prefill_done: int = 0                       # committed prefill tokens
    chunk_state: Optional[dict] = None          # batch-1 decode state
    chunk_heads: Optional[np.ndarray] = None    # KV *shape* heads of it
    chunk_eff: Optional[np.ndarray] = None      # effective heads of it


class ContinuousServeEngine:
    """Requests join and leave the running decode batch in flight.

    The engine owns one decode state shaped ``(batch_slots, max_len,
    ...)`` (``transformer.init_decode_state``'s layout) and a per-slot
    position vector; a decode step runs every slot in one ragged
    ``decode_step`` (a (B,) ``pos``). ``params`` are fp32 in ``repro``'s
    layout on any device; the engine keeps them on ``device`` with the
    weights cast to bf16 once, and a ``swapper`` must hold that cast tree
    (as ``ServeEngine`` requires). ``degrader``, if given, is any object
    with ``select(tokens) -> WidthPlan`` and ``observe(signal)``, and needs
    ``admission`` as its signal's source.

    Decoder-only models only (``cfg.is_encdec`` is rejected).
    """

    def __init__(self, params, cfg: ModelConfig, *, max_len: int = 512,
                 batch_slots: int = 4, rng_seed: int = 0, device="cuda",
                 planner=None, swapper=None, admission=None, degrader=None,
                 clock: Callable[[], float] = time.monotonic,
                 batch_cost_fn=None, max_retries: int = 2,
                 boundary_every: int = 4, boundary_cooldown: int = 8,
                 compile_cache=None,
                 prefill_bucketing: Optional[bool] = None,
                 prefill_bucket_min: int = 8,
                 prefill_chunk: Optional[int] = None,
                 step_token_budget: Optional[int] = None,
                 chunk_fault_hook: Optional[Callable[[], None]] = None):
        if cfg.is_encdec:
            raise ValueError("continuous batching supports decoder-only "
                             "models (no cross-attention cache rewrite)")
        if degrader is not None and admission is None:
            raise ValueError(
                "a degradation controller needs an AdmissionControl as "
                "its overload-signal source; pass admission= too")
        self.device = require_device(device)
        self.cfg = cfg
        self.params = tfm.cast_params(params, self.device)
        if swapper is not None and not _same_leaves(swapper.full_params,
                                                    self.params):
            raise ValueError(
                "the swapper must hold the engine's cast params: build it "
                "as WidthSwapper(engine.params, cfg), or pass "
                "transformer.cast_params(params, device) to both")
        self.max_len = int(max_len)
        self.slots = int(batch_slots)
        self.gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self.planner = planner
        self.swapper = swapper
        self.admission = admission
        self.degrader = degrader
        self.clock = clock
        self.batch_cost_fn = batch_cost_fn
        self.max_retries = max(int(max_retries), 0)
        # Plan boundaries are only considered every `boundary_every` steps
        # (a continuous engine has no natural batch edge), and after a
        # failed crossing the engine serves `boundary_cooldown` steps on
        # the canonical tree before retrying, so that a crash-looping swap
        # cannot starve the requeued requests out of their retries.
        self.boundary_every = max(int(boundary_every), 1)
        self.boundary_cooldown = max(int(boundary_cooldown), 0)

        # Active serving state: params + the realized widths they carry.
        self.params_active = self.params
        self._canonical = self.params if swapper is None \
            else swapper.full_params
        n_refs = len(tfm.decoder_layer_refs(cfg))
        self._full_heads = np.full(n_refs, cfg.n_heads, dtype=np.int64)
        self._heads_active = self._full_heads.copy()
        # Head counts of the KV-cache SHAPES, which differ from the
        # effective `_heads_active` exactly when the active plan is a
        # zero-mask (masked params keep canonical shapes): reshape_states
        # sources from the shapes, grow detection compares effective heads.
        self._shape_heads = self._full_heads.copy()
        self._masked_active = False
        self._plan_active: Optional[WidthPlan] = None
        self._key_active: Optional[tuple] = None

        # Prefill length bucketing: pow2-pad join prefills, so the number
        # of prefill shapes (captures) is bounded by log2(max_len). Exact
        # only for pure global-causal-attention dense stacks: local rings
        # rotate by the total prefill length and recurrent/MoE layers see
        # the pad rows. Default: on when a step cache is attached.
        bucket_ok = not cfg.moe and all(
            kind == "attn" for kind, _ in tfm.layer_plan(cfg))
        if prefill_bucketing is None:
            self.prefill_bucketing = compile_cache is not None and bucket_ok
        elif prefill_bucketing and not bucket_ok:
            raise ValueError(
                "prefill_bucketing requires a pure global-attention "
                "dense decoder (local/recurrent layers and MoE capacity "
                "are length-sensitive)")
        else:
            self.prefill_bucketing = bool(prefill_bucketing)
        self.prefill_bucket_min = max(int(prefill_bucket_min), 1)

        # Chunked prefill: a join seats the request in a "prefilling" slot
        # and its prompt runs `prefill_chunk` tokens at a time from each
        # step's token budget, between the other slots' decode steps. Same
        # eligibility as bucketing: a chunk replays against a KV cache.
        if prefill_chunk is not None:
            if not bucket_ok:
                raise ValueError(
                    "chunked prefill requires a pure global-attention "
                    "dense decoder (local/recurrent layers and MoE "
                    "capacity cannot replay a chunk against a cache)")
            if int(prefill_chunk) < 1:
                raise ValueError("prefill_chunk must be >= 1")
        self.prefill_chunk = None if prefill_chunk is None \
            else int(prefill_chunk)
        self.step_token_budget = None if step_token_budget is None \
            else max(int(step_token_budget), 1)
        self.chunk_fault_hook = chunk_fault_hook

        # Slot state: one shared decode state + per-slot positions.
        self.states = self._fresh_states(self._full_heads)
        self.pos = np.zeros(self.slots, dtype=np.int64)
        self._slots: List[Optional[_Tracked]] = [None] * self.slots
        self._last_tok = np.zeros(self.slots, dtype=np.int64)

        # Queues: pending (future arrivals), waiting (delivered, not yet
        # admitted), retry (admitted work evicted by a boundary or chunk
        # failure — rejoins ahead of the queue, without re-admission).
        self._pending: deque = deque()
        self._queue: deque = deque()
        self._retry: deque = deque()
        self.draining = False

        # Accounting.
        self._next_rid = 0
        self._results: dict[int, Result] = {}
        self._submitted = 0
        self._finished = 0
        self._shed = 0
        self._failed = 0
        self._evicted = 0
        self.steps = 0
        self._decode_steps = 0
        self._last_boundary_fail = -(10 ** 9)
        self.plan_log: List[WidthPlan] = []
        self.swap_log: List = []
        self.boundary_log: List[BoundaryEvent] = []
        self.chunk_log: List[ChunkEvent] = []
        self.join_count = 0
        self.chunk_steps = 0        # successful prefill chunks executed

        # Captured steps (serving/compile_cache.py): replay on a hit, the
        # eager step otherwise; warm_compile() makes joins and boundary
        # crossings capture-free.
        self.compile_cache = compile_cache
        if compile_cache is not None:
            if compile_cache.cfg is not cfg and compile_cache.cfg != cfg:
                raise ValueError("compile_cache was built for a different "
                                 "ModelConfig than this engine")
            # the decode entries' static states become this engine's slot
            # state: the cache serves no other engine while this one lives
            compile_cache.claim(self, continuous=True)
            self._decode = compile_cache.decode
            self._prefill = compile_cache.prefill
            self._chunk = compile_cache.chunk
        else:
            self._decode = lambda p, t, pos, st: tfm.decode_step(
                p, cfg, t, pos, st)
            self._prefill = lambda p, toks: tfm.forward(
                p, cfg, tokens=toks, mode="prefill")
            self._chunk = lambda p, toks, pos, st: tfm.prefill_chunk(
                p, cfg, toks, pos, st)

    def _prefill_len(self, plen: int) -> int:
        """Padded prefill length for a ``plen``-token join."""
        if not self.prefill_bucketing:
            return plen
        return min(pow2_bucket(plen, self.prefill_bucket_min),
                   max(self.max_len, plen))

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(toks, dtype=np.int64)).to(
            self.device)

    @torch.inference_mode()
    def warm_compile(self, plans: Sequence[WidthPlan],
                     prefill_lengths: Sequence[int] = ()) -> int:
        """Plan-time capture: the ragged decode step, and the single-request
        prefill buckets of ``prefill_lengths`` (or, with ``prefill_chunk``,
        the chunk shapes they need), for every plan plus the full-width
        baseline, so that boundary crossings and joins are table lookups.
        Masked-crossover plans warm the full-width key. Returns the number
        of warm entries; capture faults are absorbed (the serve path runs
        those steps eagerly). ``repro`` computes the chunk shapes here and
        never compiles them; the port captures them."""
        if self.compile_cache is None:
            return 0
        cache = self.compile_cache
        prev_key = cache.active_key
        if self.prefill_chunk is None:
            buckets = sorted({self._prefill_len(int(n))
                              for n in prefill_lengths})
            chunk_buckets: list = []
        else:
            # Chunked joins never call the whole-prompt prefill: the shape
            # set is the chunk itself plus the pow2 buckets of each
            # prompt's final partial chunk (capped at the chunk).
            c = self.prefill_chunk
            shapes = {c}
            for plen in prefill_lengths:
                tail = int(plen) % c or c
                shapes.add(min(self._prefill_len(tail), c))
            chunk_buckets = sorted(shapes)
            buckets = []
        n = 0
        todo = ([None] if self.swapper is None else list(plans) + [None])
        for plan in todo:
            if plan is None:
                key = cache.full_key
                params = self._canonical
                heads = self._full_heads
            else:
                masked = bool(plan.widths) \
                    and cache.decide(plan) == "masked"
                params, event = self.swapper.apply_guarded(
                    plan, masked=masked)
                if event.outcome != "ok":
                    continue
                mlp_w, heads_to = self.swapper.realize_plan(plan)
                if masked:
                    key, heads = cache.full_key, self._full_heads
                else:
                    key = realized_exec_key(mlp_w, heads_to)
                    heads = np.asarray(heads_to, dtype=np.int64)
            cache.set_active(key)
            zeros = torch.zeros(self.slots, dtype=torch.long,
                                device=self.device)
            n += cache.precompile("decode", key, (self.slots,),
                                  (params, zeros, zeros.clone(),
                                   self._fresh_states(heads)))
            for plen in buckets:
                toks = torch.zeros((1, plen), dtype=torch.long,
                                   device=self.device)
                n += cache.precompile("prefill", key, (1, plen),
                                      (params, toks))
            for c in chunk_buckets:
                toks = torch.zeros((1, c), dtype=torch.long,
                                   device=self.device)
                n += cache.precompile("chunk", key, (1, c),
                                      (params, toks, 0,
                                       self._fresh_states(heads, batch=1)))
            if plan is not None:
                cache.mark_plan_warm(plan)
        cache.set_active(prev_key)
        return n

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, request: Request, *, arrival_t: Optional[float] = None,
               klass: str = "") -> int:
        """Register one request; returns its id. Arrivals in the future
        (``arrival_t`` > now) are delivered when the clock reaches them.
        A draining engine sheds immediately: it no longer admits."""
        rid = self._next_rid
        self._next_rid += 1
        self._submitted += 1
        t = self.clock() if arrival_t is None else float(arrival_t)
        tr = _Tracked(rid=rid, request=request, klass=klass, arrival_t=t)
        if self.draining:
            self._terminal(tr, shed=True)
            return rid
        self._pending.append(tr)
        return rid

    def result(self, rid: int) -> Optional[Result]:
        return self._results.get(rid)

    def _clear_slot(self, i: int) -> None:
        self._slots[i] = None
        self.pos[i] = 0
        self._last_tok[i] = 0

    def cancel(self, rid: int) -> bool:
        """Cancel one in-flight or queued request: only its slot is freed
        (every other slot keeps decoding) and it resolves as shed with
        ``cancelled=True``. Returns False for unknown or already-terminal
        ids."""
        for i, tr in enumerate(self._slots):
            if tr is not None and tr.rid == rid:
                self._clear_slot(i)
                self._terminal(tr, shed=True, cancelled=True)
                return True
        for q in (self._retry, self._queue, self._pending):
            for tr in q:
                if tr.rid == rid:
                    q.remove(tr)
                    self._terminal(tr, shed=True, cancelled=True)
                    return True
        return False

    # ------------------------------------------------------------------
    # replica failover surface
    # ------------------------------------------------------------------
    def evict_in_flight(self) -> List[_Tracked]:
        """Strip every non-terminal request off this engine (slots, retry,
        waiting and pending queues) and return the trackers with generated
        tokens and chunk checkpoints intact. No Results are written: the
        requests are terminal on this engine only (``Ledger.evicted``),
        for another engine to :meth:`adopt`."""
        out: List[_Tracked] = []
        for i, tr in enumerate(self._slots):
            if tr is not None:
                self._clear_slot(i)
                out.append(tr)
        out.extend(self._retry)
        self._retry.clear()
        out.extend(self._queue)
        self._queue.clear()
        out.extend(self._pending)
        self._pending.clear()
        self._evicted += len(out)
        return out

    def adopt(self, tr: _Tracked, *,
              arrival_t: Optional[float] = None) -> int:
        """Accept a request evicted from another engine: a fresh local
        rid, its original arrival time (deadlines and latency keep counting
        from it), generated tokens and chunk checkpoint carried over; the
        checkpoint's head vectors revalidate at join time. The checkpoint
        must already be on this engine's device (the router's replicas
        share one): a mismatch raises rather than copying it across."""
        if tr.chunk_state is not None:
            for x in leaves(tr.chunk_state):
                if x.device.type != self.device.type or (
                        self.device.index is not None
                        and x.device.index != self.device.index):
                    raise ValueError(
                        f"request {tr.rid}'s chunk checkpoint is on "
                        f"{x.device}, this engine on {self.device}: "
                        f"adopt() moves no tensors across devices")
        rid = self._next_rid
        self._next_rid += 1
        self._submitted += 1
        t = tr.arrival_t if arrival_t is None else float(arrival_t)
        adopted = _Tracked(
            rid=rid, request=tr.request, klass=tr.klass, arrival_t=t,
            generated=list(tr.generated), retries=tr.retries,
            prefill_done=tr.prefill_done, chunk_state=tr.chunk_state,
            chunk_heads=tr.chunk_heads, chunk_eff=tr.chunk_eff)
        if self.draining:
            self._terminal(adopted, shed=True)
            return rid
        self._pending.append(adopted)
        return rid

    def ledger(self) -> Ledger:
        return Ledger(
            submitted=self._submitted, finished=self._finished,
            shed=self._shed, failed=self._failed,
            in_flight=sum(tr is not None for tr in self._slots)
            + len(self._retry),
            queued=len(self._queue) + len(self._pending),
            evicted=self._evicted)

    # ------------------------------------------------------------------
    # terminal states
    # ------------------------------------------------------------------
    def _terminal(self, tr: _Tracked, *, shed: bool = False,
                  failed: bool = False, cancelled: bool = False) -> Result:
        now = self.clock()
        lat = now - tr.arrival_t
        d = tr.request.deadline_s
        res = Result(
            tokens=np.asarray(tr.generated, dtype=np.int32),
            steps=len(tr.generated), shed=shed,
            deadline_missed=(d is not None and lat > d
                             and (shed or not failed) and not cancelled
                             and bool(tr.generated or not shed)),
            latency_s=lat, retries=tr.retries, failed=failed,
            recovered=(tr.retries > 0 and not shed and not failed),
            cancelled=cancelled)
        self._results[tr.rid] = res
        if failed:
            self._failed += 1
        elif shed:
            self._shed += 1
        else:
            self._finished += 1
        return res

    def _finish(self, tr: _Tracked) -> None:
        res = self._terminal(tr)
        if self.admission is not None:
            self.admission.observe(self.clock() - tr.join_t)
        if self.planner is not None:
            name = (self._plan_active.traffic.name
                    if self._plan_active is not None else tr.klass)
            self.planner.record(name or "default", res.latency_s)

    # ------------------------------------------------------------------
    # queue movement
    # ------------------------------------------------------------------
    def _deliver(self) -> None:
        """Move pending arrivals whose time has come into the queue."""
        now = self.clock()
        ready = [tr for tr in self._pending if tr.arrival_t <= now]
        if ready:
            self._pending = deque(
                tr for tr in self._pending if tr.arrival_t > now)
            ready.sort(key=lambda tr: (tr.arrival_t, tr.rid))
            self._queue.extend(ready)

    def _free_slot(self) -> Optional[int]:
        for i, tr in enumerate(self._slots):
            if tr is None:
                return i
        return None

    def _join_waiting(self) -> int:
        """Fill free slots from the retry queue (pre-admitted), then the
        waiting queue (through admission). Returns the prefill token count
        for this step's cost accounting."""
        tokens = 0
        while True:
            i = self._free_slot()
            if i is None:
                break
            if self._retry:
                tr = self._retry.popleft()
            elif self._queue:
                tr = self._queue.popleft()
                if self.admission is not None and not self.admission.admit(
                        tr.request, now=self.clock(),
                        arrival=tr.arrival_t,
                        backlog_batches=len(self._queue) // self.slots):
                    self._terminal(tr, shed=True)
                    continue
            else:
                break
            tokens += self._join(i, tr)
        return tokens

    def _history(self, tr: _Tracked) -> np.ndarray:
        """The request's prompt followed by the tokens generated so far."""
        return np.concatenate(
            [np.asarray(tr.request.prompt, dtype=np.int64),
             np.asarray(tr.generated, dtype=np.int64)])

    def _join(self, i: int, tr: _Tracked) -> int:
        """Prefill ``tr``'s prompt (plus any tokens generated before a
        requeue) into slot ``i``. Returns the prefill token count."""
        prompt = self._history(tr)
        remaining = tr.request.max_new_tokens - len(tr.generated)
        if remaining <= 0:          # requeued after its last token
            tr.join_t = self.clock()
            self._finish(tr)
            return 0
        if len(prompt) + remaining > self.max_len:
            self._terminal(tr, failed=True)
            return 0
        tr.join_t = self.clock()
        if self.prefill_chunk is not None:
            return self._join_chunked(i, tr)
        plen = len(prompt)
        # pow2 bucket: right-pad, so that the prefill shape is one of
        # log2(max_len). Exact for global causal attention: rows < plen
        # never attend the pad rows, _write_slot commits only the first
        # plen KV rows, and the logits are read at plen - 1.
        prompt_in = np.zeros(self._prefill_len(plen), np.int64)
        prompt_in[:plen] = prompt
        logits, states = self._prefill(self.params_active,
                                       self._tokens(prompt_in[None]))
        self._write_slot(i, states, plen)
        first = int(torch.argmax(logits[0, plen - 1, :self.cfg.vocab_size]))
        tr.generated.append(first)
        self._slots[i] = tr
        self.pos[i] = plen
        self._last_tok[i] = first
        self.join_count += 1
        if self._done(tr):
            self._release(i)
        return plen

    def _join_chunked(self, i: int, tr: _Tracked) -> int:
        """Seat ``tr`` in slot ``i`` as a *prefilling* request: no model
        call happens at join time; :meth:`_advance_prefills` runs its
        prompt ``prefill_chunk`` tokens per step from the step token
        budget. A checkpoint built under the engine's current head vectors
        resumes from its committed tokens; anything else restarts from
        token zero."""
        plen = len(tr.request.prompt) + len(tr.generated)
        resumable = (
            tr.chunk_state is not None
            and tr.chunk_heads is not None and tr.chunk_eff is not None
            and tr.chunk_heads.shape == self._shape_heads.shape
            and (tr.chunk_heads == self._shape_heads).all()
            and (tr.chunk_eff == self._heads_active).all()
            and 0 < tr.prefill_done <= plen)
        if not resumable:
            tr.chunk_state = self._fresh_states(self._shape_heads, batch=1)
            tr.chunk_heads = self._shape_heads.copy()
            tr.chunk_eff = self._heads_active.copy()
            tr.prefill_done = 0
        self._slots[i] = tr
        self.pos[i] = 0
        self._last_tok[i] = 0
        self.join_count += 1
        return 0

    def _advance_prefills(self, budget: Optional[int]) -> int:
        """Run at most one prefill chunk per prefilling slot (round-robin,
        repeated until the budget is spent or no slot can advance).
        Returns the padded chunk tokens executed, for the step's cost. The
        first chunk of a pass always runs even over budget: a chunk larger
        than the budget must still make progress."""
        spent = 0
        progressed = True
        while progressed:
            progressed = False
            for i, tr in enumerate(self._slots):
                if tr is None or tr.chunk_state is None:
                    continue
                target = len(tr.request.prompt) + len(tr.generated)
                clen = min(self.prefill_chunk, target - tr.prefill_done)
                if clen <= 0:       # fully committed last pass
                    continue
                padded = min(self._prefill_len(clen), self.prefill_chunk)
                if budget is not None and spent > 0 \
                        and spent + padded > budget:
                    return spent
                buf = np.zeros(padded, np.int64)
                buf[:clen] = self._history(tr)[
                    tr.prefill_done:tr.prefill_done + clen]
                try:
                    if self.chunk_fault_hook is not None:
                        self.chunk_fault_hook()
                    logits, tr.chunk_state = self._chunk(
                        self.params_active, self._tokens(buf[None]),
                        tr.prefill_done, tr.chunk_state)
                except Exception as e:  # noqa: BLE001 — checkpoint restart
                    self._chunk_fault(i, tr, e)
                    continue
                tr.prefill_done += clen
                spent += padded
                self.chunk_steps += 1
                progressed = True
                if tr.prefill_done >= target:
                    self._commit_prefill(i, tr, logits, target, clen)
        return spent

    def _commit_prefill(self, i: int, tr: _Tracked, logits, plen: int,
                        clen: int) -> None:
        """Final chunk committed: write the checkpoint into the shared slot
        state, take the first token from the last real row's logits, and
        switch the slot to decoding."""
        self._write_slot(i, tr.chunk_state, plen)
        tr.chunk_state = None
        tr.chunk_heads = None
        tr.chunk_eff = None
        tr.prefill_done = 0
        first = int(torch.argmax(logits[0, clen - 1, :self.cfg.vocab_size]))
        tr.generated.append(first)
        self.pos[i] = plen
        self._last_tok[i] = first
        if self._done(tr):
            self._release(i)

    def _chunk_fault(self, i: int, tr: _Tracked, e: Exception) -> None:
        """A chunk faulted: free the slot and requeue the request keeping
        its checkpoint, so recovery resumes from the last committed chunk.
        Past ``max_retries`` the request fails (checkpoint dropped)."""
        self._clear_slot(i)
        tr.retries += 1
        self.chunk_log.append(ChunkEvent(
            step=self.steps, rid=tr.rid, committed=tr.prefill_done,
            error=f"{type(e).__name__}: {e}"))
        if tr.retries > self.max_retries:
            tr.chunk_state = None
            tr.chunk_heads = None
            tr.chunk_eff = None
            self._terminal(tr, failed=True)
        else:
            self._retry.append(tr)

    def _done(self, tr: _Tracked) -> bool:
        if len(tr.generated) >= tr.request.max_new_tokens:
            return True
        return tr.request.eos_id >= 0 \
            and tr.generated[-1] == tr.request.eos_id

    def _release(self, i: int) -> None:
        tr = self._slots[i]
        self._clear_slot(i)
        if tr is not None:
            self._finish(tr)

    # ------------------------------------------------------------------
    # slot state writes
    # ------------------------------------------------------------------
    def _write_slot(self, i: int, prefill_states: dict, plen: int) -> None:
        """Write a one-request prefill's layer states into slot ``i`` of the
        shared decode state, in place (with a step cache, the decode
        entry's static states, which the next replay reads as they are).
        K/V caches land in rows ``0..plen`` of the slot's sequence axis —
        only the first ``plen`` source rows, since a bucketed prefill
        carries junk in its pad rows and a local ring may hold fewer;
        recurrent states replace the slot's row."""
        for group in ("stack", "extra"):
            stacked = group == "stack"
            for key, lst in prefill_states.get(group, {}).items():
                gst = self.states[group][key]
                for name, lv in lst.items():
                    gv = gst[name]
                    src = lv[:, 0] if stacked else lv[0]
                    dst = gv[:, i] if stacked else gv[i]
                    if name in ("k", "v"):
                        s = min(plen, src.shape[-3])
                        src, dst = src[..., :s, :, :], dst[..., :s, :, :]
                    dst.copy_(src)

    def _fresh_states(self, heads, batch: Optional[int] = None) -> dict:
        """A fresh (zero) decode state shaped for realized ``heads``:
        canonical shapes re-sliced through the swapper with no fault hook
        in the path (recovery must not be injectable). ``batch`` overrides
        the slot count (chunk checkpoints are batch-1 states)."""
        b = self.slots if batch is None else int(batch)
        st = tfm.init_decode_state(self.cfg, b, self.max_len, self.device)
        if self.swapper is None or (np.asarray(heads)
                                    == self._full_heads).all():
            return st
        return self.swapper.reshape_fresh(st, self._full_heads, heads)

    # ------------------------------------------------------------------
    # boundary transactions
    # ------------------------------------------------------------------
    def _live_tokens(self) -> int:
        live = int(sum(self.pos[i] + (tr.prefill_done
                                      if tr.chunk_state is not None else 0)
                       for i, tr in enumerate(self._slots)
                       if tr is not None))
        return max(live, 1)

    def _requeue_in_flight(self) -> int:
        """Evict every occupied slot back to the retry queue, generated
        tokens intact. Requests out of retries become terminal failures —
        accounted, never silently dropped."""
        n = 0
        for i, tr in enumerate(self._slots):
            if tr is None:
                continue
            self._clear_slot(i)
            tr.retries += 1
            if tr.retries > self.max_retries:
                self._terminal(tr, failed=True)
            else:
                self._retry.append(tr)
            n += 1
        return n

    def _abort_boundary(self, outcome: str, plan, error: str) -> None:
        """Transaction rollback: restore the canonical tree + a fresh
        canonical-shape state, requeue live work."""
        requeued = self._requeue_in_flight()
        self.params_active = self._canonical
        self._heads_active = self._full_heads.copy()
        self._shape_heads = self._full_heads.copy()
        self._masked_active = False
        self._plan_active = None
        self._key_active = None
        if self.compile_cache is not None:
            self.compile_cache.set_active(None)
        self.states = self._fresh_states(self._full_heads)
        self._last_boundary_fail = self.steps
        self.boundary_log.append(BoundaryEvent(
            step=self.steps, plan_name=plan.traffic.name,
            outcome=outcome, requeued=requeued, error=error))

    def _maybe_cross_boundary(self) -> None:
        if self.swapper is None:
            return
        if self.degrader is not None:
            plan = self.degrader.select(self._live_tokens())
        elif self.planner is not None:
            plan = self.planner.select(self._live_tokens())
        else:
            return
        if self.steps - self._last_boundary_fail < self.boundary_cooldown:
            return                      # cooling down after a failure
        mlp_t, heads_to = self.swapper.realize_plan(plan)
        masked = (self.compile_cache is not None
                  and bool(getattr(plan, "widths", None))
                  and self.compile_cache.decide(plan) == "masked")
        key = (tuple(mlp_t.tolist()), tuple(heads_to.tolist()))
        if (key == self._key_active
                and masked == self._masked_active) or (
                self._key_active is None
                and (mlp_t == self.cfg.d_ff).all()
                and (heads_to == self.cfg.n_heads).all()):
            return                      # same realized widths: no boundary
        params_new, event = self.swapper.apply_guarded(plan, masked=masked)
        self.swap_log.append(event)
        if event.outcome != "ok":
            self._abort_boundary("swap_rolled_back", plan, event.error)
            return
        g = self.cfg.n_heads // max(self.cfg.n_kv_heads, 1)
        kv_from = np.maximum(self._heads_active // g, 1)
        kv_to = np.maximum(heads_to // g, 1)
        live = any(tr is not None for tr in self._slots)
        shape_to = self._full_heads.copy() if masked else heads_to
        if live and (kv_to > kv_from).any():
            # Growing KV heads cannot restore sliced-away history: requeue
            # the live requests, so that their tokens re-prefill at the new
            # width, and adopt the plan on a fresh state (a masked grow
            # too: the re-grown heads' rows were written while masked).
            requeued = self._requeue_in_flight()
            self.states = self._fresh_states(shape_to)
            outcome = "requeued_grow"
        elif masked and (shape_to == self._shape_heads).all():
            # Masked realization on already-canonical shapes: the dropped
            # heads are zero-weighted on both the q and output projections,
            # so stale KV rows in them are unreadable; no state op needed.
            requeued = 0
            outcome = "ok"
        else:
            try:
                self.states = self.swapper.reshape_states(
                    self.states, self._shape_heads, shape_to)
                # Live chunk checkpoints cross in the same transaction: a
                # fault here aborts the whole crossing, and the requeued
                # checkpoints revalidate against the recovered widths.
                for ctr in self._slots:
                    if ctr is not None and ctr.chunk_state is not None:
                        ctr.chunk_state = self.swapper.reshape_states(
                            ctr.chunk_state, self._shape_heads, shape_to)
                        ctr.chunk_heads = np.asarray(shape_to).copy()
                        ctr.chunk_eff = heads_to.copy()
                requeued = 0
                outcome = "ok"
            except Exception as e:  # noqa: BLE001 — the guard IS the point
                self._abort_boundary("reshape_failed", plan,
                                     f"{type(e).__name__}: {e}")
                return
        self.params_active = params_new
        self._heads_active = heads_to
        self._shape_heads = shape_to
        self._masked_active = masked
        self._plan_active = plan
        self._key_active = key
        if self.compile_cache is not None:
            self.compile_cache.set_active(
                None if masked else realized_exec_key(mlp_t, heads_to))
        self.plan_log.append(plan)
        self.boundary_log.append(BoundaryEvent(
            step=self.steps, plan_name=plan.traffic.name,
            outcome=outcome, requeued=requeued))

    # ------------------------------------------------------------------
    # the engine step
    # ------------------------------------------------------------------
    def _watchdog(self) -> None:
        """Shed any decoding request past its deadline — enforcement
        during decode, not only at admission."""
        now = self.clock()
        for i, tr in enumerate(self._slots):
            if tr is None or tr.request.deadline_s is None:
                continue
            if now - tr.arrival_t > tr.request.deadline_s:
                self._clear_slot(i)
                self._terminal(tr, shed=True)

    @torch.inference_mode()
    def step(self) -> bool:
        """One engine step: deliver arrivals, consider a plan boundary,
        join free slots, advance chunked prefills, decode one token for
        every decoding slot, account time, enforce watchdogs. Returns True
        while work remains."""
        self.steps += 1
        self._deliver()
        if self.steps % self.boundary_every == 0:
            self._maybe_cross_boundary()
        prefill_tokens = self._join_waiting()
        chunk_tokens = 0
        if self.prefill_chunk is not None:
            # Chunk budget: what the step token budget leaves after one
            # decode token per decoding slot; budget-less engines run
            # every prefilling slot one chunk per step.
            n_decoding = sum(tr is not None and tr.chunk_state is None
                             for tr in self._slots)
            cbudget = None if self.step_token_budget is None \
                else max(self.step_token_budget - n_decoding, 0)
            chunk_tokens = self._advance_prefills(cbudget)
        active = [i for i, tr in enumerate(self._slots)
                  if tr is not None and tr.chunk_state is None]
        if not active and prefill_tokens == 0 and chunk_tokens == 0:
            if not (self._queue or self._retry) and self._pending:
                # idle until the next arrival: fast-forward a virtual
                # clock; a wall clock delivers at once (open-loop arrival
                # times in the past).
                nxt = min(tr.arrival_t for tr in self._pending)
                advance = getattr(self.clock, "advance", None)
                if advance is not None and nxt > self.clock():
                    advance(nxt - self.clock())
                else:
                    self._queue.extend(
                        sorted(self._pending,
                               key=lambda tr: (tr.arrival_t, tr.rid)))
                    self._pending.clear()
            return self._outstanding()

        decoded = 0
        if active:
            logits, self.states = self._decode(
                self.params_active, self._tokens(self._last_tok),
                self._tokens(self.pos), self.states)
            cur = self._sample(logits[:, :self.cfg.vocab_size], active)
            host = cur.cpu().numpy()
            for i in active:
                tr = self._slots[i]
                tr.generated.append(int(host[i]))
                self.pos[i] += 1
                self._last_tok[i] = int(host[i])
                decoded += 1
                if self._done(tr):
                    self._release(i)
            self._decode_steps += 1

        # time accounting: modeled (virtual clock) or measured
        step_tokens = decoded + prefill_tokens + chunk_tokens
        if self.batch_cost_fn is not None and step_tokens:
            dt = self.batch_cost_fn(self._plan_active, step_tokens)
            advance = getattr(self.clock, "advance", None)
            if advance is not None:
                advance(dt)
        self._watchdog()
        if self.admission is not None and self.degrader is not None:
            qb = (len(self._queue) + len(self._retry)
                  + self.slots - 1) // self.slots
            self.degrader.observe(self.admission.signal(qb))
        return self._outstanding()

    def _sample(self, logits: torch.Tensor, active) -> torch.Tensor:
        """Greedy rows take the argmax; rows with a temperature draw from
        the softmax with the engine's generator, as ``ServeEngine``
        samples."""
        greedy = torch.argmax(logits, dim=-1)
        temps = [self._slots[i].request.temperature for i in active]
        if not any(t > 0 for t in temps):
            return greedy
        temp = np.ones(self.slots, np.float32)
        use = np.zeros(self.slots, bool)
        for i in active:
            t = self._slots[i].request.temperature
            if t > 0:
                temp[i] = max(t, 1e-6)
                use[i] = True
        t_dev = torch.from_numpy(temp).to(self.device)[:, None]
        probs = torch.softmax(logits.float() / t_dev, dim=-1)
        drawn = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        return torch.where(torch.from_numpy(use).to(self.device), drawn,
                           greedy)

    def _outstanding(self) -> bool:
        return (bool(self._pending) or bool(self._queue)
                or bool(self._retry)
                or any(tr is not None for tr in self._slots))

    # ------------------------------------------------------------------
    # front doors
    # ------------------------------------------------------------------
    def run(self, arrivals: Sequence, *, max_steps: int = 1_000_000
            ) -> List[Result]:
        """Serve an open-loop workload (``Arrival``s, or bare ``Request``s
        that arrive now) to completion; results align with the input
        order."""
        rids = []
        for a in arrivals:
            if isinstance(a, Arrival):
                rids.append(self.submit(a.request, arrival_t=a.t,
                                        klass=a.klass))
            else:
                rids.append(self.submit(a))
        steps = 0
        while self._outstanding():
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"run exceeded {max_steps} steps")
            self.step()
        return [self._results[r] for r in rids]

    def drain(self, *, max_steps: int = 100_000) -> Ledger:
        """Stop admitting, shed the waiting queue, finish (or shed, once
        ``max_steps`` is spent) the in-flight work, and return a complete
        ledger."""
        self.draining = True
        self._deliver()
        for tr in list(self._pending) + list(self._queue):
            self._terminal(tr, shed=True)
        self._pending.clear()
        self._queue.clear()
        if not self._retry and all(tr is None for tr in self._slots):
            # nothing in flight (the zero-submission case included): the
            # ledger, without stepping the engine
            led = self.ledger()
            assert led.complete, f"drain ledger does not sum: {led}"
            return led
        steps = 0
        while self._retry or any(tr is not None for tr in self._slots):
            steps += 1
            if steps > max_steps:
                for i, tr in enumerate(self._slots):
                    if tr is not None:
                        self._clear_slot(i)
                        self._terminal(tr, shed=True)
                while self._retry:
                    self._terminal(self._retry.popleft(), shed=True)
                break
            self.step()
        led = self.ledger()
        assert led.complete, f"drain ledger does not sum: {led}"
        return led
