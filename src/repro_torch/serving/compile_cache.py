"""Width-variant step cache: CUDA graphs of whole prefill and decode steps
per plan (``repro.serving.compile_cache``'s counterpart).

``repro`` AOT-compiles its prefill and decode functions per realized plan
so that a warm batch boundary is a table lookup, never a trace. On the
card the host, not the device, sets a step's wall time: an eager decode
step issues a couple of thousand torch ops and kernel launches, and the
device idles for most of it. The counterpart of an AOT executable is
therefore a CUDA graph of the whole step, captured at plan time
(``ServeEngine.warm_compile``) and replayed at serve time:

  * :class:`WidthVariantCompileCache` keys each entry on ``(hardware
    fingerprint, kind, realized plan key, shape)``, as ``repro`` does.
    :meth:`~WidthVariantCompileCache.precompile` warms the step up on a
    side stream (it loads the kernels and sizes the GEMMs' decode
    scratch), then captures it under ``torch.inference_mode()``; "lower"
    fires before the warm-up and "compile" before the capture.
  * Serve-time :meth:`~WidthVariantCompileCache.prefill` and
    :meth:`~WidthVariantCompileCache.decode` copy their inputs into the
    entry's static buffers and replay it on the current stream, the one
    the engine launches on. A miss, or a fault at any step, runs the same
    step eagerly on the same device and kernels (``repro``'s traced
    fallback), so a cold or broken cache costs time, never a request.
  * :meth:`~WidthVariantCompileCache.decide` is ``repro``'s cost
    crossover, with ``compile_cost_s`` now pricing one capture.
  * :class:`TraceCounter` counts captures; a warm step leaves it unchanged.

Design choices the card forces:

  * **Params are static buffers.** A graph keeps the addresses it was
    captured with, where ``repro`` passes params as arguments. So each
    realized key owns a static param tree, a clone of the first tree
    captured at that key, and all its graphs read it. A lookup copies the
    tree it is given into that static tree before the replay, leaf by
    leaf, skipping each leaf that is the very tensor copied in last (it
    holds a reference to each, so an identity test is sound; trees are
    never written in place, as ``WidthSwapper`` builds them). So a replay
    always runs on the weights passed: a tree that ``WidthSwapper``
    evicted and rebuilt replays its key's graphs, and a masked
    realization (``apply(plan, masked=True)``, full-width shapes) replays
    the full-width graphs with its masked leaves copied in, with no
    capture of its own, as ``repro`` runs it on the full-width
    executable. A boundary's copy moves the leaves the swap changed; the
    static trees cost one copy of each key's weights on the device.
  * **``pos`` is a tensor.** A graph bakes in a Python int, so the cached
    decode takes ``pos`` into a static (B,) int64 buffer, filled on the
    device before each replay (``transformer.decode_step`` accepts a (B,)
    ``pos``; at equal positions it gives the int form's bits).
  * **States are static.** The decode graph updates its static decode
    state in place (KV rows by ``index_put``, recurrent states by
    ``copy_``) and returns it. A batch's prefill states are copied in at
    its first decode step; after that the engine hands back the static
    tree, and no copy or allocation happens in the steady decode loop.
    :func:`decode_state_struct` builds the zero state a graph captures.
  * **Launch counts.** The kernel wrappers count launches on the host
    (``kernels.build.LAUNCHES``), so a replay counts nothing by itself: a
    capture records each entry's launches and every replay adds them.
    The capture's own calls are not launches and are taken back out.
  * **Scratch.** The GEMMs' decode-form scratch (``kernels.matmul_tiled``
    ``workspace``) is shared by eager launches and every graph; it is
    safe in stream order, and replays run on the current stream.
  * **The CPU** has no graphs. There an entry is a static step: it runs
    the eager step on its key's static params and copies the results
    into its static outputs, so outputs alias and states update exactly
    as a graph's do. This path exists only for a caller that asked for
    ``device="cpu"``; on a CUDA device an entry is always a graph.

Each graph keeps a private memory pool: its static outputs (a prefill's
logits among them) stay allocated while the entry lives, and a key's
static params while any of its entries does.

The "chunk" kind serves ``transformer.prefill_chunk`` to the continuous
engine (``serving/continuous.py``): one graph per chunk shape, captured
with a static 0-d ``pos`` and a static batch-1 ``max_len`` state tree, so
one entry serves every chunk position of every request that is
prefilling. Each request keeps its own checkpoint: :meth:`chunk` copies
the request's states in, replays, and copies the updated states back out
into the request's tensors (two batch-1 cache copies per chunk), so the
next request's chunk cannot overwrite them.

**One continuous engine a cache.** A decode entry's static states are
the slot state of the continuous engine that replays it: the engine keeps
them as its own ``states`` and writes each join into them in place. A
second engine replaying the same entry would copy its own KV caches over
the first one's, and both would then decode on one tree. So every engine
claims its cache at construction (:meth:`~WidthVariantCompileCache.claim`),
and a cache held by a live ``ContinuousServeEngine`` refuses any other
engine, continuous or static (it holds engines by weak references). Static
engines may share a cache with each other and with a planner: a static
batch keeps no state across ``generate`` calls. ``repro``'s fleet may
share one executable table, since its arrays are immutable; the port's
gives each replica its own cache (``serving/router.py``).

Every step, captured or eager, runs inside ``ops.kernel_context(hw=hw,
cache=tile_cache)``, as ``repro`` traces it: on a GPU spec its GEMMs take
the tile autotuner's tiles (``kernels.autotune``, persisted through
``tile_cache``, a ``ProfileTableCache``). The choice is made on the host
at capture, so a graph keeps its tiles; ``hw=None`` keeps the kernels'
default tiles.
"""

from __future__ import annotations

import dataclasses
import gc
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan_address import plan_key
from repro_torch.core.table_cache import hardware_fingerprint
from repro_torch.kernels import build, ops
from repro_torch.models import transformer as tfm

# Fault-hook checkpoints, mirroring width_swap.SWAP_STEPS: "lower" and
# "compile" fire during plan-time capture (before the warm-up and before
# the capture), "lookup" on every serve-time fetch. A hook raising at any
# of them must leave the engine on the eager fallback with no lost request.
COMPILE_STEPS = ("lower", "compile", "lookup")

def pow2_bucket(n: int, lo: int = 8) -> int:
    """Smallest power of two >= n (and >= lo) — the prefill length
    bucket.  Bucketing bounds the number of distinct prefill shapes (and
    therefore captures) at log2(max_len) instead of one per distinct
    prompt length."""
    n = max(int(n), 1)
    b = max(int(lo), 1)
    while b < n:
        b *= 2
    return b


class TraceCounter:
    """Counts captures by counting executions of the captured callable.

    The cache wraps the step only for its capture (on the CPU, the run
    that makes a static step's outputs), so a replay, a warm-up or an
    eager fallback leaves ``count`` unchanged."""

    def __init__(self) -> None:
        self.count = 0

    def wrap(self, fn: Callable) -> Callable:
        def counted(*args, **kwargs):
            self.count += 1
            return fn(*args, **kwargs)
        return counted


@dataclasses.dataclass(frozen=True)
class CompileEvent:
    """One cache interaction, appended to ``events``."""

    kind: str           # "prefill" | "decode" | "chunk"
    key: tuple          # entry key (fingerprint/kind/plan/shape)
    outcome: str        # "compiled" | "hit" | "miss" | "fault"
    wall_s: float = 0.0
    error: str = ""


def realized_exec_key(mlp_w, heads) -> tuple:
    """Entry key for a realized width assignment: the per-layer (mlp
    widths, head counts) the param/KV *shapes* follow.  Masked
    realizations keep canonical shapes and therefore use the cache's
    ``full_key`` instead."""
    return (tuple(int(x) for x in np.asarray(mlp_w).ravel()),
            tuple(int(x) for x in np.asarray(heads).ravel()))


def leaves(tree) -> list:
    """A param tree's tensors in a fixed (sorted-key) order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _copy_into(dst, src) -> None:
    """Copy ``src`` into the static tree ``dst``, leaf for leaf; a leaf
    that already is the static tensor is left alone. Raises where the
    structures, shapes or dtypes differ (``copy_`` would broadcast or
    cast)."""
    if dst is src:
        return
    if isinstance(dst, dict):
        if not isinstance(src, dict) or dst.keys() != src.keys():
            raise ValueError("the tree's structure differs from the "
                             "entry's static one")
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, tuple):
        if not isinstance(src, tuple) or len(dst) != len(src):
            raise ValueError("the outputs differ from the entry's")
        for d, s in zip(dst, src):
            _copy_into(d, s)
    else:
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(f"{src.dtype} {tuple(src.shape)} does not fit "
                             f"the static {dst.dtype} {tuple(dst.shape)}")
        dst.copy_(src)


def _version(x: torch.Tensor):
    """The tensor's in-place version counter, or None for an inference
    tensor, which keeps none."""
    try:
        return x._version
    except RuntimeError:
        return None


class _StaticParams:
    """A realized key's static param tree, which its graphs read, and the
    leaves last copied into it with their version counters (the leaves are
    held, so that ``is`` tells a leaf apart from one that merely reuses a
    freed tensor's id, and a leaf changed in place since shows by its
    version)."""

    def __init__(self, params: dict):
        self.tree = _clone(params)
        self.static = leaves(self.tree)
        self.loaded = leaves(params)
        self.versions = [_version(x) for x in self.loaded]

    def load(self, params: dict) -> None:
        """Copy ``params`` in, leaf by leaf, skipping the leaves copied in
        last unless they changed in place since (an inference tensor keeps
        no version, so it is copied every time). Raises, copying nothing,
        where the trees do not fit."""
        src = leaves(params)
        if len(src) != len(self.static):
            raise ValueError("the tree's structure differs from the key's "
                             "static params")
        versions = [_version(x) for x in src]
        todo = [i for i, x in enumerate(src)
                if x is not self.loaded[i] or versions[i] is None
                or versions[i] != self.versions[i]]
        for i in todo:
            d, x = self.static[i], src[i]
            if d.shape != x.shape or d.dtype != x.dtype:
                raise ValueError(f"{x.dtype} {tuple(x.shape)} does not fit "
                                 f"the static {d.dtype} {tuple(d.shape)}")
        for i in todo:
            self.static[i].copy_(src[i])
            self.loaded[i] = src[i]
            self.versions[i] = versions[i]


@dataclasses.dataclass
class _Entry:
    """One warm step: its key's static params, its static inputs and
    outputs, and its CUDA graph (None on the CPU, where ``fn`` runs)."""

    params: _StaticParams
    inputs: tuple           # (toks,) or (toks, pos, states)
    out: tuple              # (logits, states)
    graph: Any
    fn: Callable
    launches: Dict[str, int]

    def replay(self, params: dict) -> tuple:
        self.params.load(params)
        if self.graph is None:
            _copy_into(self.out, self.fn(self.params.tree, *self.inputs))
            return self.out
        self.graph.replay()
        for k, n in self.launches.items():
            build.LAUNCHES[k] += n
        return self.out


class WidthVariantCompileCache:
    """Captured-step table for one model config.

    One instance per engine (``cfg`` must match the engine's): the engine
    routes every prefill/decode through :meth:`prefill` / :meth:`decode`,
    and calls ``set_active`` with the realized key at each boundary so
    lookups address the right variant.
    """

    def __init__(self, cfg: ModelConfig, *, hw=None, tile_cache=None,
                 compile_cost_s: float = 0.25, horizon_batches: int = 32,
                 fault_hook: "Callable[[str], None] | None" = None,
                 max_entries: int = 64):
        self.cfg = cfg
        self.hw = hw
        self.tile_cache = tile_cache
        self.fingerprint = "" if hw is None else hardware_fingerprint(hw)
        self.compile_cost_s = float(compile_cost_s)
        self.horizon_batches = max(int(horizon_batches), 1)
        self.fault_hook = fault_hook
        self.max_entries = max(int(max_entries), 1)
        self._exec: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._params: Dict[tuple, _StaticParams] = {}
        self._warm_plans: set = set()
        self.events: List[CompileEvent] = []
        self.stats = {"aot_compiles": 0, "hits": 0, "misses": 0,
                      "fallbacks": 0}
        self.tracer = TraceCounter()
        # the continuous engine whose slot state the decode entries hold,
        # and the static engines serving on the cache (claim())
        self._holder: Optional[weakref.ref] = None
        self._static: "weakref.WeakSet" = weakref.WeakSet()

        n_refs = len(tfm.decoder_layer_refs(cfg))
        # Canonical full-width key — what masked realizations and the
        # engine's initial (unswapped) state resolve to.
        self.full_key = ((cfg.d_ff,) * n_refs, (cfg.n_heads,) * n_refs)
        self._active_key: tuple = self.full_key

        # The eager steps: what a capture records, and the fallback; both
        # run under the kernel context, so a GPU spec's autotuned tiles
        # are what a graph records.
        def prefill_fn(p, toks):
            with ops.kernel_context(hw=self.hw, cache=self.tile_cache):
                return tfm.forward(p, cfg, tokens=toks, mode="prefill")

        def decode_fn(p, t, pos, st):
            with ops.kernel_context(hw=self.hw, cache=self.tile_cache):
                return tfm.decode_step(p, cfg, t, pos, st)

        def chunk_fn(p, toks, pos, st):
            with ops.kernel_context(hw=self.hw, cache=self.tile_cache):
                return tfm.prefill_chunk(p, cfg, toks, pos, st)

        self._fns = {"prefill": prefill_fn, "decode": decode_fn,
                     "chunk": chunk_fn}

    # ------------------------------------------------------------------
    # keys
    # ------------------------------------------------------------------
    def set_active(self, key: "tuple | None") -> None:
        """Point serve-time lookups at a realized key (the boundary-time
        switch).  ``None`` resets to full width."""
        self._active_key = self.full_key if key is None else tuple(key)

    @property
    def active_key(self) -> tuple:
        return self._active_key

    # ------------------------------------------------------------------
    # who serves on the cache
    # ------------------------------------------------------------------
    def _holder_engine(self):
        return None if self._holder is None else self._holder()

    def claim(self, engine, *, continuous: bool) -> None:
        """Register ``engine`` as serving on this cache. A continuous
        engine holds its slot state in the decode entries' static states,
        so it must be the cache's only live engine; static engines may
        share. Raises ``ValueError`` where the claim would put a live
        continuous engine beside another engine. An engine that is gone
        no longer counts (weak references; a collection runs first, so an
        engine kept only by a reference cycle does not either)."""
        def conflict() -> Optional[str]:
            # holds no strong reference to another engine once it returns
            holder = self._holder_engine()
            if holder is not None and holder is not engine:
                return "continuous"
            if continuous and any(e is not engine for e in self._static):
                return "static"
            return None

        why = conflict()
        if why is not None:
            gc.collect()
            why = conflict()
        if why == "continuous":
            raise ValueError(
                "this step cache already serves a live ContinuousServeEngine, "
                "whose slot state its decode entries hold: a second engine "
                "would decode on that engine's KV caches. Give each engine a "
                "WidthVariantCompileCache of its own")
        if why == "static":
            raise ValueError(
                "this step cache already serves a live ServeEngine, whose "
                "decode steps would overwrite a continuous engine's slot "
                "state in the decode entries. Give the continuous engine a "
                "WidthVariantCompileCache of its own")
        if continuous:
            self._holder = weakref.ref(engine)
        else:
            self._static.add(engine)

    def _entry_key(self, kind: str, key: tuple, shape_key: tuple) -> tuple:
        return (self.fingerprint, kind, key, tuple(shape_key))

    def __len__(self) -> int:
        return len(self._exec)

    # ------------------------------------------------------------------
    # warm-plan registry (planner preference signal)
    # ------------------------------------------------------------------
    def mark_plan_warm(self, plan) -> None:
        self._warm_plans.add(plan_key(plan.widths))

    def plan_is_warm(self, plan) -> bool:
        return plan_key(plan.widths) in self._warm_plans

    # ------------------------------------------------------------------
    # cost crossover
    # ------------------------------------------------------------------
    def decide(self, plan) -> str:
        """``"sliced"`` | ``"masked"``: realize the plan with genuinely
        smaller shapes (own entries) or as zero-masked full-shape params.

        The crossover prices one capture against the plan's modeled
        saving over ``horizon_batches`` served batches: a capture that
        costs more wall time than the FLOPs it saves is realized as a
        mask instead, which replays the full-width graphs on the masked
        weights (copied into their static params) with no capture."""
        widths = getattr(plan, "widths", None)
        if not widths:
            return "sliced"     # full width: nothing to mask
        saved_per_batch = max(
            float(plan.baseline_latency_s) - float(plan.latency_s), 0.0)
        saved = saved_per_batch * self.horizon_batches
        return "sliced" if saved >= self.compile_cost_s else "masked"

    # ------------------------------------------------------------------
    # plan-time capture
    # ------------------------------------------------------------------
    def _check(self, step: str) -> None:
        if self.fault_hook is not None:
            self.fault_hook(step)

    def _kind(self, kind: str) -> None:
        if kind not in self._fns:
            raise ValueError(f"unknown kind {kind!r}")

    def _capture(self, fn: Callable, params: dict, inputs: tuple):
        """(graph, static outputs, launches per replay) of ``fn`` on
        ``params`` and the static ``inputs``; graph None on the CPU."""
        counted = self.tracer.wrap(fn)
        dev = inputs[0].device
        if dev.type != "cuda":
            self._check("compile")
            # the static step's first run makes its static outputs; its
            # wrappers count their own (plain, uncounted) calls
            return None, counted(params, *inputs), {}
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn(params, *inputs)         # warm-up: kernels, scratch
        cur.wait_stream(side)
        self._check("compile")
        graph = torch.cuda.CUDAGraph()
        before = dict(build.LAUNCHES)
        try:
            with torch.cuda.graph(graph):
                out = counted(params, *inputs)
        finally:
            launches = {k: build.LAUNCHES[k] - n for k, n in before.items()}
            build.LAUNCHES.update(before)   # a capture launches nothing
        return graph, out, {k: n for k, n in launches.items() if n}

    @torch.inference_mode()
    def precompile(self, kind: str, key: tuple, shape_key: tuple,
                   example_args: tuple) -> bool:
        """Capture one (kind, realized key, shape) step on ``example_args``
        — ``(params, toks)`` for a prefill, ``(params, toks, pos,
        states)`` for a decode step (``pos`` an int or a (B,) tensor) or a
        chunk (``pos`` an int or a 0-d tensor); the cache copies the inputs
        into static buffers of its own and ``params`` into the key's static
        params. Returns True when the entry is warm afterwards; a fault is
        recorded and absorbed (the serve path runs the step eagerly)."""
        self._kind(kind)
        ek = self._entry_key(kind, key, shape_key)
        if ek in self._exec:
            return True
        t0 = time.perf_counter()
        try:
            self._check("lower")
            store = self._params.get(key)
            if store is None:
                store = _StaticParams(example_args[0])
            else:
                store.load(example_args[0])
            if kind == "prefill":
                inputs = (example_args[1].clone(),)
            else:
                toks, pos, states = example_args[1:]
                p = torch.zeros(() if kind == "chunk" else toks.shape[0],
                                dtype=torch.long, device=toks.device)
                inputs = (toks.clone(), p.copy_(pos) if torch.is_tensor(pos)
                          else p.fill_(int(pos)), _clone(states))
            graph, out, launches = self._capture(self._fns[kind],
                                                 store.tree, inputs)
        except Exception as e:  # noqa: BLE001 — fault => eager fallback
            self.stats["fallbacks"] += 1
            self.events.append(CompileEvent(
                kind=kind, key=ek, outcome="fault",
                wall_s=time.perf_counter() - t0,
                error=f"{type(e).__name__}: {e}"))
            return False
        self._params[key] = store
        self._exec[ek] = _Entry(params=store, inputs=inputs, out=out,
                                graph=graph, fn=self._fns[kind],
                                launches=launches)
        while len(self._exec) > self.max_entries:
            self._exec.popitem(last=False)
        live = {k[2] for k in self._exec}
        for k in [k for k in self._params if k not in live]:
            del self._params[k]
        self.stats["aot_compiles"] += 1
        self.events.append(CompileEvent(
            kind=kind, key=ek, outcome="compiled",
            wall_s=time.perf_counter() - t0))
        return True

    # ------------------------------------------------------------------
    # serve-time entry points
    # ------------------------------------------------------------------
    def _get(self, kind: str, shape_key: tuple) -> Optional[_Entry]:
        ek = self._entry_key(kind, self._active_key, shape_key)
        try:
            self._check("lookup")
        except Exception as e:  # noqa: BLE001 — fault => eager fallback
            self.stats["fallbacks"] += 1
            self.events.append(CompileEvent(
                kind=kind, key=ek, outcome="fault",
                error=f"{type(e).__name__}: {e}"))
            return None
        entry = self._exec.get(ek)
        if entry is None:
            self.stats["misses"] += 1
            self.events.append(CompileEvent(kind=kind, key=ek,
                                            outcome="miss"))
            return None
        self._exec.move_to_end(ek)
        self.stats["hits"] += 1
        return entry

    @torch.inference_mode()
    def prefill(self, params, toks):
        """Replayed prefill on a hit, else the eager step.  Same signature
        and return value as ``transformer.forward(mode="prefill")``: the
        (logits, states) of a hit are the entry's static tensors, valid
        until its next replay."""
        shape_key = tuple(int(d) for d in toks.shape)
        entry = self._get("prefill", shape_key)
        if entry is not None:
            try:
                entry.inputs[0].copy_(toks)
                return entry.replay(params)
            except (RuntimeError, ValueError):  # => eager fallback
                self.stats["fallbacks"] += 1
        return self._fns["prefill"](params, toks)

    @torch.inference_mode()
    def decode(self, params, toks, pos, states):
        """Replayed decode step on a hit, else the eager step.  ``pos`` is
        an int or a (B,) tensor; ``states`` are copied into the entry's
        static states unless they are those already. Returns (logits,
        states) as ``transformer.decode_step`` does; on a hit both are
        the entry's static tensors."""
        shape_key = tuple(int(d) for d in toks.shape)
        entry = self._get("decode", shape_key)
        if entry is not None:
            try:
                t, p, st = entry.inputs
                t.copy_(toks)
                if torch.is_tensor(pos):
                    p.copy_(pos)
                else:
                    p.fill_(int(pos))
                _copy_into(st, states)
                return entry.replay(params)
            except (RuntimeError, ValueError):  # => eager fallback
                self.stats["fallbacks"] += 1
        return self._fns["decode"](params, toks, pos, states)

    @torch.inference_mode()
    def chunk(self, params, toks, pos, states):
        """Replayed prefill chunk (``transformer.prefill_chunk``) on a hit,
        else the eager step. ``pos`` is an int or a 0-d tensor, so one
        entry per chunk shape serves every position. Returns (logits,
        states): the logits are the entry's static tensor on a hit, and
        the states are always the caller's own tree, updated in place (a
        hit copies the entry's static states back out into it)."""
        shape_key = tuple(int(d) for d in toks.shape)
        entry = self._get("chunk", shape_key)
        if entry is not None:
            try:
                t, p, st = entry.inputs
                t.copy_(toks)
                if torch.is_tensor(pos):
                    p.copy_(pos)
                else:
                    p.fill_(int(pos))
                _copy_into(st, states)
                logits, out = entry.replay(params)
                _copy_into(states, out)
                return logits, states
            except (RuntimeError, ValueError):  # => eager fallback
                self.stats["fallbacks"] += 1
        return self._fns["chunk"](params, toks, pos, states)


def decode_state_struct(cfg: ModelConfig, b: int, max_len: int, *,
                        swapper=None, heads=None, device=None) -> dict:
    """The zero decode state of a batch of ``b`` rows, shaped as
    ``ServeEngine`` hands it to decode after a prefill: a global layer's
    KV cache of ``max_len`` rows, a local layer's ring of ``window`` rows
    (what ``transformer._ring`` leaves), recurrent states as they are. A
    decode graph captures it as its static states. With a swapper and
    realized ``heads``, the KV caches are re-sliced to the plan's KV
    heads, as ``repro`` does."""
    st = tfm.init_decode_state(cfg, b, max_len, device)
    for r in tfm.decoder_layer_refs(cfg):
        if r["kind"] != "local":
            continue
        cache = st[r["group"]][r["key"]]
        for name in ("k", "v"):
            pad = cfg.window - cache[name].shape[-3]
            if pad > 0:
                cache[name] = F.pad(cache[name], (0, 0, 0, 0, 0, pad))
    if swapper is not None and heads is not None:
        full = np.full(len(swapper.refs), cfg.n_heads, dtype=np.int64)
        if (np.asarray(heads) != full).any():
            st = swapper.reshape_fresh(st, full, np.asarray(heads))
    return st
