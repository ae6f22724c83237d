"""Live width-swap subsystem: materialize WidthPlans onto real params
(``repro.serving.width_swap``'s counterpart, on torch tensors).

``ServingWidthPlanner`` (engine.py) plans per-traffic-class width configs
with the paper's Algorithm 2; this module closes the model-to-hardware
gap by *applying* a plan to a real ``models.transformer`` param tree at a
batch boundary:

  * **MLP widths** slice the FFN hidden dim: ``w_up``/``w_gate`` columns
    and ``w_down`` rows cut to the planned width.
  * **Attention widths** slice query heads (KV heads follow at the GQA
    ratio) after :func:`core.plan_address.snap_heads` rounds the
    planned channel count to whole realizable heads.
  * **Stacked scan units** cannot be ragged: all layers sharing a unit
    slot are cut to the *maximum* planned width in the group and the
    channels between a layer's own width and the group cut are zeroed.
    Zeroed channels are exact — a zeroed FFN channel contributes 0
    through ``w_down``, a zeroed head contributes 0 through ``w_o`` — so
    a sliced forward equals the full forward with those channels zeroed
    (tested in tests/test_torch_width_swap.py).

Every cut tensor is made contiguous once, when its plan is materialized:
the MLP kernel takes contiguous weights, and a column slice is a strided
view. Masks are boolean tensors on the params' device, applied with
``torch.where``. Hand the swapper the tree the engine serves from (the
bf16 tree on the card), so a plan is cut once and a warm swap re-casts
nothing.

The canonical full-width params are retained by the swapper; every plan
is materialized *from* them, so swapping down and back up is lossless
(the full plan returns the original pytree object, bit for bit).
Materialized pytrees are cached per realized width assignment
(``plan_key``): a warm swap to an already-seen plan is a dict lookup —
zero new array allocations — which is what makes per-batch swapping at
serving rates affordable (``SwapEvent.cache_hit`` records this).

KV caches are laid out per plan by prefill; for engines that retain
decode state across a boundary, :meth:`WidthSwapper.reshape_states`
re-shapes the cached K/V head axis to the new plan — exact when
shrinking (kept heads keep their history), zero-filled when growing
(new heads have no history; the paper swaps at batch boundaries
precisely so this case starts from a fresh prefill).
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.candidates import analytic_candidates, \
    realizable_candidates
from repro_torch.core.plan_address import ModuleRef, plan_key, snap_heads
from repro_torch.core.tail_model import LayerShape
from repro_torch.core.tail_optimizer import TunableLayer
from repro_torch.models import transformer as tfm


# ---------------------------------------------------------------------------
# templates: a transformer config as TunableLayers + module addresses
# ---------------------------------------------------------------------------
def serving_templates(cfg: ModelConfig, hw, *, tokens: int = 4096,
                      sites: Sequence[str] = ("mlp",),
                      shard_out: int = 1):
    """TunableLayer templates plus the name -> ModuleRef mapping for a
    transformer config — the two halves a live swap needs: the planner
    optimizes the templates, the swapper addresses the pytree.

    One template per decoder layer per requested site: ``"mlp"`` for
    dense-FFN layers (width = ``d_ff``), ``"attn"`` for self-attention
    layers (width = ``n_heads * head_dim`` channels).  MoE/recurrent
    layers have no width-swap site and are skipped.  Candidates come
    from the analytic staircase *on the realizable grid per site* —
    lane multiples for FFN widths, whole GQA head groups
    (``g * head_dim`` multiples) for attention — so every planned width
    is materializable by :class:`WidthSwapper` as-is, with no swap-time
    re-snap changing the width the plan was ranked by.  All candidates
    are capped at the canonical width — a live swap can only *slice*
    the trained weights, never invent wider ones.
    """
    for s in sites:
        if s not in ("mlp", "attn"):
            raise ValueError(f"unknown site {s!r}")
    d = cfg.d_model
    g = cfg.n_heads // max(cfg.n_kv_heads, 1)
    templates: list[TunableLayer] = []
    modules: dict[str, ModuleRef] = {}
    for i, (kind, mlpk) in enumerate(tfm.layer_plan(cfg, encoder=False)):
        if "mlp" in sites and mlpk == "dense":
            name = f"mlp{i}"
            shape = LayerShape(name, tokens=tokens, d_in=d, width=cfg.d_ff,
                               shard_out=shard_out)
            cands = analytic_candidates(hw, shape, max_width=cfg.d_ff)
            cands = cands[cands <= cfg.d_ff]
            if cands.size == 0:
                cands = np.array([cfg.d_ff], dtype=np.int64)
            templates.append(TunableLayer(
                layer=shape, candidates=cands,
                params_per_unit=(3 if cfg.mlp_gated else 2) * d,
                max_width=cfg.d_ff))
            modules[name] = ModuleRef(i, "mlp")
        if "attn" in sites and kind in ("attn", "local"):
            name = f"attn{i}"
            full_w = cfg.n_heads * cfg.head_dim
            shape = LayerShape(name, tokens=tokens, d_in=d, width=full_w,
                               shard_out=shard_out,
                               flop_multiplier=2.0 + 2.0 / g)
            # realizable grid: whole heads in GQA group-size multiples,
            # so a ladder/planner width never needs a swap-time re-snap
            cands = realizable_candidates(
                hw, shape, realize_quantum=g * cfg.head_dim,
                max_width=full_w, min_width=g * cfg.head_dim)
            if full_w not in cands:
                cands = np.append(cands, full_w)
            templates.append(TunableLayer(
                layer=shape, candidates=cands,
                # q + o rows per channel, k + v at the GQA ratio
                params_per_unit=2 * d + 2 * d / g,
                min_width=g * cfg.head_dim, max_width=full_w))
            modules[name] = ModuleRef(i, "attn")
    return templates, modules


# ---------------------------------------------------------------------------
# slicing primitives
# ---------------------------------------------------------------------------
def _mask(widths, wmax: int, stacked: bool, device):
    """Boolean keep-mask over the cut axis, on ``device``; None when
    nothing is masked (every layer in the group uses the full cut
    width)."""
    w = np.asarray(widths, dtype=np.int64)
    if (w == wmax).all():
        return None
    if stacked:
        keep = np.arange(wmax)[None, :] < w[:, None]
    else:
        keep = np.arange(wmax) < int(w)
    return torch.from_numpy(keep).to(device)


def _expand(m, stacked: bool, before: int, after: int):
    """Reshape a keep-mask for broadcasting against a param tensor whose
    cut axis sits ``before`` axes after the (optional) stacked leading
    axis and ``after`` axes before the end."""
    if m is None:
        return None
    if stacked:  # (U, w) -> (U, 1*before, w, 1*after)
        shape = (m.shape[0],) + (1,) * before + (m.shape[1],) + (1,) * after
    else:        # (w,) -> (w, 1*after); leading dims broadcast on the left
        shape = (m.shape[0],) + (1,) * after
    return m.reshape(shape)


def _cut(x, m, axis_from_end: int, size: int):
    """Slice one axis (counted from the end) to ``size`` and zero the
    entries ``m`` masks out (``m`` pre-shaped for broadcasting); the
    result is contiguous."""
    idx = [slice(None)] * x.ndim
    idx[x.ndim - 1 - axis_from_end] = slice(0, size)
    x = x[tuple(idx)]
    if m is not None:
        x = torch.where(m, x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))
    return x.contiguous()


def _slice_mlp(p: dict, widths, wmax: int, stacked: bool) -> dict:
    """Cut the FFN hidden dim of an (optionally stacked) mlp param dict
    to ``wmax`` columns, zeroing columns past each layer's own width."""
    m = _mask(widths, wmax, stacked, p["w_down"].device)
    out = dict(p)
    for k in ("w_up", "w_gate"):
        if k in out:  # (..., d, f)
            out[k] = _cut(out[k], _expand(m, stacked, 1, 0), 0, wmax)
    out["w_down"] = _cut(out["w_down"], _expand(m, stacked, 0, 1), 1, wmax)
    if "b_up" in out:  # (..., f)
        out["b_up"] = _cut(out["b_up"], _expand(m, stacked, 0, 0), 0, wmax)
    return out


def _slice_attn(p: dict, heads, hmax: int, g: int, stacked: bool) -> dict:
    """Cut query heads to ``hmax`` (KV heads to ``hmax // g``), zeroing
    the projections of heads past each layer's own count.  Zeroing w_o
    rows alone removes a head's contribution; w_q/w_k/w_v are zeroed
    too so padded heads write exact zeros into the KV cache."""
    kvmax = max(hmax // g, 1)
    dev = p["wo"].device
    qm = _mask(heads, hmax, stacked, dev)
    kvm = _mask(np.maximum(np.asarray(heads, dtype=np.int64) // g, 1),
                kvmax, stacked, dev)
    out = dict(p)
    # wq (..., d, h, dh) / wk, wv (..., d, kv, dh): cut axis -2
    for k, hsz, m in (("wq", hmax, qm), ("wk", kvmax, kvm),
                      ("wv", kvmax, kvm)):
        if k in out:
            out[k] = _cut(out[k], _expand(m, stacked, 1, 1), 1, hsz)
    # wo (..., h, dh, d): cut axis -3
    out["wo"] = _cut(out["wo"], _expand(qm, stacked, 0, 2), 2, hmax)
    # biases (..., h|kv, dh): cut axis -2
    for k, hsz, m in (("bq", hmax, qm), ("bk", kvmax, kvm),
                      ("bv", kvmax, kvm)):
        if k in out:
            out[k] = _cut(out[k], _expand(m, stacked, 0, 1), 1, hsz)
    return out


def _resize_axis(x, axis: int, size: int):
    """Slice or zero-pad one axis of ``x`` to ``size``."""
    cur = x.shape[axis]
    if cur == size:
        return x
    if cur > size:
        return x.narrow(axis, 0, size).contiguous()
    shape = list(x.shape)
    shape[axis] = size - cur
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


# ---------------------------------------------------------------------------
# the swapper
# ---------------------------------------------------------------------------
# Named checkpoints inside apply(), in execution order.  A fault_hook
# installed on the swapper is called with each step name and may raise —
# a fault injector uses this to prove apply_guarded() rolls back cleanly
# from a failure at ANY step.
SWAP_STEPS = ("begin", "realize", "materialize", "commit", "finish")


@dataclasses.dataclass(frozen=True)
class SwapEvent:
    """One boundary swap, as recorded in ``ServeEngine.swap_log``."""

    plan_name: str            # traffic class the plan was built for
    key: tuple                # canonical realized-width identity
    realized: tuple           # ((module name, realized channel width), ...)
    swap_s: float             # wall time of the apply() call
    cache_hit: bool           # True: served from the plan cache, 0 allocs
    outcome: str = "ok"       # "ok" | "rolled_back" (guarded swap failed)
    error: str = ""           # repr of the mid-swap exception, if any
    masked: bool = False      # zero-masked full-shape realization


class WidthSwapper:
    """Applies WidthPlans to a live param pytree, with a per-plan cache.

    ``full_params`` is the canonical tree; every plan is sliced from it
    (swap-back is lossless).  ``apply`` returns the materialized params
    plus a :class:`SwapEvent`; repeated swaps to the same realized plan
    return the cached tree with zero new array allocations.  ``max_plans``
    bounds the cache (LRU) — a serving tier has a handful of traffic
    classes, so the working set is small by construction.
    """

    def __init__(self, params, cfg: ModelConfig, *, max_plans: int = 8,
                 fault_hook=None, reshape_fault_hook=None):
        self.full_params = params
        self.cfg = cfg
        self.refs = tfm.decoder_layer_refs(cfg)
        self.max_plans = max(int(max_plans), 1)
        self._cache: "OrderedDict[tuple, dict]" = OrderedDict()
        self._group_g = cfg.n_heads // max(cfg.n_kv_heads, 1)
        # Optional callable(step_name) invoked at every SWAP_STEPS
        # checkpoint inside apply(); it may raise to simulate a mid-swap
        # failure (a fault injector's entry point).
        self.fault_hook = fault_hook
        # Optional callable() invoked at the top of reshape_states: the
        # KV-reshape counterpart of fault_hook, which the continuous
        # engine's boundary transaction must survive too
        # (serving.chaos.ReshapeFailureInjector).
        self.reshape_fault_hook = reshape_fault_hook

    def _step(self, name: str) -> None:
        if self.fault_hook is not None:
            self.fault_hook(name)

    # ---- realization ---------------------------------------------------
    def realize(self, widths: Mapping[str, int],
                modules: Mapping[str, ModuleRef]):
        """Planned name->width mapping -> per-decoder-layer realized
        (mlp_width, query_heads) arrays.  Unplanned layers keep their
        canonical width.  Raises on names without an address or plans
        targeting a site the layer does not have."""
        cfg = self.cfg
        n = len(self.refs)
        mlp_w = np.full(n, cfg.d_ff, dtype=np.int64)
        heads = np.full(n, cfg.n_heads, dtype=np.int64)
        for name, w in widths.items():
            ref = modules.get(name)
            if ref is None:
                raise ValueError(f"plan names {name!r} but the module "
                                 f"mapping has no address for it")
            if ref.layer >= n:
                raise ValueError(f"{name!r} addresses layer {ref.layer} "
                                 f"but the model has {n} decoder layers")
            meta = self.refs[ref.layer]
            if ref.site == "mlp":
                if meta["mlp_kind"] != "dense":
                    raise ValueError(
                        f"{name!r}: layer {ref.layer} has mlp_kind "
                        f"{meta['mlp_kind']!r}, not a sliceable dense FFN")
                mlp_w[ref.layer] = min(max(int(w), 1), cfg.d_ff)
            else:
                if meta["kind"] not in ("attn", "local"):
                    raise ValueError(
                        f"{name!r}: layer {ref.layer} is {meta['kind']!r}, "
                        f"not self-attention")
                heads[ref.layer] = snap_heads(int(w), cfg.head_dim,
                                              cfg.n_heads, cfg.n_kv_heads)
        return mlp_w, heads

    def realized_widths(self, mlp_w, heads,
                        modules: Mapping[str, ModuleRef]) -> tuple:
        """Canonical ((name, channel width), ...) for the addressed
        modules — names come from the plan's own mapping, so SwapEvent
        entries always correlate with ``plan.widths`` keys."""
        out = {}
        for name, ref in modules.items():
            if ref.site == "mlp":
                out[name] = int(mlp_w[ref.layer])
            else:
                out[name] = int(heads[ref.layer]) * self.cfg.head_dim
        return plan_key(out)

    # ---- materialization -----------------------------------------------
    @torch.no_grad()
    def materialize(self, mlp_w, heads, *, pad_to_full: bool = False):
        """Build the param tree realizing per-layer widths.

        ``pad_to_full`` keeps every array at its canonical shape and only
        zeroes the dropped channels — the reference the equivalence
        property compares against (sliced == zeroed, channel for
        channel)."""
        cfg = self.cfg
        cycle = tfm.unit_cycle(cfg)
        n_units = len(self.refs) // cycle
        g = self._group_g

        def cut_unit(unit: dict, lids: list, stacked: bool) -> dict:
            # `stacked` is the group type, not len(lids): a stack with a
            # single unit still carries the leading unit axis.
            meta = self.refs[lids[0]]
            out = unit
            if meta["mlp_kind"] == "dense" and "mlp" in unit:
                w = mlp_w[lids] if stacked else mlp_w[lids[0]]
                wmax = cfg.d_ff if pad_to_full else int(np.max(w))
                if pad_to_full or wmax < cfg.d_ff \
                        or (np.asarray(w) != wmax).any():
                    out = dict(out)
                    out["mlp"] = _slice_mlp(unit["mlp"], w, wmax, stacked)
            if meta["kind"] in ("attn", "local") and "attn" in unit:
                h = heads[lids] if stacked else heads[lids[0]]
                hmax = cfg.n_heads if pad_to_full else int(np.max(h))
                if pad_to_full or hmax < cfg.n_heads \
                        or (np.asarray(h) != hmax).any():
                    out = dict(out)
                    out["attn"] = _slice_attn(unit["attn"], h, hmax, g,
                                              stacked)
            return out

        decoder = dict(self.full_params["decoder"])
        if "stack" in decoder and n_units:
            stack = dict(decoder["stack"])
            for j in range(cycle):
                lids = [u * cycle + j for u in range(n_units)]
                stack[f"u{j}"] = cut_unit(stack[f"u{j}"], lids,
                                          stacked=True)
            decoder["stack"] = stack
        if "extra" in decoder:
            extra = dict(decoder["extra"])
            for j in range(len(self.refs) - n_units * cycle):
                lid = n_units * cycle + j
                extra[f"x{j}"] = cut_unit(extra[f"x{j}"], [lid],
                                          stacked=False)
            decoder["extra"] = extra
        params = dict(self.full_params)
        params["decoder"] = decoder
        return params

    # ---- the boundary swap ---------------------------------------------
    def apply(self, plan, *, masked: bool = False) -> tuple:
        """Materialize ``plan`` (a WidthPlan with a module mapping) and
        return ``(params, SwapEvent)``.  The full-width plan returns the
        canonical tree itself — swap-back is bit-for-bit the original.

        ``masked=True`` realizes the plan as zero-masked *full-shape*
        params (``materialize(..., pad_to_full=True)``): the dropped
        channels are zeroed but every array keeps its canonical shape,
        so the result runs at the full-width shapes (``repro``'s compile
        cache uses it to stay on a compiled executable).  Masked and
        sliced materializations of the same widths are cached under
        distinct keys.

        The plan cache is only written *after* materialization completes
        (the "commit" checkpoint), so a failure at any step leaves no
        partially built tree behind — the invariant ``apply_guarded``'s
        rollback relies on."""
        t0 = time.perf_counter()
        if not getattr(plan, "modules", None):
            raise ValueError(
                "plan has no module mapping; build templates with "
                "width_swap.serving_templates and pass modules= to "
                "ServingWidthPlanner")
        self._step("begin")
        self._step("realize")
        mlp_w, heads = self.realize(plan.widths, plan.modules)
        key = (tuple(mlp_w.tolist()), tuple(heads.tolist()))
        full = (mlp_w == self.cfg.d_ff).all() \
            and (heads == self.cfg.n_heads).all()
        if full:
            masked = False          # nothing to mask at full width
        cache_key = key + (("masked",) if masked else ())
        hit = cache_key in self._cache
        if hit:
            params = self._cache[cache_key]
            self._cache.move_to_end(cache_key)
        else:
            self._step("materialize")
            if full:
                params = self.full_params
            else:
                params = self.materialize(mlp_w, heads,
                                          pad_to_full=masked)
            self._step("commit")
            self._cache[cache_key] = params
            while len(self._cache) > self.max_plans:
                self._cache.popitem(last=False)
        self._step("finish")
        name = plan.traffic.name if getattr(plan, "traffic", None) else ""
        event = SwapEvent(plan_name=name, key=key,
                          realized=self.realized_widths(mlp_w, heads,
                                                        plan.modules),
                          swap_s=time.perf_counter() - t0, cache_hit=hit,
                          masked=masked)
        return params, event

    def apply_guarded(self, plan, *, masked: bool = False) -> tuple:
        """Transactional :meth:`apply`: any mid-swap exception rolls back
        to the retained canonical tree instead of propagating.

        Returns ``(params, SwapEvent)`` exactly like ``apply``; on a
        failure the params are ``full_params`` (the canonical full-width
        tree, untouched by construction — every materialization builds a
        NEW tree from it) and the event records ``outcome="rolled_back"``
        plus the exception.  A plan without a module mapping still
        raises — that is a caller contract violation, not a runtime
        fault to degrade through."""
        t0 = time.perf_counter()
        if not getattr(plan, "modules", None):
            raise ValueError(
                "plan has no module mapping; build templates with "
                "width_swap.serving_templates and pass modules= to "
                "ServingWidthPlanner")
        try:
            return self.apply(plan, masked=masked)
        except Exception as e:  # noqa: BLE001 — the guard IS the point
            name = plan.traffic.name \
                if getattr(plan, "traffic", None) else ""
            event = SwapEvent(
                plan_name=name, key=(), realized=(),
                swap_s=time.perf_counter() - t0, cache_hit=False,
                outcome="rolled_back",
                error=f"{type(e).__name__}: {e}")
            return self.full_params, event

    # ---- plan realization helper ---------------------------------------
    def realize_plan(self, plan):
        """Per-decoder-layer realized ``(mlp_w, heads)`` arrays for a
        WidthPlan — the head vector :meth:`reshape_states` needs on each
        side of a boundary.  The full-width plan (``widths={}``) realizes
        to the canonical widths even without a module mapping."""
        if not getattr(plan, "widths", None):
            n = len(self.refs)
            return (np.full(n, self.cfg.d_ff, dtype=np.int64),
                    np.full(n, self.cfg.n_heads, dtype=np.int64))
        if not getattr(plan, "modules", None):
            raise ValueError(
                "plan has no module mapping; build templates with "
                "width_swap.serving_templates and pass modules= to "
                "ServingWidthPlanner")
        return self.realize(plan.widths, plan.modules)

    # ---- KV state re-shaping -------------------------------------------
    def reshape_states(self, states: Optional[dict], heads_from,
                       heads_to) -> Optional[dict]:
        """Re-shape decode KV caches from one plan's head counts to
        another's at a batch boundary.  Shrinking slices the cached
        K/V head prefix (exact: GQA keeps a prefix of KV heads); growing
        zero-pads the new head slots, which have no cached history —
        engines that prefill per batch never hit the growing case, and
        the continuous engine re-prefills grown requests from their own
        tokens instead of decoding on zero-history heads."""
        if self.reshape_fault_hook is not None:
            self.reshape_fault_hook()
        return self.reshape_fresh(states, heads_from, heads_to)

    def reshape_fresh(self, states: Optional[dict], heads_from,
                      heads_to) -> Optional[dict]:
        """:meth:`reshape_states` for a state built fresh (a buffer, not
        live KV at a boundary): the same cut, with no
        ``reshape_fault_hook`` in the path, so shaping a buffer or
        recovering from a fault cannot be fault-injected."""
        if states is None:
            return None
        cfg = self.cfg
        g = self._group_g
        cycle = tfm.unit_cycle(cfg)
        n_units = len(self.refs) // cycle
        hf = np.asarray(heads_from, dtype=np.int64)
        ht = np.asarray(heads_to, dtype=np.int64)

        def cut_state(st: dict, lids: list) -> dict:
            meta = self.refs[lids[0]]
            if meta["kind"] not in ("attn", "local") or "k" not in st:
                return st
            kv_from = max(int(np.max(hf[lids])) // g, 1)
            kv_to = max(int(np.max(ht[lids])) // g, 1)
            if kv_from == kv_to:
                return st
            out = dict(st)
            for k in ("k", "v"):
                # (B, S, KV, dh) or stacked (U, B, S, KV, dh): KV = -2
                out[k] = _resize_axis(st[k], st[k].ndim - 2, kv_to)
            return out

        out = dict(states)
        if "stack" in states and n_units:
            stack = dict(states["stack"])
            for j in range(cycle):
                lids = [u * cycle + j for u in range(n_units)]
                stack[f"u{j}"] = cut_state(stack[f"u{j}"], lids)
            out["stack"] = stack
        if "extra" in states:
            extra = dict(states["extra"])
            for j in range(len(self.refs) - n_units * cycle):
                lid = n_units * cycle + j
                extra[f"x{j}"] = cut_state(extra[f"x{j}"], [lid])
            out["extra"] = extra
        return out
