"""GPU(-analogue)-aware model configuration optimization — paper Algorithm 2
(``repro.core.tail_optimizer``'s counterpart, the same logic).

Two duals, exactly as in the paper section 4.3:

  * latency-oriented (Eq. 7):  maximize sum LG_i  s.t.  sum PG_i in (-tau, tau)
  * accuracy-oriented (Eq. 6): maximize sum PG_i  s.t.  sum LG_i >= 0

where per layer i (Eq. 5):  LG_i = L_i[R_old] - L_i[R_new]   (latency gain)
                            PG_i = params(R_new) - params(R_old)  (param gain)

The mechanics follow Algorithm 2: identify per-layer candidates C_i[m]
(Eq. 4, see candidates.py), keep two queues ranked by LG, greedily pop the
max-LG layer to *scale down* (Eq. 8a) and balance the parameter budget by
popping min-LG layers to *scale up* (Eq. 8b); after all layers are adjusted,
check L_new <= delta * L_old and loosen tau if the target is missed
(Algorithm 2 line 18).

Table-driven hot path
---------------------
This is the paper's own split: "Step 1: pre-analysis" builds per-layer
L/U/T tables, Algorithm 2 then only *reads* them.  Per ``optimize_*`` call
we precompute per-layer candidate tables with vectorized
``WaveQuantizationModel.latency_batch`` sweeps (latency per candidate plus
the starting width; params are an exact scalar multiply) — after that the
greedy loops are pure table lookups:

  * sweeps are batched across layers that share a ``LayerShape`` (all
    fields but width) and chunked to stay cache-resident; latency mode
    sweeps only each layer's reachable one-step probes (Alg. 2 moves a
    layer at most one candidate per round), accuracy mode with slack
    sweeps the full table for its wave-jump walk;
  * candidate navigation is index ±1 on the sorted-unique width table
    (Eq. 8a/8b snaps; the only binary searches happen once at build);
  * the two LG-ranked queues are binary heaps with lazy deletion, keyed on
    the precomputed LG and tie-broken by layer position so the pop order is
    identical to the historical sorted-list ``pop(0)``/``pop(-1)``, and the
    queues plus the per-layer LG estimates are hoisted out of the
    tau-loosening rounds (only tau changes between rounds);
  * the Eq. 7 window check keeps PG as an O(1) running sum instead of an
    O(layers) parameter rescan per move;
  * accuracy pass 2 keeps each layer's next wave-jump in a max-heap on
    PG/LG and re-pushes only the moved layer, instead of re-ranking every
    layer per accepted move.  (Entries are discarded permanently when they
    fail the budget filter — the budget only shrinks, so they can never
    become valid again.)

Model-level stacked sweeps and the profile-table cache
------------------------------------------------------
``_build_tables`` resolves each layer's latency vector from three sources,
cheapest first:

  1. a **measured profile** attached to the ``TunableLayer`` (``measured``;
     see ``tunable_from_profile``) — the optimizer only reads latency and
     params arrays, so Algorithm 2 runs unmodified over profiled hardware
     tables (the paper's original nvprof flow);
  2. the **disk cache** (``core.table_cache.ProfileTableCache``,
     passed to the constructor): repeated ``optimize_*`` calls across
     processes skip the pre-analysis entirely (a fully warm cache makes
     zero model sweeps);
  3. one **stacked model sweep** for every remaining layer at once
     (``WaveQuantizationModel.latency_model_batch``): all layers x all
     sweep widths in a single chunked call instead of one dispatch per
     layer-shape group; with ``backend="kernel"`` that call is one launch
     of the staircase kernel.

``repro`` keeps its historical per-shape-group table build as a parity
baseline; the port has only the stacked build, and
``tests/test_torch_planner.py`` holds it to ``repro``'s optimizer.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import TYPE_CHECKING, Sequence

import numpy as np

from repro_torch.core import candidates as cand
from repro_torch.core.tail_model import LayerShape, WaveQuantizationModel

if TYPE_CHECKING:
    from repro_torch.core.table_cache import ProfileTableCache


@dataclasses.dataclass
class TunableLayer:
    """One width-adjustable layer handed to the optimizer.

    ``candidates`` is normalized to a sorted-unique int64 array at
    construction (snaps are set-based, so this is behavior-preserving);
    the optimizer's binary searches rely on it.

    ``measured`` optionally attaches a profiled (width, latency) table —
    any object with ``widths`` and ``latency_s`` parallel arrays (and
    ``utilization``/``throughput`` for ``tunable_from_profile``).  When
    set, ``_build_tables`` reads every latency it needs from the table
    instead of sweeping the analytic model, so Algorithm 2 optimizes over
    measured hardware data; the table must cover every candidate width
    plus the starting width.
    """

    layer: LayerShape
    candidates: np.ndarray
    # parameters contributed per unit of width (e.g. d_in for a dense layer,
    # d_in + d_out for a conv filter that also feeds the next layer's input).
    params_per_unit: float
    min_width: int = 1
    max_width: int | None = None
    measured: object = None

    def __post_init__(self):
        c = np.asarray(self.candidates, dtype=np.int64)
        if c.size > 1 and not np.all(c[:-1] < c[1:]):
            c = np.unique(c)
        self.candidates = c

    def params(self, width: int) -> float:
        return self.params_per_unit * width


def tunable_from_profile(
    layer: LayerShape,
    profile,
    params_per_unit: float,
    *,
    min_width: int = 1,
    max_width: int | None = None,
    top_per_wave: int = 1,
) -> TunableLayer:
    """Build a TunableLayer entirely from a measured profile table.

    Candidates come from paper Eq. 4 (argmax U x T per stair) on the
    profiled utilization/throughput columns, and ``measured`` wires the
    profiled latencies into ``_build_tables`` — so the optimizer runs on
    hardware we have no closed form for (the paper's nvprof flow).
    ``layer.width`` (the starting width) must appear in the profile.
    """
    cands = cand.profile_candidates(
        profile.widths, profile.utilization, profile.throughput,
        top_per_wave=top_per_wave)
    return TunableLayer(layer=layer, candidates=cands,
                        params_per_unit=params_per_unit,
                        min_width=min_width, max_width=max_width,
                        measured=profile)


def _measured_latencies(tl: TunableLayer, widths: np.ndarray) -> np.ndarray:
    """Latencies for ``widths`` read out of ``tl.measured``; raises when
    the profile does not cover a requested width."""
    prof = tl.measured
    pw = np.asarray(prof.widths, dtype=np.int64)
    order = np.argsort(pw, kind="stable")
    sorted_w = pw[order]
    idx = np.searchsorted(sorted_w, widths)
    clipped = np.minimum(idx, sorted_w.size - 1) if sorted_w.size else idx
    ok = sorted_w.size > 0 and bool(
        ((idx < sorted_w.size) & (sorted_w[clipped] == widths)).all())
    if not ok:
        have = set(int(x) for x in sorted_w)
        missing = sorted(int(x) for x in widths if int(x) not in have)
        raise ValueError(
            f"measured profile for layer {tl.layer.name!r} is missing "
            f"widths {missing}; profile covers {sorted_w.size} widths")
    lat = np.asarray(prof.latency_s, dtype=np.float64)[order]
    return lat[idx]


@dataclasses.dataclass
class Move:
    layer: str
    kind: str          # "down" | "up"
    old_width: int
    new_width: int
    latency_gain_s: float
    param_gain: float


@dataclasses.dataclass
class OptimizationResult:
    old_widths: dict[str, int]
    new_widths: dict[str, int]
    latency_old_s: float
    latency_new_s: float
    params_old: float
    params_new: float
    moves: list[Move]
    tau_final: float
    satisfied: bool

    @property
    def latency_reduction(self) -> float:
        if self.latency_old_s == 0:
            return 0.0
        return 1.0 - self.latency_new_s / self.latency_old_s

    @property
    def param_gain(self) -> float:
        return self.params_new - self.params_old

    def summary(self) -> str:
        lines = [
            f"latency: {self.latency_old_s * 1e6:.2f}us -> "
            f"{self.latency_new_s * 1e6:.2f}us "
            f"({self.latency_reduction * 100:+.1f}% reduction)",
            f"params:  {self.params_old / 1e6:.3f}M -> "
            f"{self.params_new / 1e6:.3f}M ({self.param_gain / 1e6:+.3f}M)",
            f"tau_final={self.tau_final:.3g} satisfied={self.satisfied}",
        ]
        for m in self.moves:
            lines.append(
                f"  [{m.kind:>4}] {m.layer}: {m.old_width} -> {m.new_width} "
                f"(LG {m.latency_gain_s * 1e6:+.2f}us, PG {m.param_gain:+.0f})"
            )
        return "\n".join(lines)


@dataclasses.dataclass(slots=True)
class _LayerTable:
    """Precomputed candidate table for one tunable layer (Step 1 output).

    Candidates are sorted and de-duplicated, so Eq. 8a/8b snaps from a
    candidate are just index ±1; the only binary searches happen once at
    build time (the starting width and the min/max-width fences).
    ``slots=True``: one instance per layer per build, so construction cost
    shows up directly in the stacked table-build wall time.
    """

    tl: TunableLayer
    pos: int                  # position in the ``layers`` sequence
    name: str
    cands: np.ndarray         # sorted unique candidate widths, int64
    # latency per candidate: a full float64 array (accuracy mode, whose
    # pass 2 walks many waves up) or a sparse {index: latency} dict holding
    # just the reachable one-step probes (latency mode — Alg. 2 moves each
    # layer at most one candidate from its start per round).
    lat: "np.ndarray | dict[int, float]"
    lo: int                   # first index with cands[i] >= min_width
    hi: int                   # last index with cands[i] <= max_width
    start_width: int
    start_lat: float
    start_par: float
    start_down: int           # index of max candidate < start_width, or -1
    start_up: int             # index of min candidate > start_width, or n

    def par_at(self, idx: int) -> float:
        # identical to the historical params(width): one exact scalar
        # multiply, so no per-candidate params array is materialized
        return self.tl.params(int(self.cands[idx]))

    def down_from(self, idx: int) -> int | None:
        """Eq. 8a: next candidate index below cursor (-1 = at start)."""
        i = self.start_down if idx < 0 else idx - 1
        return i if i >= self.lo else None

    def up_from(self, idx: int) -> int | None:
        """Eq. 8b: next candidate index above cursor (-1 = at start)."""
        i = self.start_up if idx < 0 else idx + 1
        return i if i <= self.hi else None


class _LayerState:
    """Mutable per-round cursor over a _LayerTable.  ``idx`` is the current
    candidate index, or -1 while still at the (possibly off-table) starting
    width."""

    __slots__ = ("table", "idx", "width", "lat", "par")

    def __init__(self, table: _LayerTable):
        self.table = table
        self.idx = -1
        self.width = table.start_width
        self.lat = table.start_lat
        self.par = table.start_par

    def move_to(self, idx: int) -> None:
        t = self.table
        self.idx = idx
        self.width = int(t.cands[idx])
        self.lat = float(t.lat[idx])
        self.par = t.tl.params(self.width)

    def reset(self) -> None:
        t = self.table
        self.idx = -1
        self.width, self.lat, self.par = (
            t.start_width, t.start_lat, t.start_par)

    def down(self) -> int | None:
        return self.table.down_from(self.idx)

    def up(self) -> int | None:
        return self.table.up_from(self.idx)


class TailEffectOptimizer:
    """Paper Algorithm 2 over precomputed per-layer candidate tables.

    ``cache`` (a ``table_cache.ProfileTableCache``) persists the swept
    tables on disk keyed on (hardware, shape-minus-width, width vector):
    a warm cache makes ``_build_tables`` skip the model entirely.
    """

    def __init__(self, model: WaveQuantizationModel,
                 cache: "ProfileTableCache | None" = None,
                 bundle_min_layers: int = 64):
        self.model = model
        self.cache = cache
        # Stacks at least this deep are cached as ONE whole-stack bundle
        # file instead of per-layer entries: above ~64 layers the per-file
        # open cost of fine-grained entries exceeds resweeping the model.
        self.bundle_min_layers = bundle_min_layers
        # Reused full-mode sweep matrix: every build rewrites every cell
        # (data, start and pad columns), so reuse is purely an allocation
        # saving — a fresh 8 MB matrix per build costs more in page
        # faults than the sweep's own arithmetic.
        self._w2d_buf: np.ndarray | None = None

    # ---- Step 1: pre-analysis -------------------------------------------
    def _build_tables(self, layers: Sequence[TunableLayer],
                      full: bool = True) -> list[_LayerTable]:
        """Per-layer candidate tables from measured / cached / swept data.

        Each layer needs latencies for one sweep vector: its candidates
        plus the starting width (``full=True``), or just the reachable
        one-step probes plus the start (``full=False``, latency mode —
        Algorithm 2's latency rounds move a layer at most one candidate
        from its start, so anything further is never read; accuracy mode
        needs the whole table for its wave-jump walk).

        The vector is resolved from the first source that has it:

          1. ``tl.measured`` — a profiled (width, latency) table;
          2. the disk cache (when this optimizer holds one): per-layer
             entries for shallow models, ONE whole-stack bundle entry for
             stacks of at least ``bundle_min_layers`` (per-layer file
             opens dominate at 1000+ layers);
          3. one stacked ``latency_model_packed`` sweep over every
             unresolved layer at once — all layers x all sweep widths in
             a single chunked call, then written back to the cache.
        """
        n_layers = len(layers)
        starts = np.fromiter((tl.layer.width for tl in layers),
                             np.int64, n_layers)
        # Cursor/fence arrays over all layers.  Layers handed the SAME
        # candidates array object (a transformer stack / NAS supernet
        # sharing one grid) are prepped in one vectorized pass per shared
        # grid — the binary searches and fence math run over the whole
        # stack at once; unshared layers fall back to the scalar path.
        sd_a = np.empty(n_layers, np.int64)
        su_a = np.empty(n_layers, np.int64)
        lo_a = np.empty(n_layers, np.int64)
        hi_a = np.empty(n_layers, np.int64)
        if full:
            # The sweep widths for ALL layers, packed into one (L, kmax)
            # matrix up front (pad width 1, masked by ``counts``): filling
            # rows is a memcpy per layer (one broadcast per shared grid),
            # where building L small arrays and re-packing them dominated
            # the whole table build.
            kmax = 1 + max((int(tl.candidates.size) for tl in layers),
                           default=0)
            # empty, not ones: each grid group fills its rows' data AND
            # pad cells exactly once below (ones would touch the whole
            # 8 MB matrix just to be overwritten)
            if self._w2d_buf is not None \
                    and self._w2d_buf.shape == (n_layers, kmax):
                w2d = self._w2d_buf
            else:
                w2d = self._w2d_buf = np.empty((n_layers, kmax),
                                               dtype=np.int64)
            counts = np.empty(n_layers, dtype=np.int64)
        else:
            # Latency mode: every row is the fixed 3-slot layout
            # [down-probe, up-probe, start]; unreachable probe slots hold
            # pad width 1 and are never read back.
            w2d = np.ones((n_layers, 3), dtype=np.int64)
            w2d[:, 2] = starts
            counts = np.full(n_layers, 3, dtype=np.int64)

        grids: dict[int, list[int]] = {}
        for pos, tl in enumerate(layers):
            grids.setdefault(id(tl.candidates), []).append(pos)
        for idxs in grids.values():
            cands = layers[idxs[0]].candidates  # sorted unique (init)
            n = int(cands.size)
            if n == 0:
                for pos in idxs:
                    sd_a[pos], su_a[pos] = -1, 0
                    lo_a[pos], hi_a[pos] = 0, -1
                    if full:
                        w2d[pos, 0] = starts[pos]
                        w2d[pos, 1:] = 1
                        counts[pos] = 1
                continue
            if len(idxs) < 4:
                # scalar path: vectorized overhead loses on tiny groups
                for pos in idxs:
                    tl = layers[pos]
                    start_w = int(starts[pos])
                    i = int(cands.searchsorted(start_w, side="left"))
                    sd = i - 1
                    su = i + 1 if (i < n and int(cands[i]) == start_w) \
                        else i
                    lo = (0 if tl.min_width <= int(cands[0]) else
                          int(cands.searchsorted(tl.min_width,
                                                 side="left")))
                    hi = (n - 1 if (tl.max_width is None
                                    or tl.max_width >= int(cands[-1])) else
                          int(cands.searchsorted(tl.max_width,
                                                 side="right")) - 1)
                    sd_a[pos], su_a[pos] = sd, su
                    lo_a[pos], hi_a[pos] = lo, hi
                    if full:
                        w2d[pos, :n] = cands
                        w2d[pos, n] = start_w
                        w2d[pos, n + 1:] = 1
                        counts[pos] = n + 1
                    else:
                        if sd >= lo:
                            w2d[pos, 0] = cands[sd]
                        if su <= hi:
                            w2d[pos, 1] = cands[su]
                continue
            pos = np.asarray(idxs)
            st = starts[pos]
            i = cands.searchsorted(st, side="left")
            sd = i - 1
            hit = (i < n) & (cands[np.minimum(i, n - 1)] == st)
            su = np.where(hit, i + 1, i)
            min_ws = np.fromiter((layers[j].min_width for j in idxs),
                                 np.int64, len(idxs))
            lo = np.where(min_ws <= int(cands[0]), 0,
                          cands.searchsorted(min_ws, side="left"))
            max_list = [layers[j].max_width for j in idxs]
            if all(m is None for m in max_list):
                hi = np.full(len(idxs), n - 1, dtype=np.int64)
            else:
                top = int(cands[-1])
                mw = np.fromiter((top if m is None else m
                                  for m in max_list), np.int64, len(idxs))
                hi = np.where(mw >= top, n - 1,
                              cands.searchsorted(mw, side="right") - 1)
            sd_a[pos], su_a[pos] = sd, su
            lo_a[pos], hi_a[pos] = lo, hi
            if full:
                w2d[pos, :n] = cands  # one broadcast per shared grid
                w2d[pos, n] = st
                w2d[pos, n + 1:] = 1
                counts[pos] = n + 1
            else:
                d_ok = sd >= lo
                u_ok = su <= hi
                w2d[pos, 0] = np.where(d_ok, cands[np.maximum(sd, 0)], 1)
                w2d[pos, 1] = np.where(u_ok, cands[np.minimum(su, n - 1)],
                                       1)

        down_ok_l = (sd_a >= lo_a).tolist()
        up_ok_l = (su_a <= hi_a).tolist()
        sd_l, su_l = sd_a.tolist(), su_a.tolist()
        lo_l, hi_l = lo_a.tolist(), hi_a.tolist()
        starts_l = starts.tolist()

        # Resolve each layer's sweep-vector latencies, cheapest source
        # first: measured profile -> disk cache -> stacked model sweep.
        # ``lat_vecs[i]`` may be a full padded row (swept) or an exact
        # ``counts[i]``-length vector (measured/cached); only indices
        # below ``counts[i]`` (and, in latency mode, only the reachable
        # probe slots) are read.
        lat_vecs: list = [None] * n_layers
        any_measured = False
        for i, tl in enumerate(layers):
            if tl.measured is not None:
                any_measured = True
                if full:
                    lat_vecs[i] = _measured_latencies(tl,
                                                      w2d[i, :counts[i]])
                else:
                    # look up only the real slots — pad slots (width 1)
                    # need not exist in the profile and are never read
                    mask = np.array([down_ok_l[i], up_ok_l[i], True])
                    vec = np.zeros(3, dtype=np.float64)
                    vec[mask] = _measured_latencies(tl, w2d[i, mask])
                    lat_vecs[i] = vec
        lat2d_all = None   # the full (L, C) sweep matrix, when one exists
        variant = getattr(self.model, "table_variant", "")
        if self.cache is not None and not any_measured \
                and n_layers >= self.bundle_min_layers:
            # Deep stack: one whole-stack bundle file (per-layer entries
            # would cost one file open each — slower than resweeping).
            hw = self.model.hw
            shapes = [tl.layer for tl in layers]
            lat2d = self.cache.get_stack(hw, shapes, w2d, counts,
                                         variant=variant)
            if lat2d is None:
                lat2d = self.model.latency_model_packed(shapes, w2d,
                                                        counts)
                self.cache.put_stack(hw, shapes, w2d, counts, lat2d,
                                     variant=variant)
            lat_vecs = list(lat2d)
            lat2d_all = lat2d
        else:
            if self.cache is not None:
                hw = self.model.hw
                for i, tl in enumerate(layers):
                    if lat_vecs[i] is None:
                        hit = self.cache.get(hw, tl.layer,
                                             w2d[i, :counts[i]],
                                             variant=variant)
                        if hit is not None and "latency_s" in hit:
                            lat_vecs[i] = hit["latency_s"]
            miss = [i for i, v in enumerate(lat_vecs) if v is None]
            if miss:
                if len(miss) == n_layers:
                    lat2d = self.model.latency_model_packed(
                        [tl.layer for tl in layers], w2d, counts)
                    lat_vecs = list(lat2d)
                    lat2d_all = lat2d
                else:
                    rows = np.asarray(miss)
                    lat2d = self.model.latency_model_packed(
                        [layers[i].layer for i in miss],
                        w2d[rows], counts[rows])
                    for r, i in enumerate(miss):
                        lat_vecs[i] = lat2d[r]
                if self.cache is not None:
                    hw = self.model.hw
                    for i in miss:
                        k = int(counts[i])
                        self.cache.put(hw, layers[i].layer, w2d[i, :k],
                                       {"latency_s": lat_vecs[i][:k]},
                                       variant=variant)

        tables = []
        counts_l = counts.tolist()
        # start_par is params_per_unit * width per layer: one vectorized
        # multiply (elementwise float64 mul == the scalar `params` mul
        # bit-for-bit), not 1000 method calls.
        ppu = np.fromiter((tl.params_per_unit for tl in layers),
                          np.float64, n_layers)
        start_par_l = (ppu * starts).tolist()
        # Latency-mode rows convert to Python floats in ONE bulk tolist
        # when they all come from the stacked sweep matrix.
        rows_l = lat2d_all.tolist() if (not full and
                                        lat2d_all is not None) else None
        for pos, tl in enumerate(layers):
            vec = lat_vecs[pos]
            sd, su = sd_l[pos], su_l[pos]
            start_w = starts_l[pos]
            if full:
                k = counts_l[pos]
                lat = vec[: k - 1]
                start_lat = float(vec[k - 1])
            else:
                row = rows_l[pos] if rows_l is not None else \
                    vec[:3].tolist()
                lat = {}
                if down_ok_l[pos]:
                    lat[sd] = row[0]
                if up_ok_l[pos]:
                    lat[su] = row[1]
                start_lat = row[2]
            tables.append(_LayerTable(
                tl=tl, pos=pos, name=tl.layer.name,
                cands=tl.candidates,
                lat=lat,
                lo=lo_l[pos], hi=hi_l[pos],
                start_width=start_w,
                start_lat=start_lat,
                start_par=start_par_l[pos],
                start_down=sd,
                start_up=su,
            ))
        return tables

    # ---- latency-oriented (Eq. 7, Algorithm 2) ----------------------------
    def optimize_latency(
        self,
        layers: Sequence[TunableLayer],
        tau: float,
        delta: float = 0.9,
        max_rounds: int = 8,
    ) -> OptimizationResult:
        """Maximize sum LG subject to sum PG in (-tau, tau); retry with
        loosened tau until L_new <= delta * L_old (Algorithm 2 lines 15-18).

        ``tau`` is in absolute parameter counts.  The candidate tables are
        built once (reachable probes only — latency mode) and shared by
        every tau-loosening round.
        """
        tables = self._build_tables(layers, full=False)
        old_widths = {t.name: t.start_width for t in tables}
        l_old = sum(t.start_lat for t in tables)
        p_old = sum(t.start_par for t in tables)

        # Round-invariant state, hoisted out of the tau-loosening loop:
        # every round starts from the same widths, so the per-layer LG
        # estimates (Alg. 2 line 6) and the LG-ranked queues are identical —
        # only tau changes between rounds.
        states = [_LayerState(t) for t in tables]
        lg = []
        for t in tables:
            di = t.down_from(-1)
            lg.append(float(t.start_lat - t.lat[di]) if di is not None
                      else 0.0)
        # The historical implementation kept ONE list sorted descending by
        # LG (stable, so ties keep layer order) and popped max-LG from the
        # front / min-LG from the back.  Two heaps with lazy deletion
        # reproduce that exact pop sequence: ties at the front go to the
        # lowest layer position, ties at the back to the highest.
        base_down = [(-lg[i], i) for i in range(len(tables))]
        base_up = [(lg[i], -i) for i in range(len(tables))]
        heapq.heapify(base_down)
        heapq.heapify(base_up)

        best: OptimizationResult | None = None
        cur_tau = tau
        for _ in range(max_rounds):
            res = self._one_latency_round(tables, states, lg, base_down,
                                          base_up, old_widths, l_old, p_old,
                                          cur_tau, delta)
            if best is None or res.latency_new_s < best.latency_new_s:
                best = res
            if res.satisfied:
                return res
            cur_tau *= 2.0  # Algorithm 2 line 18: loosen and repeat
        assert best is not None
        return best

    def _one_latency_round(self, tables, states, lg, base_down, base_up,
                           old_widths, l_old, p_old, tau,
                           delta) -> OptimizationResult:
        for s in states:
            s.reset()
        moves: list[Move] = []
        pg = 0.0  # running sum PG (Eq. 7 window), exact for integer params

        down_heap = list(base_down)  # a copy of a heap is a valid heap
        up_heap = list(base_up)
        consumed = [False] * len(tables)
        remaining = len(tables)

        def pop_max_lg() -> int | None:
            while down_heap:
                _, i = heapq.heappop(down_heap)
                if not consumed[i]:
                    return i
            return None

        def pop_min_lg() -> int | None:
            while up_heap:
                _, neg = heapq.heappop(up_heap)
                i = -neg
                if not consumed[i]:
                    return i
            return None

        while remaining > 0:
            j = pop_max_lg()                 # Argmax LG (line 9)
            consumed[j] = True
            remaining -= 1
            sj = states[j]
            tj = tables[j]
            di = sj.down()
            applied_down = False
            dp_down = 0.0
            down_move_at = len(moves)
            if di is not None and lg[j] > 0:
                gain = sj.lat - float(tj.lat[di])
                dp_down = tj.par_at(di) - sj.par
                moves.append(Move(tj.name, "down", sj.width,
                                  int(tj.cands[di]), gain, dp_down))
                sj.move_to(di)
                pg += dp_down
                applied_down = True

            # Balance PG by scaling up min-LG layers (lines 11-13).
            while remaining > 0 and not (-tau < pg < tau):
                k = pop_min_lg()             # Argmin LG (line 12)
                consumed[k] = True
                remaining -= 1
                sk = states[k]
                tk = tables[k]
                ui = sk.up()
                if ui is None:
                    continue
                dp = tk.par_at(ui) - sk.par
                # only balance if the move brings PG closer to the window
                if abs(pg + dp) >= abs(pg):
                    continue
                extra = float(tk.lat[ui]) - sk.lat
                moves.append(Move(tk.name, "up", sk.width,
                                  int(tk.cands[ui]), -extra, dp))
                sk.move_to(ui)
                pg += dp

            # Eq. 7 is a hard constraint: if no up-candidates remain to
            # balance this scale-down, revert it — removing the down-Move
            # itself, not whatever Move happens to be last (the balance
            # loop may have appended up-moves after it that stay applied).
            # The seed popped the last entry, so ``moves`` could disagree
            # with ``new_widths`` in this corner; fixed in lockstep with
            # ``scalar_ref`` (coordinated behavior-change, see ROADMAP).
            if applied_down and not (-tau < pg < tau):
                sj.reset()
                pg -= dp_down
                del moves[down_move_at]

        l_new = sum(s.lat for s in states)
        widths = {s.table.name: s.width for s in states}
        return OptimizationResult(
            old_widths=dict(old_widths), new_widths=widths,
            latency_old_s=l_old, latency_new_s=l_new,
            params_old=p_old, params_new=p_old + pg,
            moves=moves, tau_final=tau,
            satisfied=l_new <= l_old * delta,
        )

    # ---- accuracy-oriented (Eq. 6) ----------------------------------------
    def optimize_accuracy(
        self,
        layers: Sequence[TunableLayer],
        latency_slack: float = 0.0,
    ) -> OptimizationResult:
        """Maximize sum PG subject to sum LG >= -latency_slack * L_old.

        Pass 1 snaps every layer *up* to the right edge of its current wave —
        by construction latency is unchanged (same wave) and capacity grows
        for free (the paper's EfficientNet move, Table 3).  Pass 2 greedily
        spends any remaining latency slack on full wave jumps, largest
        PG-per-latency first, via a max-heap over each layer's next jump.

        With no slack there is no pass-2 walk, so only the one-step probes
        are swept (``full=False``); with slack the walk can climb many
        waves and needs the whole table.
        """
        tables = self._build_tables(layers, full=latency_slack > 0)
        old_widths = {t.name: t.start_width for t in tables}
        l_old = sum(t.start_lat for t in tables)
        p_old = sum(t.start_par for t in tables)
        budget = latency_slack * l_old

        states = [_LayerState(t) for t in tables]
        moves: list[Move] = []
        for s in states:
            t = s.table
            ui = s.up()
            if ui is None:
                continue
            extra = float(t.lat[ui]) - s.lat
            if extra <= 1e-15:  # same wave: free capacity
                dp = t.par_at(ui) - s.par
                moves.append(Move(t.name, "up", s.width,
                                  int(t.cands[ui]), -extra, dp))
                s.move_to(ui)

        # Pass 2: spend the slack budget on wave jumps.  Each layer has one
        # live heap entry — its next jump; a popped entry that exceeds the
        # (monotonically shrinking) budget or has dp <= 0 can never become
        # valid again and is dropped for good.
        heap: list[tuple[float, int, int, float, float]] = []

        def push_next(i: int) -> None:
            s = states[i]
            t = s.table
            ui = s.up()
            if ui is None:
                return
            extra = float(t.lat[ui]) - s.lat
            dp = t.par_at(ui) - s.par
            ratio = dp / max(extra, 1e-15)
            heapq.heappush(heap, (-ratio, i, ui, extra, dp))

        if budget > 0:
            for i in range(len(states)):
                push_next(i)
        while heap and budget > 0:
            _, i, ui, extra, dp = heapq.heappop(heap)
            if extra > budget or dp <= 0:
                continue
            s = states[i]
            t = s.table
            moves.append(Move(t.name, "up", s.width,
                              int(t.cands[ui]), -extra, dp))
            s.move_to(ui)
            budget -= extra
            push_next(i)

        l_new = sum(s.lat for s in states)
        p_new = sum(s.par for s in states)
        widths = {s.table.name: s.width for s in states}
        return OptimizationResult(
            old_widths=old_widths, new_widths=widths,
            latency_old_s=l_old, latency_new_s=l_new,
            params_old=p_old, params_new=p_new,
            moves=moves, tau_final=0.0,
            satisfied=l_new <= l_old * (1 + latency_slack) + 1e-12,
        )


def discretize_pruning_space(
    layers: Sequence[TunableLayer],
    target_widths: dict[str, int],
) -> dict[str, int]:
    """Section 4.4 "Advancing Filter Pruning": replace a pruning method's
    continuous per-layer width targets with the nearest tail-free candidates,
    giving the pruner a *discrete* search space with no GPU-tail waste."""
    out = {}
    for tl in layers:
        name = tl.layer.name
        out[name] = cand.snap_nearest(tl.candidates, target_widths[name])
    return out
