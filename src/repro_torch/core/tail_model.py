"""The latency-staircase / tail-effect model, adapted from GPU waves to TPU tiles
(``repro.core.tail_model``'s counterpart; the ``"kernel"`` backend runs the
fused sweep through the port's Triton kernel on the card).

Paper Eq. 3 models one conv layer as

    L = dL * ceil(B / S),      B = threads_per_filter * F / threads_per_block

i.e. work is quantized into *waves* of S SMs and a partial last wave (the GPU
tail) costs a full cycle.  On TPU the same ceil-quantization appears at three
levels (see DESIGN.md section 2):

  1. MXU/VPU tiles:  a (M, K) x (K, N) matmul issues
         ceil(M/Tm) * ceil(K/Tk) * ceil(N/Tn)
     systolic tile passes; the residual of each dim burns a full tile.
  2. Pallas grid "waves": grid cells map onto ``cores_per_chip`` cores,
     L = dL * ceil(num_cells / cores) — literally paper Eq. 3.
  3. Mesh shards: a dim d sharded n ways costs ceil(d/n) per device; every
     device pays the max (ragged) shard.

``WaveQuantizationModel`` composes (1) and (3) into per-layer staircase
functions L(width), U(width), T(width) — the quantities the paper profiles
with nvprof — and ``GridWaveModel`` implements (2) for the Fig. 5
verification benchmark.

On a GPU the paper's own form comes back: ``CtaWaveModel`` (the port's
addition, which a ``gpu.GpuSpec`` selects through ``model_for``) is Eq. 3
over the CTA grid the port's GEMM launches, waves of S SMs times the CTAs
an SM overlaps, behind the same interface, so Algorithm 2 runs on either.

Table-driven evaluation
-----------------------
The model is closed-form, so a whole width sweep is one vectorized NumPy
expression.  ``evaluate_batch(layer, widths)`` returns a ``StairTable`` —
parallel arrays of latency / utilization / throughput / waves / FLOPs over a
width vector — and is the primitive everything else is built on:

  * ``evaluate`` is a thin one-width wrapper over ``evaluate_batch``;
  * ``profiler.analytic_profile`` is ``evaluate_batch`` plus a name tag;
  * ``latency_batch`` is the latency column alone (bit-identical, fewer
    array passes) — ``tail_optimizer`` sweeps it once per ``optimize_*``
    call to build per-layer candidate tables and then runs Algorithm 2
    entirely on table lookups, never calling back into the model inside
    its greedy loops.

Stacked model-level sweeps
--------------------------
``evaluate_batch`` is per-layer, so a 1000+-layer config still pays one
NumPy dispatch (and one Python loop iteration) per layer-shape group.  The
model-level engine stacks the whole sweep instead: layers are flattened
into padded ``(n_layers, max_candidates)`` width arrays (``pack_widths``)
and the per-layer constants — tile-padded token/d_in dims, shard counts,
dtype, flop multiplier — are broadcast as ``(n_layers, 1)`` columns
(``_LayerColumns``), so all layers x all candidate widths evaluate in ONE
stacked NumPy call:

  * ``evaluate_model_batch(layers, widths_per_layer)`` returns a
    ``ModelStairTable`` — the 2-D counterpart of ``StairTable`` with a
    per-layer ``counts`` mask; ``layer_table(i)`` slices row ``i`` back to
    a plain ``StairTable``;
  * ``latency_model_batch`` is its latency-only fast path (ragged list of
    row views), the primitive under ``tail_optimizer._build_tables`` and
    the disk-backed profile-table cache (``core.table_cache``);
  * both are chunked over row blocks so the ~10 elementwise temporaries
    stay cache-resident however many layers are stacked.

Every row is bit-for-bit equal to the per-layer ``evaluate_batch`` sweep:
the float expressions keep the exact scalar operand order, and the
exact-identity factors the per-layer path skips (shard 1, flop multiplier
1.0) are IEEE no-ops when multiplied in as columns.

This mirrors the paper's "Step 1: pre-analysis": profile (here: derive) the
per-layer L/U/T tables once, then optimize over the tables.  The float
arithmetic is ordered identically to the historical scalar path, so batched
results are bit-for-bit equal to per-width evaluation (``repro`` holds its
copy of this engine to a frozen scalar path; ``tests/test_torch_planner.py``
holds this copy to ``repro``'s).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.hardware import HardwareSpec


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _ceil_div_arr(a: np.ndarray, b: int, nonneg: bool) -> np.ndarray:
    """Elementwise ceil_div; a shift when ``b`` is a power of two and the
    numerator is known nonnegative (bit-identical, ~2x cheaper)."""
    if nonneg and b & (b - 1) == 0:
        return (a + (b - 1)) >> (b.bit_length() - 1)
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """One width-adjustable matmul layer: (tokens, d_in) @ (d_in, width).

    ``shard_in`` / ``shard_out`` are the mesh-axis sizes sharding ``d_in`` and
    ``width`` respectively (1 = unsharded).  ``tokens`` is the *per-device*
    token count (batch already sharded by data parallelism).  ``flop_multiplier``
    scales FLOPs for layers where one "width unit" does more than one MAC per
    token-input pair (e.g. GQA heads, experts).

    ``experts`` (the port's addition, read by the GPU form only) is the
    count of such products one grouped launch computes (``moe_gmm``): it
    multiplies the launch's CTAs. The TPU form folds experts into
    ``flop_multiplier``, as ``repro`` does.
    """

    name: str
    tokens: int
    d_in: int
    width: int
    shard_in: int = 1
    shard_out: int = 1
    dtype_bits: int = 16
    flop_multiplier: float = 1.0
    experts: int = 1

    def with_width(self, width: int) -> "LayerShape":
        return dataclasses.replace(self, width=width)


@dataclasses.dataclass(frozen=True)
class StairPoint:
    width: int
    latency_s: float        # modeled L
    utilization: float      # paper's U: useful / (padded quantum) work
    throughput: float       # paper's T: FLOP/s achieved
    waves: int              # ceil count along the width dim
    flops: float            # useful (model) FLOPs
    padded_flops: float     # FLOPs actually executed incl. tile padding


@dataclasses.dataclass(frozen=True)
class StairTable:
    """One layer's staircase over a width vector: parallel arrays.

    The batched counterpart of ``StairPoint`` — the paper's profiled
    (width, L, U, T) table, derived in one vectorized shot.
    """

    widths: np.ndarray        # (n,) int64
    latency_s: np.ndarray     # (n,) float64
    utilization: np.ndarray   # (n,) float64
    throughput: np.ndarray    # (n,) float64
    waves: np.ndarray         # (n,) int64
    flops: np.ndarray         # (n,) float64
    padded_flops: np.ndarray  # (n,) float64

    def __len__(self) -> int:
        return int(self.widths.size)

    def point(self, i: int) -> StairPoint:
        return StairPoint(
            width=int(self.widths[i]),
            latency_s=float(self.latency_s[i]),
            utilization=float(self.utilization[i]),
            throughput=float(self.throughput[i]),
            waves=int(self.waves[i]),
            flops=float(self.flops[i]),
            padded_flops=float(self.padded_flops[i]),
        )

    def points(self) -> list[StairPoint]:
        return [self.point(i) for i in range(len(self))]


@dataclasses.dataclass(frozen=True)
class ModelStairTable:
    """All layers x all candidate widths: one stacked sweep, 2-D arrays.

    Rows are layers, columns are candidates; rows shorter than
    ``widths.shape[1]`` are padded (pad width 1) and masked by ``counts``.
    ``layer_table(i)`` slices row ``i`` back to a per-layer ``StairTable``
    whose arrays are bit-for-bit what ``evaluate_batch`` would return.
    """

    layer_names: tuple[str, ...]
    widths: np.ndarray        # (L, C) int64, rows padded with width 1
    counts: np.ndarray        # (L,) int64: valid candidates per row
    latency_s: np.ndarray     # (L, C) float64
    utilization: np.ndarray   # (L, C) float64
    throughput: np.ndarray    # (L, C) float64
    waves: np.ndarray         # (L, C) int64
    flops: np.ndarray         # (L, C) float64
    padded_flops: np.ndarray  # (L, C) float64

    def __len__(self) -> int:
        return len(self.layer_names)

    def layer_table(self, i: int) -> StairTable:
        n = int(self.counts[i])
        return StairTable(
            widths=self.widths[i, :n],
            latency_s=self.latency_s[i, :n],
            utilization=self.utilization[i, :n],
            throughput=self.throughput[i, :n],
            waves=self.waves[i, :n],
            flops=self.flops[i, :n],
            padded_flops=self.padded_flops[i, :n],
        )


@dataclasses.dataclass(frozen=True)
class _LayerColumns:
    """Per-layer constants of the staircase math as (L, 1) columns.

    Derived quantities that the scalar path computes from ints
    (``two_mk = (2.0 * m_pad) * k_pad`` etc.) are hoisted here once per
    stack in the scalar operand order, so broadcasting them over a width
    block reproduces the per-layer float sequence exactly.  ``all_*``
    flags let the stacked core skip whole passes when a factor is the
    identity for EVERY row (the per-layer path skips them per layer; for
    mixed stacks the multiply runs everywhere and is an IEEE no-op on the
    identity rows).
    """

    shard_out: np.ndarray   # (L, 1) int64
    shard_in: np.ndarray    # (L, 1) int64
    fm: np.ndarray          # (L, 1) float64 flop_multiplier
    bits: np.ndarray        # (L, 1) int64 dtype_bits
    m_pad: np.ndarray       # (L, 1) int64
    k_pad: np.ndarray       # (L, 1) int64
    two_mk: np.ndarray      # (L, 1) float64: (2.0 * m_pad) * k_pad
    mk: np.ndarray          # (L, 1) int64: m_pad * k_pad
    k_plus_m: np.ndarray    # (L, 1) int64: k_pad + m_pad
    two_td: np.ndarray      # (L, 1) float64: (2.0 * tokens) * d_in
    all_so1: bool           # every shard_out == 1
    all_si1: bool           # every shard_in == 1
    all_fm1: bool           # every flop_multiplier == 1.0
    bytes_aligned: bool     # every dtype_bits % 8 == 0

    def block(self, sl: slice) -> "_LayerColumns":
        return dataclasses.replace(
            self, shard_out=self.shard_out[sl], shard_in=self.shard_in[sl],
            fm=self.fm[sl], bits=self.bits[sl], m_pad=self.m_pad[sl],
            k_pad=self.k_pad[sl], two_mk=self.two_mk[sl], mk=self.mk[sl],
            k_plus_m=self.k_plus_m[sl], two_td=self.two_td[sl])


# Elements per stacked row-block sweep: with ~10 float64 temporaries this
# keeps the working set around 2.5 MB (L2/L3-resident); one giant pass over
# a 1000-layer stack goes memory-bound and costs several times more per
# point.
_STACKED_CHUNK = 32768

# Staircase evaluation engines (see ``kernels.staircase_fused``):
#   numpy            exact reference — bit-for-bit vs the frozen scalar path
#   kernel           the sweep through ``kernels.ops`` on the model's
#                    ``device``: the Triton kernel on a CUDA device, its
#                    plain version on the CPU; both evaluate the numpy
#                    engine's float64 expression, so their tables equal
#                    numpy's bit for bit and Algorithm 2 breaks ties alike
BACKENDS = ("numpy", "kernel")


class _StackedSweep:
    """The sweep loop both forms share: the stacked model-level sweeps
    (``latency_model_packed``, ``latency_model_batch``,
    ``evaluate_model_batch``) in row blocks of ``_STACKED_CHUNK`` cells,
    and the one-width wrappers. A form supplies ``_stack_columns`` (its
    per-layer constants as (L, 1) columns) and two blocks over a (rows, C)
    width block: ``_latency_block`` writes the latency into ``out``;
    ``_table_block`` returns (latency, waves, utilization, throughput,
    useful FLOPs, padded FLOPs)."""

    def __init__(self, hw: HardwareSpec, backend: str = "numpy",
                 device="cuda"):
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}; expected one of {BACKENDS}")
        self.hw = hw
        self.backend = backend
        self.device = torch.device(device)
        self.eval_calls = 0    # number of evaluate/evaluate_batch calls
        self.eval_points = 0   # total widths evaluated across those calls

    def evaluate(self, layer: LayerShape) -> StairPoint:
        return self.evaluate_batch(layer, [layer.width]).point(0)

    def staircase(
        self, layer: LayerShape, widths: Sequence[int]
    ) -> list[StairPoint]:
        return self.evaluate_batch(layer, widths).points()

    @staticmethod
    def pack_widths(
        widths_per_layer: Sequence[Sequence[int]],
    ) -> tuple[np.ndarray, np.ndarray]:
        """Ragged per-layer width vectors -> padded (L, C) int64 + counts.

        Pad value is 1 (any valid width); padded cells compute ordinary
        staircase values and are masked out by ``counts`` downstream.
        """
        vecs = [np.atleast_1d(np.asarray(v, dtype=np.int64))
                for v in widths_per_layer]
        counts = np.array([v.size for v in vecs], dtype=np.int64)
        n_layers = len(vecs)
        n_cols = int(counts.max()) if n_layers else 0
        if n_layers and int(counts.min()) == n_cols:
            return (np.stack(vecs) if n_cols else
                    np.zeros((n_layers, 0), np.int64)), counts
        # empty + per-row fill: each cell written exactly once (np.ones
        # would write the whole matrix and then overwrite the data region)
        packed = np.empty((n_layers, n_cols), dtype=np.int64)
        for i, v in enumerate(vecs):
            packed[i, : v.size] = v
            packed[i, v.size:] = 1
        return packed, counts

    @staticmethod
    def _row_blocks(n_layers: int, n_cols: int):
        rows = max(1, _STACKED_CHUNK // max(1, n_cols))
        return [slice(r0, r0 + rows) for r0 in range(0, n_layers, rows)]

    def latency_model_packed(
        self,
        layers: Sequence[LayerShape],
        w2d: np.ndarray,
        counts: np.ndarray,
    ) -> np.ndarray:
        """(L, C) latency matrix for a pre-packed width matrix (rows padded
        with any valid width past ``counts[i]``; pad cells compute ordinary
        staircase values the caller masks out).  The packed core under
        ``latency_model_batch``, exposed so hot callers (the optimizer's
        table build) can fill one matrix instead of L small arrays."""
        if len(layers) != w2d.shape[0]:
            raise ValueError("one width row per layer required")
        self.eval_calls += 1
        self.eval_points += int(np.asarray(counts).sum())
        cols = self._stack_columns(layers)
        lat = np.empty(w2d.shape, dtype=np.float64)
        for sl in self._row_blocks(*w2d.shape):
            self._latency_block(cols.block(sl), w2d[sl], lat[sl])
        return lat

    def latency_model_batch(
        self,
        layers: Sequence[LayerShape],
        widths_per_layer: Sequence[Sequence[int]],
    ) -> list[np.ndarray]:
        """The latency columns of ``evaluate_model_batch`` alone — one
        stacked sweep over all layers, returned as a ragged list of row
        views (bit-identical to per-layer ``latency_batch`` calls).  This
        is the optimizer's model-level table-build fast path."""
        if len(layers) != len(widths_per_layer):
            raise ValueError("one width vector per layer required")
        w2d, counts = self.pack_widths(widths_per_layer)
        lat = self.latency_model_packed(layers, w2d, counts)
        return [lat[i, : int(counts[i])] for i in range(len(layers))]

    def evaluate_model_batch(
        self,
        layers: Sequence[LayerShape],
        widths_per_layer: Sequence[Sequence[int]],
    ) -> ModelStairTable:
        """Stacked staircase: one ``ModelStairTable`` over all layers x all
        candidate widths.  ``layer_table(i)`` is bit-for-bit what
        ``evaluate_batch(layers[i], widths_per_layer[i])`` returns;
        ``layers[i].width`` is ignored (the sweep variable is the width
        vector)."""
        if len(layers) != len(widths_per_layer):
            raise ValueError("one width vector per layer required")
        w2d, counts = self.pack_widths(widths_per_layer)
        self.eval_calls += 1
        self.eval_points += int(counts.sum())
        cols = self._stack_columns(layers)
        lat, util, thr, flops, padded = (np.empty(w2d.shape, np.float64)
                                         for _ in range(5))
        waves = np.empty(w2d.shape, dtype=np.int64)
        for sl in self._row_blocks(*w2d.shape):
            lat[sl], waves[sl], util[sl], thr[sl], flops[sl], padded[sl] = \
                self._table_block(cols.block(sl), w2d[sl])
        return ModelStairTable(
            layer_names=tuple(l.name for l in layers),
            widths=w2d, counts=counts,
            latency_s=lat, utilization=util, throughput=thr,
            waves=waves, flops=flops, padded_flops=padded,
        )


class WaveQuantizationModel(_StackedSweep):
    """Closed-form staircase model L(width) = dL * ceil(width / Q).

    ``evaluate_batch`` is the primitive; ``evaluate``/``staircase`` are thin
    wrappers over it.  ``evaluate_model_batch``/``latency_model_batch``
    stack many layers into one call (see module docstring).  ``eval_points``
    counts widths evaluated since construction (benchmark instrumentation
    for the table-driven refactor).

    ``backend`` selects the sweep engine (``BACKENDS``).  The kernel
    engine requires byte-aligned dtypes and widths >= 1 (the affine
    factoring is exact only there) and falls back to the exact numpy core
    otherwise, so every backend is total over the model's input domain.
    ``device`` is where the ``"kernel"`` backend sweeps (the card unless
    the caller asks for the CPU); the numpy backend ignores it.
    """

    @property
    def table_variant(self) -> str:
        """The table cache's name for this sweep engine: "" for the exact
        numpy engine, else the backend and its device type (their tables
        equal numpy's, but a table is only read back by the engine and
        device that wrote it)."""
        if self.backend == "numpy":
            return ""
        return f"{self.backend}-{self.device.type}"

    # ---- quanta ---------------------------------------------------------
    def width_quantum(self, shard_out: int) -> int:
        """Q: widths that are multiples of this have zero tail."""
        return shard_out * self.hw.lane

    def padded_dim(self, d: int, shard: int, tile: int) -> int:
        """Per-device padded size of dim ``d`` sharded ``shard`` ways."""
        per_dev = ceil_div(d, shard)
        return ceil_div(per_dev, tile) * tile

    # ---- per-layer staircase -------------------------------------------
    def waves(self, layer: LayerShape) -> int:
        """Tile waves along the adjustable width dim (paper's ceil(B/S))."""
        per_dev = ceil_div(layer.width, layer.shard_out)
        return ceil_div(per_dev, self.hw.lane)

    # ---- kernel backend -------------------------------------------------
    def _kernel_staircase(self, w2d, shard_out, two_mk, fm, mk, kpm, bpe):
        """Route a fused (rows, C) sweep through ``kernels.ops`` on the
        model's device; the results come back as float64/int64 NumPy."""
        from repro_torch.kernels import ops
        from repro_torch.kernels.staircase_fused import sweep_rates
        rows = w2d.shape[0]

        def put(a, dtype):
            col = np.broadcast_to(np.asarray(a, dtype=dtype), (rows, 1))
            return torch.from_numpy(col.copy()).to(self.device)

        w = torch.from_numpy(np.ascontiguousarray(w2d, dtype=np.int64)) \
            .to(self.device)
        lat, waves, _ = ops.staircase_latency(
            w, put(shard_out, np.int64), put(two_mk, np.float64),
            put(fm, np.float64), *(put(a, np.int64) for a in (mk, kpm, bpe)),
            torch.from_numpy(sweep_rates(self.hw)).to(self.device),
            lane=self.hw.lane)
        return (lat.cpu().numpy().astype(np.float64),
                waves.cpu().numpy().astype(np.int64))

    def _staircase_core_fused(self, layer: LayerShape, w: np.ndarray):
        """Per-layer fused evaluation, or None when the input is outside
        the fused domain (empty / signed widths, non-byte-aligned dtype)
        and the exact numpy core must run instead."""
        hw = self.hw
        if w.size == 0 or int(w.min()) < 1 or layer.dtype_bits % 8 != 0:
            return None
        sub = hw.sublane(layer.dtype_bits)
        m_pad = ceil_div(layer.tokens, sub) * sub
        k_pad = self.padded_dim(layer.d_in, layer.shard_in, hw.lane)
        two_mk = (2.0 * m_pad) * k_pad
        latency, n_waves = self._kernel_staircase(
            w[None, :], layer.shard_out, two_mk, layer.flop_multiplier,
            m_pad * k_pad, k_pad + m_pad, layer.dtype_bits // 8)
        latency, n_waves = latency[0], n_waves[0]
        padded_per_dev = two_mk * (n_waves * hw.lane)
        if layer.flop_multiplier != 1.0:
            padded_per_dev = padded_per_dev * layer.flop_multiplier
        return latency, n_waves, padded_per_dev, True

    def _staircase_core(self, layer: LayerShape, w: np.ndarray):
        """Shared vectorized core: (latency, n_waves, padded_per_dev, nonneg).

        The float expressions are ordered exactly as the historical scalar
        path (``repro.core.scalar_ref``) so every element is bit-for-bit
        equal to evaluating that width alone.  Multiplies/divides by
        exact-identity factors (shard 1, flop_multiplier 1.0) are skipped
        and power-of-two ceil-divs become shifts on the nonnegative fast
        path — bit-identical results, fewer/cheaper array passes.
        """
        if self.backend != "numpy":
            res = self._staircase_core_fused(layer, w)
            if res is not None:
                return res
        hw = self.hw
        sub = hw.sublane(layer.dtype_bits)
        m_pad = ceil_div(layer.tokens, sub) * sub
        k_pad = self.padded_dim(layer.d_in, layer.shard_in, hw.lane)
        nonneg = w.size == 0 or int(w.min()) >= 1
        per_dev = w if layer.shard_out == 1 else \
            _ceil_div_arr(w, layer.shard_out, nonneg)
        n_waves = _ceil_div_arr(per_dev, hw.lane, nonneg)
        n_pad = n_waves * hw.lane

        # Per-device padded work (d_in and width divided across shards).
        padded_per_dev = 2.0 * m_pad * k_pad * n_pad
        if layer.flop_multiplier != 1.0:
            padded_per_dev = padded_per_dev * layer.flop_multiplier

        compute_s = padded_per_dev / hw.peak_flops_bf16
        # == (m_pad*k_pad + k_pad*n_pad + m_pad*n_pad) * bits // 8, with the
        # n_pad terms factored and the //8 folded into the multiplier for
        # byte-aligned dtypes (both exact in int64).
        elems = m_pad * k_pad + (k_pad + m_pad) * n_pad
        if layer.dtype_bits % 8 == 0:
            bytes_per_dev = elems * (layer.dtype_bits // 8)
        else:
            bytes_per_dev = elems * layer.dtype_bits // 8
        memory_s = bytes_per_dev / hw.hbm_bandwidth
        latency = np.maximum(compute_s, memory_s)
        return latency, n_waves, padded_per_dev, nonneg

    def latency_batch(self, layer: LayerShape,
                      widths: Sequence[int]) -> np.ndarray:
        """The latency column of ``evaluate_batch`` alone — identical math
        and bit-identical values, skipping the utilization / throughput /
        FLOPs columns.  This is the optimizer's table-build fast path (its
        tables only need L and params)."""
        w = np.atleast_1d(np.asarray(widths, dtype=np.int64))
        self.eval_calls += 1
        self.eval_points += int(w.size)
        return self._staircase_core(layer, w)[0]

    def evaluate_batch(self, layer: LayerShape,
                       widths: Sequence[int]) -> StairTable:
        """Vectorized staircase: one ``StairTable`` over a width vector.

        Every row is bit-for-bit equal to evaluating that width alone (the
        frozen scalar path ``repro.core.scalar_ref``).  ``layer.width``
        is ignored; the sweep variable is ``widths``.
        """
        w = np.atleast_1d(np.asarray(widths, dtype=np.int64))
        self.eval_calls += 1
        self.eval_points += int(w.size)
        latency, n_waves, padded_per_dev, nonneg = \
            self._staircase_core(layer, w)

        useful = 2.0 * layer.tokens * layer.d_in * w
        if layer.flop_multiplier != 1.0:
            useful = useful * layer.flop_multiplier
        padded_total = padded_per_dev
        if layer.shard_in != 1:
            padded_total = padded_total * layer.shard_in
        if layer.shard_out != 1:
            padded_total = padded_total * layer.shard_out

        if nonneg:
            # widths >= 1 ⇒ n_pad >= lane ⇒ padded/latency strictly positive
            util = useful / padded_total
            thr = useful / latency
        else:
            util = np.divide(useful, padded_total,
                             out=np.zeros_like(useful),
                             where=padded_total != 0.0)
            thr = np.divide(useful, latency,
                            out=np.zeros_like(useful),
                            where=latency != 0.0)
        return StairTable(
            widths=w,
            latency_s=latency,
            utilization=util,
            throughput=thr,
            waves=n_waves,
            flops=useful,
            padded_flops=padded_total,
        )

    def staircase_arrays(self, layer: LayerShape, widths: Sequence[int]):
        t = self.evaluate_batch(layer, widths)
        return t.widths, t.latency_s, t.utilization, t.throughput

    # ---- stacked model-level sweep (driven by ``_StackedSweep``) ------
    def _stack_columns(self, layers: Sequence[LayerShape]) -> _LayerColumns:
        hw = self.hw

        def col(vals, dtype):
            return np.asarray(vals, dtype=dtype)[:, None]

        tokens = col([l.tokens for l in layers], np.int64)
        d_in = col([l.d_in for l in layers], np.int64)
        shard_in = col([l.shard_in for l in layers], np.int64)
        shard_out = col([l.shard_out for l in layers], np.int64)
        bits = col([l.dtype_bits for l in layers], np.int64)
        fm = col([l.flop_multiplier for l in layers], np.float64)
        sub = np.where(bits >= 32, hw.sublane_fp32, hw.sublane_bf16)
        m_pad = -(-tokens // sub) * sub
        k_pad = -(-(-(-d_in // shard_in)) // hw.lane) * hw.lane
        return _LayerColumns(
            shard_out=shard_out, shard_in=shard_in, fm=fm, bits=bits,
            m_pad=m_pad, k_pad=k_pad,
            two_mk=(2.0 * m_pad) * k_pad,
            mk=m_pad * k_pad,
            k_plus_m=k_pad + m_pad,
            two_td=(2.0 * tokens) * d_in,
            all_so1=bool((shard_out == 1).all()) if len(layers) else True,
            all_si1=bool((shard_in == 1).all()) if len(layers) else True,
            all_fm1=bool((fm == 1.0).all()) if len(layers) else True,
            bytes_aligned=bool((bits % 8 == 0).all()) if len(layers) else True,
        )

    def _stacked_fused(self, cols: _LayerColumns, w: np.ndarray,
                       need_padded: bool, out):
        """Stacked fused evaluation, or None when outside the fused domain
        (see ``_staircase_core_fused``)."""
        if w.size == 0 or not cols.bytes_aligned or int(w.min()) < 1:
            return None
        latency, n_waves = self._kernel_staircase(
            w, cols.shard_out, cols.two_mk, cols.fm, cols.mk, cols.k_plus_m,
            cols.bits // 8)
        if out is not None:
            out[...] = latency
            latency = out
        padded_per_dev = None
        if need_padded:
            padded_per_dev = cols.two_mk * (n_waves * self.hw.lane)
            if not cols.all_fm1:
                padded_per_dev = padded_per_dev * cols.fm
        return latency, n_waves, padded_per_dev, True

    def _staircase_core_stacked(self, cols: _LayerColumns, w: np.ndarray,
                                need_padded: bool = True, out=None):
        """Stacked counterpart of ``_staircase_core`` over a (rows, C) width
        block with (rows, 1) layer-constant columns.

        Same float operand order as the scalar path; identity factors the
        per-layer path skips are multiplied in uniformly (IEEE no-ops on
        the identity rows), so every element is bit-for-bit equal to the
        per-layer sweep of its row.

        ``need_padded=False`` lets the kernel backend skip the
        padded-FLOPs pass (latency-only callers); ``out`` receives the
        latency block in place when given.  The numpy path always computes
        padded FLOPs (it is an intermediate of the latency there anyway).
        """
        if self.backend != "numpy":
            res = self._stacked_fused(cols, w, need_padded, out)
            if res is not None:
                return res
        hw = self.hw
        nonneg = w.size == 0 or int(w.min()) >= 1
        per_dev = w if cols.all_so1 else -(-w // cols.shard_out)
        n_waves = _ceil_div_arr(per_dev, hw.lane, nonneg)
        n_pad = n_waves * hw.lane

        padded_per_dev = cols.two_mk * n_pad
        if not cols.all_fm1:
            padded_per_dev = padded_per_dev * cols.fm

        compute_s = padded_per_dev / hw.peak_flops_bf16
        elems = cols.mk + cols.k_plus_m * n_pad
        if cols.bytes_aligned:
            bytes_per_dev = elems * (cols.bits // 8)
        else:
            bytes_per_dev = elems * cols.bits // 8
        memory_s = bytes_per_dev / hw.hbm_bandwidth
        latency = np.maximum(compute_s, memory_s, out=out)
        return latency, n_waves, padded_per_dev, nonneg

    def _latency_block(self, cols: _LayerColumns, w: np.ndarray,
                       out: np.ndarray) -> None:
        self._staircase_core_stacked(cols, w, need_padded=False, out=out)

    def _table_block(self, blk: _LayerColumns, w: np.ndarray):
        latency, n_waves, padded_per_dev, nonneg = \
            self._staircase_core_stacked(blk, w)
        useful = blk.two_td * w
        if not blk.all_fm1:
            useful = useful * blk.fm
        padded_total = padded_per_dev
        if not blk.all_si1:
            padded_total = padded_total * blk.shard_in
        if not blk.all_so1:
            padded_total = padded_total * blk.shard_out
        if nonneg:
            util = useful / padded_total
            thr = useful / latency
        else:
            util = np.divide(useful, padded_total,
                             out=np.zeros_like(useful),
                             where=padded_total != 0.0)
            thr = np.divide(useful, latency, out=np.zeros_like(useful),
                            where=latency != 0.0)
        return latency, n_waves, util, thr, useful, padded_total


# ---------------------------------------------------------------------------
# The GPU form: paper Eq. 3 over a non-persistent GEMM's CTA grid
# ---------------------------------------------------------------------------
# The CTAs an SM runs at once *and* overlaps, per form of the port's GEMM
# (``csrc/gemm_sm90.cuh``): a wave holds S x this many CTAs. Fixed from
# the card's Fig. 5 sweep (``launch/wave_verification.py``; PERF.md §6):
# the prefill form runs one CTA an SM (``matmul_tiled.FORMS``), and its
# sweep steps at every S CTAs and is flat in between. (When two CTAs
# shared an SM they took 1.6-1.8x one's time and the sweep ramped inside
# every stair, which no slot count fits.) The decode value is the form's
# occupancy and nothing more: the decode sweep is bound by its bytes and
# shows no stair, so no sweep has fixed it.
EFFECTIVE_CTAS_PER_SM = {"prefill": 1, "decode": 3}


@dataclasses.dataclass(frozen=True)
class CtaForm:
    """One layer's CTA grid as a function of its width: B = g * tiles, with
    tiles = ceil(ceil(width / shard_out) / block_n)."""

    g: int              # CTAs per column tile: row tiles x K chunks x experts
    slots: int          # CTAs in one wave: S x the effective CTAs an SM
    block_n: int        # output columns per CTA
    m_pad: int          # rows as the CTAs cover them
    k_pad: int          # K as the CTAs cover it (chunks x chunk)
    tile_flops: float   # 2 x block_m x block_n x K of one CTA
    rate: float = 1.0   # a CTA's share of an SM's peak: dL divides by
    #                     it (1, Eq. 3 at the peak, unless a caller sets
    #                     ``autotune.tile_rate``)


def cta_form(hw: HardwareSpec, layer: LayerShape, tile=None) -> CtaForm:
    """``layer``'s CTA grid on ``hw`` on ``tile`` (the launch's default
    when None): the port's GEMM as it launches
    (``kernels.matmul_tiled.grid_blocks``, ``kernels.moe_gmm.grid_blocks``
    for experts > 1)."""
    from repro_torch.kernels import matmul_tiled as mt
    from repro_torch.kernels import moe_gmm
    k_dev = ceil_div(layer.d_in, layer.shard_in)
    decode, chunks = mt.kernel_form(layer.tokens, k_dev)
    bm, bn = mt.launch_tile(layer.tokens, tile)
    k_cta = mt.SPLIT_K if decode else ceil_div(k_dev, mt.BLOCK_K) \
        * mt.BLOCK_K
    g = mt.grid_blocks(layer.tokens, 1, k_dev, tile) \
        if layer.experts == 1 else \
        moe_gmm.grid_blocks(layer.experts, layer.tokens, 1, k_dev, tile)
    c = EFFECTIVE_CTAS_PER_SM["decode" if decode else "prefill"]
    return CtaForm(g=g, slots=hw.cores_per_chip * c, block_n=bn,
                   m_pad=ceil_div(layer.tokens, bm) * bm,
                   k_pad=chunks * k_cta, tile_flops=(2.0 * bm) * bn * k_cta)


@dataclasses.dataclass(frozen=True)
class _CtaColumns:
    """Per-layer constants of the CTA-wave math as (L, 1) columns."""

    shard_out: np.ndarray   # int64
    g: np.ndarray           # int64: CTAs per column tile
    slots: np.ndarray       # int64: CTAs a wave
    dl: np.ndarray          # float64: one wave's time, slots x tile FLOPs
    #                         x flop_multiplier / peak (paper Eq. 3's dL)
    mk: np.ndarray          # int64: m_pad x k_pad
    k_plus_m: np.ndarray    # int64: k_pad + m_pad
    bits: np.ndarray        # int64
    experts: np.ndarray     # int64
    wave_flops: np.ndarray  # float64: one wave's FLOPs on all shards
    useful: np.ndarray      # float64: useful FLOPs per unit of width
    block_n: int
    bytes_aligned: bool

    def block(self, sl: slice) -> "_CtaColumns":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name)[sl]
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), np.ndarray)})

    @staticmethod
    def stack(parts: Sequence["_CtaColumns"]) -> "_CtaColumns":
        """The rows of ``parts`` one after another (one ``block_n``)."""
        return dataclasses.replace(parts[0], **{
            f.name: np.concatenate([getattr(c, f.name) for c in parts])
            for f in dataclasses.fields(parts[0])
            if isinstance(getattr(parts[0], f.name), np.ndarray)},
            bytes_aligned=all(c.bytes_aligned for c in parts))


@dataclasses.dataclass(frozen=True)
class _TiledColumns:
    """``CtaWaveModel``'s columns with ``tile_hw``: one ``_CtaColumns``
    per tile slot (slot i of a row is its i-th candidate tile, the last
    repeated where a row has fewer), and per row what the autotuner's pick
    reads: (kernel, experts, tokens, K per device, dtype bits)."""

    slots: tuple            # of _CtaColumns, each (L, 1)
    picks: tuple            # per row: (kernel, e, m, k_dev, bits)

    def block(self, sl: slice) -> "_TiledColumns":
        return _TiledColumns(tuple(c.block(sl) for c in self.slots),
                             self.picks[sl])


class CtaWaveModel(_StackedSweep):
    """Paper Eq. 3 over the grid a GEMM launches: the tail model's GPU
    form, which a ``gpu.GpuSpec`` selects.

    For a layer of width w (per device ceil(w / shard_out)), the port's
    GEMM launches B = g * tiles CTAs, tiles = ceil(per_dev / block_n) and g
    = row tiles x K chunks (x experts), exactly
    ``matmul_tiled.grid_blocks(tokens, per_dev, ceil(d_in / shard_in))``
    (``moe_gmm.grid_blocks`` for experts > 1). They run in
    waves = ceil(B / (S * c)) of S SMs (``hw.cores_per_chip``) and c CTAs
    an SM (``EFFECTIVE_CTAS_PER_SM``, from the card's own sweep), and

        latency = max(waves * dL, bytes / bandwidth),

    dL one wave's tile FLOPs (c tiles at one SM's share of the peak, times
    ``flop_multiplier``), the bytes those of ``WaveQuantizationModel`` over
    the CTAs' padded M, K and N (times experts). Utilization is the useful
    FLOPs over the wave's slots' FLOPs, so Eq. 4's argmax(U x T) lands on
    the right edges of the CTA-wave stairs.

    It answers what ``TailEffectOptimizer``, ``candidates`` and
    ``table_cache`` call on ``WaveQuantizationModel``, so Algorithm 2 runs
    on it unchanged. ``backend`` "numpy" is the exact engine; "kernel"
    sweeps through ``ops.staircase_cta_latency`` on ``device`` (the Triton
    kernel on a CUDA device, its plain version on the CPU; both the numpy
    core's float64 expression, so bit for bit its values), falling back
    to numpy outside the kernel's domain (widths below 1, dtypes that are
    not whole bytes), as ``WaveQuantizationModel`` does. Every stacked row
    is bit-for-bit the per-layer sweep: both run the same stacked core.

    Each width is priced on the tile its GEMM launches. Without
    ``tile_hw`` that is the default tile, as a launch outside
    ``ops.kernel_context`` takes. With ``tile_hw`` (a GPU spec) it is the
    tile the autotuner picks on that spec at that width
    (``autotune.gemm_tile_picks``), as a step cache built with
    ``hw=tile_hw`` launches: B, the waves and the padded bytes are that
    tile's, and dL is divided by the tile's measured share of an SM's peak
    (``autotune.tile_rate``), so at ``flop_multiplier`` 1 and one shard a
    width's latency is the autotuner's ``latency_s`` for its pick. A sweep
    then evaluates every candidate tile in one pass of the core (one
    kernel launch) and keeps the pick at each width.
    """

    def __init__(self, hw: HardwareSpec, backend: str = "numpy",
                 device="cuda", tile_hw=None):
        super().__init__(hw, backend=backend, device=device)
        self.tile_hw = tile_hw

    @property
    def table_variant(self) -> str:
        """The table cache's name for this model: the CTA-wave form, its
        effective CTAs an SM, the tiles it prices and the sweep engine, so
        a TPU-form table never answers it, nor one of another engine, c or
        tile set."""
        c = EFFECTIVE_CTAS_PER_SM
        form = f"cta-gemm-c{c['prefill']}.{c['decode']}"
        if self.tile_hw is not None:
            from repro_torch.core.table_cache import hardware_fingerprint
            form += f"-tiles-{hardware_fingerprint(self.tile_hw)}"
        if self.backend == "numpy":
            return form
        return f"{form}-{self.backend}-{self.device.type}"

    def tile(self, layer: LayerShape) -> tuple:
        """The tile ``layer``'s GEMM launches at ``layer.width``."""
        from repro_torch.kernels import matmul_tiled as mt
        from repro_torch.kernels.autotune import gemm_tile_picks
        if self.tile_hw is None:
            return mt.launch_tile(layer.tokens)
        tiles, pick = gemm_tile_picks(
            "matmul" if layer.experts == 1 else "moe_gmm", self.tile_hw,
            layer.experts, layer.tokens,
            ceil_div(layer.d_in, layer.shard_in),
            np.array([ceil_div(layer.width, layer.shard_out)]),
            layer.dtype_bits)
        return tiles[int(pick[0])]

    def form(self, layer: LayerShape) -> CtaForm:
        """``layer``'s CTA form on the tile it launches at its width."""
        if self.tile_hw is None:
            return cta_form(self.hw, layer)
        return self._tile_form(layer, self.tile(layer))

    def _tile_form(self, layer: LayerShape, tile) -> CtaForm:
        from repro_torch.kernels.autotune import tile_rate
        return dataclasses.replace(
            cta_form(self.hw, layer, tile), rate=tile_rate(
                layer.tokens, ceil_div(layer.d_in, layer.shard_in), tile))

    def width_quantum(self, shard_out: int) -> int:
        """Widths that are multiples of this leave no partly filled CTA
        tile (the stairs' edges are multiples of it)."""
        from repro_torch.kernels.matmul_tiled import BLOCK_N
        return shard_out * BLOCK_N

    def blocks(self, layer: LayerShape) -> int:
        """B of paper Eq. 3 at ``layer.width``."""
        f = self.form(layer)
        return f.g * ceil_div(ceil_div(layer.width, layer.shard_out),
                              f.block_n)

    def waves(self, layer: LayerShape) -> int:
        return ceil_div(self.blocks(layer), self.form(layer).slots)

    # ---- columns and the stacked core ------------------------------------
    def _stack_columns(self, layers: Sequence[LayerShape]):
        if self.tile_hw is None:
            return self._columns(layers, [self.form(l) for l in layers])
        from repro_torch.kernels.autotune import gemm_candidates
        picks, cands = [], []
        for l in layers:
            k_dev = ceil_div(l.d_in, l.shard_in)
            picks.append(("matmul" if l.experts == 1 else "moe_gmm",
                          l.experts, l.tokens, k_dev, l.dtype_bits))
            cands.append(gemm_candidates(self.tile_hw, l.tokens, k_dev))
        n_slots = max((len(c) for c in cands), default=1)
        slots = tuple(self._columns(layers, [
            self._tile_form(l, c[min(i, len(c) - 1)])
            for l, c in zip(layers, cands)]) for i in range(n_slots))
        return _TiledColumns(slots, tuple(picks))

    def _columns(self, layers: Sequence[LayerShape],
                 forms: Sequence[CtaForm]) -> _CtaColumns:
        hw = self.hw
        bns = {f.block_n for f in forms}
        if len(bns) > 1:
            raise ValueError(f"one block_n per sweep, got {sorted(bns)}")

        def col(vals, dtype):
            return np.asarray(vals, dtype=dtype).reshape(-1, 1)

        fm = col([l.flop_multiplier for l in layers], np.float64)
        slots = col([f.slots for f in forms], np.int64)
        tile = col([f.tile_flops for f in forms], np.float64)
        m_pad = col([f.m_pad for f in forms], np.int64)
        k_pad = col([f.k_pad for f in forms], np.int64)
        bits = col([l.dtype_bits for l in layers], np.int64)
        experts = col([l.experts for l in layers], np.int64)
        shards = col([l.shard_in * l.shard_out for l in layers], np.float64)
        wave = (slots * tile) * fm
        rate = col([f.rate for f in forms], np.float64)
        useful = ((2.0 * col([l.tokens for l in layers], np.int64))
                  * col([l.d_in for l in layers], np.int64)) * fm * experts
        return _CtaColumns(
            shard_out=col([l.shard_out for l in layers], np.int64),
            g=col([f.g for f in forms], np.int64), slots=slots,
            dl=wave / hw.peak_flops_bf16 / rate, mk=m_pad * k_pad,
            k_plus_m=k_pad + m_pad, bits=bits, experts=experts,
            wave_flops=wave * shards, useful=useful,
            block_n=bns.pop() if bns else hw.lane,
            bytes_aligned=bool((bits % 8 == 0).all()))

    def _core(self, cols, w: np.ndarray):
        """(latency, waves, tiles, one wave's FLOPs on all shards) over a
        (rows, C) width block; with ``tile_hw`` every tile slot in one
        pass, then the autotuner's pick at each width."""
        if isinstance(cols, _CtaColumns):
            return self._tile_core(cols, w) + (cols.wave_flops,)
        from repro_torch.kernels.autotune import gemm_tile_picks
        n = len(cols.slots)
        lat, waves, tiles = (a.reshape((n,) + w.shape) for a in
                             self._tile_core(_CtaColumns.stack(cols.slots),
                                             np.concatenate([w] * n)))
        shard_out = cols.slots[0].shard_out
        pick = np.empty(w.shape, dtype=np.int64)
        for r, (kernel, e, m, k_dev, bits) in enumerate(cols.picks):
            pick[r] = gemm_tile_picks(kernel, self.tile_hw, e, m, k_dev,
                                      -(-w[r] // shard_out[r]), bits)[1]
        flops = np.stack([np.broadcast_to(c.wave_flops, w.shape)
                          for c in cols.slots])

        def take(a):
            return np.take_along_axis(a, pick[None], 0)[0]
        return take(lat), take(waves), tiles[0], take(flops)

    def _tile_core(self, cols: _CtaColumns, w: np.ndarray):
        """(latency, waves, tiles) over a (rows, C) width block."""
        if self.backend != "numpy" and w.size and cols.bytes_aligned \
                and int(w.min()) >= 1:
            return self._kernel_core(cols, w)
        hw, bn = self.hw, cols.block_n
        per_dev = -(-w // cols.shard_out)
        tiles = -(-per_dev // bn)
        waves = -(-(cols.g * tiles) // cols.slots)
        compute_s = waves * cols.dl
        elems = cols.mk + cols.k_plus_m * (tiles * bn)
        if cols.bytes_aligned:
            nbytes = elems * (cols.bits // 8) * cols.experts
        else:
            nbytes = elems * cols.bits // 8 * cols.experts
        return np.maximum(compute_s, nbytes / hw.hbm_bandwidth), waves, tiles

    KERNEL_COLUMNS = ("shard_out", "g", "slots", "dl", "mk", "kpm", "bpe")

    def _kernel_columns(self, cols: _CtaColumns) -> dict:
        """The CTA-wave kernel's (L, 1) columns (``KERNEL_COLUMNS``): the
        numpy core's own, with ``bpe`` the bytes an element times the
        experts (byte-aligned dtypes), and the (1,) bandwidth (``dl``
        already carries the peak)."""
        return {"shard_out": cols.shard_out, "g": cols.g,
                "slots": cols.slots, "dl": cols.dl, "mk": cols.mk,
                "kpm": cols.k_plus_m,
                "bpe": (cols.bits // 8) * cols.experts,
                "bandwidth": np.array([self.hw.hbm_bandwidth], np.float64)}

    def kernel_columns(self, layers: Sequence[LayerShape]) -> dict:
        """The kernel backend's per-layer columns for ``layers`` (numpy,
        (L, 1)), the bandwidth and its ``block_n``: what
        ``ops.staircase_cta_latency`` takes beside the widths; with
        ``tile_hw``, the rows of every tile slot, slot after slot."""
        cols = self._stack_columns(layers)
        if isinstance(cols, _TiledColumns):
            cols = _CtaColumns.stack(cols.slots)
        return dict(self._kernel_columns(cols), block_n=cols.block_n)

    def _kernel_core(self, cols: _CtaColumns, w: np.ndarray):
        """The sweep through ``kernels.ops`` on the model's device."""
        from repro_torch.kernels import ops
        rows = w.shape[0]

        def put(a, dtype):
            a = np.broadcast_to(np.asarray(a, dtype=dtype), (rows, 1))
            return torch.from_numpy(a.copy()).to(self.device)

        k = self._kernel_columns(cols)
        lat, waves, tiles = ops.staircase_cta_latency(
            torch.from_numpy(np.ascontiguousarray(w, dtype=np.int64))
            .to(self.device),
            *(put(k[n], np.float64 if n == "dl" else np.int64)
              for n in self.KERNEL_COLUMNS),
            torch.from_numpy(k["bandwidth"]).to(self.device),
            block_n=cols.block_n)
        return (lat.cpu().numpy().astype(np.float64),
                waves.cpu().numpy().astype(np.int64),
                tiles.cpu().numpy().astype(np.int64))

    # ---- the blocks ``_StackedSweep`` drives ----------------------------
    def _latency_block(self, cols, w: np.ndarray, out: np.ndarray) -> None:
        out[...] = self._core(cols, w)[0]

    def _table_block(self, blk, w: np.ndarray):
        latency, n_waves, _, wave_flops = self._core(blk, w)
        useful = (blk.slots[0] if isinstance(blk, _TiledColumns)
                  else blk).useful * w
        padded_total = n_waves * wave_flops
        util = np.divide(useful, padded_total, out=np.zeros_like(useful),
                         where=padded_total != 0.0)
        thr = np.divide(useful, latency, out=np.zeros_like(useful),
                        where=latency != 0.0)
        return latency, n_waves, util, thr, useful, padded_total

    def evaluate_batch(self, layer: LayerShape,
                       widths: Sequence[int]) -> StairTable:
        """One layer's ``StairTable`` over a width vector: the stacked
        sweep's single row (``layer.width`` is ignored)."""
        w = np.atleast_1d(np.asarray(widths, dtype=np.int64))
        return self.evaluate_model_batch([layer], [w]).layer_table(0)

    def latency_batch(self, layer: LayerShape,
                      widths: Sequence[int]) -> np.ndarray:
        """The latency column of ``evaluate_batch`` alone."""
        return self.latency_model_batch([layer], [widths])[0]


def model_for(hw: HardwareSpec, backend: str = "numpy", device="cuda",
              tile_hw=None):
    """The tail model ``hw`` selects: ``CtaWaveModel`` on a GPU spec
    (``gpu.GpuSpec``), pricing the tiles the autotuner picks on
    ``tile_hw`` where that is a GPU spec too (the default tile otherwise);
    ``WaveQuantizationModel`` on a TPU's."""
    from repro_torch.core.gpu import is_gpu
    if not is_gpu(hw):
        return WaveQuantizationModel(hw, backend=backend, device=device)
    return CtaWaveModel(hw, backend=backend, device=device,
                        tile_hw=tile_hw if tile_hw is not None
                        and is_gpu(tile_hw) else None)


@dataclasses.dataclass(frozen=True)
class GridWave:
    blocks: int     # B: number of grid cells (thread blocks in the paper)
    waves: int      # W: ceil(B / S)
    latency_s: float  # L = dL * W


class GridWaveModel:
    """Paper Eq. 3 verbatim, for a kernel grid.

    A ``pallas_call`` with grid (gm, gn, gk) issues B = gm*gn*gk cells; cells
    are scheduled onto ``cores_per_chip`` cores, so L = dL * ceil(B / S).
    This is the direct TPU transcription of the paper's block->SM wave model
    and is what ``benchmarks/wave_verification.py`` checks against the
    analytic staircase (paper Fig. 5's B / W / L panels).

    ``ctas_per_sm`` (the port's addition) is the blocks an SM runs at
    once: a wave is ``cores_per_chip * ctas_per_sm`` blocks. On a GPU spec
    dL is their FLOPs at the chip's peak (``ctas_per_sm`` blocks at one
    SM's share of it); on a TPU spec it is ``ctas_per_sm`` cells at the
    chip's peak, so the default of 1 is ``repro``'s dL for every TPU spec.
    """

    def __init__(self, hw: HardwareSpec, block_flops: float,
                 ctas_per_sm: int = 1):
        from repro_torch.core.gpu import is_gpu
        self.hw = hw
        self.block_flops = block_flops
        self.ctas_per_sm = ctas_per_sm
        self.slots = hw.cores_per_chip * ctas_per_sm
        blocks = self.slots if is_gpu(hw) else ctas_per_sm
        self.delta_l = (blocks * block_flops) / hw.peak_flops_bf16

    def blocks_for(self, m: int, n: int, k: int, bm: int, bn: int, bk: int) -> int:
        return ceil_div(m, bm) * ceil_div(n, bn) * ceil_div(k, bk)

    def evaluate(self, blocks: int) -> GridWave:
        waves = ceil_div(blocks, self.slots)
        return GridWave(blocks=blocks, waves=waves,
                        latency_s=self.delta_l * waves)


def staircase_edges(widths: np.ndarray, latency: np.ndarray) -> np.ndarray:
    """Right edges of each stair: the last width before latency increases.

    These are the paper's profile-derived optimal candidates (Fig. 6: the
    right edge point has max utilization and max throughput within a wave).
    """
    widths = np.asarray(widths, dtype=np.int64)
    latency = np.asarray(latency)
    if widths.size == 0:
        return np.array([], dtype=np.int64)
    rises = latency[1:] > latency[:-1] * (1 + 1e-9)
    edges = np.append(widths[:-1][rises], widths[-1])
    return np.unique(edges)
