"""Per-layer L/U/T table builders — the paper's "Step 1: pre-analysis"
(``repro.core.profiler``'s counterpart).

The paper profiles each layer's latency / SM-utilization / throughput over a
width sweep with nvprof. The port derives the same tables from four
sources:

  * ``analytic``  — the tail model ``hw`` selects (``tail_model.model_for``:
                    ``CtaWaveModel`` on a GPU spec, ``WaveQuantizationModel``
                    on a TPU's);
  * ``flop``      — ``torch.utils.flop_counter.FlopCounterMode`` over the
                    layer's product at each width, on meta tensors (the
                    counterpart of ``repro``'s ``hlo_profile``, which reads
                    XLA's ``cost_analysis``): the counted FLOPs are the
                    useful work, the model supplies the quantization;
  * ``grid``      — the CTA count of the port's GEMM (``matmul_tiled``'s
                    ``grid_blocks``) through ``GridWaveModel``: the literal
                    ceil(B / S) of paper Eq. 3 (``repro``'s
                    ``pallas_grid_profile``);
  * ``measured``  — the paper's nvprof step on the card: ``ops.matmul``
                    timed at each width (``measured_profile``).

``analytic_profile_stack`` profiles a whole model (all layers x all widths)
in one stacked sweep; persisting these tables across processes is
``core.table_cache``'s job.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.tail_model import (
    CtaWaveModel, GridWaveModel, LayerShape, ceil_div, cta_form, model_for,
)


@dataclasses.dataclass
class LayerProfile:
    name: str
    widths: np.ndarray
    latency_s: np.ndarray
    utilization: np.ndarray
    throughput: np.ndarray
    waves: np.ndarray
    source: str
    # measured: the max - min of each width's timed replays (the port's
    # addition; None for a derived profile)
    spread_s: Optional[np.ndarray] = None

    def as_table(self) -> str:
        rows = ["width,latency_us,utilization,throughput_tflops,waves"]
        for i in range(len(self.widths)):
            rows.append(
                f"{self.widths[i]},{self.latency_s[i] * 1e6:.4f},"
                f"{self.utilization[i]:.4f},"
                f"{self.throughput[i] / 1e12:.4f},{self.waves[i]}"
            )
        return "\n".join(rows)


def analytic_profile_stack(
    hw: HardwareSpec,
    layers: Sequence[LayerShape],
    widths_per_layer: Sequence[Sequence[int]],
) -> list[LayerProfile]:
    """All layers x all widths in ONE stacked model call; each returned
    profile is bit-for-bit what the per-layer sweep yields."""
    stacked = model_for(hw).evaluate_model_batch(layers, widths_per_layer)
    out = []
    for i, layer in enumerate(layers):
        t = stacked.layer_table(i)
        out.append(LayerProfile(
            name=layer.name, widths=t.widths, latency_s=t.latency_s,
            utilization=t.utilization, throughput=t.throughput,
            waves=t.waves, source="analytic"))
    return out


def analytic_profile(hw: HardwareSpec, layer: LayerShape,
                     widths: Sequence[int]) -> LayerProfile:
    """One-layer wrapper over the stacked engine — no per-width loop."""
    return analytic_profile_stack(hw, [layer], [widths])[0]


def flop_profile(hw: HardwareSpec, layer: LayerShape,
                 widths: Sequence[int]) -> LayerProfile:
    """Count the FLOPs of (tokens, d_in) @ (d_in, w) per width with
    ``FlopCounterMode`` on meta tensors (nothing is computed); the model
    supplies latency, padding and waves, as ``repro``'s ``hlo_profile``
    takes them from its analytic overlay."""
    from torch.utils.flop_counter import FlopCounterMode

    tbl = model_for(hw).evaluate_batch(layer, widths)
    x = torch.empty((layer.tokens, layer.d_in), dtype=torch.bfloat16,
                    device="meta")
    lat, util, thr, wav = [], [], [], []
    for i, w in enumerate(widths):
        wt = torch.empty((layer.d_in, int(w)), dtype=torch.bfloat16,
                         device="meta")
        counter = FlopCounterMode(display=False)
        with counter:
            torch.mm(x, wt)
        useful = float(counter.get_total_flops())
        pt = tbl.point(i)
        lat.append(pt.latency_s)
        util.append(useful / pt.padded_flops if pt.padded_flops else 0.0)
        thr.append(useful / pt.latency_s if pt.latency_s else 0.0)
        wav.append(pt.waves)
    return LayerProfile(
        name=layer.name, widths=np.asarray(list(widths)),
        latency_s=np.asarray(lat), utilization=np.asarray(util),
        throughput=np.asarray(thr), waves=np.asarray(wav), source="flop")


def grid_profile(hw: HardwareSpec, layer: LayerShape,
                 widths: Sequence[int]) -> LayerProfile:
    """Wave counts of the port's GEMM grid (``matmul_tiled.grid_blocks``,
    the decode form's K chunks included) through ``GridWaveModel`` with
    the effective CTAs an SM of ``CtaWaveModel``: dL is one CTA's tile
    FLOPs, the latency its waves, with no bytes term."""
    from repro_torch.kernels import matmul_tiled as mt

    k_dev = ceil_div(layer.d_in, layer.shard_in)
    form = cta_form(hw, layer)
    gw = GridWaveModel(hw, form.tile_flops * layer.flop_multiplier,
                       ctas_per_sm=form.slots // hw.cores_per_chip)
    lat, util, thr, wav = [], [], [], []
    for w in widths:
        b = mt.grid_blocks(layer.tokens, ceil_div(int(w), layer.shard_out),
                           k_dev)
        g = gw.evaluate(b)
        useful = 2.0 * layer.tokens * layer.d_in * w * layer.flop_multiplier
        padded = g.waves * gw.slots * gw.block_flops * layer.shard_out \
            * layer.shard_in
        lat.append(g.latency_s)
        util.append(min(useful / padded, 1.0) if padded else 0.0)
        thr.append(useful / g.latency_s if g.latency_s else 0.0)
        wav.append(g.waves)
    return LayerProfile(
        name=layer.name, widths=np.asarray(list(widths)),
        latency_s=np.asarray(lat), utilization=np.asarray(util),
        throughput=np.asarray(thr), waves=np.asarray(wav), source="grid")


def time_graph_ms(fn, reps: int = 20, repeats: int = 5) -> list[float]:
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, each of ``repeats`` replays timed with CUDA events (so the
    host's launch cost does not count). Needs a CUDA device."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                # warm-up before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    del graph
    return out


def bf16_operands(m: int, k: int, n: int, device, seed: int = 0):
    """Random bf16 x (m, k) and w (k, n) from ``seed``, made on
    ``device``: the operands the card's timings multiply."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device=device).bfloat16()
    w = torch.randn(k, n, generator=gen, device=device).bfloat16()
    return x, w


def measured_profile(layer: LayerShape, widths: Sequence[int], *,
                     hw: Optional[HardwareSpec] = None, device="cuda",
                     reps: int = 20, repeats: int = 5,
                     seed: int = 0, tile=None,
                     tile_hw=None) -> LayerProfile:
    """The paper's nvprof step on the card: ``ops.matmul`` of random bf16
    (tokens, ceil(d_in / shard_in)) @ (.., ceil(w / shard_out)) operands
    at each width, the median of ``repeats`` CUDA-graph replays of
    ``reps`` calls (``time_graph_ms``). Each product runs on ``tile``, or
    where that is None on the autotuner's pick on ``tile_hw`` (what a step
    cache with ``hw=tile_hw`` launches), else on the kernel's default.
    Utilization and waves are ``CtaWaveModel``'s on ``hw`` (the card's own
    spec by default, ``GpuSpec.from_device``) with ``tile_hw`` (the
    default tile's without it, ``tile`` or not); throughput is the useful
    FLOPs over the measured time. Raises without a CUDA device: a
    measurement never falls back to the CPU."""
    from repro_torch.core.gpu import GpuSpec
    from repro_torch.kernels import ops

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"measured_profile times the card: device {dev} "
                           f"is not an available CUDA device")
    hw = hw if hw is not None else GpuSpec.from_device(dev)
    tbl = CtaWaveModel(hw, tile_hw=tile_hw).evaluate_batch(layer, widths)
    n_max = max(ceil_div(int(w), layer.shard_out) for w in widths)
    x, w_full = bf16_operands(layer.tokens,
                              ceil_div(layer.d_in, layer.shard_in), n_max,
                              dev, seed)
    # the widest product first: the decode form's workspace grows once,
    # not at every width (each buffer it outgrows stays allocated)
    ops.matmul(x, w_full, tile=tile, hw=tile_hw)
    lat, spread = [], []
    for w in widths:
        wt = w_full[:, :ceil_div(int(w), layer.shard_out)].contiguous()
        ms = time_graph_ms(lambda: ops.matmul(x, wt, tile=tile,
                                              hw=tile_hw), reps, repeats)
        lat.append(float(np.median(ms)) * 1e-3)
        spread.append((max(ms) - min(ms)) * 1e-3)
        del wt
    lat = np.asarray(lat)
    return LayerProfile(
        name=layer.name, widths=np.asarray(list(widths)), latency_s=lat,
        utilization=tbl.utilization, throughput=tbl.flops / lat,
        waves=tbl.waves, source="measured", spread_s=np.asarray(spread))
