"""Paper Fig. 1/3: the latency staircase of each arch's FFN layer
(``benchmarks/staircase.py``, ported, with the GPU form and the card).

    PYTHONPATH=src python -m repro_torch.launch.staircase
    PYTHONPATH=src python -m repro_torch.launch.staircase --tokens 512
    PYTHONPATH=src python -m repro_torch.launch.staircase --device cpu
    PYTHONPATH=src python -m repro_torch.launch.staircase --device cpu \
        --hw tpu_v5e

For each arch of ``list_archs()`` the FFN layer (tokens, d_model) @
(d_model, d_ff) is swept through the tail model that ``--hw`` selects
(``tail_model.model_for``), and each line says where the arch's own d_ff
sits in its wave: its quantum q, waves, the fill of its last wave (1.0 at
the right edge: no tail), its utilization and the number of stairs the
sweep crossed.

- The TPU form (``--hw tpu_v5e``) is the reference's, line for line:
  ``WaveQuantizationModel`` at 8192 tokens with its TP = 16 shard rule
  (``shard = 16 if d_ff % 16 == 0 else 1``, MoE experts unsharded), the
  fill d_ff / (waves x q).
- The GPU form (the default: the card's own spec, ``GpuSpec.from_device``,
  or ``H100_SXM`` with ``--device cpu``) prices the same layer with shard 1
  (one card) through ``CtaWaveModel``: waves = ceil(B / S) of the CTA grid
  B the port's GEMM launches on its default tile, the fill B / (waves x S).
  MoE FFNs are priced as one dense layer of width moe_d_ff, as the
  reference prices them.

On the card (the default device; ``--device cpu`` stops at the model):
every sweep also runs on the model's kernel backend (``staircase_cta`` for
the GPU form, ``staircase_fused`` for the TPU form), held to the numpy
engine (waves, stairs and latency equal bit for bit); and in the GPU form
each arch's FFN product is timed on ``matmul_tiled``
(``profiler.measured_profile``, CUDA-graph replays) at N in 64-column
steps from the model's stair edge below d_ff through the edge above it
and one width past it, and at least ``WINDOW`` tiles each side of d_ff
(at 8192 tokens a stair is about two tiles wide). Each arch prints the
measured and modeled us at d_ff, at the stair's right edge and at the
first width past it, the stair's spread (max - min of the measured us
across its widths) and the rise past the edge (the time just past it
over the stair's median). The product at d_ff is held against the plain
version. ``--json PATH`` writes every row.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np

from repro_torch.configs import get_config, list_archs
from repro_torch.core import LayerShape, ceil_div
from repro_torch.core.gpu import is_gpu
from repro_torch.core.profiler import bf16_operands, measured_profile
from repro_torch.launch import paper_card
from repro_torch.launch.pruning_opt import resolve_hw
from repro_torch.serving.engine import require_device

TOKENS = 8192       # the reference's
TP = 16             # the reference's tensor parallelism over v5e chips
WINDOW = 8          # 64-column tiles timed at least each side of d_ff


def ffn_width(cfg) -> int:
    return cfg.moe_d_ff if (cfg.moe and cfg.moe_d_ff) else cfg.d_ff


def ffn_shard(cfg, hw) -> int:
    """The reference's shard rule on a TPU (MoE expert FFNs are expert
    parallel, not width sharded); 1 on a GPU (one card)."""
    d_ff = ffn_width(cfg)
    if is_gpu(hw) or cfg.moe:
        return 1
    return TP if d_ff % TP == 0 else 1


def ffn_layer(arch: str, cfg, hw, tokens: int) -> LayerShape:
    return LayerShape(f"{arch}/ffn", tokens=tokens, d_in=cfg.d_model,
                      width=ffn_width(cfg), shard_out=ffn_shard(cfg, hw))


def stair_line(arch: str, layer: LayerShape, model, table) -> dict:
    """One arch's line: d_ff, q, waves, fill, utilization, stairs, from the
    sweep ``table`` whose last row is d_ff itself."""
    d_ff = layer.width
    q = model.width_quantum(layer.shard_out)
    pt = table.point(len(table) - 1)
    if is_gpu(model.hw):
        # the last wave's share of its slots that the grid fills
        frac = model.blocks(layer) / (pt.waves * model.form(layer).slots)
    else:
        frac = d_ff / (pt.waves * q)
    n_steps = int(np.unique(np.round(table.latency_s[:-1], 12)).size)
    return {"arch": arch, "d_ff": d_ff, "q": q, "waves": int(pt.waves),
            "fill": float(frac), "util": float(pt.utilization),
            "stairs": n_steps}


def sweep_widths(layer: LayerShape, q: int) -> np.ndarray:
    """The reference's sweep: widths q/2 .. d_ff + q in steps of q/2, then
    d_ff itself."""
    widths = np.arange(q // 2, layer.width + q + 1, q // 2)
    return np.append(widths, layer.width)


def tables_agree(a, b) -> dict:
    """A kernel-backend sweep table against the numpy engine's."""
    rel = float(np.max(np.abs(a.latency_s - b.latency_s)
                       / np.abs(b.latency_s)))
    return {"waves_equal": bool(np.array_equal(a.waves, b.waves)),
            "max_rel_err": rel}


def stair_window(model, layer: LayerShape) -> dict:
    """The widths the card times around d_ff: the model's stair edge below
    it (the last width of fewer waves), its stair's right edge, one width
    past that, and at least ``WINDOW`` tiles each side of d_ff, in steps of
    the quantum."""
    q = model.width_quantum(layer.shard_out)
    d_ff = layer.width
    form = model.form(layer)
    waves = model.waves(layer)
    # widths of w waves end at the last whole tile whose grid fits w waves
    lo = (waves - 1) * form.slots // form.g * q
    hi = waves * form.slots // form.g * q
    start = max(q, min(lo, (ceil_div(d_ff, q) - WINDOW) * q))
    end = max(hi + q, (d_ff // q + WINDOW) * q)
    return {"lo": int(lo), "hi": int(hi), "past": int(hi + q),
            "widths": np.union1d(np.arange(start, end + 1, q),
                                 [d_ff]).astype(np.int64)}


def card_stair(layer: LayerShape, model, device, seed: int) -> dict:
    """``layer``'s product timed on the card across its stair window
    (``measured_profile``); the product at d_ff held against plain."""
    win = stair_window(model, layer)
    widths = win["widths"]
    prof = measured_profile(layer, widths, hw=model.hw, device=device,
                            reps=paper_card.reps_for(
                                layer.tokens, layer.d_in, int(widths[-1])),
                            repeats=paper_card.REPEATS, seed=seed)
    held = paper_card.held(*bf16_operands(layer.tokens, layer.d_in,
                                          layer.width, device, seed))
    us = prof.latency_s * 1e6
    spread = (prof.spread_s * 1e6).tolist()
    model_us = model.latency_batch(layer, widths) * 1e6
    at = {int(n): i for i, n in enumerate(widths)}
    d_ff = layer.width
    stair = (widths > win["lo"]) & (widths <= win["hi"])
    st = us[stair]
    st_spread = float(st.max() - st.min())
    rise = float(us[at[win["past"]]] - np.median(st))
    return {"widths": widths.tolist(), "us": us.tolist(),
            "replay_spread_us": spread, "model_us": model_us.tolist(),
            "waves": prof.waves.tolist(), "lo": win["lo"], "hi": win["hi"],
            "past": win["past"],
            "us_at": {k: float(us[at[n]]) for k, n in
                      (("d_ff", d_ff), ("edge", win["hi"]),
                       ("past", win["past"]))},
            "model_us_at": {k: float(model_us[at[n]]) for k, n in
                            (("d_ff", d_ff), ("edge", win["hi"]),
                             ("past", win["past"]))},
            "stair_spread_us": st_spread, "rise_us": rise,
            "rises": rise > st_spread, "held": held}


def run(csv_rows: Optional[list] = None, verbose: bool = True, hw=None,
        tokens: int = TOKENS, device="cuda", archs=None,
        seed: int = 0) -> dict:
    """Fig. 1/3 on ``hw`` (a spec, a registered name, or None for the
    card's own) at ``tokens``; on a CUDA ``device`` also the kernel
    backend's sweeps and, in the GPU form, the card's stairs. ``archs``
    (default ``list_archs()``) limits the archs. Returns {"hw", "tokens",
    "lines": each arch's line (with "card" on the card), "kernel": each
    arch's kernel-backend sweep against numpy's, "csv": the reference's
    CSV row (also appended to ``csv_rows``)}."""
    dev = require_device(device)
    hw = resolve_hw(hw, dev)
    models = paper_card.sweep_models(hw, dev)
    model = models["numpy"]
    t0 = time.time()
    lines, kernel = [], {}
    for arch in (archs or list_archs()):
        cfg = get_config(arch)
        layer = ffn_layer(arch, cfg, hw, tokens)
        q = model.width_quantum(layer.shard_out)
        widths = sweep_widths(layer, q)
        table = model.evaluate_batch(layer, widths)
        line = stair_line(arch, layer, model, table)
        lines.append(line)
        if "kernel" in models:
            ktable = models["kernel"].evaluate_batch(layer, widths)
            k = tables_agree(ktable, table)
            k["stairs_equal"] = stair_line(arch, layer, model,
                                           ktable)["stairs"] == line["stairs"]
            kernel[arch] = k
        if verbose:
            print(f"  {arch:>28} d_ff={line['d_ff']:>6} q={q:>5} "
                  f"waves={line['waves']:>3} "
                  f"wave-fill={line['fill']:5.3f} "
                  f"util={line['util']:5.3f} stairs={line['stairs']}")
    dt_us = (time.time() - t0) * 1e6 / max(len(lines), 1)
    worst = min(lines, key=lambda r: r["fill"])
    csv = ("staircase_fig1_3", f"{dt_us:.1f}",
           f"worst_wave_fill={worst['arch']}:{worst['fill']:.3f}")
    if csv_rows is not None:
        csv_rows.append(csv)
    if kernel and verbose:
        bad = [a for a, k in kernel.items()
               if not (k["waves_equal"] and k["stairs_equal"])]
        print(f"  kernel backend on {dev}: waves and stairs equal to numpy's "
              f"for {len(kernel) - len(bad)} of {len(kernel)} archs "
              f"{bad if bad else ''}; max_rel_err "
              f"{max(k['max_rel_err'] for k in kernel.values()):.3g}")
    if dev.type == "cuda" and is_gpu(hw):
        for i, line in enumerate(lines):
            cfg = get_config(line["arch"])
            layer = ffn_layer(line["arch"], cfg, hw, tokens)
            line["card"] = c = card_stair(layer, model, dev, seed + i)
            if verbose:
                u, mu = c["us_at"], c["model_us_at"]
                print(f"  {line['arch']:>28} on the card, M={tokens} "
                      f"K={cfg.d_model}: us at d_ff {line['d_ff']} "
                      f"{u['d_ff']:.3f} (model {mu['d_ff']:.3f}), at the "
                      f"edge {c['hi']} {u['edge']:.3f} ({mu['edge']:.3f}), "
                      f"past it {c['past']} {u['past']:.3f} "
                      f"({mu['past']:.3f}); stair ({c['lo']}, {c['hi']}] "
                      f"spread {c['stair_spread_us']:.3f} us, rise past "
                      f"the edge {c['rise_us']:.3f} us; product at d_ff "
                      f"{'matches' if c['held']['ok'] else 'MISSES'} plain "
                      f"({c['held']['max_abs_err']:.3g} <= "
                      f"{c['held']['tol']:.3g})")
    elif verbose and is_gpu(hw):
        print("  on the card: not measured (device cpu)")
    return {"hw": hw.name, "tokens": tokens, "lines": lines,
            "kernel": kernel, "csv": csv}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hw", default=None,
                    help="a registered spec (tpu_v5e is the reference's "
                         "TPU form); the card's own when left out")
    ap.add_argument("--tokens", type=int, default=TOKENS)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    out = run(verbose=True, hw=args.hw, tokens=args.tokens, device=dev)
    print("  " + ",".join(out["csv"]))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh)
    return out


if __name__ == "__main__":
    main()
