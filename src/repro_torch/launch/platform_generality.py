"""Paper Tables 4/5: the same optimizer picks different widths on different
platforms, no one-fit-all configuration (``benchmarks/platform_generality.py``,
ported, with the GPU form and the card).

    PYTHONPATH=src python -m repro_torch.launch.platform_generality
    PYTHONPATH=src python -m repro_torch.launch.platform_generality \
        --tokens 512
    PYTHONPATH=src python -m repro_torch.launch.platform_generality \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.platform_generality \
        --device cpu --form tpu

Four deliberately misaligned layers (widths 11008, 13824, 9000, 5500 at
d_in 4096), each with the tail model's stair edges up to 1.5x its width
as candidates, go through the latency-mode Algorithm 2 (tau = 0.1 x
params, delta = 0.95) on each platform.

- The TPU form (``--form tpu``) is the reference's: v5e, v4, v5p and lite
  at 4096 tokens, TP = 16 except on lite (one chip), its lines and its CSV
  row with ``distinct_configs``.
- The GPU form (the default) runs the same layers at ``--tokens`` (4096,
  the reference's) with shard 1 over ``core.gpu.GPU_PLATFORMS``: the H100
  SXM and PCIe, the A100 SXM4 80GB, and the paper's own Titan V, Quadro
  P6000 and Jetson Nano, each from its data sheet, each plan modeled on
  its own spec and also on the H100 SXM's.

On the card (the default device; ``--device cpu`` stops at the model): each
plan also comes from the model's kernel backend and must equal the numpy
engine's; the original widths, the same with 5500 rounded up to 5504
(``WIDTHS_TMA``: the port's GEMM reads an N that is not a multiple of 8
element-wise, off its TMA route, and 5504 has the same CTA grid), and
every distinct GPU plan are timed on ``matmul_tiled`` as their four
products (tokens, 4096) @ (4096, width), in ``paper_card.ROUNDS``
alternating rounds (``paper_card.alternate``), each product held against
the plain version; each platform prints its plan's measured reduction
against both originals, its modeled (on the H100) one and the params it
keeps, and where the H100's own plan ranks, by measured time, among the
plans that keep at least as many params. ``--json PATH`` writes every
row.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

from repro_torch.core import (
    H100_SXM, LayerShape, TailEffectOptimizer, TunableLayer,
    analytic_candidates, get_hardware,
)
from repro_torch.core.gpu import GPU_PLATFORMS
from repro_torch.core.tail_model import model_for
from repro_torch.launch import paper_card
from repro_torch.serving.engine import require_device

PLATFORMS = ("tpu_v5e", "tpu_v4", "tpu_v5p", "tpu_lite")
GPU_NAMES = tuple(h.name for h in GPU_PLATFORMS)
WIDTHS = (11008, 13824, 9000, 5500)     # deliberately misaligned layers
# the original widths with N rounded up to a multiple of 8: the GEMM reads
# a product whose N is not one element-wise, off its TMA route (5500 is
# not; 5504 has the same 86 column tiles, so the same CTA grid)
WIDTHS_TMA = tuple(-(-w // 8) * 8 for w in WIDTHS)
TOKENS = 4096
D_IN = 4096
TAU, DELTA = 0.1, 0.95


def layer_shard(name: str) -> int:
    """The reference's shard on a TPU (16, one chip on lite); 1 on a GPU."""
    if name in GPU_NAMES or name == "tpu_lite":
        return 1
    return 16


def tunables(hw, tokens: int, shard: int) -> list:
    tls = []
    for i, w in enumerate(WIDTHS):
        layer = LayerShape(f"L{i}", tokens=tokens, d_in=D_IN, width=w,
                           shard_out=shard)
        tls.append(TunableLayer(
            layer=layer,
            candidates=analytic_candidates(hw, layer,
                                           max_width=int(w * 1.5)),
            params_per_unit=D_IN))
    return tls


def plan_widths(res) -> list:
    return [res.new_widths[f"L{i}"] for i in range(len(WIDTHS))]


def modeled_us(model, tokens: int, widths) -> float:
    """The four layers' modeled us at ``widths`` (shard 1)."""
    return sum(float(model.latency_batch(
        LayerShape(f"L{i}", tokens=tokens, d_in=D_IN, width=w), [w])[0])
        for i, w in enumerate(widths)) * 1e6


def card_plans(plans: dict, tokens: int, device, seed: int,
               rounds: int) -> dict:
    """The original widths and each distinct plan (name -> widths), each as
    its four products, timed in ``rounds`` alternating rounds; each
    product held against plain. Returns {"timed": name -> alternate's
    entry, "held": the checks}."""
    distinct = {}
    for name, widths in plans.items():
        distinct.setdefault(tuple(widths), name)
    card = paper_card.alternate({name: widths for widths, name
                                 in distinct.items()}, tokens, D_IN, device,
                                seed, rounds)
    return {"timed": {name: card["timed"][distinct[tuple(w)]]
                      for name, w in plans.items()},
            "held": card["held"], "held_ok": card["held_ok"]}


def run_tpu(csv_rows: Optional[list] = None, verbose: bool = True,
            device="cuda") -> dict:
    """The reference's TPU platforms, its lines and CSV row; on a CUDA
    ``device`` each plan also from the kernel backend (``staircase_fused``)
    against the numpy engine's."""
    dev = require_device(device)
    t0 = time.time()
    out, kernel_equal = {}, {}
    for name in PLATFORMS:
        hw = get_hardware(name)
        shard = layer_shard(name)
        models = paper_card.sweep_models(hw, dev)
        model = models["numpy"]
        tls = tunables(hw, TOKENS, shard)
        total_p = sum(tl.params(tl.layer.width) for tl in tls)
        res = TailEffectOptimizer(model).optimize_latency(
            tls, tau=TAU * total_p, delta=DELTA)
        out[name] = res
        if "kernel" in models:
            kres = TailEffectOptimizer(models["kernel"]).optimize_latency(
                tls, tau=TAU * total_p, delta=DELTA)
            kernel_equal[name] = kres.new_widths == res.new_widths
        if verbose:
            print(f"  {name:>9}: q={model.width_quantum(shard):>5} "
                  f"latency {res.latency_old_s*1e6:8.2f} -> "
                  f"{res.latency_new_s*1e6:8.2f}us "
                  f"({res.latency_reduction*100:+5.1f}%) widths="
                  f"{plan_widths(res)}")
    # platforms must disagree on at least one chosen width (no one-fit-all)
    configs = {n: tuple(sorted(r.new_widths.items()))
               for n, r in out.items()}
    distinct = len(set(configs.values()))
    dt_us = (time.time() - t0) * 1e6 / len(PLATFORMS)
    reds = ";".join(f"{n}:-{out[n].latency_reduction*100:.1f}%"
                    for n in PLATFORMS)
    csv = ("platform_generality_tables4_5", f"{dt_us:.1f}",
           f"distinct_configs={distinct};{reds}")
    if csv_rows is not None:
        csv_rows.append(csv)
    if kernel_equal and verbose:
        print(f"  kernel backend on {dev}: plans equal to numpy's "
              f"{kernel_equal}")
    return {"form": "tpu", "results": out, "distinct": distinct,
            "kernel_equal": kernel_equal, "csv": csv}


def run(csv_rows: Optional[list] = None, verbose: bool = True,
        tokens: int = TOKENS, device="cuda", platforms=GPU_NAMES,
        seed: int = 0, rounds: int = paper_card.ROUNDS) -> dict:
    """The GPU form over ``platforms`` (registered GPU spec names) at
    ``tokens``. Returns {"form": "gpu", "tokens", "rows": per platform its
    plan, modeled us and reduction on its own spec and on the H100 SXM's,
    params kept, "kernel_equal" and "card" on the card, "distinct",
    "h100_rank", "csv"}."""
    dev = require_device(device)
    t0 = time.time()
    h100 = model_for(H100_SXM)
    l_orig_h100 = modeled_us(h100, tokens, WIDTHS)
    rows = {}
    for name in platforms:
        hw = get_hardware(name)
        models = paper_card.sweep_models(hw, dev)
        tls = tunables(hw, tokens, 1)
        total_p = sum(tl.params(tl.layer.width) for tl in tls)
        res = TailEffectOptimizer(models["numpy"]).optimize_latency(
            tls, tau=TAU * total_p, delta=DELTA)
        widths = plan_widths(res)
        on_h100 = modeled_us(h100, tokens, widths)
        row = {"platform": name, "sms": hw.cores_per_chip,
               "widths": widths, "latency_old_us": res.latency_old_s * 1e6,
               "latency_new_us": res.latency_new_s * 1e6,
               "reduction": res.latency_reduction,
               "satisfied": res.satisfied,
               "h100_us": on_h100, "h100_reduction": 1 - on_h100
               / l_orig_h100,
               "params_kept": res.params_new / res.params_old}
        if "kernel" in models:
            kres = TailEffectOptimizer(models["kernel"]).optimize_latency(
                tls, tau=TAU * total_p, delta=DELTA)
            row["kernel_widths"] = plan_widths(kres)
            row["kernel_equal"] = row["kernel_widths"] == widths
        rows[name] = row
        if verbose:
            print(f"  {name:>14} (S={hw.cores_per_chip:>3}): latency "
                  f"{row['latency_old_us']:10.2f} -> "
                  f"{row['latency_new_us']:10.2f}us "
                  f"({-row['reduction'] * 100:+5.1f}%) widths={widths}; on "
                  f"the H100 SXM {-row['h100_reduction'] * 100:+5.1f}%; "
                  f"params kept {row['params_kept'] * 100:.2f}%")
    distinct = len({tuple(r["widths"]) for r in rows.values()})
    if dev.type == "cuda":
        plans = {"original": list(WIDTHS),
                 "original_tma": list(WIDTHS_TMA)} | {
            n: r["widths"] for n, r in rows.items()}
        card = card_plans(plans, tokens, dev, seed, rounds)
        t_orig = card["timed"]["original"]["us"]
        t_tma = card["timed"]["original_tma"]["us"]
        for n, r in rows.items():
            t = card["timed"][n]
            r["card"] = {"us": t["us"], "spread_us": t["spread_us"],
                         "products_us": t["products_us"],
                         "reduction": 1 - t["us"] / t_orig,
                         "reduction_tma": 1 - t["us"] / t_tma}
        card_out = {k: card["timed"][k] for k in ("original",
                                                  "original_tma")} | {
            "held": card["held"], "held_ok": card["held_ok"]}
    else:
        card_out = None
    rank = h100_rank(rows, "card" if card_out else "h100_us")
    dt_us = (time.time() - t0) * 1e6 / len(platforms)
    reds = ";".join(f"{n}:-{r['reduction']*100:.1f}%"
                    for n, r in rows.items())
    csv = ("platform_generality_tables4_5_gpu", f"{dt_us:.1f}",
           f"tokens={tokens};distinct_configs={distinct};{reds}")
    if csv_rows is not None:
        csv_rows.append(csv)
    if verbose:
        if any("kernel_equal" in r for r in rows.values()):
            print(f"  kernel backend on {dev}: plans equal to numpy's "
                  f"{ {n: r['kernel_equal'] for n, r in rows.items()} }")
        if card_out:
            o, ot = card_out["original"], card_out["original_tma"]
            print(f"  on the card, M={tokens}: original widths "
                  f"{o['us']:.3f} us (spread {o['spread_us']:.3f}; each "
                  f"product {[round(t, 3) for t in o['products_us']]}), "
                  f"with N {list(WIDTHS_TMA)} {ot['us']:.3f} us (spread "
                  f"{ot['spread_us']:.3f}; "
                  f"{[round(t, 3) for t in ot['products_us']]}); modeled "
                  f"on the H100 SXM {l_orig_h100:.3f} us; products "
                  f"{'match' if card_out['held_ok'] else 'MISS'} plain")
            for n, r in rows.items():
                c = r["card"]
                print(f"  {n:>14} plan on the card: {c['us']:.3f} us "
                      f"(spread {c['spread_us']:.3f}), measured "
                      f"{-c['reduction'] * 100:+.2f}% against the original, "
                      f"{-c['reduction_tma'] * 100:+.2f}% against N "
                      f"{list(WIDTHS_TMA)}, modeled "
                      f"{-r['h100_reduction'] * 100:+.2f}% on the H100; "
                      f"params kept {r['params_kept'] * 100:.2f}%")
        else:
            print("  on the card: not measured (device cpu)")
        print(f"  the H100 SXM's own plan ranks {rank['rank']} of "
              f"{rank['of']} ({'measured' if card_out else 'modeled'} on "
              f"the H100) among the plans keeping at least its params: "
              f"{rank['order']}")
    return {"form": "gpu", "tokens": tokens, "rows": rows,
            "distinct": distinct, "h100_rank": rank,
            "original_h100_us": l_orig_h100, "card": card_out, "csv": csv}


def h100_rank(rows: dict, by: str) -> dict:
    """Where the H100 SXM's plan ranks (1 = fastest) by ``by`` ("card":
    measured; "h100_us": modeled on the H100) among the plans that keep at
    least its params (ties share the better rank)."""
    own = rows[H100_SXM.name]

    def t(r):
        return r["card"]["us"] if by == "card" else r["h100_us"]
    peers = sorted((n for n, r in rows.items()
                    if r["params_kept"] >= own["params_kept"]),
                   key=lambda n: t(rows[n]))
    rank = 1 + sum(t(rows[n]) < t(own) for n in peers)
    return {"rank": rank, "of": len(peers),
            "order": [(n, round(t(rows[n]), 3)) for n in peers]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--form", choices=("gpu", "tpu"), default="gpu",
                    help="gpu: the GPU platforms (core.gpu.GPU_PLATFORMS); "
                         "tpu: the reference's TPU platforms")
    ap.add_argument("--tokens", type=int, default=TOKENS)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    if args.form == "tpu":
        out = run_tpu(verbose=True, device=dev)
        out = dict(out, results={n: r.summary() for n, r in
                                 out["results"].items()})
    else:
        out = run(verbose=True, tokens=args.tokens, device=dev)
    print("  " + ",".join(out["csv"]))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, default=float)
    return out


if __name__ == "__main__":
    main()
