"""Paper Table 3: accuracy-oriented optimization, capacity grown at
iso-latency (``benchmarks/nas_scaleup.py``, ported, with the GPU form and
the card).

    PYTHONPATH=src python -m repro_torch.launch.nas_scaleup
    PYTHONPATH=src python -m repro_torch.launch.nas_scaleup --tokens 512
    PYTHONPATH=src python -m repro_torch.launch.nas_scaleup --device cpu
    PYTHONPATH=src python -m repro_torch.launch.nas_scaleup --device cpu \
        --hw tpu_v5e

For each arch (standing in for the paper's EfficientNet series) the
accuracy-mode Algorithm 2 (``optimize_accuracy``, no latency slack) runs
over its width-tunable layers, the FFN's d_ff and the attention width
(heads x head_dim), each with the tail model's stair edges up to 1.5x its
width as candidates: every layer snaps up to the right edge of its wave,
so the parameters grow at the same modeled latency.

- The TPU form (``--hw tpu_v5e``) is the reference's: 8192 tokens, TP = 16
  where the width divides (MoE FFNs unsharded), its lines and its CSV row
  with the model's evaluation counts.
- The GPU form (the default: the card's own spec, or ``H100_SXM`` with
  ``--device cpu``) runs the same with shard 1 (one card) on
  ``CtaWaveModel``.

On the card (the default device; ``--device cpu`` stops at the model): the
optimizer also runs on the model's kernel backend (``staircase_cta`` or
``staircase_fused``), whose plans must equal the numpy engine's; and for
each arch whose widths moved, its tunable layers' products, (tokens,
d_model) @ (d_model, d_ff) and (tokens, d_model) @ (d_model, heads x
head_dim), are timed on ``matmul_tiled`` at the old and the new widths in
``paper_card.ROUNDS`` alternating rounds (``paper_card.alternate``), each
product held against the plain version. Iso-latency holds on the card
where the new sum's median is at most the old's plus the old's spread
across the rounds. ``--json PATH`` writes every row.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

from repro_torch.configs import get_config, list_archs
from repro_torch.core import (
    LayerShape, TPU_V5E, TailEffectOptimizer, TunableLayer,
    analytic_candidates,
)
from repro_torch.core.gpu import is_gpu
from repro_torch.launch import paper_card
from repro_torch.launch.pruning_opt import resolve_hw
from repro_torch.serving.engine import require_device

HW = TPU_V5E
TOKENS = 8192
TP = 16


def arch_tunables(cfg, tokens: int = TOKENS, tp: int = TP, hw=HW) -> list:
    """The reference's tunables (d_ff and the attention width) on ``hw``
    with tensor parallelism ``tp`` (1 on a GPU: one card)."""
    tls = []
    d_ff = cfg.moe_d_ff if (cfg.moe and cfg.moe_d_ff) else cfg.d_ff
    shard = 1 if cfg.moe else (tp if d_ff % tp == 0 else 1)
    ffn = LayerShape("d_ff", tokens=tokens, d_in=cfg.d_model, width=d_ff,
                     shard_out=shard)
    tls.append(TunableLayer(
        layer=ffn,
        candidates=analytic_candidates(hw, ffn, max_width=int(d_ff * 1.5)),
        params_per_unit=(3 if cfg.mlp_gated else 2) * cfg.d_model
        * (cfg.n_experts if cfg.moe else 1) * cfg.n_layers))
    # attention width (heads*head_dim): ragged head counts leave tail
    attn_w = cfg.n_heads * cfg.head_dim
    shard_a = tp if cfg.n_heads % tp == 0 else 1
    att = LayerShape("attn_width", tokens=tokens, d_in=cfg.d_model,
                     width=attn_w, shard_out=shard_a)
    tls.append(TunableLayer(
        layer=att,
        candidates=analytic_candidates(hw, att,
                                       max_width=int(attn_w * 1.5)),
        params_per_unit=2 * cfg.d_model * cfg.n_layers))
    return tls


def card_widths(cfg, old: dict, new: dict, tokens: int, device,
                seed: int, rounds: int) -> dict:
    """Both tunable layers' products at the old and at the new widths,
    timed in ``rounds`` alternating rounds; each product held against
    plain."""
    names = ("d_ff", "attn_width")
    card = paper_card.alternate(
        {side: [widths[n] for n in names]
         for side, widths in (("old", old), ("new", new))},
        tokens, cfg.d_model, device, seed, rounds)
    t_old, t_new = card["timed"]["old"], card["timed"]["new"]
    return {"old": t_old, "new": t_new, "held": card["held"],
            "held_ok": card["held_ok"],
            "iso": t_new["us"] <= t_old["us"] + t_old["spread_us"],
            "change": t_new["us"] / t_old["us"] - 1.0}


def run(csv_rows: Optional[list] = None, verbose: bool = True, hw=None,
        tokens: int = TOKENS, device="cuda", archs=None, seed: int = 0,
        rounds: int = paper_card.ROUNDS) -> dict:
    """Table 3 on ``hw`` (a spec, a registered name, or None for the card's
    own) at ``tokens``. Returns {"hw", "tokens", "rows": each arch's (old
    and new widths, gain, modeled latencies, iso-latency; "kernel_equal"
    and, where widths moved, "card" on the card), "csv": the reference's
    CSV row (also appended to ``csv_rows``)}."""
    dev = require_device(device)
    hw = resolve_hw(hw, dev)
    t0 = time.time()
    models = paper_card.sweep_models(hw, dev)
    model = models["numpy"]
    opt = TailEffectOptimizer(model)
    tp = 1 if is_gpu(hw) else TP
    rows = []
    for arch in (archs or list_archs()):
        cfg = get_config(arch)
        tls = arch_tunables(cfg, tokens=tokens, tp=tp, hw=hw)
        res = opt.optimize_accuracy(tls, latency_slack=0.0)
        gain_frac = res.param_gain / max(res.params_old, 1)
        row = {"arch": arch, "old_widths": dict(res.old_widths),
               "new_widths": dict(res.new_widths), "gain": gain_frac,
               "iso_latency": res.latency_new_s
               <= res.latency_old_s + 1e-15,
               "latency_old_us": res.latency_old_s * 1e6,
               "latency_new_us": res.latency_new_s * 1e6,
               "params_old": res.params_old, "params_new": res.params_new}
        if "kernel" in models:
            kres = TailEffectOptimizer(models["kernel"]).optimize_accuracy(
                tls, latency_slack=0.0)
            row["kernel_widths"] = dict(kres.new_widths)
            row["kernel_equal"] = kres.new_widths == res.new_widths
        rows.append(row)
        if verbose:
            moved = {k: (res.old_widths[k], v)
                     for k, v in res.new_widths.items()
                     if v != res.old_widths[k]}
            print(f"  {arch:>28}: +{gain_frac*100:5.2f}% params free "
                  f"{moved if moved else '(already wave-aligned)'}")
    dt_us = (time.time() - t0) * 1e6 / max(len(rows), 1)
    best = max(rows, key=lambda r: r["gain"])
    # Table-driven engine: one evaluate_batch per tunable layer per call.
    csv = ("nas_scaleup_table3", f"{dt_us:.1f}",
           f"best_free_gain={best['arch']}:+{best['gain']*100:.2f}%;"
           f"batched_evals={model.eval_calls}({model.eval_points}pts)")
    if csv_rows is not None:
        csv_rows.append(csv)
    if "kernel" in models and verbose:
        bad = [r["arch"] for r in rows if not r["kernel_equal"]]
        print(f"  kernel backend on {dev}: plans equal to numpy's for "
              f"{len(rows) - len(bad)} of {len(rows)} archs "
              f"{bad if bad else ''}")
    if dev.type == "cuda" and is_gpu(hw):
        for i, r in enumerate(rows):
            if r["new_widths"] == r["old_widths"]:
                continue
            cfg = get_config(r["arch"])
            r["card"] = c = card_widths(cfg, r["old_widths"],
                                        r["new_widths"], tokens, dev,
                                        seed + i, rounds)
            if verbose:
                print(f"  {r['arch']:>28} on the card, M={tokens}: old "
                      f"{c['old']['us']:.3f} us (spread "
                      f"{c['old']['spread_us']:.3f}) new "
                      f"{c['new']['us']:.3f} us (spread "
                      f"{c['new']['spread_us']:.3f}), "
                      f"{c['change'] * 100:+.2f}%; modeled "
                      f"{r['latency_old_us']:.3f} -> "
                      f"{r['latency_new_us']:.3f} us; params "
                      f"+{r['gain'] * 100:.2f}%; iso-latency on the card "
                      f"{c['iso']}; products "
                      f"{'match' if c['held_ok'] else 'MISS'} plain")
    elif verbose and is_gpu(hw):
        print("  on the card: not measured (device cpu)")
    return {"hw": hw.name, "tokens": tokens, "rows": rows, "csv": csv}


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
