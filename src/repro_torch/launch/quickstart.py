"""Quickstart: see the CTA-wave staircase and eliminate the tail
(``examples/quickstart.py``, ported to the tail model's GPU form).

    PYTHONPATH=src python -m repro_torch.launch.quickstart
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

On ``H100_SXM`` (the card by default; ``--device cpu`` runs the same
sweeps on the model's CPU engine):

1. Model the staircase of qwen1.5-0.5b's FFN up-projection (d_model 1024,
   d_ff 2816) at 4096 tokens: the port's GEMM launches 32 row tiles x one
   CTA per 64 columns, which run in waves of S SMs x the CTAs an SM
   (paper Eq. 3, ``CtaWaveModel``).
2. Eq. 4: the right edges of the CTA-wave stairs (``analytic_candidates``).
3. Algorithm 2 both ways: cut latency (scale down) or grow capacity for
   free (scale up within the current wave).
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import (
    H100_SXM, LayerShape, TailEffectOptimizer, TunableLayer,
    analytic_candidates,
)
from repro_torch.core.tail_model import CtaWaveModel, cta_form
from repro_torch.serving.engine import require_device

TOKENS, D_MODEL, D_FF = 4096, 1024, 2816


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    hw = H100_SXM
    # the sweep engine: the CTA-wave Triton kernel on the card, its fp64
    # plain version on the CPU
    model = CtaWaveModel(hw, backend="kernel", device=device)
    layer = LayerShape("qwen_ffn", tokens=TOKENS, d_in=D_MODEL, width=D_FF)
    form = cta_form(hw, layer)

    print("== 1. the staircase (paper Fig. 1, GPU form) ==")
    widths = np.arange(64, 4225, 64)
    table = model.evaluate_batch(layer, widths)
    for i in range(3, len(widths), 4):
        pt = table.point(i)
        bar = "#" * int(pt.utilization * 40)
        print(f"  width {pt.width:>5}  B={form.g * -(-pt.width // 64):>5} "
              f"L={pt.latency_s * 1e6:7.2f}us waves={pt.waves}  "
              f"util={pt.utilization:5.3f} {bar}")
    print(f"  a wave: {form.slots} CTAs ({hw.cores_per_chip} SMs x "
          f"{form.slots // hw.cores_per_chip}); {form.g} CTAs per 64 "
          f"columns at {TOKENS} tokens")

    print("\n== 2. Eq. 4 candidates (argmax U x T = wave edges) ==")
    cands = analytic_candidates(hw, layer, max_width=4224)
    print(f"  {[int(c) for c in cands]}")

    print("\n== 3. Algorithm 2 ==")
    opt = TailEffectOptimizer(model)
    layers = [TunableLayer(
        layer=LayerShape(f"ffn_{i}", tokens=TOKENS, d_in=D_MODEL,
                         width=D_FF),
        candidates=cands, params_per_unit=3 * D_MODEL) for i in range(4)]
    lat = opt.optimize_latency(
        layers, tau=0.10 * sum(tl.params(D_FF) for tl in layers), delta=0.9)
    print("  latency-oriented (Eq. 7):")
    print("   " + lat.summary().replace("\n", "\n   "))
    acc = opt.optimize_accuracy(layers)
    print("  accuracy-oriented (Eq. 6):")
    print("   " + acc.summary().replace("\n", "\n   "))
    return {"table": table, "candidates": cands, "latency": lat,
            "accuracy": acc}


if __name__ == "__main__":
    main()
