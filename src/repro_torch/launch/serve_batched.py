"""Batched serving with live width swapping (``examples/serve_batched.py``,
ported).

    PYTHONPATH=src python -m repro_torch.launch.serve_batched
    PYTHONPATH=src python -m repro_torch.launch.serve_batched --device cpu

On the card (the default) it serves full-width qwen1.5-0.5b and plans for
``H100_SXM`` in the tail model's GPU form (``CtaWaveModel``: waves of the
MLP kernel's CTAs over the SMs, paper Eq. 3); the planner's table sweep
runs on the CTA-wave Triton kernel. With ``--device cpu``
it runs the example's reduced model, whose FFN width (576) is deliberately
misaligned with ``TPU_V5E``'s 128-lane quantum, on the plain versions.
Either way it plans per-traffic-class widths with Algorithm 2 and serves a
mixed batch (greedy and temperature 0.8) with the plans applied to the live
params at every batch boundary; repeat boundaries hit the swapper's plan
cache. Weights are random, from ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import H100_SXM, TPU_V5E
from repro_torch.models import init_params
from repro_torch.models.transformer import cast_params
from repro_torch.serving import (
    Request, ServeEngine, ServingWidthPlanner, TrafficClass, WidthSwapper,
    serving_templates,
)
from repro_torch.serving.engine import require_device


def main(argv=None) -> ServeEngine:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = require_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False

    cfg = get_config("qwen1.5-0.5b")
    hw = H100_SXM
    if device.type == "cpu":
        cfg = reduced_config(cfg, d_model=128, n_layers=4, d_ff=576)
        hw = TPU_V5E
    params = cast_params(init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device),
        device)

    # Plan tail-free widths per traffic class and wire the plans to the
    # live params: templates + module addresses come as a matched pair.
    templates, modules = serving_templates(cfg, hw, tokens=96,
                                           sites=("mlp",))
    planner = ServingWidthPlanner(hw, templates, modules=modules,
                                  device=device)
    t0 = time.perf_counter()
    plans = planner.plan([TrafficClass("decode", 96),
                          TrafficClass("prefill", 4096)])
    print(f"planned {len(plans)} classes for {hw.name} in "
          f"{time.perf_counter() - t0:.3f}s")
    for name, plan in plans.items():
        widths = sorted(set(plan.widths.values()))
        print(f"plan[{name}]: widths {widths} "
              f"(modeled latency -{plan.latency_reduction:.1%})")

    engine = ServeEngine(params, cfg, max_len=96, batch_slots=4,
                         rng_seed=args.seed, device=device, planner=planner,
                         swapper=WidthSwapper(params, cfg))
    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, size=(16,))
                    .astype(np.int32), max_new_tokens=24,
                    temperature=0.0 if i % 2 == 0 else 0.8)
            for i in range(8)]
    t0 = time.perf_counter()
    results = engine.generate(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(r.tokens) for r in results)
    print(f"served {len(reqs)} requests / {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s on {device})")
    for i, r in enumerate(results):
        kind = "greedy" if i % 2 == 0 else "t=0.8 "
        print(f"  req{i} [{kind}]: {r.tokens[:10].tolist()} ...")

    # every batch boundary applied its plan; repeats were cache hits
    if len(engine.plan_log) != 2 or len(engine.swap_log) != 2 \
            or not engine.swap_log[1].cache_hit:
        raise RuntimeError(f"expected a cold then a warm swap, got "
                           f"{engine.swap_log}")
    for ev in engine.swap_log:
        state = "warm (cache hit, 0 allocs)" if ev.cache_hit else "cold"
        print(f"  swap -> plan[{ev.plan_name}] {state} "
              f"in {ev.swap_s * 1e3:.2f}ms")

    # greedy requests are deterministic (the re-run swaps to the same
    # cached plan, so the sliced params are identical objects)
    again = engine.generate([reqs[0]])
    if not (np.array_equal(again[0].tokens, results[0].tokens)
            and engine.swap_log[-1].cache_hit):
        raise RuntimeError("a greedy re-run on the cached plan differed")
    print("OK: greedy decode deterministic across warm swaps")
    return engine


if __name__ == "__main__":
    main()
