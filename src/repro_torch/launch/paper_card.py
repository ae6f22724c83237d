"""What the paper benchmarks' card phases share (``launch.staircase``,
``launch.nas_scaleup``, ``launch.platform_generality``): the spec a run
prices on, its two sweep engines, GEMMs held against their plain version,
and GEMMs compared in alternating rounds. Every product is timed by
``profiler.time_graph_ms`` (CUDA-graph replays), directly or through
``profiler.measured_profile``.

- :func:`sweep_models`: the tail model ``hw`` selects, on the exact numpy
  engine, and on a CUDA device also on its kernel backend (``staircase_cta``
  for a GPU spec, ``staircase_fused`` for a TPU's), whose tables and plans
  the benchmarks hold to the numpy engine's.
- :func:`reps_for`: the calls a replay of one product, sized to its work.
- :func:`held`: one ``ops.matmul`` (``matmul_tiled`` on the card) against
  its plain version on the same operands.
- :func:`alternate`: the sum of each side's products per round, the sides'
  order reversed every round, so that old and new widths are compared
  within one process and under the same drift.
"""

from __future__ import annotations

import math
import numpy as np
import torch

from repro_torch.core.profiler import bf16_operands, time_graph_ms
from repro_torch.core.tail_model import model_for

# a timed product's replays: ``reps_for`` calls a replay, ``REPEATS``
# replays
REPEATS = 5
MAX_REPS = 20
# a replay of one product should last about this long, so that its time is
# not the launch's alone and a large product is not timed 20 times over
REPLAY_MS = 0.5
# the rate the reps are sized at: half the H100 SXM's dense bf16 peak
SIZING_FLOPS = 0.5 * 989e12
# old and new (or each plan's) products, timed in this many rounds
ROUNDS = 6


def sweep_models(hw, device) -> dict:
    """{"numpy": the model ``hw`` selects on the exact engine} and, on a
    CUDA device, "kernel": the same on its kernel backend there."""
    dev = torch.device(device)
    out = {"numpy": model_for(hw)}
    if dev.type == "cuda":
        out["kernel"] = model_for(hw, backend="kernel", device=dev)
    return out


def reps_for(m: int, k: int, n: int) -> int:
    """Calls a replay for an (m, k) @ (k, n) product: about ``REPLAY_MS``
    at ``SIZING_FLOPS``, from 1 to ``MAX_REPS``."""
    est_ms = 2.0 * m * k * n / SIZING_FLOPS * 1e3
    return int(min(MAX_REPS, max(1, math.ceil(REPLAY_MS / max(est_ms,
                                                              1e-9)))))


def held(x: torch.Tensor, w: torch.Tensor) -> dict:
    """``ops.matmul(x, w)`` against its plain version on the same
    operands: the largest |difference| and the tolerance, two bf16 steps
    at the largest output (both round one fp32 sum per output to bf16, in
    other orders)."""
    from repro_torch.kernels import ops
    got = ops.matmul(x, w).float()
    ref = ops.matmul(x, w, force="plain").float()
    err = (got - ref).abs().max().item()
    tol = 2.0 ** -7 * ref.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= tol
    m, k = x.shape
    return {"case": f"M={m} K={k} N={w.shape[1]}", "max_abs_err": err,
            "tol": tol, "ok": ok}


def alternate(sides: dict, m: int, k: int, device, seed: int = 0,
              rounds: int = ROUNDS, repeats: int = REPEATS) -> dict:
    """Per side (name -> widths), its products (m, k) @ (k, n) of random
    bf16 operands from ``seed``, each width's timed (``time_graph_ms``,
    ``reps_for`` calls a replay, the median of ``repeats`` replays) in each
    of ``rounds`` rounds, the sides in order in even rounds and in reverse
    in odd ones; each distinct width's product held against plain
    (:func:`held`). Returns {"timed": {side: {"us": median of the round
    sums, "spread_us": their max - min, "rounds": the sums,
    "products_us": each product's median over the rounds}}, "held": the
    checks, "held_ok"}."""
    from repro_torch.kernels import ops
    ns = sorted({int(n) for ws in sides.values() for n in ws})
    x, w_full = bf16_operands(m, k, ns[-1], device, seed)
    w = {n: w_full[:, :n].contiguous() for n in ns}
    del w_full
    names = list(sides)
    each = {s: [] for s in names}
    for r in range(rounds):
        for s in (names if r % 2 == 0 else names[::-1]):
            each[s].append([
                float(np.median(time_graph_ms(
                    lambda n=int(n): ops.matmul(x, w[n]),
                    reps_for(m, k, int(n)), repeats))) * 1e3
                for n in sides[s]])
    checks = [held(x, w[n]) for n in ns]
    del x, w
    timed = {}
    for s, per_round in each.items():
        sums = [sum(ts) for ts in per_round]
        timed[s] = {"us": float(np.median(sums)),
                    "spread_us": max(sums) - min(sums), "rounds": sums,
                    "products_us": np.median(per_round, axis=0).tolist()}
    return {"timed": timed, "held": checks,
            "held_ok": all(c["ok"] for c in checks)}
