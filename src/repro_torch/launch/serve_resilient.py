"""Resilient serving: a burst on one static engine, or a straggler burst on
a hedged fleet of continuous engines (``examples/serve_resilient.py`` and
``benchmarks/optimizer_scale.py``'s hedged-serving phase, ported).

    PYTHONPATH=src python -m repro_torch.launch.serve_resilient \
        --scenario fleet --hedge 0 --cached

    PYTHONPATH=src python -m repro_torch.launch.serve_resilient \
        --scenario fleet --hedge 1 --crash-at 2 --cached

    PYTHONPATH=src python -m repro_torch.launch.serve_resilient \
        --device cpu --reduced --scenario burst

Runs on the card (``--device cuda``, the default) and fails if there is
none; ``--device cpu`` runs the kernels' plain versions on the CPU (with
``--reduced`` for the example's small qwen). Weights are random, from
``--seed``.

``--scenario burst``: a 4x burst of deadline-carrying requests into one
``ServeEngine`` with ``AdmissionControl``, a ``DegradationController`` over
a three-rung ladder, seeded swap faults and straggler batches
(``SlowBatchInjector``), on a virtual clock; then the burst passing, and
the same burst without deadlines at full width and through the ladder.
Prints a ``LoadReport`` of each. On the card the ladder comes from the
GPU-form planner (``H100_SXM``) and the engines serve through a step cache;
on the CPU from ``TPU_V5E``, as the example plans.

``--scenario fleet``: two ``ContinuousServeEngine`` replicas behind a
``ReplicaRouter``, each on its own ``VirtualClock`` advanced by
``modeled_batch_cost``, replica 0 stalled 8x (``ReplicaStallInjector``).
``--hedge none|0|1`` serves unhedged, hedged at the same width, or hedged
on rung 1 of a degradation ladder (each replica then carries a swapper and
a controller whose floor only the hedge's pins move). ``--crash-at N``
crashes replica 0 at its N-th costed step (``ReplicaCrashInjector``).
The ladder's one traffic class is the fleet's own (``fleet_tokens``).
``--cached`` gives each replica a step cache of its own, warmed before
serving. Prints the router ledger, hedges and backup wins, migrations,
the health log, p50 / p99 / p99.9 latency on the virtual clocks, and per
replica the step cache's hits, misses and fallbacks. The router decides
on the virtual clocks, so its decisions are a function of the seeds and
equal to a CPU run's; the wall seconds printed beside them are the host's
and play no part in any decision.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.core import H100_SXM, TPU_V5E
from repro_torch.models import init_params
from repro_torch.launch.serve import refuse_non_text
from repro_torch.models.transformer import cast_params
from repro_torch.serving import (
    AdmissionControl, Arrival, ContinuousServeEngine, DegradationController,
    DegradationLadder, HedgePolicy, ReplicaRouter, Request, ServeEngine,
    ServingWidthPlanner, TrafficClass, WidthSwapper,
    WidthVariantCompileCache, serving_templates,
)
from repro_torch.serving.chaos import (
    LoadReport, ReplicaCrashInjector, ReplicaStallInjector,
    SlowBatchInjector, SwapFailureInjector, TailReport, VirtualClock,
    burst_requests, modeled_batch_cost,
)
from repro_torch.serving.engine import require_device

SLOTS, CAP = 4, 3
BURST_N = 4 * SLOTS * CAP       # 4x the sustainable queue
LADDER_DELTAS = (0.8, 0.6)
STALL = 8.0
# the burst's traffic class: a full batch of 16-token prompts and 8 new
# tokens (the example's 96)
BURST_PROMPT, BURST_NEW = 16, 8
BURST_TOKENS = SLOTS * (BURST_PROMPT + BURST_NEW)
# benchmarks/optimizer_scale.py's fleet: modeled seconds a token and a step
PER_TOKEN_S, OVERHEAD_S = 1e-4, 1e-4


def ladder_for(cfg, device, *, tokens: int):
    """The MLP ladder of the example: one traffic class at ``tokens``, a
    rung per delta of ``LADDER_DELTAS`` above full width. On the card the
    GPU form (``H100_SXM``, each width priced on its autotuned tile); on
    the CPU ``TPU_V5E``. Where every width's GEMM grid fits in one wave of
    the card's SMs (full-width qwen at 96 or 128 tokens), the GPU form
    cuts nothing and every rung is full width."""
    gpu = device.type == "cuda"
    hw = H100_SXM if gpu else TPU_V5E
    templates, modules = serving_templates(cfg, hw, tokens=tokens,
                                           sites=("mlp",))
    planner = ServingWidthPlanner(hw, templates, modules=modules,
                                  device=device,
                                  tile_hw=H100_SXM if gpu else None)
    traffic = [TrafficClass("burst", tokens)]
    planner.plan(traffic)
    return planner, DegradationLadder.build(
        planner, traffic, deltas=LADDER_DELTAS,
        tile_hw=H100_SXM if gpu else None)


# ---------------------------------------------------------------------------
# burst: one static engine
# ---------------------------------------------------------------------------
def burst_engine(params, cfg, planner, ladder, *, device, degrade: bool,
                 cache=None):
    """``examples/serve_resilient.py``'s engine: admission control, seeded
    straggler batches, and with ``degrade`` a swapper whose swaps fault at
    a seeded 0.2 rate and a controller over ``ladder``."""
    swapper = degrader = eng_planner = None
    injector = SwapFailureInjector(0.2, seed=1, steps=("begin",))
    if degrade:
        eng_planner = planner
        swapper = WidthSwapper(params, cfg, fault_hook=injector)
        degrader = DegradationController(
            ladder, down_threshold=1.0, up_threshold=0.5,
            down_patience=1, up_patience=2)
    eng = ServeEngine(
        params, cfg, max_len=48, batch_slots=SLOTS, device=device,
        planner=eng_planner, swapper=swapper,
        admission=AdmissionControl(max_queue_batches=CAP,
                                   target_batch_s=0.25,
                                   ewma_alpha=0.5, headroom=2.0),
        degrader=degrader, clock=VirtualClock(),
        batch_cost_fn=modeled_batch_cost(
            1e-3, overhead_s=0.01,
            slow=SlowBatchInjector(0.25, 0.05, seed=11)),
        compile_cache=cache)
    if cache is not None:
        plans = [p for r in ladder.rungs for p in r.plans.values()]
        eng.warm_compile(plans, [(b, BURST_PROMPT)
                                 for b in range(1, SLOTS + 1)])
    return eng, injector


def run_burst(params, cfg, *, device) -> dict:
    planner, ladder = ladder_for(cfg, device, tokens=BURST_TOKENS)
    for rung in ladder.rungs:
        widths = sorted({w for p in rung.plans.values()
                         for w in p.widths.values()}) or ["full"]
        print(f"ladder level {rung.level}: widths {widths} "
              f"(modeled -{rung.reduction:.1%})")
    # static engines may share a step cache: a batch keeps no state
    cache = WidthVariantCompileCache(cfg, hw=H100_SXM) \
        if device.type == "cuda" else None

    eng, injector = burst_engine(params, cfg, planner, ladder,
                                 device=device, degrade=True, cache=cache)
    burst = burst_requests(cfg.vocab_size, n=BURST_N,
                           prompt_len=BURST_PROMPT, max_new_tokens=BURST_NEW,
                           deadline_s=0.6, seed=3)
    tight = LoadReport.from_results(eng.generate(burst))
    print(f"4x burst, 0.6s deadlines: {tight.completed} served / "
          f"{tight.shed} shed / {tight.deadline_missed} missed "
          f"(p50 {tight.p50_s * 1e3:.0f}ms, p99 {tight.p99_s * 1e3:.0f}ms)")
    for s in eng.degrader.shift_log:
        print(f"  shift {s.direction}: level {s.level} at batch "
              f"{s.batch_index} (signal {s.signal:.2f})")
    rolled = [ev for ev in eng.swap_log if ev.outcome == "rolled_back"]
    print(f"  swaps rolled back: {len(rolled)} of {len(eng.swap_log)} "
          f"(injected {injector.injected}); every batch served")

    light = burst_requests(cfg.vocab_size, n=2, prompt_len=BURST_PROMPT,
                           max_new_tokens=BURST_NEW, seed=4)
    for _ in range(6):
        eng.generate(light)
    print(f"after the burst: degradation level {eng.degrader.level}")

    relaxed = burst_requests(cfg.vocab_size, n=BURST_N,
                             prompt_len=BURST_PROMPT,
                             max_new_tokens=BURST_NEW, deadline_s=100.0,
                             seed=3)
    full = LoadReport.from_results(burst_engine(
        params, cfg, planner, ladder, device=device, degrade=False,
        cache=cache)[0].generate(relaxed))
    deg = LoadReport.from_results(burst_engine(
        params, cfg, planner, ladder, device=device, degrade=True,
        cache=cache)[0].generate(relaxed))
    print(f"same burst, no shedding: p99 full {full.p99_s * 1e3:.0f}ms -> "
          f"degraded {deg.p99_s * 1e3:.0f}ms "
          f"({full.p99_s / deg.p99_s:.2f}x)")
    if cache is not None:
        print(f"step cache: {cache.stats}")
    return {"tight": tight, "full": full, "degraded": deg,
            "shifts": [(s.direction, s.level, s.batch_index)
                       for s in eng.degrader.shift_log],
            "level_after": eng.degrader.level,
            "rolled_back": len(rolled), "injected": injector.injected,
            "ladder": ladder}


# ---------------------------------------------------------------------------
# fleet: continuous replicas behind the router
# ---------------------------------------------------------------------------
def fleet_arrivals(cfg, *, n: int, prompt_lens, new_tokens, gap_s: float,
                   seed: int) -> list:
    """``n`` arrivals ``gap_s`` apart with seeded prompts; ``prompt_lens``
    and ``new_tokens`` are an int or a sequence cycled over the
    arrivals."""
    lens = np.resize(np.atleast_1d(prompt_lens), n)
    news = np.resize(np.atleast_1d(new_tokens), n)
    rng = np.random.default_rng(seed)
    return [Arrival(t=gap_s * i, request=Request(
        prompt=rng.integers(0, cfg.vocab_size, size=(int(lens[i]),))
        .astype(np.int32), max_new_tokens=int(news[i])), klass="burst")
        for i in range(n)]


def fleet_tokens(arrivals, *, slots: int, prefill_chunk=None) -> int:
    """The traffic class of a fleet's ladder, from its arrivals: the step
    size at which half of the fleet's tokens are served. A prompt is one
    join step of its length (chunked: steps of ``prefill_chunk``), and the
    tokens after each first one decode ``slots`` to a step.
    ``modeled_batch_cost`` scales every costed step's tokens by the one
    plan's ratio, so the class sits where the tokens are."""
    sizes, decode = [], 0
    for a in arrivals:
        plen = len(a.request.prompt)
        c = prefill_chunk or plen
        sizes += [min(c, plen - k) for k in range(0, plen, c)]
        decode += a.request.max_new_tokens - 1
    sizes += [slots] * (decode // slots) + [decode % slots] * (
        decode % slots > 0)
    sizes = np.sort(sizes)
    cum = np.cumsum(sizes)
    return int(sizes[np.searchsorted(cum, cum[-1] / 2)])


def _then(first, second):
    """Two batch-cost wrappers composed: ``second(first(base_s))``."""
    return lambda base_s: second(first(base_s))


def build_fleet(params, cfg, *, device, slots: int = 4, max_len: int = 64,
                prefill_chunk=4, step_token_budget=16,
                ladder=None, crash_at=None, caches=None,
                warm_lengths=()) -> dict:
    """Two replicas, ``r0`` stalled ``STALL``x (and crashing at its
    ``crash_at``-th costed step, if given), each on its own VirtualClock.
    With ``ladder`` each carries a swapper, admission control and a
    controller that only a hedge's pins move (patience 10^6). ``caches``
    (one step cache per replica) are warmed for ``warm_lengths`` and, with
    ``ladder``, every rung's plans before serving. ``params`` must be the
    cast tree (``cast_params``) when ``ladder`` is given."""
    replicas = {}
    for k in range(2):
        slow = None
        if k == 0:
            slow = ReplicaStallInjector(STALL)
            if crash_at is not None:
                slow = _then(slow, ReplicaCrashInjector(at_step=crash_at))
        kw = {}
        if ladder is not None:
            kw = dict(swapper=WidthSwapper(params, cfg),
                      admission=AdmissionControl(max_queue_batches=8,
                                                 target_batch_s=1.0),
                      degrader=DegradationController(
                          ladder, down_patience=10 ** 6,
                          up_patience=10 ** 6))
        eng = ContinuousServeEngine(
            params, cfg, max_len=max_len, batch_slots=slots, device=device,
            clock=VirtualClock(), prefill_chunk=prefill_chunk,
            step_token_budget=step_token_budget,
            compile_cache=None if caches is None else caches[k],
            batch_cost_fn=modeled_batch_cost(PER_TOKEN_S,
                                             overhead_s=OVERHEAD_S,
                                             slow=slow), **kw)
        if caches is not None:
            plans = [] if ladder is None else [
                p for r in ladder.rungs for p in r.plans.values()]
            eng.warm_compile(plans, warm_lengths)
        replicas[f"r{k}"] = eng
    return replicas


def serve_fleet(replicas: dict, arrivals: list, *, hedge=None) -> dict:
    """Serve ``arrivals`` through a ``ReplicaRouter`` over ``replicas``
    (``hedge``: None, or the rung of a ``HedgePolicy`` with a 10 ms default
    delay); health draining off, so the tail is the hedge's alone, as in
    ``benchmarks/optimizer_scale.py``."""
    router = ReplicaRouter(
        replicas, hedge=None if hedge is None else HedgePolicy(
            default_delay_s=0.01, rung=int(hedge)), slow_factor=None)
    t0 = time.perf_counter()
    results = router.run([Arrival(a.t, a.request, a.klass)
                          for a in arrivals])
    dev = next(iter(replicas.values())).device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    ok = [r for r in results if not r.shed and not r.failed]
    lats = np.asarray([r.latency_s for r in ok])
    return {"router": router, "results": results, "ledger": router.ledger(),
            "wall_s": wall, "tokens": sum(len(r.tokens) for r in results),
            "tail": TailReport.build("fleet", results),
            "p999_s": float(np.percentile(lats, 99.9)) if lats.size
            else float("nan")}


def report_fleet(out: dict, label: str) -> None:
    led, tail, router = out["ledger"], out["tail"], out["router"]
    print(f"{label}: router ledger {led.submitted} submitted = "
          f"{led.finished} finished + {led.shed} shed + {led.failed} failed "
          f"(complete {led.complete}); hedges {led.hedged}, backup wins "
          f"{led.hedge_wins_backup}, migrated {led.migrated}")
    print(f"{label}: virtual latency p50 {tail.p50_s * 1e3:.3f}ms, p99 "
          f"{tail.p99_s * 1e3:.3f}ms, p99.9 {out['p999_s'] * 1e3:.3f}ms; "
          f"{out['tokens']} tokens in {out['wall_s']:.3f}s wall")
    print(f"{label}: health log "
          f"{[(h.replica, h.state, h.reason) for h in router.health_log]}")
    for r in router.replicas:
        cache = r.engine.compile_cache
        stats = "no step cache" if cache is None else {
            k: cache.stats[k] for k in ("hits", "misses", "fallbacks")}
        print(f"{label}: {r.name} ({r.state}) ledger "
              f"{r.engine.ledger()}, step cache {stats}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="the examples' small config (d_model 128, 2 "
                         "layers, d_ff 576)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scenario", choices=("burst", "fleet"),
                    default="fleet")
    ap.add_argument("--hedge", choices=("none", "0", "1"), default="0")
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--cached", action="store_true")
    ap.add_argument("--requests", type=int, default=BURST_N)
    ap.add_argument("--prompt-len", type=int, default=13)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--prefill-chunk", type=int, default=4,
                    help="0: whole-prompt joins")
    ap.add_argument("--step-token-budget", type=int, default=16)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg, d_model=128, n_layers=2, d_ff=576)
    refuse_non_text(cfg)
    device = require_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False
    params = cast_params(init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device),
        device)
    print(f"{cfg.name} on {device}, scenario {args.scenario}")
    if args.scenario == "burst":
        return run_burst(params, cfg, device=device)

    hedge = None if args.hedge == "none" else int(args.hedge)
    chunk = args.prefill_chunk or None
    arrivals = fleet_arrivals(cfg, n=args.requests,
                              prompt_lens=args.prompt_len,
                              new_tokens=args.new_tokens, gap_s=0.001,
                              seed=args.seed + 7)
    ladder = None
    if hedge == 1:
        tokens = fleet_tokens(arrivals, slots=args.slots,
                              prefill_chunk=chunk)
        ladder = ladder_for(cfg, device, tokens=tokens)[1]
        print(f"ladder at {tokens} tokens: rung 1 modeled "
              f"-{ladder.rung(1).reduction:.2%}")
    caches = None
    if args.cached:
        caches = [WidthVariantCompileCache(
            cfg, hw=H100_SXM if device.type == "cuda" else None)
            for _ in range(2)]
    replicas = build_fleet(
        params, cfg, device=device, slots=args.slots, max_len=args.max_len,
        prefill_chunk=chunk,
        step_token_budget=args.step_token_budget if chunk else None,
        ladder=ladder, crash_at=args.crash_at, caches=caches,
        warm_lengths=(args.prompt_len,))
    out = serve_fleet(replicas, arrivals, hedge=hedge)
    crash = "" if args.crash_at is None else f", crash at {args.crash_at}"
    report_fleet(out, f"fleet (hedge {args.hedge}{crash})")
    return out


if __name__ == "__main__":
    main()
