"""Continuous-batching serving CLI: an open stream of requests through
``ContinuousServeEngine``, with random weights from a seed (the serving
part of ``examples/serve_continuous.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve_continuous \
        --arch qwen1.5-0.5b --requests 16 --slots 4 --cached

    PYTHONPATH=src python -m repro_torch.launch.serve_continuous \
        --prefill-chunk 64 --step-token-budget 68 --rate 50 --cached

    PYTHONPATH=src python -m repro_torch.launch.serve_continuous \
        --device cpu --reduced

Runs on the card (``--device cuda``, the default) and fails if there is
none; ``--device cpu`` runs the kernels' plain versions on the CPU (with
``--reduced`` for the small configs). Requests join and leave the running
decode batch in flight; without ``--rate`` they all arrive at once, with
it they arrive as a Poisson stream of that many requests a second
(``chaos.open_loop_arrivals``). ``--prefill-chunk`` prefills joins in
chunks interleaved with decode, ``--cached`` serves every step from the
step cache (CUDA graphs on the card, captured before serving). Prints
the ledger, tokens/s and the p50 / p99 request latency.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.core import H100_SXM
from repro_torch.models import init_params
from repro_torch.launch.serve import refuse_non_text
from repro_torch.serving.chaos import (
    TailReport, TrafficLoad, open_loop_arrivals)
from repro_torch.serving.compile_cache import WidthVariantCompileCache
from repro_torch.serving.continuous import Arrival, ContinuousServeEngine
from repro_torch.serving.engine import Request, require_device


class WaitingClock:
    """``time.monotonic`` that can wait: the engine fast-forwards an idle
    gap to the next arrival through ``advance``, which sleeps until
    then, so that no request is served before it arrives."""

    def __call__(self) -> float:
        return time.monotonic()

    def advance(self, dt: float) -> float:
        time.sleep(max(float(dt), 0.0))
        return time.monotonic()


def build_engine(params, cfg, *, device, slots: int, max_len: int,
                 prefill_chunk=None, step_token_budget=None,
                 cached: bool = False, seed: int = 0,
                 warm_lengths=()) -> ContinuousServeEngine:
    """The CLI's engine, on a :class:`WaitingClock`: with ``cached``, a
    step cache whose decode step and prefill buckets (or chunk shapes) for
    ``warm_lengths`` are captured before serving."""
    cache = None
    if cached:
        cache = WidthVariantCompileCache(
            cfg, hw=H100_SXM if torch.device(device).type == "cuda"
            else None)
    engine = ContinuousServeEngine(
        params, cfg, max_len=max_len, batch_slots=slots, rng_seed=seed,
        device=device, compile_cache=cache, prefill_chunk=prefill_chunk,
        step_token_budget=step_token_budget, clock=WaitingClock())
    if cached:
        engine.warm_compile([], warm_lengths)
    return engine


def arrivals(cfg, *, n: int, prompt_len: int, new_tokens: int,
             rate=None, seed: int = 0, start: float = 0.0) -> list:
    """``n`` requests of ``prompt_len`` seeded tokens: bare requests that
    arrive at once, or, with ``rate``, the first ``n`` arrivals of a
    Poisson stream at ``rate`` a second from ``start``."""
    if not rate:
        rng = np.random.default_rng(seed)
        return [Request(prompt=rng.integers(0, cfg.vocab_size,
                                            size=(prompt_len,))
                        .astype(np.int32), max_new_tokens=new_tokens)
                for _ in range(n)]
    load = TrafficLoad("poisson", rate_rps=float(rate),
                       duration_s=10.0 * n / float(rate) + 1.0,
                       prompt_len=prompt_len, max_new_tokens=new_tokens)
    return [Arrival(t=start + a.t, request=a.request, klass=a.klass)
            for a in open_loop_arrivals([load], cfg.vocab_size,
                                        seed=seed)[:n]]


def serve(engine: ContinuousServeEngine, work: list) -> dict:
    """Serve ``work`` to completion; returns the results, the ledger, the
    wall seconds, tokens/s and the latency tail."""
    t0 = time.perf_counter()
    results = engine.run(work)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.perf_counter() - t0
    n_new = sum(len(r.tokens) for r in results)
    return {"results": results, "ledger": engine.ledger(), "wall_s": wall,
            "tok_s": n_new / wall, "tokens": n_new,
            "tail": TailReport.build("all", results)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--step-token-budget", type=int, default=None)
    ap.add_argument("--rate", type=float, default=None,
                    help="Poisson arrivals a second (default: all at once)")
    ap.add_argument("--cached", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    refuse_non_text(cfg)
    device = require_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False

    params = init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    engine = build_engine(
        params, cfg, device=device, slots=args.slots, max_len=args.max_len,
        prefill_chunk=args.prefill_chunk,
        step_token_budget=args.step_token_budget, cached=args.cached,
        seed=args.seed, warm_lengths=(args.prompt_len,))
    del params
    work = arrivals(cfg, n=args.requests, prompt_len=args.prompt_len,
                    new_tokens=args.new_tokens, rate=args.rate,
                    seed=args.seed, start=engine.clock())
    out = serve(engine, work)
    led, tail = out["ledger"], out["tail"]
    print(f"{cfg.name} on {device}: {len(work)} requests, {args.slots} "
          f"slots, joins {engine.join_count}, chunks {engine.chunk_steps}"
          f"{', cached' if args.cached else ''}")
    print(f"ledger: {led.submitted} submitted = {led.finished} finished "
          f"+ {led.shed} shed + {led.failed} failed (complete "
          f"{led.complete})")
    print(f"{out['tokens']} tokens in {out['wall_s']:.2f}s "
          f"({out['tok_s']:.1f} tok/s); latency p50 {tail.p50_s:.4f}s, "
          f"p99 {tail.p99_s:.4f}s")
    if engine.compile_cache is not None:
        print(f"step cache: {engine.compile_cache.stats}")
    for i, r in enumerate(out["results"][:4]):
        print(f"  req{i}: {r.tokens[:12].tolist()}...")
    return out


if __name__ == "__main__":
    main()
