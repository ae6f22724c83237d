"""Serving CLI: batched generation with random weights from a seed.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --requests 8 --new-tokens 16

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-1b-a400m

Runs on the card (``--device cuda``, the default) and fails if there is
none; ``--device cpu`` runs the kernels' plain versions on the CPU (with
``--reduced`` for the small configs). Serves qwen1.5-0.5b and the other
global-attention archs, recurrentgemma-2b, rwkv6-1.6b and the MoE archs
(granite-moe-1b-a400m; dense expert products, as ``repro`` serves them).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.models import init_params
from repro_torch.models.transformer import unsupported
from repro_torch.serving.engine import Request, ServeEngine, require_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    why = unsupported(cfg)
    if why is not None:
        raise SystemExit(f"{cfg.name}: the port serves decoder-only "
                         f"attention, local-attention, RG-LRU, RWKV6 and "
                         f"MoE archs; {why} are not ported yet")
    device = require_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    engine = ServeEngine(params, cfg,
                         max_len=args.prompt_len + args.new_tokens,
                         batch_slots=args.batch_slots, rng_seed=args.seed,
                         device=device)
    del params
    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        size=(args.prompt_len,)).astype(
                        np.int32),
                    max_new_tokens=args.new_tokens,
                    temperature=args.temperature)
            for _ in range(args.requests)]
    t0 = time.time()
    results = engine.generate(reqs)
    dt = time.time() - t0
    total_new = sum(len(r.tokens) for r in results)
    print(f"{len(reqs)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s) on {device}")
    for i, r in enumerate(results[:4]):
        print(f"  req{i}: {r.tokens[:12].tolist()}...")
    return results


if __name__ == "__main__":
    main()
