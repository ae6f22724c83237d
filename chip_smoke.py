#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card (an H100 is
the target) and ``nvcc``:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every kernel of the port from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once) and prints the build time;
3. holds each kernel against its plain PyTorch version on the card at the
   serving path's shapes and a few ragged, GQA and local cases, and times
   the kernel, the plain version, the one PyTorch call that computes the
   same function (a yardstick only: the port never calls it) and the
   least time the card could take for the work;
4. serves 4 mixed-length requests with full-width qwen1.5-0.5b (random
   weights from seed 0) through ``ServeEngine``, with the launch counts set
   to 0 just before and read just after; checks the counts, that a second
   run gives the same tokens, that the prefill logits agree with the same
   forward on the plain versions, that a small model served on the card
   agrees with the CPU, and that the serving CLI runs on the card;
5. prints one JSON line with every kernel's numbers, then, last,
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero. Without a card, or outside a checkout, it
exits non-zero and prints no result. TF32 is off: fp32 products are fp32.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
L2_BYTES = 50e6
ARCH = "qwen1.5-0.5b"
PROMPT_LENS = (128, 97, 64, 33)   # prefill M = 4 x 128 = 512
NEW_TOKENS = 16
SEED = 0

REPLACES = {
    "matmul_tiled": "src/repro/kernels/matmul_tiled.py:40",
    "flash_attention": "src/repro/kernels/flash_attention.py:70",
}
SOURCES = {
    "matmul_tiled": "src/repro_torch/csrc/matmul_tiled.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_ms(torch, fn, args: tuple, reps: int = 50) -> float:
    """Mean device ms of fn over ``reps`` calls: the calls are captured in
    one CUDA graph and the replay is timed with CUDA events, so the host's
    launch overhead does not count. Calls rotate over copies of ``args``
    whose total exceeds twice the L2, so each call finds its inputs in
    device memory, as a layer of a deep model does."""
    nbytes = sum(t.numel() * t.element_size() for t in args
                 if hasattr(t, "numel"))
    copies = max(1, min(32, math.ceil(2 * L2_BYTES / nbytes))) if nbytes \
        else 1
    sets = [args] + [tuple(t.clone() if hasattr(t, "clone") else t
                           for t in args) for _ in range(copies - 1)]
    n = max(reps, copies)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in sets:                     # warm-up before the capture
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*sets[i % copies])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / n


def wall_ms(torch, fn, reps: int = 10) -> float:
    """Mean host-clock ms of eager calls, ending in a synchronize: what a
    caller waits, launch overhead included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def visible_pairs(sq: int, skv: int, mask: str, window: int) -> int:
    """(query, key) pairs the mask lets through, per batch row and head."""
    total = 0
    for i in range(sq):
        hi = min(skv, i + 1) if mask in ("causal", "local") else skv
        lo = max(0, i - window + 1) if mask == "local" and window > 0 else 0
        total += max(0, hi - lo)
    return total


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def card_info(torch) -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = out.stdout.strip().splitlines()[0]
    log(line)
    return line


def build_kernels(build) -> None:
    t0 = time.time()
    with ThreadPoolExecutor(len(build.LAUNCHES)) as pool:
        paths = list(pool.map(build.compile_source, build.LAUNCHES))
    log(f"build: {len(paths)} kernels in {time.time() - t0:.1f}s "
        f"({', '.join(p.name for p in paths)})")


def compare_matmul(torch, mt, case: tuple, gen) -> dict:
    m, k, n = case
    x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    w = torch.randn(k, n, generator=gen, device="cuda").bfloat16()
    out = mt.matmul_tiled(x, w)
    torch.cuda.synchronize()
    ref = mt.matmul_ref(x, w)
    err = (out.float() - ref.float()).abs().max().item()
    # both round one fp32 sum per output to bf16; sums in other orders
    # may land one bf16 step apart: two steps at the largest output
    tol = 2.0 ** -7 * ref.float().abs().max().item()
    check(bool(torch.isfinite(out.float()).all()) and err <= tol,
          f"matmul_tiled {case}: max_abs_err {err} > tol {tol}")
    b_ms, b_by = bound_ms(2.0 * m * n * k, 2.0 * (m * k + k * n + m * n))
    row = {"case": f"M={m} K={k} N={n}", "max_abs_err": err, "tol": tol,
           "ms": time_ms(torch, mt.matmul_tiled, (x, w)),
           "plain_ms": time_ms(torch, mt.matmul_ref, (x, w)),
           "library_ms": time_ms(torch, torch.matmul, (x, w)),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"matmul_tiled {row['case']}: max_abs_err {err:.4g} tol {tol:.4g} "
        f"ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} library_ms "
        f"{row['library_ms']:.4f} bound_ms {b_ms:.4f} ({b_by}) "
        f"grid {mt.grid_blocks(m, n)} CTAs")
    return row


def compare_flash(torch, fa, case: tuple, gen) -> dict:
    b, sq, skv, h, kv, dh, mask, window = case
    q = torch.randn(b, sq, h, dh, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, skv, kv, dh, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, skv, kv, dh, generator=gen, device="cuda").bfloat16()
    out = fa.flash_attention(q, k, v, mask_kind=mask, window=window)
    torch.cuda.synchronize()
    ref = fa.attention_ref(q, k, v, mask_kind=mask, window=window)
    err = (out.float() - ref.float()).abs().max().item()
    tol = 4e-2       # bf16 tolerance of repro's kernel tests
    check(bool(torch.isfinite(out.float()).all()) and err <= tol,
          f"flash_attention {case}: max_abs_err {err} > tol {tol}")

    import torch.nn.functional as F
    attn_mask = None
    if mask == "local":
        i = torch.arange(sq, device="cuda")[:, None]
        j = torch.arange(skv, device="cuda")[None, :]
        attn_mask = (j <= i) & (j > i - window)

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=attn_mask, is_causal=(mask == "causal"),
            enable_gqa=(kv != h))

    pairs = visible_pairs(sq, skv, mask, window)
    b_ms, b_by = bound_ms(4.0 * b * h * pairs * dh,
                          2.0 * (2 * b * sq * h * dh + 2 * b * skv * kv * dh))
    row = {"case": f"B={b} Sq={sq} Skv={skv} H={h} KV={kv} dh={dh} "
                   f"{mask}" + (f" w={window}" if mask == "local" else ""),
           "max_abs_err": err, "tol": tol,
           "ms": time_ms(torch, lambda *a: fa.flash_attention(
               *a, mask_kind=mask, window=window), (q, k, v)),
           "plain_ms": time_ms(torch, lambda *a: fa.attention_ref(
               *a, mask_kind=mask, window=window), (q, k, v)),
           "library_ms": time_ms(torch, library, (q, k, v)),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"flash_attention {row['case']}: max_abs_err {err:.4g} tol {tol} "
        f"ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} library_ms "
        f"{row['library_ms']:.4f} bound_ms {b_ms:.4f} ({b_by})")
    return row


def requests(cfg, Request, np):
    rng = np.random.default_rng(SEED)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, size=(n,))
                    .astype(np.int32), max_new_tokens=NEW_TOKENS)
            for n in PROMPT_LENS]


def serve_full_width(torch, np, mods) -> dict:
    """The main path: full-width qwen1.5-0.5b through ServeEngine."""
    cfg = mods["configs"].get_config(ARCH)
    tfm, Request, ServeEngine = mods["tfm"], mods["Request"], \
        mods["ServeEngine"]
    ops = mods["ops"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = tfm.init_params(cfg, gen, "cuda")
    max_len = max(PROMPT_LENS) + NEW_TOKENS
    engine = ServeEngine(params, cfg, max_len=max_len, batch_slots=4,
                         rng_seed=SEED, device="cuda")
    del params
    torch.cuda.synchronize()

    ops.reset_launches()
    t0 = time.perf_counter()
    first = engine.generate(requests(cfg, Request, np))
    cold_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    # prefill: 3 MLP products and 1 attention per layer; each of the
    # NEW_TOKENS - 1 decode steps: 3 MLP products per layer
    want = {"matmul_tiled": 3 * cfg.n_layers * NEW_TOKENS,
            "flash_attention": cfg.n_layers}
    log(f"serve {ARCH}: layers {cfg.n_layers} d_model {cfg.d_model} vocab "
        f"{cfg.vocab_size}; launches {launches} (expected {want}); first "
        f"run {cold_s:.3f}s")
    check(launches == want, f"launch counts {launches} != {want}")

    t0 = time.perf_counter()
    second = engine.generate(requests(cfg, Request, np))
    warm_s = time.perf_counter() - t0
    for a, b in zip(first, second):
        check(np.array_equal(a.tokens, b.tokens),
              "a second run gave other tokens")
    n_new = sum(len(r.tokens) for r in second)
    check(all(len(r.tokens) == NEW_TOKENS and (r.tokens >= 0).all()
              and (r.tokens < cfg.vocab_size).all() for r in second),
          "tokens out of range or of the wrong count")
    log(f"serve {ARCH}: {n_new} tokens in {warm_s:.3f}s "
        f"({n_new / warm_s:.1f} tok/s, second run); tokens of request 0: "
        f"{second[0].tokens.tolist()}")

    # prefill logits on the kernels vs the same forward on the plain
    # versions, on the engine's left-padded batch
    plen = max(PROMPT_LENS)
    toks = np.zeros((len(PROMPT_LENS), plen), np.int64)
    for i, r in enumerate(requests(cfg, Request, np)):
        toks[i, plen - len(r.prompt):] = r.prompt
    toks = torch.from_numpy(toks).cuda()
    with torch.inference_mode():
        got, _ = tfm.forward(engine.params, cfg, tokens=toks, mode="prefill")
        want_l, _ = tfm.forward(engine.params, cfg, tokens=toks,
                                mode="prefill", force="plain")
    v = cfg.vocab_size
    got, want_l = got[..., :v].float(), want_l[..., :v].float()
    check(bool(torch.isfinite(got).all()) and got.shape == want_l.shape,
          "prefill logits not finite or of the wrong shape")
    err = (got - want_l).abs().max().item()
    scale = want_l.abs().max().item()
    # 24 layers of bf16 activations: the two paths differ by bf16 steps
    # (P rounded to bf16 inside the attention kernel, matmul sums in
    # another order) that the residual stream carries; allow 5% of the
    # largest logit
    tol = 0.05 * scale
    agree = (got.argmax(-1) == want_l.argmax(-1)).float().mean().item()
    log(f"prefill logits kernels vs plain: max_abs_err {err:.4g} tol "
        f"{tol:.4g} (max |logit| {scale:.4g}); argmax agreement "
        f"{agree:.4f}")
    check(err <= tol, f"prefill logits differ by {err} > {tol}")
    del got, want_l

    # where a step's time goes: eager wall time vs the device time of the
    # same work replayed from a CUDA graph (no host in the way)
    cur = torch.zeros(len(PROMPT_LENS), dtype=torch.long, device="cuda")
    with torch.inference_mode():
        _, st = tfm.forward(engine.params, cfg, tokens=toks, mode="prefill")
        st = engine._ensure_states(st)
        steps = {
            "prefill": lambda: tfm.forward(engine.params, cfg, tokens=toks,
                                           mode="prefill"),
            "decode step": lambda: tfm.decode_step(engine.params, cfg, cur,
                                                   plen, st)}
        split = {}
        for name, fn in steps.items():
            wall, dev = wall_ms(torch, fn), time_ms(torch, fn, (), reps=8)
            split[name] = (wall, dev)
            log(f"{name}: wall {wall:.3f} ms, device {dev:.3f} ms, device "
                f"idle {100 * (1 - dev / wall):.1f}% of the wall time")
    del engine, st
    torch.cuda.empty_cache()
    return {"launches": launches, "tok_s": n_new / warm_s, "split": split}


def small_model_vs_cpu(torch, np, mods) -> None:
    """A small model (head dim 64, as the kernel takes) served on the card
    must agree with the same weights on the CPU's plain path."""
    c = mods["configs"]
    tfm = mods["tfm"]
    cfg = c.reduced_config(c.get_config(ARCH), n_layers=2, d_model=256,
                           n_heads=4, d_ff=512, vocab=250)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(3, 37)))
    with torch.inference_mode():
        cpu, _ = tfm.forward(tfm.cast_params(params, "cpu"), cfg,
                             tokens=toks, mode="prefill")
        gpu, _ = tfm.forward(tfm.cast_params(params, "cuda"), cfg,
                             tokens=toks.cuda(), mode="prefill")
    v = cfg.vocab_size
    gpu, cpu = gpu[..., :v].float().cpu(), cpu[..., :v].float()
    err = (gpu - cpu).abs().max().item()
    tol = 4e-2 * max(1.0, cpu.abs().max().item())
    log(f"small model card vs CPU: prefill logits max_abs_err {err:.4g} "
        f"tol {tol:.4g}")
    check(bool(torch.isfinite(gpu).all()) and err <= tol,
          f"small model on the card differs from the CPU by {err}")


def cli_on_card(mods) -> None:
    ops = mods["ops"]
    ops.reset_launches()
    results = mods["serve_main"](["--requests", "4", "--prompt-len", "32",
                                  "--new-tokens", "4"])
    check(len(results) == 4 and all(len(r.tokens) == 4 for r in results),
          "the serving CLI returned the wrong results")
    check(all(n > 0 for n in ops.LAUNCHES.values()),
          f"the serving CLI skipped a kernel: {dict(ops.LAUNCHES)}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA device")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} is missing: run from a checkout")
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch import configs
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul_tiled as mt
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import Request, ServeEngine
    mods = {"configs": configs, "ops": ops, "tfm": tfm, "Request": Request,
            "ServeEngine": ServeEngine, "serve_main": serve_main}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    card = card_info(torch)
    build_kernels(build)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mm = [compare_matmul(torch, mt, c, gen) for c in
          [(512, 1024, 2816), (512, 2816, 1024), (4, 1024, 2816),
           (4, 2816, 1024), (100, 130, 70)]]
    fl = [compare_flash(torch, fa, c, gen) for c in
          [(4, 128, 128, 16, 16, 64, "causal", 0),
           (4, 100, 100, 16, 16, 64, "causal", 0),
           (2, 256, 256, 16, 4, 64, "causal", 0),
           (2, 256, 256, 8, 2, 128, "local", 96),
           (1, 100, 130, 4, 4, 64, "none", 0)]]

    served = serve_full_width(torch, np, mods)
    small_model_vs_cpu(torch, np, mods)
    cli_on_card(mods)

    kernels = []
    for name, row in (("matmul_tiled", mm[0]), ("flash_attention", fl[0])):
        check(served["launches"][name] > 0,
              f"{name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": served["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "case": row["case"]})
    log(f"card: {card}; total {time.time() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
