#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card (an H100 is
the target) and ``nvcc``:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the port from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once) and prints the build time; Triton
   compiles its kernels (staircase, RG-LRU) into ``build/triton`` at their
   first launch;
3. holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes and a few ragged, GQA and local cases, and times
   the kernel, the plain version, the one PyTorch call that computes the
   same function, where there is one (a yardstick only: the port never
   calls it), and the least time the card could take for the work;
4. serves 4 mixed-length requests with full-width qwen1.5-0.5b (random
   weights from seed 0) through ``ServeEngine``, with the launch counts set
   to 0 just before and read just after; checks the counts, that a second
   run gives the same tokens, that the prefill logits agree with the same
   forward on the plain versions, that a small model served on the card
   agrees with the CPU, and that the serving CLI runs on the card; then
   the same for the recurrent families, full-width recurrentgemma-2b
   (RG-LRU prefill on the Triton kernel, its MLPs on the matmul kernel)
   and rwkv6-1.6b (RWKV6 prefill on its CUDA kernel, each pass of the
   prefill also held against its plain version on the layer's own inputs),
   each freed before the next, and ``launch.serve --arch rwkv6-1.6b`` on
   the card; then the MoE family, full-width granite-moe-1b-a400m (every
   expert product of the dense strategy, which ``repro`` serves, on the
   grouped-matmul kernel, each of the prefill's products also held against
   its plain version on its own inputs), one full-width prefill on the
   capacity strategy (the same checks on its capacity buffers), a small
   granite on the card against the CPU and ``launch.serve --arch
   granite-moe-1b-a400m``;
5. the planner path, with the counts set to 0 just before and read just
   after: plans two traffic classes for qwen1.5-0.5b on ``H100_SXM``
   (one staircase-kernel sweep each), checks that the plans equal the same
   planner's on the CPU, then serves bursts that select each class on the
   plans' sliced weights (a cold swap, then warm ones), with exact launch
   counts and the same tokens on a repeat; holds tokens/s and a decode
   step's device time on the plans against full width, in alternating
   bursts; checks that a hand-narrowed
   plan's sliced forward equals its zero-masked full-shape forward on the
   kernels, and runs ``launch.serve_batched`` on the card;
6. prints one JSON line with every kernel's numbers, then, last,
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
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
L2_BYTES = 50e6
ARCH = "qwen1.5-0.5b"
RECURRENT_ARCHS = ("recurrentgemma-2b", "rwkv6-1.6b")
MOE_ARCH = "granite-moe-1b-a400m"
PROMPT_LENS = (128, 97, 64, 33)   # prefill M = 4 x 128 = 512
NEW_TOKENS = 16
SEED = 0
# the RWKV6 kernel against its plain version, relative to the largest |o|
# and |S|: both accumulate in fp32 and sum in other orders; an output sums
# at most chunk + dh products and a score dh, each rounding by an fp32 ulp
# (6e-8), so the two differ by about 1e-7 of the largest value
RWKV6_RTOL = 1e-5
# the grouped expert matmul against its plain version, relative to the
# largest |out|: both sum each output in fp32 (in other orders) and round
# it once to bf16, so they land at most one bf16 step apart, 2^-7 of an
# element (0.78 %) just above a power of two; a wrong tile is far larger
MOE_RTOL = 1e-2

REPLACES = {
    "matmul_tiled": "src/repro/kernels/matmul_tiled.py:40",
    "flash_attention": "src/repro/kernels/flash_attention.py:70",
    "staircase_fused": "src/repro/kernels/staircase_fused.py:208",
    "rglru_scan": "src/repro/kernels/rglru.py:43",
    "rwkv6": "src/repro/kernels/rwkv6.py:66",
    "moe_gmm": "src/repro/kernels/moe_gmm.py:39",
}
SOURCES = {
    "matmul_tiled": "src/repro_torch/csrc/matmul_tiled.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "staircase_fused": "src/repro_torch/kernels/staircase_fused.py",
    "rglru_scan": "src/repro_torch/kernels/rglru.py",
    "rwkv6": "src/repro_torch/csrc/rwkv6.cu",
    "moe_gmm": "src/repro_torch/csrc/moe_gmm.cu",
}
ROUTES = {"matmul_tiled": "cuda", "flash_attention": "cuda",
          "staircase_fused": "triton", "rglru_scan": "triton",
          "rwkv6": "cuda", "moe_gmm": "cuda"}
# the planner path's traffic classes: one served burst selects each
# (batch x padded prompt tokens), "long" being the full-width burst's
CLASSES = (("short", 4 * 32), ("long", 4 * max(PROMPT_LENS)))
# bursts per side when tokens/s on the planned widths is held against full
# width, alternating which side goes first
AB_ROUNDS = 6


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


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
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
    with ThreadPoolExecutor(len(build.CUDA_SOURCES)) as pool:
        paths = list(pool.map(build.compile_source, build.CUDA_SOURCES))
    log(f"build: {len(paths)} CUDA kernels in {time.time() - t0:.1f}s "
        f"({', '.join(p.name for p in paths)}); Triton kernels "
        f"{', '.join(build.TRITON_KERNELS)} compile at first launch")


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


def expected_launches(tfm, cfg) -> dict:
    """Launches of one served batch (a prefill and NEW_TOKENS - 1 decode
    steps): in every forward, 3 MLP products per layer with a dense MLP
    and 3 grouped expert products per MoE layer (gate, up, down over every
    expert: the dense strategy); one flash attention per global layer, one
    RG-LRU scan per rglru layer and one RWKV6 pass per rwkv layer, in the
    prefill only (decode runs the single-step forms, as ``repro`` does).
    Local attention is plain torch, as ``repro`` computes it outside
    Pallas."""
    kinds = cfg.layer_kinds()
    mlps = [m for _, m in tfm.layer_plan(cfg)]
    return {"matmul_tiled": 3 * mlps.count("dense") * NEW_TOKENS,
            "flash_attention": kinds.count("attn"), "staircase_fused": 0,
            "rglru_scan": kinds.count("rglru"), "rwkv6": kinds.count("rwkv"),
            "moe_gmm": 3 * mlps.count("moe") * NEW_TOKENS}


def serve_full_width(torch, np, mods, arch: str = ARCH) -> dict:
    """A main path: full-width ``arch`` through ServeEngine."""
    cfg = mods["configs"].get_config(arch)
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
    want = expected_launches(tfm, cfg)
    log(f"serve {arch}: layers {cfg.n_layers} d_model {cfg.d_model} vocab "
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
    log(f"serve {arch}: {n_new} tokens in {warm_s:.3f}s "
        f"({n_new / warm_s:.1f} tok/s, second run); tokens of request 0: "
        f"{second[0].tokens.tolist()}")

    # prefill logits on the kernels vs the same forward on the plain
    # versions, on the engine's left-padded batch; in the kernels' forward
    # each RWKV6 pass and each grouped expert product is also held against
    # its plain version on its own inputs
    plen = max(PROMPT_LENS)
    toks = np.zeros((len(PROMPT_LENS), plen), np.int64)
    for i, r in enumerate(requests(cfg, Request, np)):
        toks[i, plen - len(r.prompt):] = r.prompt
    toks = torch.from_numpy(toks).cuda()
    layer_errs = []
    dispatch = ops.rwkv6

    def rwkv6_held(*args, **kw):
        o, s = dispatch(*args, **kw)
        ro, rs = dispatch(*args, **{**kw, "force": "plain"})
        layer_errs.append(rwkv6_errors(torch, o, s, ro, rs))
        return o, s

    ops.rwkv6 = rwkv6_held
    try:
        with torch.inference_mode():
            got, moe_errs = moe_held(torch, ops, lambda: tfm.forward(
                engine.params, cfg, tokens=toks, mode="prefill")[0])
    finally:
        ops.rwkv6 = dispatch
    with torch.inference_mode():
        want_l, _ = tfm.forward(engine.params, cfg, tokens=toks,
                                mode="prefill", force="plain")
    check_moe_held(tfm, cfg, moe_errs, f"{arch} dense prefill")
    check(len(layer_errs) == cfg.layer_kinds().count("rwkv"),
          f"{len(layer_errs)} RWKV6 passes in a prefill of "
          f"{cfg.layer_kinds().count('rwkv')} rwkv layers")
    for i, (finite, _, rel) in enumerate(layer_errs):
        check(finite and rel <= RWKV6_RTOL, f"{arch} rwkv layer {i}: RWKV6 "
              f"kernel vs plain on the layer's inputs: finite {finite}, "
              f"relative error {rel} > {RWKV6_RTOL}")
    if layer_errs:
        log(f"{arch} prefill: each of {len(layer_errs)} RWKV6 passes held "
            f"against its plain version on the layer's own inputs: finite, "
            f"max_abs_err up to {max(e for _, e, _ in layer_errs):.4g}, "
            f"relative up to {max(r for _, _, r in layer_errs):.3g} (tol "
            f"{RWKV6_RTOL})")
    v = cfg.vocab_size
    got, want_l = got[..., :v].float(), want_l[..., :v].float()
    check(bool(torch.isfinite(got).all()) and got.shape == want_l.shape,
          "prefill logits not finite or of the wrong shape")
    err = (got - want_l).abs().max().item()
    scale = want_l.abs().max().item()
    # 24-26 layers of bf16 activations: the two paths differ by bf16 steps
    # (P rounded to bf16 inside the attention kernel, matmul and recurrence
    # sums in another order) that the residual stream carries; allow 5% of
    # the largest logit. Not for rwkv6 at random weights: two plain
    # forwards whose RWKV6 sums in fp32 in other orders (chunk 32 and 16)
    # are already 4.5 % apart there, so its per-layer check above decides.
    # granite's dense experts hold to it; their floor (order_floor, logged)
    # read 3.3 % on the H100, from flipped near-tied top-8 choices
    tol = 0.05 * scale
    agree = (got.argmax(-1) == want_l.argmax(-1)).float().mean().item()
    if cfg.moe:
        floor = order_floor(torch, mods, engine.params, cfg, toks, "auto")
        log(f"{arch} dense prefill: two plain forwards differing only in "
            f"summation order: {floor:.4g} ({100 * floor / scale:.2f}% of "
            f"max |logit|)")
    log(f"{arch} prefill logits kernels vs plain: max_abs_err {err:.4g} "
        f"({100 * err / scale:.2f}% of max |logit| {scale:.4g}); argmax "
        f"agreement {agree:.4f}" + ("; rwkv: not held to 5%, see the "
                                    "per-layer check" if layer_errs else
                                    f"; tol {tol:.4g}"))
    check(bool(layer_errs) or err <= tol,
          f"prefill logits differ by {err} > {tol}")
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
            log(f"{arch} {name}: wall {wall:.3f} ms, device {dev:.3f} ms, "
                f"device idle {100 * (1 - dev / wall):.1f}% of the wall time")
    del st
    if cfg.moe:
        capacity_prefill(torch, mods, engine.params, cfg, toks)
    del engine
    torch.cuda.empty_cache()
    return {"launches": launches, "tok_s": n_new / warm_s, "split": split}


def moe_held(torch, ops, fn):
    """Run ``fn`` with every ``ops.moe_gmm`` call also held against its
    plain version on the same inputs; returns (fn's result, [(C, finite,
    max_abs_err, relative error)] per kernel launch). The plain calls
    count no launch."""
    errs, dispatch = [], ops.moe_gmm

    def held(x, w, **kw):
        out = dispatch(x, w, **kw)
        ref = dispatch(x, w, force="plain")
        e = (out.float() - ref.float()).abs().max().item()
        errs.append((x.shape[1], bool(torch.isfinite(out.float()).all()), e,
                     e / max(ref.float().abs().max().item(), 1e-30)))
        return out

    ops.moe_gmm = held
    try:
        return fn(), errs
    finally:
        ops.moe_gmm = dispatch


def check_moe_held(tfm, cfg, errs, what: str, rows=None) -> None:
    """Three held products per MoE layer, each within MOE_RTOL (and on
    ``rows``-row buffers, where given)."""
    n = 3 * sum(m == "moe" for _, m in tfm.layer_plan(cfg))
    check(len(errs) == n, f"{what}: {len(errs)} moe_gmm calls, expected {n}")
    for i, (c, finite, _, rel) in enumerate(errs):
        check(finite and rel <= MOE_RTOL and (rows is None or c == rows),
              f"{what}: moe_gmm call {i} (C={c}) vs plain on its inputs: "
              f"finite {finite}, relative error {rel} > {MOE_RTOL}")
    if errs:
        log(f"{what}: each of {len(errs)} moe_gmm launches (C = "
            f"{sorted({c for c, *_ in errs})}) held against its plain "
            f"version on its own inputs: finite, max_abs_err up to "
            f"{max(e for _, _, e, _ in errs):.4g}, relative up to "
            f"{max(r for *_, r in errs):.3g} (tol {MOE_RTOL})")


def order_floor(torch, mods, params, cfg, toks, strategy: str) -> float:
    """Largest logit difference between two plain forwards that differ only
    in the order of each expert product's fp32 sum (over all of D, or over
    its two halves, each rounded once to bf16): how far apart two right
    implementations land on this model, routing flips included."""
    tfm, ops = mods["tfm"], mods["ops"]
    dispatch = ops.moe_gmm

    def halves(x, w, **kw):
        h = x.shape[-1] // 2
        return (x[..., :h].float() @ w[:, :h].float()
                + x[..., h:].float() @ w[:, h:].float()).to(x.dtype)

    v = cfg.vocab_size
    with torch.inference_mode():
        a = tfm.forward(params, cfg, tokens=toks, mode="prefill",
                        moe_strategy=strategy, force="plain")[0]
        ops.moe_gmm = halves
        try:
            b = tfm.forward(params, cfg, tokens=toks, mode="prefill",
                            moe_strategy=strategy, force="plain")[0]
        finally:
            ops.moe_gmm = dispatch
    return (a[..., :v].float() - b[..., :v].float()).abs().max().item()


def capacity_prefill(torch, mods, params, cfg, toks) -> None:
    """One full-width prefill on the capacity strategy (``repro``'s
    production dispatch, reached by ``moe_strategy="capacity"``): exact
    launches and each grouped product on its (E, capacity, D) buffer held
    against its plain version. The logits are reported against the plain
    capacity forward's beside the noise floor (``order_floor``), not held
    to 5 %: two plain forwards that differ only in summation order are
    already 5.7 % of the largest logit apart here (a flipped near-tied
    top-8 choice also moves which tokens overflow a buffer)."""
    tfm, ops = mods["tfm"], mods["ops"]
    n_moe = sum(m == "moe" for _, m in tfm.layer_plan(cfg))
    cap = int(toks.numel() * cfg.experts_per_token * cfg.capacity_factor
              / cfg.n_experts) + 1
    ops.reset_launches()
    with torch.inference_mode():
        got, errs = moe_held(torch, ops, lambda: tfm.forward(
            params, cfg, tokens=toks, mode="prefill",
            moe_strategy="capacity")[0])
        launches = dict(ops.LAUNCHES)
        want = tfm.forward(params, cfg, tokens=toks, mode="prefill",
                           moe_strategy="capacity", force="plain")[0]
    check(launches["moe_gmm"] == 3 * n_moe and launches["flash_attention"]
          == cfg.layer_kinds().count("attn"),
          f"capacity prefill launched {launches}")
    check_moe_held(tfm, cfg, errs, f"{cfg.name} capacity prefill", rows=cap)
    v = cfg.vocab_size
    got, want = got[..., :v].float(), want[..., :v].float()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    floor = order_floor(torch, mods, params, cfg, toks, "capacity")
    log(f"{cfg.name} capacity prefill (capacity {cap} rows per expert): "
        f"launches {launches}; logits kernels vs plain max_abs_err "
        f"{err:.4g} ({100 * err / scale:.2f}% of max |logit| {scale:.4g}), "
        f"argmax agreement {agree:.4f}; two plain forwards differing only "
        f"in summation order: {floor:.4g} ({100 * floor / scale:.2f}%); "
        f"not held to 5 %, the per-launch check decides")
    check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
          "capacity prefill logits not finite or of the wrong shape")


def small_model_vs_cpu(torch, np, mods, arch: str = ARCH,
                       seq: int = 37, **reduce) -> None:
    """A small model served on the card must agree with the same weights
    on the CPU's plain path."""
    c = mods["configs"]
    tfm = mods["tfm"]
    cfg = c.reduced_config(c.get_config(arch), **reduce)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(3, seq)))
    with torch.inference_mode():
        cpu, _ = tfm.forward(tfm.cast_params(params, "cpu"), cfg,
                             tokens=toks, mode="prefill")
        gpu, _ = tfm.forward(tfm.cast_params(params, "cuda"), cfg,
                             tokens=toks.cuda(), mode="prefill")
    v = cfg.vocab_size
    gpu, cpu = gpu[..., :v].float().cpu(), cpu[..., :v].float()
    err = (gpu - cpu).abs().max().item()
    tol = 4e-2 * max(1.0, cpu.abs().max().item())
    log(f"small {cfg.name} card vs CPU: {seq} tokens, prefill logits "
        f"max_abs_err {err:.4g} tol {tol:.4g}")
    check(bool(torch.isfinite(gpu).all()) and err <= tol,
          f"small model on the card differs from the CPU by {err}")


def staircase_cases(np, mods) -> list:
    """(name, widths, shard_out, ca, mb, mc, lane) as numpy: the planner's
    latency-mode sweep for qwen1.5-0.5b on H100_SXM (rows [down-probe, pad,
    start]), the accuracy-mode size of repro's optimizer benchmark, and a
    ragged block with shards 1-3, a lane that is not a power of two and
    widths 1 and exact multiples of shard x lane."""
    hw, LayerShape = mods["H100_SXM"], mods["LayerShape"]
    fused_columns = mods["fused_columns"]
    rng = np.random.default_rng(SEED)
    cfg = mods["configs"].get_config(ARCH)
    tpl, _ = mods["serving_templates"](cfg, hw, tokens=CLASSES[1][1])
    w = np.array([[t.layer.width - hw.lane, 1, t.layer.width] for t in tpl])
    out = [("planner latency mode", w, *fused_columns(
        hw, [t.layer for t in tpl]), hw.lane)]
    layers = [LayerShape(f"l{i}", tokens=int(rng.integers(1, 8192)),
                         d_in=int(rng.integers(64, 8192)), width=1)
              for i in range(1024)]
    out.append(("accuracy mode", rng.integers(1, 50000, size=(1024, 1024)),
                *fused_columns(hw, layers), hw.lane))
    lane = 96
    so = rng.choice([1, 2, 3], size=(37, 1))
    w = rng.integers(1, 20000, size=(37, 1000))
    w[:, 0] = 1
    w[:, 1] = so[:, 0] * lane * rng.integers(1, 50, size=37)
    out.append(("ragged", w, so, *(rng.random((37, 1)) for _ in range(3)),
                lane))
    return out


def compare_staircase(torch, sf, case) -> dict:
    name, w, so, ca, mb, mc, lane = case
    i32, f32 = torch.int32, torch.float32
    args = tuple(torch.from_numpy(a.copy()).cuda().to(t) for a, t in
                 ((w, i32), (so, i32), (ca, f32), (mb, f32), (mc, f32)))
    lat, wv, occ = sf.staircase_fused(*args, lane=lane)
    torch.cuda.synchronize()
    rlat, rwv, rocc = sf.staircase_ref(*args, lane=lane)
    rows, cols = w.shape
    check(bool(torch.equal(wv.long(), rwv)),
          f"staircase_fused {name}: wave counts differ")
    rel = max(((lat.double() - rlat).abs() / rlat.abs()).max().item(),
              ((occ.double() - rocc).abs() / rocc.abs()).max().item())
    # fp32 kernel vs fp64 plain version on the same fp32 inputs: a rounded
    # product and sum (or one FMA) and a division, a few fp32 ulp
    check(rel <= 1e-6, f"staircase_fused {name}: relative error {rel} > "
                       f"1e-6")
    err = max((lat.double() - rlat).abs().max().item(),
              (occ.double() - rocc).abs().max().item())
    # each cell: 4 B in, 12 B out; each row: four 4-byte columns; about 8
    # fp32 operations per cell outside the tensor cores
    b_ms, b_by = bound_ms(8.0 * rows * cols, 16.0 * rows * cols + 16.0 * rows,
                          peak=PEAK_FP32_FLOPS)
    row = {"case": f"{name} {rows}x{cols} lane={lane}", "max_abs_err": err,
           "max_rel_err": rel, "tol": "rtol 1e-6, waves exact",
           "ms": time_ms(torch, lambda *a: sf.staircase_fused(*a, lane=lane),
                         args),
           "plain_ms": time_ms(torch, lambda *a: sf.staircase_ref(
               *a, lane=lane), args),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    log(f"staircase_fused {row['case']}: max_rel_err {rel:.3g} "
        f"max_abs_err {err:.3g} ms {row['ms']:.4f} plain_ms "
        f"{row['plain_ms']:.4f} bound_ms {b_ms:.5f} ({b_by}); no library "
        f"call computes it")
    return row


def compare_rglru(torch, rg, case: tuple, gen) -> dict:
    b, t, w = case
    a = torch.rand(b, t, w, generator=gen, device="cuda") * 0.699 + 0.3
    x = torch.randn(b, t, w, generator=gen, device="cuda")
    h0 = torch.randn(b, w, generator=gen, device="cuda")
    y, h = rg.rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    ry, rh = rg.rglru_ref(a, x, h0)
    err = max((y - ry).abs().max().item(), (h - rh).abs().max().item())
    # the same fp32 FMA chain in both; the reference's kernel test holds
    # its Pallas kernel to 1e-5 (tests/test_kernels.py:86)
    tol = 1e-5 * max(1.0, ry.abs().max().item())
    check(bool(torch.isfinite(y).all()) and err <= tol,
          f"rglru_scan {case}: max_abs_err {err} > tol {tol}")
    # a, b read and y written once (fp32), h0 read and h_last written; one
    # FMA (2 operations) per element
    b_ms, b_by = bound_ms(2.0 * b * t * w, 12.0 * b * t * w + 8.0 * b * w,
                          peak=PEAK_FP32_FLOPS)
    row = {"case": f"B={b} T={t} W={w}", "max_abs_err": err, "tol": tol,
           "ms": time_ms(torch, rg.rglru_scan, (a, x, h0)),
           "plain_ms": time_ms(torch, rg.rglru_ref, (a, x, h0), reps=4),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    log(f"rglru_scan {row['case']}: max_abs_err {err:.4g} tol {tol:.4g} ms "
        f"{row['ms']:.4f} plain_ms {row['plain_ms']:.4f} bound_ms "
        f"{b_ms:.5f} ({b_by}); grid {rg.grid_programs(b, w)} programs on "
        f"132 SMs; no library call computes it")
    return row


def rwkv6_work(b: int, t: int, h: int, dh: int, chunk: int,
               in_bytes: int, s0: bool):
    """(operations, bytes) of the chunked pairwise form on these shapes:
    per (b, h) and chunk of n rows, an exponential counting as one
    operation and a multiply-add as two: the strict-lower scores
    (n(n-1)/2 x dh x 5), the bonus diagonal (n x dh x 3), the cumsum and
    the decay scalings of r and k (n x dh x 6), the output's intra and
    state products (n(n+1)/2 x dh x 2 + n x dh^2 x 2) and the state update
    (dh^2 x 2 + n x dh^2 x 2). Bytes: r, k, v read, fp32 log_w read and o
    written once, u, and the states read (s0) and written."""
    ops = 0
    for t0 in range(0, t, chunk):
        n = min(chunk, t - t0)
        ops += (n * (n - 1) // 2 * dh * 5 + n * dh * 3 + n * dh * 6
                + n * (n + 1) // 2 * dh * 2 + n * dh * dh * 2
                + dh * dh * 2 + n * dh * dh * 2)
    state = 4.0 * b * h * dh * dh
    nbytes = (b * t * h * dh * (3 * in_bytes + 8) + 4.0 * h * dh
              + state * (2 if s0 else 1))
    return float(ops * b * h), nbytes


def rwkv6_errors(torch, o, s, ro, rs) -> tuple:
    """(finite, max_abs_err, relative error) of the kernel's (o, S)
    against the plain version's; the relative error is the larger of o's
    and S's max_abs_err, each over its own largest value, and is held to
    RWKV6_RTOL."""
    finite = bool(torch.isfinite(o).all() and torch.isfinite(s).all())
    eo, es = (o - ro).abs().max().item(), (s - rs).abs().max().item()
    rel = max(eo / ro.abs().max().item(), es / rs.abs().max().item())
    return finite, max(eo, es), rel


def compare_rwkv6(torch, rw, case: tuple, gen) -> dict:
    b, t, h, dh, lw, s0, dtype = case
    r, k, v = (torch.randn(b, t, h, dh, generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    if lw is None:     # the model's range: -exp(clip(., -8, 4))
        log_w = -torch.exp(torch.clamp(2.0 * torch.randn(
            b, t, h, dh, generator=gen, device="cuda"), -8.0, 4.0))
    else:
        log_w = torch.full((b, t, h, dh), lw, device="cuda")
    u = 0.1 * torch.randn(h, dh, generator=gen, device="cuda")
    st = torch.randn(b, h, dh, dh, generator=gen, device="cuda") \
        if s0 else None
    args = (r, k, v, log_w, u, st)
    o, s = rw.rwkv6(*args)
    torch.cuda.synchronize()
    finite, err, rel = rwkv6_errors(torch, o, s, *rw.rwkv6_ref(*args))
    name = (f"B={b} T={t} H={h} dh={dh} {str(dtype).split('.')[-1]}"
            + (" s0" if s0 else "")
            + (f" log_w={lw}" if lw is not None else ""))
    check(finite, f"rwkv6 {name}: non-finite output or state")
    check(rel <= RWKV6_RTOL, f"rwkv6 {name}: max_abs_err / max |value| "
                             f"{rel} > {RWKV6_RTOL}")
    flops, nbytes = rwkv6_work(b, t, h, dh, min(rw.CHUNK, t),
                               r.element_size(), s0)
    b_ms, b_by = bound_ms(flops, nbytes, peak=PEAK_FP32_FLOPS)
    row = {"case": name, "max_abs_err": err, "max_rel_err": rel,
           "tol": f"{RWKV6_RTOL} of the largest |o| and |S|",
           "ms": time_ms(torch, rw.rwkv6, args),
           "plain_ms": time_ms(torch, rw.rwkv6_ref, args, reps=10),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    log(f"rwkv6 {name}: finite; max_abs_err {err:.4g} relative {rel:.3g} "
        f"(tol {RWKV6_RTOL}) ms "
        f"{row['ms']:.4f} plain_ms {row['plain_ms']:.4f} bound_ms "
        f"{b_ms:.5f} ({b_by}, {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} "
        f"MB); grid {b * h} CTAs on 132 SMs; no library call computes it")
    return row


def compare_moe_gmm(torch, mg, case: tuple, gen) -> dict:
    """x (E, C, D) @ w (E, D, F); with ``broadcast`` x is one (C, D)
    activation viewed with expert stride 0, as the dense strategy gives it,
    and is read (and counted in the bound) once."""
    e, c, d, f, broadcast = case
    xb = torch.randn(*((c, d) if broadcast else (e, c, d)), generator=gen,
                     device="cuda").bfloat16()
    w = torch.randn(e, d, f, generator=gen, device="cuda").bfloat16()

    def view(xb):
        return xb.expand(e, c, d) if broadcast else xb

    out = mg.moe_gmm(view(xb), w)
    torch.cuda.synchronize()
    ref = mg.moe_gmm_ref(view(xb), w)
    err = (out.float() - ref.float()).abs().max().item()
    tol = MOE_RTOL * ref.float().abs().max().item()
    name = f"E={e} C={c} D={d} F={f}" + (" x broadcast" if broadcast else "")
    check(bool(torch.isfinite(out.float()).all()) and err <= tol,
          f"moe_gmm {name}: max_abs_err {err} > tol {tol}")
    b_ms, b_by = bound_ms(2.0 * e * c * d * f,
                          2.0 * (xb.numel() + w.numel() + e * c * f))
    row = {"case": name, "max_abs_err": err, "tol": tol,
           "ms": time_ms(torch, lambda a, b: mg.moe_gmm(view(a), b),
                         (xb, w)),
           "plain_ms": time_ms(torch, lambda a, b: mg.moe_gmm_ref(view(a), b),
                               (xb, w)),
           "library_ms": time_ms(torch, lambda a, b: torch.matmul(view(a), b),
                                 (xb, w)),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"moe_gmm {name}: max_abs_err {err:.4g} tol {tol:.4g} ms "
        f"{row['ms']:.4f} plain_ms {row['plain_ms']:.4f} library_ms "
        f"{row['library_ms']:.4f} (torch.matmul) bound_ms {b_ms:.4f} "
        f"({b_by}); grid {mg.grid_blocks(e, c, f)} CTAs")
    return row


def plan_and_serve(torch, np, mods, full_tok_s: float) -> dict:
    """The planner path: plan on the card (one staircase launch per
    class), the same plans as on the CPU, then serve on the plans."""
    cfg = mods["configs"].get_config(ARCH)
    tfm, ops, sv = mods["tfm"], mods["ops"], mods["serving"]
    hw = mods["H100_SXM"]
    tpl, modules = sv.serving_templates(cfg, hw, tokens=CLASSES[1][1])
    traffic = [sv.TrafficClass(n, t) for n, t in CLASSES]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = tfm.cast_params(tfm.init_params(cfg, gen, "cuda"), "cuda")
    torch.cuda.synchronize()

    ops.reset_launches()
    planner = sv.ServingWidthPlanner(hw, tpl, modules=modules,
                                     device="cuda")
    t0 = time.perf_counter()
    plans = planner.plan(traffic)
    plan_s = time.perf_counter() - t0
    after_plan = dict(ops.LAUNCHES)
    check(after_plan == {"matmul_tiled": 0, "flash_attention": 0,
                         "staircase_fused": len(traffic), "rglru_scan": 0,
                         "rwkv6": 0, "moe_gmm": 0},
          f"planning launched {after_plan}, expected one staircase sweep "
          f"per class ({len(traffic)})")
    on_cpu = sv.ServingWidthPlanner(hw, tpl, modules=modules, device="cpu")
    t0 = time.perf_counter()
    cpu_plans = on_cpu.plan(traffic)
    times = {"cuda": plan_s, "cpu": time.perf_counter() - t0}
    for name, p in plans.items():
        check(cpu_plans[name].widths == p.widths,
              f"plan {name}: the CPU planner chose other widths")
    for name, p in plans.items():
        counts = {}
        for w in p.widths.values():
            counts[w] = counts.get(w, 0) + 1
        log(f"plan[{name}] ({p.traffic.tokens} tokens): widths {counts} "
            f"of d_ff {cfg.d_ff}; modeled reduction "
            f"{100 * p.latency_reduction:.2f}%; satisfied {p.satisfied}; "
            f"equal on the CPU")
    log(f"planner.plan() wall s, {len(traffic)} classes: card "
        f"{times['cuda']:.4f} (kernel already compiled), cpu "
        f"{times['cpu']:.4f}")

    swapper = sv.WidthSwapper(params, cfg)
    engine = sv.ServeEngine(params, cfg, max_len=max(PROMPT_LENS)
                            + NEW_TOKENS, batch_slots=4, rng_seed=SEED,
                            device="cuda", planner=planner, swapper=swapper)
    rng = np.random.default_rng(SEED + 1)
    short = [sv.Request(prompt=rng.integers(
        0, cfg.vocab_size, size=(CLASSES[0][1] // 4,)).astype(np.int32),
        max_new_tokens=NEW_TOKENS) for _ in range(4)]
    bursts = [requests(cfg, sv.Request, np), short,
              requests(cfg, sv.Request, np)]
    outs, walls = [], []
    for reqs in bursts:
        t0 = time.perf_counter()
        outs.append(engine.generate(reqs))
        walls.append(time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    want = {k: n * len(bursts)
            for k, n in expected_launches(tfm, cfg).items()}
    want["staircase_fused"] = len(traffic)
    check(launches == want, f"planner path launched {launches} != {want}")
    names = [p.traffic.name for p in engine.plan_log]
    check(names == ["long", "short", "long"],
          f"bursts selected {names}, expected long, short, long")
    hits = [e.cache_hit for e in engine.swap_log]
    check([e.outcome for e in engine.swap_log] == ["ok"] * 3
          and hits[0] is False and hits[2] is True,
          f"swaps {engine.swap_log}: expected a cold then warm swaps")
    for a, b in zip(outs[0], outs[2]):
        check(np.array_equal(a.tokens, b.tokens),
              "a repeat on the cached plan gave other tokens")
    check(all(len(r.tokens) == NEW_TOKENS and (r.tokens >= 0).all()
              and (r.tokens < cfg.vocab_size).all() for o in outs for r in o),
          "tokens out of range or of the wrong count")
    sliced = swapper.apply(plans["long"])[0]["decoder"]["stack"]["u0"]
    check(tuple(sliced["mlp"]["w_up"].shape[1:]) == (
        cfg.d_model, max(plans["long"].widths.values())),
          "the served params are not the plan's widths")
    for e in engine.swap_log:
        log(f"swap -> plan[{e.plan_name}] "
            f"{'warm (cache hit)' if e.cache_hit else 'cold'} in "
            f"{e.swap_s * 1e3:.3f} ms")
    n_new = sum(len(r.tokens) for r in outs[2])
    tok_s = n_new / walls[2]
    log(f"serve on plan[long]: {n_new} tokens in {walls[2]:.3f}s "
        f"({tok_s:.1f} tok/s, repeat burst) vs full width "
        f"{full_tok_s:.1f} tok/s in this run; launches {launches}")
    del sliced
    ab = planned_vs_full(torch, np, mods, engine, plans["long"], swapper)
    del engine, swapper
    torch.cuda.empty_cache()
    return {"launches": launches, "tok_s": tok_s, "plan_s": times,
            "ab": ab, "params": params, "modules": modules}


def planned_vs_full(torch, np, mods, planned, plan, swapper) -> dict:
    """tokens/s on the planned widths against full width: AB_ROUNDS bursts
    of the same requests per side, alternating which side goes first, on
    engines alike but for the planner (the planned side's swaps are warm).
    Then a decode step's device time on each tree, replayed from a CUDA
    graph, which the host's noise does not reach, AB_ROUNDS times each,
    alternating too: one reading of each moved by 7 % between runs."""
    cfg = mods["configs"].get_config(ARCH)
    tfm, sv = mods["tfm"], mods["serving"]
    full = sv.ServeEngine(planned.params, cfg, max_len=planned.max_len,
                          batch_slots=planned.slots, rng_seed=SEED,
                          device="cuda")
    engines = {"full": full, "planned": planned}
    reqs = requests(cfg, sv.Request, np)
    tok_s = {"full": [], "planned": []}
    n_swaps = len(planned.swap_log)
    for r in range(AB_ROUNDS):
        for side in (("full", "planned") if r % 2 == 0 else
                     ("planned", "full")):
            t0 = time.perf_counter()
            out = engines[side].generate(reqs)
            dt = time.perf_counter() - t0
            tok_s[side].append(sum(len(x.tokens) for x in out) / dt)
    check(all(e.cache_hit and e.plan_name == plan.traffic.name
              for e in planned.swap_log[n_swaps:]),
          "the planned side's bursts did not swap warm to plan[long]")
    plen = max(PROMPT_LENS)
    toks = np.zeros((len(PROMPT_LENS), plen), np.int64)
    for i, q in enumerate(reqs):
        toks[i, plen - len(q.prompt):] = q.prompt
    toks = torch.from_numpy(toks).cuda()
    cur = torch.zeros(len(PROMPT_LENS), dtype=torch.long, device="cuda")
    trees = {"full": full.params, "planned": swapper.apply(plan)[0]}
    decode_ms = {"full": [], "planned": []}
    with torch.inference_mode():
        states = {}
        for side, tree in trees.items():
            _, st = tfm.forward(tree, cfg, tokens=toks, mode="prefill")
            states[side] = full._ensure_states(st)
        for r in range(AB_ROUNDS):
            for side in (("full", "planned") if r % 2 == 0 else
                         ("planned", "full")):
                tree, st = trees[side], states[side]
                decode_ms[side].append(time_ms(
                    torch, lambda: tfm.decode_step(tree, cfg, cur, plen, st),
                    (), reps=8))
    med = {k: float(np.median(v)) for k, v in tok_s.items()}
    dmed = {k: float(np.median(v)) for k, v in decode_ms.items()}
    for side in ("full", "planned"):
        v, d = tok_s[side], decode_ms[side]
        log(f"A/B {side}: tok/s per burst "
            f"{[round(x, 2) for x in v]}; median {med[side]:.2f}, min "
            f"{min(v):.2f}, max {max(v):.2f}; decode step device ms "
            f"{[round(x, 4) for x in d]}; median {dmed[side]:.4f}")
    log(f"A/B planned vs full ({AB_ROUNDS} rounds each, alternating): "
        f"median tok/s {100 * (med['planned'] / med['full'] - 1):+.2f}%, "
        f"median decode step device time "
        f"{100 * (dmed['planned'] / dmed['full'] - 1):+.2f}%")
    del full, trees, states
    return {"tok_s": tok_s, "decode_ms": decode_ms}


def narrowed_plan(torch, np, mods, params, modules) -> None:
    """A hand-narrowed plan (MLP widths below d_ff, multiples of 64, ragged
    across the stacked layers): its sliced forward on the kernels equals
    the zero-masked full-shape forward on the kernels. Zero columns and
    rows add exact zeros, and each CTA of the MLP kernel sums its K tiles
    in order, so the two are expected bit for bit."""
    cfg = mods["configs"].get_config(ARCH)
    tfm, sv = mods["tfm"], mods["serving"]
    widths = {name: cfg.d_ff - 64 * (1 + ref.layer % 4)
              for name, ref in modules.items()}
    plan = sv.WidthPlan(traffic=sv.TrafficClass("narrow", 512),
                        widths=widths, latency_s=1.0, baseline_latency_s=1.0,
                        satisfied=True, modules=modules)
    swapper = sv.WidthSwapper(params, cfg)
    sliced, ev = swapper.apply(plan)
    masked, ev_m = swapper.apply(plan, masked=True)
    check(ev.outcome == ev_m.outcome == "ok" and ev_m.masked,
          "the narrowed plan did not swap")
    plen = max(PROMPT_LENS)
    toks = np.zeros((len(PROMPT_LENS), plen), np.int64)
    for i, r in enumerate(requests(cfg, sv.Request, np)):
        toks[i, plen - len(r.prompt):] = r.prompt
    toks = torch.from_numpy(toks).cuda()
    with torch.inference_mode():
        a, _ = tfm.forward(sliced, cfg, tokens=toks, mode="prefill")
        b, _ = tfm.forward(masked, cfg, tokens=toks, mode="prefill")
    v = cfg.vocab_size
    a, b = a[..., :v].float(), b[..., :v].float()
    err = (a - b).abs().max().item()
    w_up = sliced["decoder"]["stack"]["u0"]["mlp"]["w_up"]
    log(f"narrowed plan (MLP widths {sorted(set(widths.values()))}, sliced "
        f"w_up {tuple(w_up.shape)}): sliced vs masked prefill logits "
        f"max_abs_err {err} (bit-identical: {bool(torch.equal(a, b))})")
    check(bool(torch.isfinite(a).all()) and bool(torch.equal(a, b)),
          f"the sliced forward differs from the masked one by {err}")


def serve_batched_on_card(mods) -> None:
    t0 = time.perf_counter()
    engine = mods["serve_batched_main"]([])
    check(len(engine.swap_log) == 3 and engine.swap_log[-1].cache_hit,
          "launch.serve_batched did not swap as expected")
    log(f"launch.serve_batched on the card: {time.perf_counter() - t0:.1f}s")


def cli_on_card(mods, arch: str = ARCH) -> None:
    """``launch.serve --arch arch`` on the card at full width; each kernel
    of that arch's path must have launched."""
    ops = mods["ops"]
    cfg = mods["configs"].get_config(arch)
    ops.reset_launches()
    t0 = time.perf_counter()
    results = mods["serve_main"](["--arch", arch, "--requests", "4",
                                  "--prompt-len", "32", "--new-tokens", "4"])
    check(len(results) == 4 and all(len(r.tokens) == 4 for r in results),
          "the serving CLI returned the wrong results")
    used = {k for k, n in expected_launches(mods["tfm"], cfg).items() if n}
    check(all(ops.LAUNCHES[k] > 0 for k in used),
          f"the serving CLI skipped a kernel: {dict(ops.LAUNCHES)}")
    log(f"launch.serve --arch {arch} on the card: "
        f"{time.perf_counter() - t0:.1f}s, launches {dict(ops.LAUNCHES)}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA device")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} is missing: run from a checkout")
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch import configs, serving
    from repro_torch.core import H100_SXM, LayerShape
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul_tiled as mt
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import rglru as rg
    from repro_torch.kernels import rwkv6 as rw
    from repro_torch.kernels import staircase_fused as sf
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.serve_batched import main as serve_batched_main
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import Request, ServeEngine
    mods = {"configs": configs, "ops": ops, "tfm": tfm, "Request": Request,
            "ServeEngine": ServeEngine, "serve_main": serve_main,
            "serving": serving, "serving_templates": serving.serving_templates,
            "H100_SXM": H100_SXM, "LayerShape": LayerShape,
            "fused_columns": sf.fused_columns,
            "serve_batched_main": serve_batched_main}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    card = card_info(torch)
    build_kernels(build)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # qwen1.5-0.5b's and recurrentgemma-2b's MLP products at prefill
    # (M = 4 x 128) and decode (M = 4), and a ragged one
    mm = [compare_matmul(torch, mt, c, gen) for c in
          [(512, 1024, 2816), (512, 2816, 1024), (4, 1024, 2816),
           (4, 2816, 1024), (512, 2560, 7680), (512, 7680, 2560),
           (4, 2560, 7680), (4, 7680, 2560), (100, 130, 70)]]
    fl = [compare_flash(torch, fa, c, gen) for c in
          [(4, 128, 128, 16, 16, 64, "causal", 0),
           (4, 100, 100, 16, 16, 64, "causal", 0),
           (2, 256, 256, 16, 4, 64, "causal", 0),
           (2, 256, 256, 8, 2, 128, "local", 96),
           (1, 100, 130, 4, 4, 64, "none", 0)]]
    t0 = time.time()
    st = [compare_staircase(torch, sf, c)
          for c in staircase_cases(np, mods)]
    log(f"staircase_fused: 3 shapes checked and timed in "
        f"{time.time() - t0:.1f}s, Triton's first compile included")
    # recurrentgemma-2b's prefill shape, a ragged W, one step
    rgl = [compare_rglru(torch, rg, c, gen) for c in
           [(4, 128, 2560), (4, 128, 2500), (4, 1, 2560)]]
    # rwkv6-1.6b's prefill shape (bf16 r, k, v, as the model gives them), a
    # ragged T from a non-zero state, and constant decays at the model's
    # floor (-e^4), at -8 and at its ceiling (-e^-8): all finite
    f32, b16 = torch.float32, torch.bfloat16
    rwk = [compare_rwkv6(torch, rw, c, gen) for c in
           [(4, 128, 32, 64, None, False, b16),
            (4, 97, 32, 64, None, True, b16),
            (4, 128, 32, 64, -54.6, True, f32),
            (4, 128, 32, 64, -8.0, True, f32),
            (4, 128, 32, 64, -3.4e-4, True, f32)]]
    # granite-moe-1b-a400m's expert products: dense prefill (4 x 128
    # tokens, x broadcast over the 32 experts) gate/up and down, the same
    # at decode (4 tokens), the capacity buffer at prefill, ragged edges
    mo = [compare_moe_gmm(torch, mg, c, gen) for c in
          [(32, 512, 1024, 512, True), (32, 512, 512, 1024, False),
           (32, 4, 1024, 512, True), (32, 4, 512, 1024, False),
           (32, 161, 1024, 512, False), (2, 33, 31, 32, False),
           (2, 65, 64, 63, False)]]

    served = serve_full_width(torch, np, mods)
    small_model_vs_cpu(torch, np, mods, n_layers=2, d_model=256, n_heads=4,
                       d_ff=512, vocab=250)
    cli_on_card(mods)
    planned = plan_and_serve(torch, np, mods, served["tok_s"])
    narrowed_plan(torch, np, mods, planned.pop("params"),
                  planned.pop("modules"))
    torch.cuda.empty_cache()
    serve_batched_on_card(mods)
    # the recurrent families: each at full width, freed before the next;
    # their small configs on the card against the CPU (70 tokens, past the
    # reduced window of 64, so the ring cache rolls)
    recurrent = {}
    for arch in RECURRENT_ARCHS:
        recurrent[arch] = serve_full_width(torch, np, mods, arch)
        small_model_vs_cpu(torch, np, mods, arch, seq=70)
    cli_on_card(mods, "rwkv6-1.6b")
    moe = serve_full_width(torch, np, mods, MOE_ARCH)
    # head dim 64 (flash attention takes 64 and 128), top-8 of 16 experts
    small_model_vs_cpu(torch, np, mods, MOE_ARCH, n_layers=2, d_model=256,
                       n_heads=4, d_ff=512, vocab=250, n_experts=16)
    cli_on_card(mods, MOE_ARCH)

    kernels = []
    # each kernel's launches are read from the main path that runs it: the
    # full-width qwen serve for the matmul and attention kernels, the
    # planner path (plan, then serve on the plans) for the staircase
    # kernel, the recurrentgemma and rwkv6 serves for the recurrences, the
    # granite serve for the grouped expert products
    rec_g, rec_w = (recurrent[a] for a in RECURRENT_ARCHS)
    check(all(planned["launches"][n] > 0 for n in (
        "matmul_tiled", "flash_attention", "staircase_fused")),
          f"the planner path skipped a kernel: {planned['launches']}")
    for name, row, path in (("matmul_tiled", mm[0], served),
                            ("flash_attention", fl[0], served),
                            ("staircase_fused", st[0], planned),
                            ("rglru_scan", rgl[0], rec_g),
                            ("rwkv6", rwk[0], rec_w),
                            ("moe_gmm", mo[0], moe)):
        check(path["launches"][name] > 0,
              f"{name} was not launched on the main path")
        kernels.append({
            "name": name, "route": ROUTES[name], "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": path["launches"][name],
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
