"""Paper Table 2: tail-aware optimization on top of pruning baselines
(``benchmarks/pruning_opt.py``'s counterpart, as a module with a CLI).

    PYTHONPATH=src python -m repro_torch.launch.pruning_opt
    PYTHONPATH=src python -m repro_torch.launch.pruning_opt --batch 32
    PYTHONPATH=src python -m repro_torch.launch.pruning_opt --batch 64 \
        --image 32
    PYTHONPATH=src python -m repro_torch.launch.pruning_opt --device cpu \
        --hw tpu_lite

VGG-style convnet (``models.convnet``) on a synthetic CIFAR-class task.
Pipeline per method:

1. train a base model (fp32, plain SGD through autograd);
2. HRank (feature-map rank) / SOFT (L2) pruning to a FLOPs target with
   *continuous* per-layer widths (the baselines' own behaviour);
3. ours: the same criteria, widths chosen by Algorithm 2 among the
   tail model's candidates (section 4.4 "Advancing Filter Pruning");
4. finetune both, report params / FLOPs / modeled latency / throughput /
   accuracy: the Table 2 columns.

The tail model is the one ``--hw`` selects (``tail_model.model_for``):
``tpu_lite`` is ``repro``'s ``WaveQuantizationModel(TPU_LITE)``; the
default is the card's own spec (``GpuSpec.from_device``; ``H100_SXM`` on
the CPU), which selects ``CtaWaveModel``. Algorithm 2 sweeps through the
model's kernel backend: on the card the Triton kernel of its form
(``staircase_cta`` for a GPU spec), on the CPU that kernel's fp64 plain
version. The reported latency is the exact (numpy) model's, at the latency
batch ``--batch`` (1, ``repro``'s) and the image ``--image`` (16,
``repro``'s), at which the nets are also trained.

On the card each net's bf16 inference forward at the latency batch is also
timed, with its conv products on ``matmul_tiled`` (CUDA-graph replays,
``profiler.time_graph_ms``): the whole forward, each conv product alone
(its grid beside the B that ``CtaWaveModel`` prices on the card's spec,
and the loads it took), and ``F.conv2d``'s forward of the same net in bf16
(a library yardstick the port never calls). Each kernel forward is also
held against the same forward on the plain versions.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import (
    H100_SXM, TPU_LITE, TailEffectOptimizer, TunableLayer,
    analytic_candidates, get_hardware, pruning,
)
from repro_torch.core.tail_model import CtaWaveModel, model_for
from repro_torch.models import convnet as cn
from repro_torch.serving.engine import require_device

HW = TPU_LITE      # repro's spec: embedded-class, quanta bite at small widths
BATCH = 32         # training and eval batch
IMAGE = 16
TRAIN_STEPS = 150
FINETUNE_STEPS = 80
LR = 3e-3
FINETUNE_LR = 1e-3
EVAL_STEPS = 8
RATIO = 0.66       # the baselines' uniform width ratio
METHODS = ("HRank", "SOFT")
# a timed forward: the median of 5 CUDA-graph replays of 20 calls
REPS, REPEATS = 20, 5
# the measured times of a timed net: whole forward, conv products alone,
# F.conv2d's forward
TIMED_KEYS = ("us", "gemm_us", "conv2d_us")


def _leaves(tree: dict) -> list:
    return [v for k in tree for v in
            (_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def train(params: dict, steps: int, lr: float = LR, *,
          image: int = IMAGE):
    """``steps`` of plain SGD on fp32 ``params`` (on their device), the
    batch of step s being ``synthetic_cifar(s)`` as in ``repro``. Returns
    (params, the last step's accuracy)."""
    params = _map(params, lambda p: p.detach().clone().requires_grad_(True))
    leaves = _leaves(params)
    device = leaves[0].device
    acc = 0.0
    for s in range(steps):
        batch = cn.synthetic_cifar(s, BATCH, image, device=device)
        loss, acc = cn.convnet_loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p -= lr * g
    return _map(params, lambda p: p.detach()), float(acc)


def eval_acc(params: dict, steps: int = EVAL_STEPS, seed: int = 10_000, *,
             image: int = IMAGE) -> float:
    device = _leaves(params)[0].device
    accs = []
    with torch.no_grad():
        for s in range(steps):
            batch = cn.synthetic_cifar(seed + s, BATCH, image, device=device)
            _, acc = cn.convnet_loss(params, batch)
            accs.append(float(acc))
    return float(np.mean(accs))


def model_latency(widths, batch: int = 1, image: int = IMAGE,
                  hw=HW) -> float:
    """Modeled seconds of the conv products at ``widths`` (the exact
    engine of the model ``hw`` selects)."""
    model = model_for(hw)
    shapes = cn.conv_layer_shapes(widths, batch=batch, image=image)
    return sum(float(model.evaluate_batch(s, [s.width]).latency_s[0])
               for s in shapes)


def tunables(widths, max_scale: float = 1.5, batch: int = 1,
             image: int = IMAGE, hw=HW) -> list:
    out = []
    for s in cn.conv_layer_shapes(widths, batch=batch, image=image):
        cands = analytic_candidates(hw, s,
                                    max_width=int(s.width * max_scale),
                                    min_width=8)
        out.append(TunableLayer(layer=s, candidates=cands,
                                params_per_unit=s.d_in))
    return out


def resolve_hw(hw, device):
    """``hw`` as a spec: a spec as it is, a registered spec's name, or None
    for the card's own spec (``H100_SXM``'s data sheet on the CPU)."""
    if hw is not None:
        return get_hardware(hw) if isinstance(hw, str) else hw
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.core.gpu import GpuSpec
        return GpuSpec.from_device(dev)
    return H100_SXM


# ---------------------------------------------------------------------------
# the card: timed inference forwards
# ---------------------------------------------------------------------------
def conv2d_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The same net through ``F.conv2d`` (NCHW views of NHWC data, so cuDNN
    runs channels-last): the library yardstick, never on the port's
    path."""
    h = x.permute(0, 3, 1, 2)
    i = 0
    while f"conv{i}" in params:
        p = params[f"conv{i}"]
        h = torch.relu(F.conv2d(h, p["kernel"], p["bias"], padding=1))
        if i % 2 == 1:
            h = F.max_pool2d(h, 2)
        i += 1
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return h @ params["head"]["w"] + params["head"]["b"]


def _median_us(fn) -> float:
    from repro_torch.core.profiler import time_graph_ms
    return float(np.median(time_graph_ms(fn, REPS, REPEATS))) * 1e3


def time_net(params: dict, widths, batch: int, image: int) -> dict:
    """One net's bf16 inference forward at ``batch`` on the card: its
    us on the kernels, each conv product's us alone with its grid, the
    B that ``CtaWaveModel`` prices on the card's spec and its loads,
    ``F.conv2d``'s us, the kernels' launches in one forward and the
    largest |logit| difference from the plain versions' forward, over the
    largest |logit|."""
    from repro_torch.core.gpu import GpuSpec
    from repro_torch.kernels import matmul_tiled as mt
    from repro_torch.kernels import ops
    dev = _leaves(params)[0].device
    gpu = CtaWaveModel(GpuSpec.from_device(dev))
    shapes = cn.conv_layer_shapes(widths, batch=batch, image=image)
    x = cn.synthetic_cifar(20_000, batch, image, device=dev)[
        "images"].bfloat16()
    pb = _map(params, lambda p: p.to(torch.bfloat16))
    operands = cn.conv_operands(params, torch.bfloat16)
    out = {}
    with torch.no_grad():
        loads = []
        before = ops.LAUNCHES["matmul_tiled"]
        logits, _ = cn.forward_convnet(pb, x, operands=operands, loads=loads)
        out["launches"] = ops.LAUNCHES["matmul_tiled"] - before
        plain, _ = cn.forward_convnet(pb, x, operands=operands,
                                      force="plain")
        scale = max(plain.float().abs().max().item(), 1e-30)
        out["plain_err"] = (logits.float() - plain.float()).abs().max() \
            .item() / scale
        out["us"] = _median_us(lambda: cn.forward_convnet(
            pb, x, operands=operands))
        # OIHW kernels, channels-last like the activations
        lib = {n: dict(p, kernel=p["kernel"].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)) if n != "head" else p
            for n, p in pb.items()}
        out["conv2d_err"] = (conv2d_forward(lib, x).float()
                             - plain.float()).abs().max().item() / scale
        out["conv2d_us"] = _median_us(lambda: conv2d_forward(lib, x))
        gen = torch.Generator(device=dev).manual_seed(0)
        products = []
        for s, load, wm in zip(shapes, loads, operands):
            (k, n), m = wm.shape, s.tokens
            cols = torch.randn(m, k, generator=gen, device=dev).bfloat16()
            products.append({
                "name": s.name, "m": m, "k": k, "n": n,
                "grid": mt.grid_blocks(m, n, k),
                "model_blocks": gpu.blocks(s), "loads": load,
                "us": _median_us(lambda: ops.matmul(cols, wm)),
                "modeled_us": gpu.latency_batch(s, [s.width])[0] * 1e6})
            del cols
    out["products"] = products
    out["gemm_us"] = sum(p["us"] for p in products)
    return out


def reductions(rows: list) -> dict:
    """Ours' reduction against each baseline (1 - Ours / baseline), per
    method: of the modeled latency ("latency_us") and, where the rows were
    timed, of each of ``TIMED_KEYS``."""
    by = {r["method"]: r for r in rows}

    def value(method, key):
        r = by[method]
        return r[key] if key in r else r["timed"][key]
    keys = ("latency_us",) + (TIMED_KEYS if "timed" in rows[0] else ())
    return {key: {m: 1.0 - value(f"{m}+Ours", key) / value(m, key)
                  for m in METHODS} for key in keys}


def print_timed(rows: list, hw_name: str) -> None:
    for r in rows:
        t = r["timed"]
        print(f"  {r['method']:>12}: widths={r['widths']} modeled "
              f"{r['latency_us']:.3f}us ({hw_name}) measured "
              f"{t['us']:.3f}us conv products {t['gemm_us']:.3f}us "
              f"F.conv2d {t['conv2d_us']:.3f}us acc={r['acc']:.3f} "
              f"launches={t['launches']} plain_err={t['plain_err']:.2e}")
        for p in t["products"]:
            print(f"      {p['name']}: M={p['m']} K={p['k']} N={p['n']} "
                  f"grid={p['grid']} model B={p['model_blocks']} loads="
                  f"{p['loads']} {p['us']:.3f}us (GPU model "
                  f"{p['modeled_us']:.3f}us)")
    red = reductions(rows)
    for key, what in zip(red, ("modeled", "measured forward",
                               "measured conv products", "F.conv2d")):
        print(f"  reduction of Ours ({what}): "
              + ", ".join(f"{m} {v * 100:+.2f}%" for m, v in
                          red[key].items()))


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------
def run(csv_rows: Optional[list] = None, verbose: bool = True,
        train_steps: int = TRAIN_STEPS, finetune_steps: int = FINETUNE_STEPS,
        *, hw=None, device="cuda", batch: int = 1, image: int = IMAGE,
        eval_steps: int = EVAL_STEPS, params: Optional[dict] = None,
        timed: Optional[bool] = None) -> dict:
    """Table 2 on ``device`` (the card unless the caller asks for the
    CPU): ``hw`` is a spec, a registered spec's name, or None for the
    card's own; ``batch`` the latency batch; ``image`` the train, eval and
    latency image; ``params`` the fp32 initial params (``init_convnet``
    from seed 0 when None). Returns {"rows": repro's rows (method, widths,
    params, flops, latency_us, tflops, acc; with "timed" where timed),
    "csv": repro's CSV row (also appended to ``csv_rows``), "base": the
    base net's row, "nets": method -> finetuned params (with "base"),
    "acts": the probe batch's conv activations, "reductions":
    :func:`reductions`}. ``timed`` (default: on a CUDA device) times each
    net on the card (:func:`time_net`)."""
    t0 = time.time()
    dev = require_device(device)
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "pruning_opt trains in fp32 as repro does: "
            "torch.get_float32_matmul_precision() must be 'highest', not "
            f"{torch.get_float32_matmul_precision()!r} (TF32)")
    hw = resolve_hw(hw, dev)
    timed = dev.type == "cuda" if timed is None else timed
    if timed and dev.type != "cuda":
        raise RuntimeError("timed forwards need a CUDA device")
    base_widths = cn.DEFAULT_WIDTHS
    if params is None:
        params = cn.init_convnet(torch.Generator(device=dev).manual_seed(0),
                                 base_widths, image=image)
    params = _map(params, lambda p: p.to(dev))
    params, _ = train(params, train_steps, image=image)
    base_acc = eval_acc(params, eval_steps, image=image)

    # probe batch for HRank activations
    probe = cn.synthetic_cifar(77, 32, image, device=dev)
    with torch.no_grad():
        _, acts = cn.forward_convnet(params, probe["images"],
                                     collect_acts=True)

    names = cn.conv_names(base_widths)
    full = dict(zip(names, base_widths))
    # Algorithm 2's sweeps on the kernel backend of the model hw selects
    opt = TailEffectOptimizer(model_for(hw, backend="kernel", device=dev))
    results, nets = [], {"base": params}
    for method in METHODS:
        if method == "HRank":
            def score_fn(n):
                return pruning.feature_map_rank_scores(acts[n])
        else:
            def score_fn(n):
                return pruning.l2_filter_scores(params[n]["kernel"])

        # --- baseline: continuous uniform-ratio targets -------------------
        targets = pruning.uniform_flops_plan(full, RATIO)
        plan_b = pruning.build_plan(score_fn, targets)
        pruned_b, _ = train(cn.prune_convnet(params, plan_b.indices),
                            finetune_steps, lr=FINETUNE_LR, image=image)
        wb = [plan_b.widths[n] for n in names]

        # --- ours: Algorithm 2 over the baseline's widths (table-driven) ---
        tls = tunables(wb, batch=batch, image=image, hw=hw)
        total_p = sum(tl.params(tl.layer.width) for tl in tls)
        res = opt.optimize_latency(tls, tau=0.25 * total_p, delta=0.92)
        # honour max available filters
        w_ours = {n: min(res.new_widths[f"conv{i}"], full[n])
                  for i, n in enumerate(names)}
        plan_o = pruning.build_plan(score_fn, w_ours)
        pruned_o, _ = train(cn.prune_convnet(params, plan_o.indices),
                            finetune_steps, lr=FINETUNE_LR, image=image)
        wo = [plan_o.widths[n] for n in names]

        for tag, w_, p_ in ((method, wb, pruned_b),
                            (f"{method}+Ours", wo, pruned_o)):
            fl = cn.count_conv_flops(w_, batch=batch, image=image)
            lat = model_latency(w_, batch=batch, image=image, hw=hw)
            results.append({
                "method": tag, "widths": w_,
                "params": cn.count_conv_params(w_, image=image),
                "flops": fl, "latency_us": lat * 1e6,
                "tflops": fl / lat / 1e12,
                "acc": eval_acc(p_, eval_steps, image=image),
            })
            nets[tag] = p_

    lat = model_latency(base_widths, batch=batch, image=image, hw=hw)
    base = {"method": "base", "widths": list(base_widths),
            "params": cn.count_conv_params(base_widths, image=image),
            "flops": cn.count_conv_flops(base_widths, batch=batch,
                                         image=image),
            "latency_us": lat * 1e6, "acc": base_acc}
    base["tflops"] = base["flops"] / lat / 1e12
    if timed:
        for r in [base] + results:
            r["timed"] = time_net(nets[r["method"]], r["widths"], batch,
                                  image)
    if verbose:
        print(f"  hw={hw.name} latency batch={batch} image={image}")
        print(f"  base widths={list(base_widths)} acc={base_acc:.3f}")
        for r in results:
            print(f"  {r['method']:>12}: widths={r['widths']} "
                  f"params={r['params']/1e3:7.1f}k "
                  f"FLOPs={r['flops']/1e6:7.1f}M "
                  f"L={r['latency_us']:7.2f}us "
                  f"T={r['tflops']:6.3f}TF/s acc={r['acc']:.3f}")
        if timed:
            print_timed([base] + results, hw.name)
    # latency reduction of ours vs each baseline
    reds = reductions(results)
    dt_us = (time.time() - t0) * 1e6
    row = ("pruning_table2", f"{dt_us:.0f}",
           ";".join(f"{m}:-{r*100:.1f}%lat" for m, r in
                    reds["latency_us"].items()))
    if csv_rows is not None:
        csv_rows.append(row)
    return {"rows": results, "csv": row, "base": base, "nets": nets,
            "acts": acts, "reductions": reds, "hw": hw.name}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hw", default=None,
                    help="the tail model's spec, a registered name "
                         "(tpu_lite is repro's); the card's own when "
                         "left out")
    ap.add_argument("--batch", type=int, default=1,
                    help="the latency batch")
    ap.add_argument("--image", type=int, default=IMAGE)
    ap.add_argument("--train-steps", type=int, default=TRAIN_STEPS)
    ap.add_argument("--finetune-steps", type=int, default=FINETUNE_STEPS)
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    out = run(verbose=True, train_steps=args.train_steps,
              finetune_steps=args.finetune_steps, hw=args.hw, device=dev,
              batch=args.batch, image=args.image)
    print("  " + ",".join(out["csv"]))
    return out


if __name__ == "__main__":
    main()
