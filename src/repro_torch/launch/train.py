"""Training CLI (``repro.launch.train``'s counterpart).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b

trains full-width qwen1.5-0.5b (random weights from ``--seed``, batch 8 x
128 of the synthetic stream) on the card (``--device cuda``, the default; it
fails if there is none), every MLP product and causal attention, forward
and backward, on the hand-written kernels; so do ``--arch
granite-moe-1b-a400m`` (its dense expert products on ``moe_gmm`` and its
backward), ``recurrentgemma-2b`` (the RG-LRU on ``rglru_scan`` and
``rglru_scan_bwd``) and ``rwkv6-1.6b`` (``rwkv6`` and ``rwkv6_bwd``).
``--device cpu --reduced`` runs the plain versions on the CPU with a tiny
config:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --reduced --steps 200 --ckpt-dir /tmp/ckpt

Fault tolerance, as in ``repro``: a checkpoint every ``--ckpt-every`` steps
(atomic manifest, optionally written on a thread); on start the run resumes
from the latest complete checkpoint; the data stream is a pure function of
the step, so a resumed run sees exactly the batches it would have; on
SIGTERM the current step finishes, a checkpoint is written and the run
returns.
"""

from __future__ import annotations

import argparse
import signal
import time
from typing import Optional

import torch

from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.models import init_params
from repro_torch.serving.engine import require_device
from repro_torch.train import (
    AdamWConfig, DataConfig, TrainConfig, adamw_init, augment_for_arch,
    build_train_step, checkpoint, cosine_schedule, make_source,
)


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main(argv=None, *, stats: Optional[list] = None):
    """Returns the losses of the steps run. ``stats``, if a list, gets one
    dict per step: its loss, wall ms (host clock to the step's last
    result) and, on a card, stream ms: the elapsed time between CUDA
    events recorded before the step and after its last queued work, the
    device's idle gaps included (not its busy time)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="family-preserving tiny config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "full", "dots", "sqrt"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-async", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-path", default="",
                    help="memmapped token file (synthetic stream if unset)")
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg, n_layers=args.n_layers,
                             d_model=args.d_model)
    device = require_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False
    on_card = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"device: {device} ({name})  arch: {cfg.name}")

    tc = TrainConfig(adamw=AdamWConfig(), microbatches=args.microbatches,
                     remat=args.remat, moe_strategy="dense")
    lr = cosine_schedule(args.lr, max(args.steps // 20, 1), args.steps)
    source = make_source(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, path=args.data_path or None))

    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device)
    opt_state = adamw_init(params, tc.adamw)
    step_fn = build_train_step(cfg, tc, lr)

    start = 0
    if args.ckpt_dir:
        latest = checkpoint.latest_step(args.ckpt_dir)
        if latest is not None:
            params, opt_state = checkpoint.restore(args.ckpt_dir, latest,
                                                   (params, opt_state))
            start = latest
            print(f"resumed from step {latest}")

    # Preemption: on SIGTERM finish the current step, checkpoint, return.
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        preempted["flag"] = True

    prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    losses = []
    t0 = time.time()
    pending = None
    try:
        for step in range(start, args.steps):
            batch = augment_for_arch(source.batch(step), cfg, args.seq, step)
            batch = to_device(batch, device)
            if on_card:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            w0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 step)
            if on_card:
                ev[1].record()
            loss = float(metrics["loss"])
            wall = (time.perf_counter() - w0) * 1e3
            losses.append(loss)
            if stats is not None:
                stream_ms = None
                if on_card:
                    ev[1].synchronize()
                    stream_ms = ev[0].elapsed_time(ev[1])
                stats.append({"step": step, "loss": loss, "wall_ms": wall,
                              "stream_ms": stream_ms})
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:7.4f} "
                      f"grad_norm {float(metrics['grad_norm']):8.3f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"({time.time() - t0:5.1f}s)", flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                if pending is not None:
                    pending.join()
                pending = checkpoint.save(args.ckpt_dir, step + 1,
                                          (params, opt_state),
                                          blocking=not args.ckpt_async)
            if preempted["flag"]:
                if args.ckpt_dir:
                    if pending is not None:
                        pending.join()
                    checkpoint.save(args.ckpt_dir, step + 1,
                                    (params, opt_state))
                print(f"preempted at step {step + 1}: checkpointed, "
                      f"exiting cleanly", flush=True)
                return losses
        if pending is not None:
            pending.join()
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
    if args.ckpt_dir:
        checkpoint.save(args.ckpt_dir, args.steps, (params, opt_state))
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}, best "
              f"{min(losses):.4f})")
    return losses


if __name__ == "__main__":
    main()
