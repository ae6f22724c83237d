"""Train-step builder: loss, gradients and AdamW, with microbatched
gradient accumulation (``repro.train.step``'s counterpart).

Gradients come from ``torch.autograd.grad`` over the parameter leaves
(which the step marks as requiring grad), so the step returns a tree of
gradients as ``repro``'s ``jax.value_and_grad`` does, and nothing is left
in ``.grad``. On a card every MLP product, dense expert product, causal
or unmasked attention, RG-LRU scan and RWKV6 pass, forward and backward,
runs on the hand-written kernels (``kernels.ops``); ``force="plain"``
takes the plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.train.optim import AdamState, AdamWConfig, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    remat: str = "full"       # none | full | dots | sqrt
    moe_strategy: str = "auto"
    aux_weight: float = 0.01
    z_weight: float = 1e-3
    accum_dtype: str = "f32"  # grad-accumulation dtype (bf16 with kahan)


def named_leaves(tree, prefix=()) -> list:
    """[(path, leaf)] of nested dicts in sorted-key order (a path is the
    tuple of keys down to the leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def from_named_leaves(pairs: list) -> dict:
    """The nested dicts of :func:`named_leaves`' (path, leaf) pairs."""
    out: dict = {}
    for path, leaf in pairs:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return out


def _split_micro(batch: dict, n: int) -> list:
    def sp(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} "
                             f"microbatches")
        return x.reshape(n, b // n, *x.shape[1:])
    parts = {k: sp(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def loss_fn(params, batch, cfg: ModelConfig, tc: TrainConfig,
            force: Optional[str] = None):
    return tfm.train_loss(params, batch, cfg, moe_strategy=tc.moe_strategy,
                          remat=tc.remat, aux_weight=tc.aux_weight,
                          z_weight=tc.z_weight, force=force)


def _value_and_grad(params, batch, cfg, tc, force):
    flat = named_leaves(params)
    leaves = [t for _, t in flat]
    for t in leaves:
        if not t.requires_grad:
            t.requires_grad_(True)
    with torch.enable_grad():
        total, metrics = loss_fn(params, batch, cfg, tc, force)
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total.detach(), metrics, from_named_leaves(
        [(p, g) for (p, _), g in zip(flat, grads)])


def grads_fn(params, batch, cfg: ModelConfig, tc: TrainConfig,
             force: Optional[str] = None):
    """(loss, metrics, grads), with microbatch accumulation: the
    microbatches' gradients summed in ``accum_dtype`` and averaged, the
    losses and metrics averaged."""
    if tc.microbatches <= 1:
        return _value_and_grad(params, batch, cfg, tc, force)
    acc_dt = torch.bfloat16 if tc.accum_dtype == "bf16" else torch.float32
    g_acc = {p: torch.zeros(t.shape, dtype=acc_dt, device=t.device)
             for p, t in named_leaves(params)}
    l_sum, ms = 0.0, []
    for mb in _split_micro(batch, tc.microbatches):
        loss, metrics, g = _value_and_grad(params, mb, cfg, tc, force)
        for p, t in named_leaves(g):
            g_acc[p] = g_acc[p] + t.to(acc_dt)
        l_sum = l_sum + loss
        ms.append(metrics)
    inv = 1.0 / tc.microbatches
    grads = from_named_leaves([(p, g * inv) for p, g in g_acc.items()])
    metrics = {k: torch.mean(torch.stack([m[k] for m in ms]))
               for k in ms[0]}
    return l_sum * inv, metrics, grads


def build_train_step(cfg: ModelConfig, tc: TrainConfig,
                     lr_schedule: Callable,
                     force: Optional[str] = None) -> Callable:
    """step(params, opt_state, batch, step_idx) -> (params, opt_state,
    metrics): the params and optimizer state are updated in place (see
    ``optim.adamw_update``) and returned; metrics has "loss",
    "moe_lb_loss", "moe_z_loss", "logz_mean", "grad_norm", "lr" and
    "total_loss". ``step_idx`` is an int or a 0-d tensor; the learning rate
    is computed from it on the optimizer state's device, so an int step and
    the same step as a tensor there (a CUDA graph's input) give the same
    bits."""

    def train_step(params, opt_state: AdamState, batch: dict, step_idx):
        loss, metrics, grads = grads_fn(params, batch, cfg, tc, force)
        if not torch.is_tensor(step_idx):
            step_idx = torch.full((), step_idx, dtype=torch.int64,
                                  device=opt_state.count.device)
        lr = lr_schedule(step_idx)
        params, opt_state, om = adamw_update(grads, opt_state, params, lr,
                                             tc.adamw, force=force)
        metrics = dict(metrics, **om, lr=lr, total_loss=loss)
        return params, opt_state, metrics

    return train_step


def build_eval_step(cfg: ModelConfig, tc: TrainConfig,
                    force: Optional[str] = None) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch, cfg, tc, force)
        return dict(metrics, total_loss=loss)
    return eval_step
