"""AdamW, gradient clipping and the cosine LR schedule
(``repro.train.optim``'s counterpart).

The optimizer state mirrors the parameter tree (nested dicts). Where
``repro`` returns new arrays, :func:`adamw_update` writes the new
parameters, moments and compensation into the given tensors in place,
under ``torch.no_grad()``, and returns those same tensors: PyTorch's idiom,
and at full width the memory of a second copy of every tree is not there to
spend. The values are ``repro``'s: the same formulas, in fp32.

Every value the update reads per step is a tensor on the leaves' device:
``count``, the bias corrections computed from it, ``lr`` (from
:func:`cosine_schedule` of a step-index tensor) and the clip scale. So the
update runs inside a CUDA graph (``train/graph.py``) without a copy from the
host, and each replay reads that step's values.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Union

import torch

from repro_torch.kernels import ops

F32 = torch.float32


class Quantized(NamedTuple):
    """int8 tensor + per-row fp32 scale (8-bit Adam moments)."""
    q: torch.Tensor       # int8, the param's shape
    scale: torch.Tensor   # f32, shape[:-1] + (1,)


def quantize_q8(x: torch.Tensor) -> Quantized:
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return Quantized(q=q, scale=scale.to(F32))


def dequantize_q8(z: Quantized) -> torch.Tensor:
    return z.q.to(F32) * z.scale


def quantize_q8_sqrt(x: torch.Tensor) -> Quantized:
    """sqrt-domain int8 for the (non-negative) second moment: a linear grid
    on v zeroes small entries, and 1/sqrt(v ~ 0) explodes the step."""
    return quantize_q8(torch.sqrt(torch.clamp(x, min=0.0)))


def dequantize_q8_sqrt(z: Quantized) -> torch.Tensor:
    return torch.square(dequantize_q8(z))


class AdamState(NamedTuple):
    count: torch.Tensor
    mu: dict
    nu: dict
    comp: object = None    # bf16 Kahan compensation (bf16_kahan master)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    quantize_moments: bool = False   # 8-bit Adam (int8 mu/nu + row scales)
    # 'f32' keeps fp32 master weights; 'bf16_kahan' stores a bf16 master and
    # a bf16 Kahan compensation
    master_dtype: str = "f32"


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` congruent)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree) -> list:
    """The leaves of nested dicts in ``repro``'s order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def adamw_init(params, cfg: AdamWConfig = AdamWConfig()) -> AdamState:
    def zeros(p):
        z = torch.zeros(p.shape, dtype=F32, device=p.device)
        return quantize_q8(z) if cfg.quantize_moments else z
    comp = None
    if cfg.master_dtype == "bf16_kahan":
        comp = _map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                          device=p.device), params)
    dev = _leaves(params)[0].device
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=dev),
                     mu=_map(zeros, params), nu=_map(zeros, params),
                     comp=comp)


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.to(F32))) for g in _leaves(tree)]
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _map(lambda g: g * scale.to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(grads, state: AdamState, params, lr, cfg: AdamWConfig,
                 force: Optional[str] = None):
    """One AdamW step with global-norm clipping. Writes the new params,
    moments, compensation and count into their tensors in place and
    returns ``(params, state, {"grad_norm"})`` with those tensors.

    An fp32 master with fp32 moments and gradients (the CLI's
    configuration) takes ``ops.adamw``: on a CUDA tensor the fused Triton
    pass (``kernels.adamw``), on the CPU or with ``force="plain"`` its
    plain version. The ``bf16_kahan`` master, 8-bit moments and gradients
    accumulated in bf16 take the plain update below on every device: the
    pass does not cover them yet."""
    lr = torch.as_tensor(lr, dtype=F32).to(state.count.device)
    if cfg.master_dtype == "f32" and not cfg.quantize_moments \
            and all(g.dtype == F32 for g in _leaves(grads)):
        gnorm = ops.adamw(
            _leaves(params), _leaves(grads), _leaves(state.mu),
            _leaves(state.nu), state.count, lr, b1=cfg.b1, b2=cfg.b2,
            eps=cfg.eps, weight_decay=cfg.weight_decay,
            clip_norm=cfg.clip_norm, force=force)
        return params, state, {"grad_norm": gnorm}
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    state.count.add_(1)
    cf = state.count.to(F32)
    bc1 = 1.0 - torch.pow(torch.full_like(cf, cfg.b1), cf)
    bc2 = 1.0 - torch.pow(torch.full_like(cf, cfg.b2), cf)
    kahan = cfg.master_dtype == "bf16_kahan"

    def upd(g, m, v, p, c):
        gf = g.to(F32)
        m_new = cfg.b1 * m + (1 - cfg.b1) * gf
        v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(gf)
        step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        step = step + cfg.weight_decay * p.to(F32)
        delta = -lr * step
        pf = p.to(F32)
        if c is not None:
            # the compensation carries the bits the bf16 store loses
            y = delta - c.to(F32)
            p_new = (pf + y).to(p.dtype)
            c.copy_(((p_new.to(F32) - pf) - y).to(torch.bfloat16))
        else:
            p_new = (pf + delta).to(p.dtype)
        p.copy_(p_new)
        return m_new, v_new

    def store(dst, new, quant):
        if isinstance(dst, Quantized):
            z = quant(new)
            dst.q.copy_(z.q)
            dst.scale.copy_(z.scale)
        else:
            dst.copy_(new)

    def one_leaf(p, g, m, v, c=None):
        if isinstance(m, Quantized):
            mf, vf = dequantize_q8(m), dequantize_q8_sqrt(v)
        else:
            mf, vf = m, v
        m_new, v_new = upd(g, mf, vf, p, c)
        store(m, m_new, quantize_q8)
        store(v, v_new, quantize_q8_sqrt)

    if kahan:
        _map(one_leaf, params, grads, state.mu, state.nu, state.comp)
    else:
        _map(one_leaf, params, grads, state.mu, state.nu)
    return params, state, {"grad_norm": gnorm}


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> Callable:
    def lr(step: Union[int, torch.Tensor]) -> torch.Tensor:
        s = torch.as_tensor(step).to(F32)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0, 1)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(
            math.pi * prog))
        return base_lr * torch.where(s < warmup, warm, cos)
    return lr
