"""AdamW with global-norm clipping as one fused pass over every leaf: the
Triton kernel's wrapper and its plain version.

Both compute ``repro``'s ``adamw_update`` (``src/repro/train/optim.py:102``)
for fp32 master weights and fp32 moments, in place::

    norm  = sqrt(sum over every leaf of sum(g^2))
    scale = min(1, clip_norm / max(norm, 1e-9))
    count = count + 1,  bc1 = 1 - b1^count,  bc2 = 1 - b2^count
    g     = g * scale
    m     = b1 m + (1 - b1) g,   v = b2 v + (1 - b2) g^2
    p     = p - lr ((m / bc1) / (sqrt(v / bc2) + eps) + weight_decay p)

and return ``norm``. ``count`` (int32) and ``lr`` (fp32) are 0-d tensors on
the leaves' device, so a CUDA graph that captures the pass reads each
step's values; the constants of the configuration are the kernels'
arguments.

No TPU kernel computes this: ``repro`` jits its train step and XLA fuses
the update's elementwise chain inside that one executable. The port runs
its step eagerly (or replays it as one CUDA graph, ``train/graph.py``), so
the fusion is a kernel of its own. Its bound is bytes: 32 a parameter (the
norm reads g; the update reads p, g, m, v and writes p, m, v), against about
15 elementwise torch ops that each read and write a whole leaf.

``adamw`` launches its Triton kernels on the current stream, counted as
one call under ``NAME``:

1. ``_adamw_partials``, one launch per leaf: one program per block of
   ``BLOCK`` elements of the leaf writes the block's sum of g^2 to its own
   slot of one buffer of partials, from the leaf's first slot
   (``leaf_blocks``); no atomics, so two calls give the same bits;
2. ``_adamw_scalars``, one program: sums the partials in a fixed order,
   writes the norm, the clip scale, the bias corrections and lr to a small
   buffer of scalars, and adds one to ``count``;
3. ``_adamw_update``, one launch per leaf: one program per block reads g,
   m, v and p once and writes m, v and p.

So a call on L leaves, none empty, is 2 L + 1 kernels. Each kernel takes
its leaves' addresses and lengths as arguments, which a CUDA graph that
captures the call keeps: a capture needs nothing more than the step's
own tensors.

``adamw_ref`` is the plain version, the same formulas in torch, leaf by
leaf; the CPU path and ``force="plain"`` take it. The kernel sums the
norm in another order, and rounds pow, sqrt and division at other last
bits, so the two differ by a few fp32 ulps of each value.

Triton is imported, and the kernels compiled (into ``build/triton``), at
the first launch (``build.import_triton``), never when this module is
imported.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.kernels import build

__all__ = ["adamw_ref", "adamw", "leaf_blocks"]

NAME = "adamw"
F32 = torch.float32
BLOCK = 4096          # elements of a leaf per program of passes 1 and 3
SUM_BLOCK = 1024      # partials summed per step of pass 2's loop


def adamw_ref(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
              count: torch.Tensor, lr: torch.Tensor, *, b1: float, b2: float,
              eps: float, weight_decay: float,
              clip_norm: float) -> torch.Tensor:
    """Plain version of :func:`adamw`: the same update in torch, writing
    ``params``, ``mu``, ``nu`` and ``count`` in place; returns the
    gradients' global norm (0-d fp32)."""
    sq = [torch.sum(torch.square(g.to(F32))) for g in grads]
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    norm = torch.sqrt(total)
    scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-9), max=1.0)
    count.add_(1)
    cf = count.to(F32)
    bc1 = 1.0 - torch.pow(torch.full_like(cf, b1), cf)
    bc2 = 1.0 - torch.pow(torch.full_like(cf, b2), cf)
    for p, g, m, v in zip(params, grads, mu, nu):
        gf = (g * scale.to(g.dtype)).to(F32)
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * torch.square(gf)
        step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        step = step + weight_decay * p.to(F32)
        p.copy_((p.to(F32) + -lr * step).to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)
    return norm


def leaf_blocks(numels: Sequence[int], block: int = BLOCK):
    """(each leaf's first slot in the buffer of partials, its number of
    blocks), int64: leaf i covers ``ceil(numels[i] / block)`` consecutive
    slots, an empty leaf none."""
    nb = np.array([-(-int(n) // block) for n in numels], dtype=np.int64)
    return np.cumsum(nb) - nb, nb


# triton.language, bound by ``_kernels`` before the kernels are compiled
# (see ``staircase_fused``); the constexpr annotations stay strings
tl = None


def _adamw_partials(g_ptr, n, part_ptr, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    g = tl.load(g_ptr + offs, mask=offs < n, other=0.0)
    tl.store(part_ptr + pid, tl.sum(g * g, axis=0))


def _adamw_scalars(part_ptr, n_part, count_ptr, lr_ptr, scal_ptr, clip_norm,
                   log2_b1, log2_b2, BLOCK: tl.constexpr):
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for start in range(0, n_part, BLOCK):
        offs = start + tl.arange(0, BLOCK)
        acc += tl.load(part_ptr + offs, mask=offs < n_part, other=0.0)
    norm = tl.sqrt_rn(tl.sum(acc, axis=0))
    count = tl.load(count_ptr) + 1
    tl.store(count_ptr, count)
    c = count.to(tl.float32)
    tl.store(scal_ptr, norm)
    tl.store(scal_ptr + 1, tl.minimum(
        tl.div_rn(clip_norm, tl.maximum(norm, 1e-9)), 1.0))
    tl.store(scal_ptr + 2, 1.0 - tl.exp2(c * log2_b1))
    tl.store(scal_ptr + 3, 1.0 - tl.exp2(c * log2_b2))
    tl.store(scal_ptr + 4, tl.load(lr_ptr))


def _adamw_update(p_ptr, g_ptr, m_ptr, v_ptr, n, scal_ptr, b1, ob1, b2, ob2,
                  eps, wd, BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    scale = tl.load(scal_ptr + 1)
    bc1 = tl.load(scal_ptr + 2)
    bc2 = tl.load(scal_ptr + 3)
    lr = tl.load(scal_ptr + 4)
    g = tl.load(g_ptr + offs, mask=mask, other=0.0) * scale
    m = b1 * tl.load(m_ptr + offs, mask=mask, other=0.0) + ob1 * g
    v = b2 * tl.load(v_ptr + offs, mask=mask, other=0.0) + ob2 * (g * g)
    p = tl.load(p_ptr + offs, mask=mask, other=0.0)
    step = tl.div_rn(tl.div_rn(m, bc1), tl.sqrt_rn(tl.div_rn(v, bc2)) + eps)
    tl.store(p_ptr + offs, p + -lr * (step + wd * p), mask=mask)
    tl.store(m_ptr + offs, m, mask=mask)
    tl.store(v_ptr + offs, v, mask=mask)


@functools.lru_cache(maxsize=None)
def _kernels():
    global tl
    triton = build.import_triton()
    import triton.language
    tl = triton.language
    return tuple(triton.jit(f) for f in (_adamw_partials, _adamw_scalars,
                                         _adamw_update))


def _check(params, grads, mu, nu, count, lr) -> None:
    dev = count.device
    lists = (params, grads, mu, nu)
    if not (len(params) == len(grads) == len(mu) == len(nu)):
        raise ValueError("adamw: params, grads, mu and nu must have one "
                         "leaf each")
    if not all(t.is_cuda and t.device == dev for ts in lists for t in ts) \
            or not (count.is_cuda and lr.device == dev):
        raise ValueError("adamw: every input must lie on one CUDA device")
    if any(t.dtype != F32 for ts in lists for t in ts) or \
            lr.dtype != F32 or count.dtype != torch.int32:
        raise TypeError("adamw: takes fp32 leaves and lr and an int32 count")
    if count.dim() or lr.dim():
        raise ValueError("adamw: count and lr must be 0-d")
    if any(not (g.shape == m.shape == v.shape == p.shape)
           for p, g, m, v in zip(*lists)):
        raise ValueError("adamw: a leaf's param, grad and moments must have "
                         "one shape")
    if not all(t.is_contiguous() for ts in lists for t in ts):
        raise ValueError("adamw: leaves must be contiguous")


def adamw(params: List[torch.Tensor], grads: List[torch.Tensor],
          mu: List[torch.Tensor], nu: List[torch.Tensor],
          count: torch.Tensor, lr: torch.Tensor, *, b1: float, b2: float,
          eps: float, weight_decay: float,
          clip_norm: float) -> torch.Tensor:
    """Launch the passes on the current stream: fp32 contiguous leaves (one
    list each of params, grads, first and second moments, the i-th of each
    of one shape), an int32 0-d ``count`` and an fp32 0-d ``lr``, on one
    CUDA device. Writes params, moments and ``count`` in place and returns
    the gradients' global norm (0-d fp32). One call, counted under
    ``NAME``."""
    _check(params, grads, mu, nu, count, lr)
    dev = count.device
    numels = [p.numel() for p in params]
    if max(numels, default=0) >= 2 ** 31 - BLOCK:
        raise ValueError(f"adamw: a leaf of {max(numels)} elements is out "
                         "of range")
    first, nb = leaf_blocks(numels)
    n_part = int(nb.sum())
    scal = torch.empty(5, dtype=F32, device=dev)
    part = torch.empty(max(n_part, 1), dtype=F32, device=dev)
    partials, scalars, update = _kernels()
    with torch.cuda.device(dev):
        for g, n, f, b in zip(grads, numels, first.tolist(), nb.tolist()):
            if b:
                partials[(b,)](g, n, part[f:], BLOCK=BLOCK, num_warps=8)
        scalars[(1,)](part, n_part, count, lr, scal, float(clip_norm),
                      math.log2(b1), math.log2(b2), BLOCK=SUM_BLOCK,
                      num_warps=4)
        for p, g, m, v, n, b in zip(params, grads, mu, nu, numels,
                                    nb.tolist()):
            if b:
                update[(b,)](p, g, m, v, n, scal, float(b1), 1.0 - b1,
                             float(b2), 1.0 - b2, float(eps),
                             float(weight_decay), BLOCK=BLOCK, num_warps=8)
    build.LAUNCHES[NAME] += 1
    return scal[0]
