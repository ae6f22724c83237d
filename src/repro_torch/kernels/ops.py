"""Kernel dispatch by device (``repro.kernels.ops``'s counterpart).

A CUDA tensor launches the hand-written kernel; its wrapper raises if it
cannot, and nothing falls back. A CPU tensor takes the kernel's plain
version. ``force="plain"`` takes the plain version on any device: it exists
so that tests and ``chip_smoke.py`` can hold a kernel against it on the
card, and neither the model nor the planner sets it on its own.
``LAUNCHES`` counts the kernels' launches by name.

Tile selection, as in ``repro``: ``matmul``, ``moe_gmm`` and
``flash_attention`` take an explicit ``tile=``, or ``hw=`` (a GPU spec,
``core.gpu.GpuSpec``), whose tile comes from the tail-aware autotuner
(``kernels.autotune``: Eq. 3 over the card's SMs, memoized per spec and
shape, persisted through ``cache=``). Model code that cannot thread them
through every call runs inside :func:`kernel_context`, whose ``hw`` and
``cache`` fill the unset arguments. With neither, a launch takes the
kernel's default tile ((128, 64) at prefill). A TPU spec's tiles are
``repro``'s Pallas blocks, which the CUDA kernels do not have, so a TPU
spec leaves the default tile too. The choice is made on the host before
the launch, so a CUDA graph captured inside a context keeps its tiles. The
plain versions compute the same values whatever the tile; ``TILES``
records, per kernel, the tile of the last call, the one its launch took
or, on the CPU, would take.

Gradients. ``matmul``, ``moe_gmm``, ``flash_attention``, ``rglru_scan``
and ``rwkv6`` are ``torch.autograd.Function``s when grad is enabled and an
input requires it: on a CUDA tensor the forward and the backward run the
hand-written kernels (the GEMMs' dX and dW products; the attention kernel
with its row log-sum-exp, then ``flash_attention_bwd``, one ``wgmma``
launch; ``rglru_scan_bwd``; ``rwkv6_bwd``), on the CPU (or with ``force="plain"``) the plain forward
and the plain backward's explicit formulas. Serving, under ``no_grad`` or
on tensors that need no grad, takes the forward alone.

The optimizer: ``adamw`` updates fp32 leaves with their global-norm
clipping in one fused pass (``kernels.adamw``) on a CUDA tensor, and with
its plain version on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import adamw as adamw_kernel
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import (
    attention_ref, flash_attention as flash_attention_kernel)
from repro_torch.kernels.matmul_tiled import launch_tile, matmul_bwd, \
    matmul_bwd_ref, matmul_ref, matmul_tiled
from repro_torch.kernels.moe_gmm import moe_gmm as moe_gmm_kernel, \
    moe_gmm_bwd, moe_gmm_bwd_ref, moe_gmm_ref
from repro_torch.kernels.rglru import rglru_bwd_ref, rglru_ref, \
    rglru_scan as rglru_kernel, rglru_scan_bwd
from repro_torch.kernels.rwkv6 import CHUNK, rwkv6 as rwkv6_kernel, \
    rwkv6_bwd, rwkv6_bwd_ref, rwkv6_ref
from repro_torch.kernels.staircase_fused import staircase_cta, \
    staircase_cta_ref, staircase_fused, staircase_ref

LAUNCHES = build.LAUNCHES
reset_launches = build.reset_launches
# per kernel, the tile of the last call (launched, or on the CPU the one a
# launch would take)
TILES = {"matmul": None, "moe_gmm": None, "flash_attention": None}


@dataclasses.dataclass(frozen=True)
class KernelContext:
    """Ambient tile-selection state for model code that cannot thread
    ``hw=`` / ``cache=`` through every call (the forward a step cache
    captures). Installed with :func:`kernel_context`; the wrappers below
    fall back to it when their own ``hw`` / ``cache`` are unset."""

    hw: Any = None
    cache: Any = None


_KERNEL_CTX: Optional[KernelContext] = None


def get_kernel_context() -> Optional[KernelContext]:
    return _KERNEL_CTX


@contextlib.contextmanager
def kernel_context(hw=None, cache=None):
    """Install a :class:`KernelContext` for the duration of the block."""
    global _KERNEL_CTX
    prev = _KERNEL_CTX
    _KERNEL_CTX = KernelContext(hw=hw, cache=cache)
    try:
        yield _KERNEL_CTX
    finally:
        _KERNEL_CTX = prev


def _ctx_fallback(hw, cache):
    """Fill unset hw/cache from the ambient context, if any."""
    ctx = _KERNEL_CTX
    if ctx is None:
        return hw, cache
    return (hw if hw is not None else ctx.hw,
            cache if cache is not None else ctx.cache)


def _tuned(tile, hw, cache, tune):
    """The tile a call asks for: ``tile`` when given, else the autotuner's
    (``tune(hw, cache)``) on a GPU spec from the arguments or the context,
    else None (the kernel's default)."""
    if tile is not None:
        return tuple(tile)
    hw, cache = _ctx_fallback(hw, cache)
    if hw is None:
        return None
    from repro_torch.core.gpu import is_gpu
    if not is_gpu(hw):
        return None
    return tuple(tune(hw, cache).blocks)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


class _Matmul(torch.autograd.Function):
    """x @ w on the kernel (or the plain version), with dX = dY W^T and dW =
    X^T dY on the kernel too (or the plain formulas)."""

    @staticmethod
    def forward(ctx, x, w, tile, plain):
        ctx.save_for_backward(x, w)
        ctx.plain = plain
        return matmul_ref(x, w) if plain else matmul_tiled(x, w, tile)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        if ctx.plain:
            dx, dw = matmul_bwd_ref(x, w, dy)
        else:
            dx, dw = matmul_bwd(x, w, dy, ctx.needs_input_grad[:2])
        return dx, dw, None, None


class _MoeGmm(torch.autograd.Function):
    """Per-expert x @ w on the kernel (or the plain version), with dX = dY
    W^T and dW = X^T dY on the kernel too (or the plain formulas)."""

    @staticmethod
    def forward(ctx, x, w, tile, plain):
        ctx.save_for_backward(x, w)
        ctx.plain = plain
        return moe_gmm_ref(x, w) if plain else moe_gmm_kernel(x, w, tile)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        if ctx.plain:
            dx, dw = moe_gmm_bwd_ref(x, w, dy)
        else:
            dx, dw = moe_gmm_bwd(x, w, dy, ctx.needs_input_grad[:2])
        return dx, dw, None, None


class _RgLru(torch.autograd.Function):
    """The RG-LRU recurrence on the kernel (or the plain version), its
    backward on ``rglru_scan_bwd`` (or ``rglru_bwd_ref``) from the saved
    output."""

    @staticmethod
    def forward(ctx, a, b, h0, plain):
        y, h = rglru_ref(a, b, h0) if plain else rglru_kernel(
            a.contiguous(), b.contiguous(), h0.contiguous())
        ctx.save_for_backward(a, y, h0)
        ctx.plain = plain
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        a, y, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        if ctx.plain:
            da, db, dh0 = rglru_bwd_ref(a, y, h0, dy, dh)
        else:
            da, db, dh0 = rglru_scan_bwd(
                a.contiguous(), y, h0.contiguous(), dy.contiguous(),
                None if dh is None else dh.contiguous())
        return da, db, dh0, None


class _Rwkv6(torch.autograd.Function):
    """RWKV6 on the kernel (or the plain version), its backward on
    ``rwkv6_bwd`` (or ``rwkv6_bwd_ref``) from the saved inputs."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, s0, chunk, plain):
        if plain:
            o, s = rwkv6_ref(r, k, v, log_w, u, s0, chunk=chunk)
        else:
            r, k, v, log_w, u = (t.contiguous() for t in (r, k, v, log_w, u))
            s0 = None if s0 is None else s0.contiguous()
            o, s = rwkv6_kernel(r, k, v, log_w, u, s0, chunk=chunk)
        ctx.save_for_backward(r, k, v, log_w, u, s0)
        ctx.plain = plain
        ctx.set_materialize_grads(False)
        return o, s

    @staticmethod
    def backward(ctx, do, ds):
        r, k, v, log_w, u, s0 = ctx.saved_tensors
        if do is None:
            do = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        bwd = rwkv6_bwd_ref if ctx.plain else rwkv6_bwd
        dr, dk, dv, dlw, du, ds0 = bwd(
            r, k, v, log_w, u, s0, do.float().contiguous(),
            None if ds is None else ds.float().contiguous())
        return (dr, dk, dv, dlw, du, None if s0 is None else ds0, None,
                None)


class _FlashAttention(torch.autograd.Function):
    """Attention on the kernel with its row log-sum-exp (or the plain
    version), and its backward on ``flash_attention_bwd`` (or
    ``attention_bwd_ref``)."""

    @staticmethod
    def forward(ctx, q, k, v, mask_kind, window, plain):
        if plain:
            o, lse = attention_ref(q, k, v, mask_kind=mask_kind,
                                   window=window, lse=True)
        else:
            o, lse = flash_attention_kernel(q, k, v, mask_kind=mask_kind,
                                            window=window, lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask_kind, ctx.window, ctx.plain = mask_kind, window, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if ctx.plain:
            grads = fa.attention_bwd_ref(q, k, v, o, lse, do,
                                         mask_kind=ctx.mask_kind,
                                         window=ctx.window)
        else:
            grads = fa.flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                           mask_kind=ctx.mask_kind)
        return (*grads, None, None, None)


def _use_plain(t: torch.Tensor, force: Optional[str]) -> bool:
    if force == "plain":
        return True
    if force is not None:
        raise ValueError(f"force must be None or 'plain', got {force!r}")
    if t.device.type == "cuda":
        return False
    if t.device.type == "cpu":
        return True
    raise ValueError(f"no kernel or plain path for device {t.device}")


def matmul(x: torch.Tensor, w: torch.Tensor, *, tile=None, hw=None,
           cache=None, force: Optional[str] = None) -> torch.Tensor:
    """(M, K) @ (K, N) with fp32 accumulation, in x.dtype, on ``tile`` (or
    the autotuner's for ``hw``; see the module docstring)."""
    from repro_torch.kernels.autotune import autotune_matmul
    m, k = x.shape
    n = w.shape[1]
    tile = _tuned(tile, hw, cache, lambda h, c: autotune_matmul(
        h, m, n, k, dtype_bits=x.element_size() * 8, cache=c))
    TILES["matmul"] = launch_tile(m, tile)
    plain = _use_plain(x, force)
    if _needs_grad(x, w):
        return _Matmul.apply(x, w, tile, plain)
    if plain:
        return matmul_ref(x, w)
    return matmul_tiled(x, w, tile)


def moe_gmm(x: torch.Tensor, w: torch.Tensor, *, tile=None, hw=None,
            cache=None, force: Optional[str] = None) -> torch.Tensor:
    """Per expert (E, C, D) @ (E, D, F) with fp32 accumulation, in x.dtype,
    on ``tile`` (or the autotuner's for ``hw``). x may be a broadcast view
    (expert stride 0): the kernel reads it as it is."""
    from repro_torch.kernels.autotune import autotune_moe_gmm
    e, c, d = x.shape
    f = w.shape[2]
    tile = _tuned(tile, hw, cache, lambda h, cc: autotune_moe_gmm(
        h, e, c, d, f, dtype_bits=x.element_size() * 8, cache=cc))
    TILES["moe_gmm"] = launch_tile(c, tile)
    plain = _use_plain(x, force)
    if _needs_grad(x, w):
        return _MoeGmm.apply(x, w, tile, plain)
    if plain:
        return moe_gmm_ref(x, w)
    return moe_gmm_kernel(x, w, tile)


def flash_attention(q, k, v, *, mask_kind: str = "causal", window: int = 0,
                    tile=None, hw=None, cache=None,
                    force: Optional[str] = None) -> torch.Tensor:
    """Attention over (B, S, H, dh) q and (B, S, KV, dh) k, v. The kernel
    has one tile, (``BLOCK_Q``, ``BLOCK_KV``); the autotuner scores it, and
    another raises. Where grad is needed, the backward kernel covers the
    ``causal`` and ``none`` masks; ``local`` raises on a CUDA tensor."""
    from repro_torch.kernels.autotune import autotune_flash_attention
    b, sq, h, dh = q.shape
    skv, kv = k.shape[1], k.shape[2]
    tile = _tuned(tile, hw, cache, lambda hh, c: autotune_flash_attention(
        hh, b, sq, skv, h, kv, dh, dtype_bits=q.element_size() * 8,
        cache=c))
    one = (fa.BLOCK_Q, fa.BLOCK_KV)
    if tile is not None and tile != one:
        raise ValueError(f"flash_attention has the one tile {one}, not "
                         f"{tile}")
    TILES["flash_attention"] = one
    plain = _use_plain(q, force)
    if _needs_grad(q, k, v):
        if not plain and mask_kind not in fa.BWD_MASKS:
            raise RuntimeError(
                f"flash_attention: the backward kernel takes masks "
                f"{fa.BWD_MASKS}, not {mask_kind!r}")
        return _FlashAttention.apply(q, k, v, mask_kind, window, plain)
    if plain:
        return attention_ref(q, k, v, mask_kind=mask_kind, window=window)
    return flash_attention_kernel(q, k, v, mask_kind=mask_kind,
                                  window=window)


def staircase_latency(widths, shard_out, ca, mb, mc, *, lane: int,
                      force: Optional[str] = None):
    """Fused staircase sweep (``kernels.staircase_fused``): (L, C) widths
    and (L, 1) ``shard_out``/``ca``/``mb``/``mc`` -> (latency, waves,
    occupancy). A CUDA tensor launches the Triton kernel, which computes in
    int32 and fp32; the widths and shards are checked against its domain
    first, in int64 whatever their integer type (one host sync), and cast.
    A CPU tensor takes the fp64 plain version."""
    if _use_plain(widths, force):
        return staircase_ref(widths, shard_out, ca, mb, mc, lane=lane)
    w, so = widths.to(torch.int64), shard_out.to(torch.int64)
    if bool((w < 0).any() | (w >= 2 ** 31).any() | (so < 1).any()
            | (so >= 2 ** 31).any()):
        raise ValueError("staircase_latency: the kernel takes widths in "
                         "[0, 2**31) and shard_out in [1, 2**31)")
    i32, f32 = torch.int32, torch.float32
    return staircase_fused(
        widths.to(i32).contiguous(), shard_out.to(i32).contiguous(),
        ca.to(f32).contiguous(), mb.to(f32).contiguous(),
        mc.to(f32).contiguous(), lane=lane)


def staircase_cta_latency(widths, shard_out, g, slots, ca, mb, mc, *,
                          block_n: int, force: Optional[str] = None):
    """CTA-wave staircase sweep (``kernels.staircase_fused``, the tail
    model's GPU form): (L, C) widths and (L, 1) ``shard_out``, ``g``,
    ``slots``, ``ca``, ``mb``, ``mc`` -> (latency, waves, tiles). A CUDA
    tensor launches the Triton kernel, which computes in int32 and fp32;
    the integers are checked against its domain first, in int64 (one host
    sync), and cast. A CPU tensor takes the fp64 plain version."""
    if _use_plain(widths, force):
        return staircase_cta_ref(widths, shard_out, g, slots, ca, mb, mc,
                                 block_n=block_n)
    w, so = widths.to(torch.int64), shard_out.to(torch.int64)
    gg, sl = g.to(torch.int64), slots.to(torch.int64)
    top = 2 ** 31
    w_max = w.amax(dim=1, keepdim=True) if w.numel() else w[:, :1]
    most = gg * -torch.div(-(-torch.div(-w_max.clamp(min=0), so.clamp(min=1),
                                        rounding_mode="floor")), block_n,
                           rounding_mode="floor")
    if bool((w < 0).any() | (w >= top).any() | (so < 1).any()
            | (so >= top).any() | (gg < 0).any() | (sl < 1).any()
            | (sl >= top).any() | (most >= top).any()):
        raise ValueError("staircase_cta_latency: the kernel takes widths "
                         "in [0, 2**31), shard_out and slots in [1, 2**31), "
                         "g >= 0 and g x tiles below 2**31")
    i32, f32 = torch.int32, torch.float32
    return staircase_cta(
        widths.to(i32).contiguous(), shard_out.to(i32).contiguous(),
        g.to(i32).contiguous(), slots.to(i32).contiguous(),
        ca.to(f32).contiguous(), mb.to(f32).contiguous(),
        mc.to(f32).contiguous(), block_n=block_n)


def rglru_scan(a, b, h0, *, force: Optional[str] = None):
    """The RG-LRU recurrence ``h_t = a_t * h_{t-1} + b_t`` from ``h0`` over
    (B, T, W) fp32 ``a``, ``b`` -> (y (B, T, W) fp32, h_last (B, W))."""
    plain = _use_plain(a, force)
    if _needs_grad(a, b, h0):
        return _RgLru.apply(a, b, h0, plain)
    if plain:
        return rglru_ref(a, b, h0)
    return rglru_kernel(a.contiguous(), b.contiguous(), h0.contiguous())


def rwkv6(r, k, v, log_w, u, s0=None, *, chunk: int = CHUNK,
          force: Optional[str] = None):
    """RWKV6 linear attention over (B, T, H, dh) from the state ``s0``
    (zeros when None) -> (o fp32, final state (B, H, dh, dh) fp32)."""
    plain = _use_plain(r, force)
    if _needs_grad(r, k, v, log_w, u, s0):
        return _Rwkv6.apply(r, k, v, log_w, u, s0, chunk, plain)
    if plain:
        return rwkv6_ref(r, k, v, log_w, u, s0, chunk=chunk)
    return rwkv6_kernel(r.contiguous(), k.contiguous(), v.contiguous(),
                        log_w.contiguous(), u.contiguous(),
                        None if s0 is None else s0.contiguous(), chunk=chunk)


def adamw(params, grads, mu, nu, count, lr, *, b1: float, b2: float,
          eps: float, weight_decay: float, clip_norm: float,
          force: Optional[str] = None) -> torch.Tensor:
    """AdamW with global-norm clipping over lists of fp32 leaves (params,
    gradients, first and second moments), in place, from the int32 0-d
    ``count`` and the fp32 0-d ``lr`` on their device -> the gradients'
    global norm (``kernels.adamw``)."""
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              clip_norm=clip_norm)
    if _use_plain(count, force):
        return adamw_kernel.adamw_ref(params, grads, mu, nu, count, lr, **kw)
    return adamw_kernel.adamw(params, grads, mu, nu, count, lr, **kw)
