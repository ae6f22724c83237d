"""Kernel dispatch by device (``repro.kernels.ops``'s counterpart).

A CUDA tensor launches the hand-written kernel; its wrapper raises if it
cannot, and nothing falls back. A CPU tensor takes the kernel's plain
version. ``force="plain"`` takes the plain version on any device: it exists
so that tests and ``chip_smoke.py`` can hold a kernel against it on the
card, and neither the model nor the planner sets it on its own.
``LAUNCHES`` counts the kernels' launches by name.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (
    attention_ref, flash_attention as flash_attention_kernel)
from repro_torch.kernels.matmul_tiled import matmul_ref, matmul_tiled
from repro_torch.kernels.moe_gmm import moe_gmm as moe_gmm_kernel, \
    moe_gmm_ref
from repro_torch.kernels.rglru import rglru_ref, rglru_scan as rglru_kernel
from repro_torch.kernels.rwkv6 import CHUNK, rwkv6 as rwkv6_kernel, rwkv6_ref
from repro_torch.kernels.staircase_fused import staircase_cta, \
    staircase_cta_ref, staircase_fused, staircase_ref

LAUNCHES = build.LAUNCHES
reset_launches = build.reset_launches


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


def matmul(x: torch.Tensor, w: torch.Tensor, *,
           force: Optional[str] = None) -> torch.Tensor:
    """(M, K) @ (K, N) with fp32 accumulation, in x.dtype."""
    if _use_plain(x, force):
        return matmul_ref(x, w)
    return matmul_tiled(x, w)


def moe_gmm(x: torch.Tensor, w: torch.Tensor, *,
            force: Optional[str] = None) -> torch.Tensor:
    """Per expert (E, C, D) @ (E, D, F) with fp32 accumulation, in x.dtype.
    x may be a broadcast view (expert stride 0): the kernel reads it as it
    is."""
    if _use_plain(x, force):
        return moe_gmm_ref(x, w)
    return moe_gmm_kernel(x, w)


def flash_attention(q, k, v, *, mask_kind: str = "causal", window: int = 0,
                    force: Optional[str] = None) -> torch.Tensor:
    """Attention over (B, S, H, dh) q and (B, S, KV, dh) k, v."""
    if _use_plain(q, force):
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
    if _use_plain(a, force):
        return rglru_ref(a, b, h0)
    return rglru_kernel(a.contiguous(), b.contiguous(), h0.contiguous())


def rwkv6(r, k, v, log_w, u, s0=None, *, chunk: int = CHUNK,
          force: Optional[str] = None):
    """RWKV6 linear attention over (B, T, H, dh) from the state ``s0``
    (zeros when None) -> (o fp32, final state (B, H, dh, dh) fp32)."""
    if _use_plain(r, force):
        return rwkv6_ref(r, k, v, log_w, u, s0, chunk=chunk)
    return rwkv6_kernel(r.contiguous(), k.contiguous(), v.contiguous(),
                        log_w.contiguous(), u.contiguous(),
                        None if s0 is None else s0.contiguous(), chunk=chunk)
