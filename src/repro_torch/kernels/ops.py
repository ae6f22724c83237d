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
from repro_torch.kernels.staircase_fused import staircase_fused, \
    staircase_ref

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
