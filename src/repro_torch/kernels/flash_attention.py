"""Flash attention: the CUDA kernel's wrapper and its plain version.

Replaces ``flash_attention_pallas`` (``src/repro/kernels/flash_attention.py``,
body ``_flash_kernel``) with ``csrc/flash_attention.cu``, a Hopper kernel:
one CTA per (batch x head, 64-row query block), one consumer warpgroup and
one producer warp. The producer loads Q and a ring of K/V tiles through TMA
tensor maps over the (B, S, heads, dh) layout, every stage's loads issued up
front; the consumer computes Q K^T and P V on ``wgmma`` (P from registers),
with the online-softmax carry (m, l, acc in fp32) in registers. Same mask
kinds (causal, local with a window, none), the same GQA map (kv head
``h // (H / KV)``), the same ``-1e30`` mask and ``1e-30`` floor on ``l``.
Causal and local masks skip kv blocks that no row of the query block sees,
which is exact. Ragged sequences are masked by position with no padding
(TMA zero-fills rows past the end). At the prefill shape the kernel is
small and bound by latency; at long sequences it is bound by tensor-core
operations.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NAME = "flash_attention"
BLOCK_Q = 64
BLOCK_KV = 64         # keys per ring stage
HEAD_DIMS = (64, 128)
# Each head dim's CTA as csrc/flash_attention.cu builds it: K/V ring
# stages, threads, dynamic shared memory bytes and the CTAs an SM holds
# (the tile autotuner's c). :func:`form` reads the same on the card.
FORMS = {64: {"stages": 4, "threads": 160, "smem_bytes": 74888,
              "ctas_per_sm": 3},
         128: {"stages": 2, "threads": 160, "smem_bytes": 83016,
               "ctas_per_sm": 2}}
_MASKS = {"none": 0, "causal": 1, "local": 2}


def attention_ref(q, k, v, *, mask_kind: str = "causal",
                  window: int = 0) -> torch.Tensor:
    """Plain version: exact softmax attention in fp32.
    q: (B, Sq, H, dh); k/v: (B, Skv, KV, dh) -> (B, Sq, H, dh) in q.dtype."""
    b, sq, h, dh = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.reshape(b, sq, kv, g, dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) / math.sqrt(dh)
    iq = torch.arange(sq, device=q.device)[:, None]
    jk = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if mask_kind in ("causal", "local"):
        mask &= jk <= iq
    if mask_kind == "local" and window > 0:
        mask &= jk > iq - window
    s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, dh).to(q.dtype)


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bf16.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                         ci, ci, ci, ctypes.c_float, vp]
    lib.flash_attention_bf16.restype = ci
    lib.flash_attention_error_string.argtypes = [ci]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention_block_q.argtypes = []
    lib.flash_attention_block_q.restype = ci
    lib.flash_attention_form.argtypes = [ci, ctypes.POINTER(ci)]
    lib.flash_attention_form.restype = ci
    if lib.flash_attention_block_q() != BLOCK_Q:
        raise RuntimeError("flash_attention.cu block differs from BLOCK_Q")


def grid_blocks(b: int, sq: int, h: int) -> int:
    """CTAs of one launch: one per (batch x head, 64-row query block)."""
    return -(-sq // BLOCK_Q) * b * h


def form(dh: int) -> dict:
    """The kernel's form at head dim ``dh`` on the current CUDA device: K/V
    ring stages, threads a CTA, registers a thread, dynamic shared memory
    bytes, CTAs an SM holds, and bytes spilled a thread."""
    lib = build.load(NAME, _bind)
    out = (ctypes.c_int * 6)()
    err = lib.flash_attention_form(dh, out)
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention_form({dh}) failed: {msg}")
    return dict(zip(("stages", "threads", "registers", "smem_bytes",
                     "ctas_per_sm", "spill_bytes"), out))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mask_kind: str = "causal",
                    window: int = 0) -> torch.Tensor:
    """Launch the kernel on CUDA tensors, on the current stream.
    q: (B, Sq, H, dh); k/v: (B, Skv, KV, dh), bf16, dh in (64, 128)."""
    ts = (q, k, v)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError(f"flash_attention: q, k, v must lie on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError(f"flash_attention: takes bf16, got "
                        f"{[t.dtype for t in ts]}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, h, dh = q.shape
    _, skv, kv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != dh or kv == 0 or h % kv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in "
                         f"{HEAD_DIMS}")
    if mask_kind not in _MASKS:
        raise ValueError(f"flash_attention: mask_kind {mask_kind!r}")
    if mask_kind == "local" and window > 0 and sq > skv:
        raise ValueError(f"flash_attention: a local mask with Sq={sq} > "
                         f"Skv={skv} leaves rows with no visible key")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError("flash_attention: q, k, v must be contiguous and "
                         "16-byte aligned")
    if b * h > 65535:
        raise ValueError(f"flash_attention: B*H={b * h} exceeds the grid's "
                         f"y limit")
    out = torch.empty_like(q)
    if b == 0 or sq == 0 or h == 0:
        return out
    if skv == 0:
        return out.zero_()
    lib = build.load(NAME, _bind)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, h, kv, dh, _MASKS[mask_kind], int(window),
            1.0 / math.sqrt(dh), stream)
    if err:
        raise RuntimeError(
            f"flash_attention launch failed: "
            f"{lib.flash_attention_error_string(err).decode()}")
    build.LAUNCHES[NAME] += 1
    return out
