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

The backward (:func:`flash_attention_bwd`, ``csrc/flash_attention_bwd.cu``)
has no Pallas counterpart: ``repro`` trains through plain JAX. It takes the
forward's output and its row log-sum-exp (``flash_attention(..., lse=True)``)
and recomputes P, FlashAttention-2's scheme: a dK/dV pass per (batch x kv
head, 64-key block) and a dQ pass per (batch x head, 64-query block), on
``mma.sync``, with no atomics (two calls are bit-equal). Masks ``causal``
and ``none``. Its plain version is :func:`attention_bwd_ref`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NAME = "flash_attention"
NAME_BWD = "flash_attention_bwd"
BWD_MASKS = ("none", "causal")
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


def _mask(sq: int, skv: int, mask_kind: str, window: int, device):
    """(Sq, Skv) True where query i sees key j."""
    iq = torch.arange(sq, device=device)[:, None]
    jk = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if mask_kind in ("causal", "local"):
        mask &= jk <= iq
    if mask_kind == "local" and window > 0:
        mask &= jk > iq - window
    return mask


def _scores(q, k, mask_kind: str, window: int):
    """fp32 (B, KV, G, Sq, Skv) scaled scores, masked to -1e30, and the
    mask."""
    b, sq, h, dh = q.shape
    skv, kv = k.shape[1], k.shape[2]
    qf = q.reshape(b, sq, kv, h // kv, dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) / math.sqrt(dh)
    mask = _mask(sq, skv, mask_kind, window, q.device)
    return torch.where(mask, s, torch.full((), -1e30, device=q.device)), mask


def attention_ref(q, k, v, *, mask_kind: str = "causal", window: int = 0,
                  lse: bool = False):
    """Plain version: exact softmax attention in fp32.
    q: (B, Sq, H, dh); k/v: (B, Skv, KV, dh) -> (B, Sq, H, dh) in q.dtype;
    with ``lse`` also each row's log-sum-exp of the scaled scores, fp32
    (B, H, Sq)."""
    b, sq, h, dh = q.shape
    s, _ = _scores(q, k, mask_kind, window)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    o = o.reshape(b, sq, h, dh).to(q.dtype)
    if not lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(b, h, sq)


def attention_bwd_ref(q, k, v, o, lse, do, *, mask_kind: str = "causal",
                      window: int = 0):
    """Plain version of the backward: (dq, dk, dv) in the inputs' dtypes
    from the forward's output ``o`` and row log-sum-exp ``lse`` (B, H, Sq),
    the explicit formulas in fp32: P = exp(S - lse) on the visible pairs,
    dV = P^T dO, dP = dO V^T, D = rowsum(dO * O), dS = P (dP - D), dQ =
    scale dS K, dK = scale dS^T Q (a kv head summed over its group)."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    g = h // kv
    s, mask = _scores(q, k, mask_kind, window)
    lse5 = lse.float().reshape(b, kv, g, sq)[..., None]
    p = torch.where(mask, torch.exp(s - lse5),
                    torch.zeros((), device=q.device))
    dof = do.reshape(b, sq, kv, g, dh).float()
    of = o.reshape(b, sq, kv, g, dh).float()
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    delta = (dof * of).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - delta) / math.sqrt(dh)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float())
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.reshape(b, sq, kv, g, dh).float())
    return (dq.reshape(b, sq, h, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bf16.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                         ci, ci, ci, ci, ctypes.c_float, vp]
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


def _check(what: str, q, k, v, extra=()) -> None:
    """Raise unless q (B, Sq, H, dh) and k, v (B, Skv, KV, dh) (and the
    ``extra`` tensors of q's shape) are contiguous, 16-byte aligned bf16 on
    one CUDA device, with H a multiple of KV, dh in ``HEAD_DIMS`` and B*H
    within the grid."""
    ts = (q, k, v) + tuple(extra)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError(f"{what}: tensors must lie on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise TypeError(f"{what}: takes bf16, got {[t.dtype for t in ts]}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or any(
            t.shape != q.shape for t in extra):
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, others "
                         f"{[tuple(t.shape) for t in extra]}")
    b, _, h, dh = q.shape
    kv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or kv == 0 or h % kv:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {dh} not in {HEAD_DIMS}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError(f"{what}: tensors must be contiguous and 16-byte "
                         f"aligned")
    if b * h > 65535:
        raise ValueError(f"{what}: B*H={b * h} exceeds the grid's y limit")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mask_kind: str = "causal", window: int = 0,
                    lse: bool = False):
    """Launch the kernel on CUDA tensors, on the current stream.
    q: (B, Sq, H, dh); k/v: (B, Skv, KV, dh), bf16, dh in (64, 128). With
    ``lse`` it returns (out, each row's log-sum-exp as fp32 (B, H, Sq)),
    which the backward takes."""
    _check("flash_attention", q, k, v)
    b, sq, h, dh = q.shape
    _, skv, kv, _ = k.shape
    if mask_kind not in _MASKS:
        raise ValueError(f"flash_attention: mask_kind {mask_kind!r}")
    if mask_kind == "local" and window > 0 and sq > skv:
        raise ValueError(f"flash_attention: a local mask with Sq={sq} > "
                         f"Skv={skv} leaves rows with no visible key")
    out = torch.empty_like(q)
    rows = torch.empty((b, h, sq), dtype=torch.float32,
                       device=q.device) if lse else None
    if b == 0 or sq == 0 or h == 0 or skv == 0:
        out.zero_()
        if lse:
            rows.fill_(-math.inf)
        return (out, rows) if lse else out
    lib = build.load(NAME, _bind)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            rows.data_ptr() if lse else None, b, sq, skv, h, kv, dh,
            _MASKS[mask_kind], int(window), 1.0 / math.sqrt(dh), stream)
    if err:
        raise RuntimeError(
            f"flash_attention launch failed: "
            f"{lib.flash_attention_error_string(err).decode()}")
    build.LAUNCHES[NAME] += 1
    return (out, rows) if lse else out


def _bind_bwd(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd_bf16.argtypes = [vp] * 10 + [ci] * 7 + [
        ctypes.c_float, vp]
    lib.flash_attention_bwd_bf16.restype = ci
    lib.flash_attention_bwd_error_string.argtypes = [ci]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    lib.flash_attention_bwd_form.argtypes = [ci, ctypes.POINTER(ci)]
    lib.flash_attention_bwd_form.restype = ci
    lib.flash_attention_bwd_block.argtypes = []
    lib.flash_attention_bwd_block.restype = ci
    if lib.flash_attention_bwd_block() != BLOCK_Q:
        raise RuntimeError("flash_attention_bwd.cu block differs from "
                           "BLOCK_Q")


def bwd_form(dh: int) -> dict:
    """The backward's passes at head dim ``dh`` on the current CUDA device:
    threads a CTA, dynamic shared memory bytes, and registers and spilled
    bytes a thread of the dK/dV and the dQ pass."""
    lib = build.load(NAME_BWD, _bind_bwd)
    out = (ctypes.c_int * 6)()
    err = lib.flash_attention_bwd_form(dh, out)
    if err:
        msg = lib.flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention_bwd_form({dh}) failed: {msg}")
    return dict(zip(("threads", "smem_bytes", "dkdv_registers",
                     "dkdv_spill_bytes", "dq_registers", "dq_spill_bytes"),
                    out))


def bwd_grid_blocks(b: int, sq: int, skv: int, h: int, kv: int) -> tuple:
    """CTAs of the backward's dK/dV pass and dQ pass."""
    return -(-skv // BLOCK_KV) * b * kv, -(-sq // BLOCK_Q) * b * h


def flash_attention_bwd(q, k, v, o, lse, do, *, mask_kind: str = "causal"):
    """Launch the backward on CUDA tensors, on the current stream: (dq, dk,
    dv) of attention over q (B, Sq, H, dh) and k, v (B, Skv, KV, dh) from
    the forward's output ``o``, its row log-sum-exp ``lse`` (fp32 (B, H,
    Sq), from ``flash_attention(..., lse=True)``) and the output's gradient
    ``do``. Masks ``none`` and ``causal``. One call is three launches
    (D = rowsum(dO * O), the dK/dV pass, the dQ pass) and counts one."""
    _check("flash_attention_bwd", q, k, v, (o, do))
    if mask_kind not in BWD_MASKS:
        raise ValueError(f"flash_attention_bwd: mask_kind {mask_kind!r} not "
                         f"in {BWD_MASKS}")
    b, sq, h, dh = q.shape
    _, skv, kv, _ = k.shape
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq) or \
            not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse must be contiguous fp32 "
                         f"{(b, h, sq)} on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b == 0 or h == 0 or sq == 0 or skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = build.load(NAME_BWD, _bind_bwd)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, sq, skv, h, kv, dh,
            _MASKS[mask_kind], 1.0 / math.sqrt(dh), stream)
    if err:
        raise RuntimeError(
            f"flash_attention_bwd launch failed: "
            f"{lib.flash_attention_bwd_error_string(err).decode()}")
    build.LAUNCHES[NAME_BWD] += 1
    return dq, dk, dv
