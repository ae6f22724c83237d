"""RWKV6 chunked linear attention: the CUDA kernel's wrapper and its plain
version (``repro.kernels.rwkv6``'s counterpart).

Both compute, per batch row and head, from a state ``s0`` (zeros when None)
and with the bonus ``u``::

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (diag(w_t) S_{t-1} + (u * k_t)^T v_t),   w_t = exp(log_w_t)

over (B, T, H, dh) ``r``, ``k``, ``v`` and fp32 ``log_w`` and an (H, dh)
``u``, and return ``(o, S)``: o (B, T, H, dh) fp32 and the final state
(B, H, dh, dh) fp32, which the model's prefill hands to decode.

``rwkv6`` launches ``csrc/rwkv6.cu``, which replaces ``rwkv6_pallas``
(``src/repro/kernels/rwkv6.py``, body ``_rwkv_kernel``): one CTA per
(b, h) keeps S in shared memory and walks chunks of ``chunk`` steps in
order, a ragged last chunk masked. Within a chunk it uses the pairwise form
of ``repro``'s ``rwkv_chunked`` (every exponent <= 0), not the TPU kernel's
factored product, which overflows fp32 for log decays <= -3 while the model
reaches -e^4. It adds ``s0`` and the final state, which the TPU kernel
lacks.

``rwkv6_ref`` is the plain version: the same pairwise chunk step in torch
(:func:`chunk_scan`), the sequence zero-padded to whole chunks (a padded
step has ``log_w`` 0 and ``k`` = ``v`` = 0, so it leaves S as it is).

Both accumulate in fp32, as ``repro`` does; they sum in other orders, so
they agree to fp32 rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

__all__ = ["chunk_scan", "rwkv6_ref", "rwkv6"]

NAME = "rwkv6"
CHUNK = 32        # rwkv6_pallas's and rwkv_chunked's default
MAX_HEAD_DIM = 128   # csrc/rwkv6.cu checks both
MAX_CHUNK = 64


def chunk_scan(r, k, v, log_w, u, s0=None, *, chunk: int):
    """The pairwise chunked form over T = n * ``chunk`` steps
    (``repro.models.recurrent.rwkv_chunked``'s chunk step, looped), in
    fp32; returns (o, S)."""
    b, t, h, dk = r.shape
    if t % chunk:
        raise ValueError(f"chunk_scan: T={t} is not a multiple of {chunk}")
    n, c = t // chunk, chunk
    rf, kf, vf, lw = (a.float().reshape(b, n, c, h, dk)
                      for a in (r, k, v, log_w))
    uf = u.float()
    s = (torch.zeros((b, h, dk, dk), device=r.device)
         if s0 is None else s0.float())
    idx = torch.arange(c, device=r.device)
    tri = (idx[:, None] > idx[None, :])[None, :, :, None, None]
    eye = torch.eye(c, device=r.device)
    outs = []
    for i in range(n):
        rc, kc, vc = rf[:, i], kf[:, i], vf[:, i]           # (B, C, H, K)
        le = torch.cumsum(lw[:, i], dim=1)                  # inclusive logs
        # pairwise decay exp(le_i - le_j) for j < i (exp of <= 0); the
        # masked entries are never multiplied, so their inf is dropped
        diff = le[:, :, None] - le[:, None, :]              # (B,C,C,H,K)
        a = torch.where(tri, torch.exp(diff),
                        torch.zeros((), device=r.device))
        intra = torch.einsum("bihd,bjhd,bijhd->bhij", rc, kc, a)
        diag = torch.einsum("bihd,hd,bihd->bhi", rc, uf, kc)
        intra = intra + diag[..., None] * eye
        o = torch.einsum("bhij,bjhd->bihd", intra, vc)
        o = o + torch.einsum("bihd,bhdj->bihj", rc * torch.exp(le), s)
        le_c = le[:, -1]                                    # (B, H, K)
        k_scaled = kc * torch.exp(le_c[:, None] - le)
        s = torch.exp(le_c)[..., None] * s \
            + torch.einsum("bihd,bihj->bhdj", k_scaled, vc)
        outs.append(o)
    if not outs:
        return r.new_zeros((b, 0, h, dk), dtype=torch.float32), s.clone()
    return torch.cat(outs, dim=1), s


def rwkv6_ref(r, k, v, log_w, u, s0=None, *, chunk: int = CHUNK):
    """Plain version: ``chunk_scan`` over the sequence padded to whole
    chunks of ``min(chunk, T)``, on the inputs' device."""
    t = r.shape[1]
    c = max(1, min(chunk, t))
    pad = -t % c
    if pad:
        r, k, v, log_w = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                          for a in (r, k, v, log_w))
    o, s = chunk_scan(r, k, v, log_w, u, s0, chunk=c)
    return o[:, :t], s


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_forward.argtypes = [vp] * 8 + [ci] * 6 + [vp]
    lib.rwkv6_forward.restype = ci
    lib.rwkv6_error_string.argtypes = [ci]
    lib.rwkv6_error_string.restype = ctypes.c_char_p
    for fn in (lib.rwkv6_max_head_dim, lib.rwkv6_max_chunk):
        fn.argtypes = []
        fn.restype = ci
    if (lib.rwkv6_max_head_dim(), lib.rwkv6_max_chunk()) != (
            MAX_HEAD_DIM, MAX_CHUNK):
        raise RuntimeError("rwkv6.cu limits differ from MAX_HEAD_DIM / "
                           "MAX_CHUNK")


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          log_w: torch.Tensor, u: torch.Tensor,
          s0: Optional[torch.Tensor] = None, *, chunk: int = CHUNK):
    """Launch the kernel on the current stream: r, k, v (B, T, H, dh), all
    bf16 or all fp32; log_w (B, T, H, dh) fp32; u (H, dh) fp32; s0
    (B, H, dh, dh) fp32 or None; contiguous, on one CUDA device ->
    (o (B, T, H, dh) fp32, S (B, H, dh, dh) fp32). dh <= 128 and
    1 <= chunk <= 64. Checks nothing that needs the host to wait, so it can be captured in a
    CUDA graph."""
    args = (r, k, v, log_w, u) + (() if s0 is None else (s0,))
    if not all(t.is_cuda and t.device == r.device for t in args):
        raise ValueError("rwkv6: every input must lie on one CUDA device")
    if r.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6: r, k, v must all be bf16 or all fp32, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if any(t.dtype != torch.float32 for t in args[3:]):
        raise TypeError("rwkv6: log_w, u and s0 must be fp32")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, log_w)):
        raise ValueError(f"rwkv6: r, k, v and log_w must share one (B, T, "
                         f"H, dh) shape, got {tuple(r.shape)}")
    b, t, h, dh = r.shape
    if tuple(u.shape) != (h, dh) or (
            s0 is not None and tuple(s0.shape) != (b, h, dh, dh)):
        raise ValueError(f"rwkv6: u must be ({h}, {dh}) and s0 ({b}, {h}, "
                         f"{dh}, {dh})")
    if not all(x.is_contiguous() for x in args):
        raise ValueError("rwkv6: inputs must be contiguous")
    if not (1 <= dh <= MAX_HEAD_DIM and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(f"rwkv6: the kernel takes head dim 1-{MAX_HEAD_DIM}"
                         f" and chunk 1-{MAX_CHUNK}, got head dim {dh} and "
                         f"chunk {chunk}")
    if b * h >= 2 ** 31 or t >= 2 ** 31:
        raise ValueError(f"rwkv6: shape {tuple(r.shape)} out of range")
    o = torch.empty((b, t, h, dh), dtype=torch.float32, device=r.device)
    s = torch.empty((b, h, dh, dh), dtype=torch.float32, device=r.device)
    if b * h == 0:
        return o, s
    if t == 0:
        return o, (s.zero_() if s0 is None else s.copy_(s0))
    lib = build.load(NAME, _bind)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rwkv6_forward(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            o.data_ptr(), s.data_ptr(), b, t, h, dh, min(chunk, t),
            int(r.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"rwkv6 launch failed: "
                           f"{lib.rwkv6_error_string(err).decode()}")
    build.LAUNCHES[NAME] += 1
    return o, s
