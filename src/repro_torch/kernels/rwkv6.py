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
(``src/repro/kernels/rwkv6.py``, body ``_rwkv_kernel``): a CTA per
(b, h, block of ``VALUE_BLOCK`` value columns) keeps its columns of S in
shared memory and walks chunks of ``chunk`` steps in order, the next chunk's
rows streaming into shared memory meanwhile, a ragged last chunk
zero-padded. Within a chunk, 16-row sub-chunks factor each off-diagonal
block's decays through the row before the block (every exponent <= 0), so
the scores, ``A v``, the state term and the state update are matrix
products, run on the tensor cores in TF32 split into high and low parts
(fp32 accuracy); only the 16 x 16 diagonal blocks stay pairwise. It never
uses the TPU kernel's factor ``exp(-le)``, which overflows fp32 for log
decays <= -3 while the model reaches -e^4. It adds ``s0`` and the final
state, which the TPU kernel lacks.

``rwkv6_ref`` is the plain version: the same pairwise chunk step in torch
(:func:`chunk_scan`), the sequence zero-padded to whole chunks (a padded
step has ``log_w`` 0 and ``k`` = ``v`` = 0, so it leaves S as it is).

Both accumulate in fp32, as ``repro`` does; they sum in other orders, so
they agree to fp32 rounding, not bit for bit.

The backward (:func:`rwkv6_bwd`, ``csrc/rwkv6_bwd.cu``) has no Pallas
counterpart: ``repro`` trains through plain JAX. It takes the inputs, the
output's gradient ``do`` and the final state's ``ds`` (or None) and returns
the gradients of r, k, v (in their dtype), of log_w, u and s0 (fp32). Its
plain version, :func:`rwkv6_bwd_ref`, walks the recurrence backward with
the explicit formulas, from G = dS_final::

    dr_t  = do_t (w_t * S_{t-1} + (u * k_t)^T v_t)^T
    dk_t  = r_t * u (do_t . v_t) + G v_t
    dv_t  = (r_t . (u * k_t)) do_t + G^T k_t
    du   += r_t * k_t (do_t . v_t)
    dlw_t = w_t * rowsum((r_t^T do_t + G) * S_{t-1})
    G     = diag(w_t) (G + r_t^T do_t);   ds0 = G at the end

The kernel computes the same values another way (see its source): T cut
into chunks of ``bwd_form(dh)["chunk"]`` rows (32; 16 at head dims whose
chunk of 32 does not fit in shared memory). Launch 1 walks the chunks per
(b, h): forward for the state before each chunk, backward for the
outputs' part of the state's cotangent at each chunk's end (and ds0);
launch 2 takes a CTA per (b, h, chunk), all independent, and computes the
chunk's gradients from those two states with its products on the tensor
cores (TF32 ``mma.sync`` split into high and low parts: fp32 accuracy) and
dlog_w as a prefix and a suffix sum within the chunk. No state is recovered
by dividing by w_t, which underflows, and every exponent is <= 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

__all__ = ["chunk_scan", "rwkv6_ref", "rwkv6", "form", "rwkv6_bwd_ref",
           "rwkv6_bwd"]

NAME = "rwkv6"
NAME_BWD = "rwkv6_bwd"
CHUNK = 32        # rwkv6_pallas's and rwkv_chunked's default
MAX_HEAD_DIM = 128   # csrc/rwkv6.cu checks all three
MAX_CHUNK = 64
VALUE_BLOCK = 64     # value columns a CTA owns where they fit (else half)


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
        # difference is masked before the exp, so no entry overflows and
        # the backward multiplies no masked inf by 0 (a NaN gradient)
        diff = le[:, :, None] - le[:, None, :]              # (B,C,C,H,K)
        zero = torch.zeros((), device=r.device)
        a = torch.where(tri, torch.exp(torch.where(tri, diff, zero)), zero)
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


def rwkv6_bwd_ref(r, k, v, log_w, u, s0, do, ds=None):
    """Plain backward: the explicit formulas of the module docstring in
    fp32, a reverse walk over the states S_{t-1} of a sequential forward
    (every exponent <= 0, so finite at any decay) -> (dr, dk, dv in their
    inputs' dtypes; dlog_w (B, T, H, dh), du (H, dh), ds0 (B, H, dh, dh)
    fp32). ``s0`` and ``ds`` may be None (zeros)."""
    b, t, h, dk = r.shape
    rf, kf, vf, dof = (a.float() for a in (r, k, v, do))
    w = torch.exp(log_w.float())
    uf = u.float()
    zeros = torch.zeros((b, h, dk, dk), device=r.device)
    s = zeros if s0 is None else s0.float()
    prev = []                                   # S_{t-1}, t = 0 .. T-1
    for i in range(t):
        prev.append(s)
        s = w[:, i, ..., None] * s \
            + kf[:, i, ..., :, None] * vf[:, i, ..., None, :]
    g = zeros if ds is None else ds.float()
    dr, dkk, dv, dlw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros((h, dk), device=r.device)
    for i in reversed(range(t)):
        rt, kt, vt, dot, wt = rf[:, i], kf[:, i], vf[:, i], dof[:, i], w[:, i]
        c = (dot * vt).sum(-1, keepdim=True)                   # (B, H, 1)
        dr[:, i] = wt * torch.einsum("bhde,bhe->bhd", prev[i], dot) \
            + uf * kt * c
        du = du + (rt * kt * c).sum(0)
        dkk[:, i] = rt * uf * c + torch.einsum("bhde,bhe->bhd", g, vt)
        dv[:, i] = (rt * uf * kt).sum(-1, keepdim=True) * dot \
            + torch.einsum("bhde,bhd->bhe", g, kt)
        rdo = rt[..., :, None] * dot[..., None, :]
        dlw[:, i] = wt * ((rdo + g) * prev[i]).sum(-1)
        g = wt[..., None] * (g + rdo)
    return dr.to(r.dtype), dkk.to(k.dtype), dv.to(v.dtype), dlw, du, g


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_forward.argtypes = [vp] * 8 + [ci] * 6 + [vp]
    lib.rwkv6_forward.restype = ci
    lib.rwkv6_error_string.argtypes = [ci]
    lib.rwkv6_error_string.restype = ctypes.c_char_p
    lib.rwkv6_form.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
    lib.rwkv6_form.restype = ci
    for fn in (lib.rwkv6_max_head_dim, lib.rwkv6_max_chunk,
               lib.rwkv6_value_block):
        fn.argtypes = []
        fn.restype = ci
    if (lib.rwkv6_max_head_dim(), lib.rwkv6_max_chunk(),
            lib.rwkv6_value_block()) != (MAX_HEAD_DIM, MAX_CHUNK,
                                         VALUE_BLOCK):
        raise RuntimeError("rwkv6.cu limits differ from MAX_HEAD_DIM / "
                           "MAX_CHUNK / VALUE_BLOCK")


def form(dh: int, chunk: int = CHUNK, dtype=torch.bfloat16) -> dict:
    """The kernel's form at head dim ``dh`` and ``chunk`` for r, k, v of
    ``dtype`` on the current CUDA device: threads a CTA, registers a
    thread, dynamic shared memory bytes, CTAs an SM holds, chunk buffers
    in the load ring, value columns a CTA (a launch takes B * H *
    ceil(dh / value_block) CTAs), bytes spilled a thread, and buffers of S
    (2: double-buffered; 1: updated in place)."""
    lib = build.load(NAME, _bind)
    out = (ctypes.c_int * 8)()
    err = lib.rwkv6_form(dh, chunk, int(dtype == torch.bfloat16), out)
    if err:
        msg = lib.rwkv6_error_string(err).decode()
        raise RuntimeError(f"rwkv6_form({dh}, {chunk}) failed: {msg}")
    return dict(zip(("threads", "registers", "smem_bytes", "ctas_per_sm",
                     "stages", "value_block", "spill_bytes", "s_buffers"),
                    out))


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          log_w: torch.Tensor, u: torch.Tensor,
          s0: Optional[torch.Tensor] = None, *, chunk: int = CHUNK):
    """Launch the kernel on the current stream: r, k, v (B, T, H, dh), all
    bf16 or all fp32; log_w (B, T, H, dh) fp32; u (H, dh) fp32; s0
    (B, H, dh, dh) fp32 or None; contiguous, on one CUDA device ->
    (o (B, T, H, dh) fp32, S (B, H, dh, dh) fp32). dh <= 128 and
    1 <= chunk <= 64. Checks nothing that needs the host to wait, so it
    can be captured in a CUDA graph."""
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
    if b * h * -(-dh // (VALUE_BLOCK // 2)) >= 2 ** 31 or t >= 2 ** 31:
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


def _bind_bwd(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_backward.argtypes = [vp] * 17 + [ci] * 5 + [vp]
    lib.rwkv6_backward.restype = ci
    lib.rwkv6_bwd_error_string.argtypes = [ci]
    lib.rwkv6_bwd_error_string.restype = ctypes.c_char_p
    lib.rwkv6_bwd_form.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
    lib.rwkv6_bwd_form.restype = ci
    lib.rwkv6_bwd_chunk_rows.argtypes = [ci]
    lib.rwkv6_bwd_chunk_rows.restype = ci
    lib.rwkv6_bwd_max_head_dim.argtypes = []
    lib.rwkv6_bwd_max_head_dim.restype = ci
    if lib.rwkv6_bwd_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("rwkv6_bwd.cu's head dim limit differs from "
                           "MAX_HEAD_DIM")


def bwd_form(dh: int, dtype=torch.bfloat16, state_grad: bool = False) -> dict:
    """The backward's form at head dim ``dh`` for r, k, v of ``dtype``,
    with or without a final state's gradient, on the current CUDA device:
    rows a ``chunk``; launch 2's (a CTA per (b, h, chunk)) threads a CTA,
    registers a thread, dynamic shared memory bytes, CTAs an SM holds and
    bytes spilled a thread; the same of launch 1 (a CTA per (pass, b, h,
    block of ``value_block`` value columns)) under ``scan_*``."""
    lib = build.load(NAME_BWD, _bind_bwd)
    out = (ctypes.c_int * 12)()
    err = lib.rwkv6_bwd_form(dh, int(dtype == torch.bfloat16),
                             int(state_grad), out)
    if err:
        msg = lib.rwkv6_bwd_error_string(err).decode()
        raise RuntimeError(f"rwkv6_bwd_form({dh}) failed: {msg}")
    keys = ("threads", "registers", "smem_bytes", "ctas_per_sm",
            "spill_bytes")
    return {**dict(zip(keys, out[:5])),
            **{f"scan_{k_}": x for k_, x in zip(keys, out[5:10])},
            "chunk": out[10], "value_block": out[11]}


def rwkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_w: torch.Tensor, u: torch.Tensor,
              s0: Optional[torch.Tensor], do: torch.Tensor,
              ds: Optional[torch.Tensor] = None):
    """Launch the backward kernel on the current stream: the forward's
    inputs as :func:`rwkv6` takes them, ``do`` (B, T, H, dh) fp32 and
    ``ds`` (B, H, dh, dh) fp32 or None, contiguous, on one CUDA device ->
    (dr, dk, dv in r's dtype; dlog_w (B, T, H, dh), du (H, dh), ds0 (B, H,
    dh, dh) fp32). Two kernel launches (the chunk-start states and
    chunk-end cotangents, then a CTA per chunk), counted as one call under
    ``NAME_BWD``; du is summed over the batch and the chunks from the
    kernel's per-chunk sums in a fixed order, so two calls are
    bit-equal."""
    args = (r, k, v, log_w, u, do) + tuple(
        x for x in (s0, ds) if x is not None)
    if not all(x.is_cuda and x.device == r.device for x in args):
        raise ValueError("rwkv6_bwd: every input must lie on one CUDA "
                         "device")
    if r.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_bwd: r, k, v must all be bf16 or all fp32, "
                        f"got {r.dtype}, {k.dtype}, {v.dtype}")
    if any(x.dtype != torch.float32 for x in args[3:]):
        raise TypeError("rwkv6_bwd: log_w, u, do, s0 and ds must be fp32")
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, log_w, do)):
        raise ValueError(f"rwkv6_bwd: r, k, v, log_w and do must share one "
                         f"(B, T, H, dh) shape, got {tuple(r.shape)}")
    b, t, h, dh = r.shape
    if tuple(u.shape) != (h, dh) or any(
            x is not None and tuple(x.shape) != (b, h, dh, dh)
            for x in (s0, ds)):
        raise ValueError(f"rwkv6_bwd: u must be ({h}, {dh}), s0 and ds "
                         f"({b}, {h}, {dh}, {dh})")
    if not all(x.is_contiguous() for x in args):
        raise ValueError("rwkv6_bwd: inputs must be contiguous")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"rwkv6_bwd: the kernel takes head dim "
                         f"1-{MAX_HEAD_DIM}, got {dh}")
    if b * h >= 2 ** 31 or t >= 2 ** 31:
        raise ValueError(f"rwkv6_bwd: shape {tuple(r.shape)} out of range")
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv = (torch.empty_like(x) for x in (r, k, v))
    dlw = torch.empty((b, t, h, dh), **f32)
    ds0 = torch.empty((b, h, dh, dh), **f32)
    if b * h == 0:
        return dr, dk, dv, dlw, torch.zeros((h, dh), **f32), ds0
    if t == 0:
        return (dr, dk, dv, dlw, torch.zeros((h, dh), **f32),
                ds0.zero_() if ds is None else ds0.copy_(ds))
    lib = build.load(NAME_BWD, _bind_bwd)
    n = -(-t // lib.rwkv6_bwd_chunk_rows(dh))
    # scratch: the states before chunks 1.., G^o at the ends of chunks
    # ..n-2, the later chunks' log decay (where ds is given), and each
    # chunk's rows of du, summed here in a fixed order
    states, gends = (torch.empty((b, h, n - 1, dh, dh), **f32)
                     for _ in range(2))
    lrest = torch.empty((b, h, n, dh), **f32) if ds is not None else None
    du_part = torch.empty((b, n, h, dh), **f32)

    def ptr(x):
        return None if x is None else x.data_ptr()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rwkv6_backward(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
            u.data_ptr(), ptr(s0), do.data_ptr(), ptr(ds), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dlw.data_ptr(), du_part.data_ptr(),
            ds0.data_ptr(), states.data_ptr(), gends.data_ptr(), ptr(lrest),
            b, t, h, dh, int(r.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"rwkv6_bwd launch failed: "
                           f"{lib.rwkv6_bwd_error_string(err).decode()}")
    build.LAUNCHES[NAME_BWD] += 1
    du = du_part.view(b * n, h * dh).sum(0).view(h, dh)
    return dr, dk, dv, dlw, du, ds0
