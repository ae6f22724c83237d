"""Recurrent blocks: RG-LRU (RecurrentGemma/Griffin) and RWKV6 (Finch)
(``repro.models.recurrent``'s counterpart).

Each has three forms, as in ``repro``:
  * parallel-in-time for prefill: the RG-LRU recurrence through
    ``ops.rglru_scan`` (the Triton kernel on the card; ``repro`` uses an
    associative scan), RWKV6 through ``ops.rwkv6`` (the CUDA kernel on the
    card; ``repro`` uses ``rwkv_chunked``). Both kernels compute the same
    functions as ``repro``'s forms, from a carried state;
  * single-step for decode, O(1) carried state, plain torch as in
    ``repro`` (``rglru_step``, ``rwkv_ref`` at T = 1);
  * a sequential oracle (``rglru_ref``, ``rwkv_ref``) and ``rwkv_chunked``,
    for the tests.

Conventions (``repro``'s):
  RG-LRU:  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
           a_t = exp(-c * softplus(L) * r_t),  c = 8
  RWKV6:   S_t = diag(w_t) S_{t-1} + k_t^T v_t
           o_t = r_t @ (diag(w_t) S_{t-1} + (u * k_t)^T v_t)

Casts are ``repro``'s: projections and the conv in bf16, gates, decays and
states in fp32 from fp32 parameters (``transformer.cast_params`` keeps
those fp32), outputs back to bf16. The projections are torch products, as
they are XLA einsums outside any Pallas kernel in ``repro``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6 import chunk_scan
from repro_torch.models.layers import (
    COMPUTE_DTYPE, PARAM_DTYPE, apply_norm, cast, dense_init, init_norm,
)

RG_C = 8.0
CONV_K = 4


# ===========================================================================
# RG-LRU (Griffin recurrent block)
# ===========================================================================
def init_rglru(gen: torch.Generator, d_model: int,
               width: Optional[int] = None, *, lead: tuple = ()) -> dict:
    w = width or d_model
    dev = gen.device
    # a_param initialized so a^c in (0.9, 0.999) at r=1 (paper's Lambda init)
    lo, hi = 0.9 ** 2, 0.999 ** 2
    u = torch.rand(lead + (w,), generator=gen, device=dev,
                   dtype=PARAM_DTYPE) * (hi - lo) + lo
    a_param = torch.log(torch.exp(-torch.log(u) / (2 * RG_C)) - 1.0)

    def zeros():
        return torch.zeros(lead + (w,), dtype=PARAM_DTYPE, device=dev)

    return {
        "w_x": dense_init(gen, (d_model, w), lead=lead),
        "w_gate": dense_init(gen, (d_model, w), lead=lead),
        "w_out": dense_init(gen, (w, d_model), lead=lead, in_axis_size=w),
        "conv_w": dense_init(gen, (CONV_K, w), lead=lead,
                             in_axis_size=CONV_K),
        "conv_b": zeros(),
        "a_param": a_param,
        "in_gate_w": dense_init(gen, (w,), lead=lead, in_axis_size=1),
        "in_gate_b": zeros(),
        "rec_gate_w": dense_init(gen, (w,), lead=lead, in_axis_size=1),
        "rec_gate_b": zeros(),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Width-CONV_K causal depthwise conv over time.  x: (B, T, W).

    Returns (y, new_state), the state being the trailing CONV_K-1 inputs."""
    if state is None:
        pad = x.new_zeros((x.shape[0], CONV_K - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # (B, T+K-1, W)
    t = x.shape[1]
    y = xp[:, 0:t] * cast(w[0])
    for i in range(1, CONV_K):
        y = y + xp[:, i:i + t] * cast(w[i])
    y = y + cast(b)
    return y, xp[:, -(CONV_K - 1):]


def _rglru_gates(p: dict, x: torch.Tensor):
    """Per-channel decay ``a`` and input ``b`` of the recurrence, fp32."""
    xf = x.float()
    i_gate = torch.sigmoid(xf * p["in_gate_w"] + p["in_gate_b"])
    r_gate = torch.sigmoid(xf * p["rec_gate_w"] + p["rec_gate_b"])
    log_a = -RG_C * F.softplus(p["a_param"]) * r_gate     # <= 0
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably via expm1
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    return a, beta * (i_gate * xf)


def rglru_scan(p: dict, x: torch.Tensor, h0: Optional[torch.Tensor] = None,
               *, force: Optional[str] = None):
    """Parallel-in-time RG-LRU through ``ops.rglru_scan``.  x: (B, T, W).

    Returns (y (B, T, W) bf16, h_last (B, W) fp32). ``repro`` folds ``h0``
    into the first step's input; the kernel starts from it instead."""
    a, b = _rglru_gates(p, x)                             # (B,T,W) fp32
    if h0 is None:
        h0 = a.new_zeros((a.shape[0], a.shape[2]))
    y, h = ops.rglru_scan(a, b, h0.float(), force=force)
    return y.to(COMPUTE_DTYPE), h


def rglru_step(p: dict, x_t: torch.Tensor, h: torch.Tensor):
    """One decode step.  x_t: (B, W); h: (B, W) fp32 state."""
    a, b = _rglru_gates(p, x_t[:, None])
    h_new = a[:, 0] * h + b[:, 0]
    return h_new.to(COMPUTE_DTYPE), h_new


def rglru_ref(p: dict, x: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """Sequential oracle (tests)."""
    h = x.new_zeros((x.shape[0], x.shape[2]), dtype=torch.float32) \
        if h0 is None else h0
    ys = []
    for t in range(x.shape[1]):
        y, h = rglru_step(p, x[:, t], h)
        ys.append(y)
    return torch.stack(ys, dim=1), h


def apply_rglru_block(p: dict, x: torch.Tensor, *,
                      state: Optional[dict] = None, decode: bool = False,
                      force: Optional[str] = None):
    """Full Griffin recurrent block: x -> (in-proj, conv, RG-LRU) * gate.

    x: (B, T, D) (T = 1 for decode).  state: {"h": (B, W), "conv":
    (B, K-1, W)}.  Returns (out (B, T, D), new_state)."""
    gate = F.gelu(torch.einsum("btd,dw->btw", x, cast(p["w_gate"])),
                  approximate="tanh")                 # jax.nn.gelu's default
    xin = torch.einsum("btd,dw->btw", x, cast(p["w_x"]))
    conv_state = state["conv"] if state is not None else None
    xc, conv_state = _causal_conv(xin, p["conv_w"], p["conv_b"], conv_state)
    if decode:
        y, h = rglru_step(p, xc[:, 0], state["h"])
        y = y[:, None]
    else:
        h0 = state["h"] if state is not None else None
        y, h = rglru_scan(p, xc, h0, force=force)
    out = torch.einsum("btw,wd->btd", y * gate, cast(p["w_out"]))
    return out, {"h": h, "conv": conv_state}


def rglru_init_state(batch: int, width: int, *, lead: tuple = (),
                     device=None) -> dict:
    return {"h": torch.zeros(lead + (batch, width), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, CONV_K - 1, width),
                                dtype=COMPUTE_DTYPE, device=device)}


# ===========================================================================
# RWKV6 time-mix + channel-mix
# ===========================================================================
def init_rwkv(gen: torch.Generator, d_model: int, n_heads: int,
              head_dim: int, d_ff: int, *, lead: tuple = ()) -> dict:
    dev = gen.device
    lora = 64
    hk = (n_heads, head_dim)

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=PARAM_DTYPE, device=dev)

    def normal(shape, std):
        return torch.randn(lead + shape, generator=gen, device=dev,
                           dtype=PARAM_DTYPE) * std

    tm = {
        "w_r": dense_init(gen, (d_model,) + hk, lead=lead),
        "w_k": dense_init(gen, (d_model,) + hk, lead=lead),
        "w_v": dense_init(gen, (d_model,) + hk, lead=lead),
        "w_g": dense_init(gen, (d_model,) + hk, lead=lead),
        "w_o": dense_init(gen, hk + (d_model,), lead=lead,
                          in_axis_size=n_heads * head_dim),
        # base decay: w = exp(-exp(.)) in (0, 1)
        "decay_w": full(hk, -1.0),
        "decay_lora_a": dense_init(gen, (d_model, lora), lead=lead),
        "decay_lora_b": normal((lora,) + hk, 0.01),
        "bonus_u": normal(hk, 0.1),
        "mix_r": full((d_model,), 0.5),
        "mix_k": full((d_model,), 0.5),
        "mix_v": full((d_model,), 0.5),
        "mix_g": full((d_model,), 0.5),
        "mix_w": full((d_model,), 0.5),
        "ln_x": init_norm("layernorm", n_heads * head_dim, lead=lead,
                          device=dev),
    }
    cm = {
        "w_in": dense_init(gen, (d_model, d_ff), lead=lead),
        "w_out": dense_init(gen, (d_ff, d_model), lead=lead,
                            in_axis_size=d_ff),
        "w_r": dense_init(gen, (d_model, d_model), lead=lead),
        "mix_c": full((d_model,), 0.5),
        "mix_rc": full((d_model,), 0.5),
    }
    return {"rwkv": tm, "cmix": cm}


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """x: (B, T, D) -> the previous token's value (B, T, D), plus the new
    carry (B, 1, D)."""
    prev = x.new_zeros(x[:, :1].shape) if prev is None else prev.to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1), x[:, -1:]


def _mix(x, shifted, m):
    m = cast(m)
    return x * m + shifted * (1.0 - m)


def _rwkv_rkvwg(p: dict, x: torch.Tensor, shifted: torch.Tensor):
    xr, xk, xv, xg, xw = (_mix(x, shifted, p[f"mix_{n}"])
                          for n in ("r", "k", "v", "g", "w"))
    r = torch.einsum("btd,dhk->bthk", xr, cast(p["w_r"]))
    k = torch.einsum("btd,dhk->bthk", xk, cast(p["w_k"]))
    v = torch.einsum("btd,dhk->bthk", xv, cast(p["w_v"]))
    g = torch.einsum("btd,dhk->bthk", xg, cast(p["w_g"]))
    # data-dependent decay, fp32 for stability
    dd = torch.einsum("btd,dl->btl", xw.float(), p["decay_lora_a"])
    dd = torch.einsum("btl,lhk->bthk", torch.tanh(dd), p["decay_lora_b"])
    log_w = -torch.exp(torch.clamp(p["decay_w"] + dd, -8.0, 4.0))   # < 0
    return r, k, v, g, log_w


def rwkv_ref(r, k, v, log_w, u, s0=None):
    """Sequential oracle, and the decode step at T = 1.  r/k/v/log_w:
    (B, T, H, K); u: (H, K).  Returns (o (B, T, H, K) fp32, S (B, H, K, K)
    fp32)."""
    b, t, h, dk = r.shape
    rf, kf, vf = (a.float() for a in (r, k, v))
    w = torch.exp(log_w.float())
    uf = u.float()
    s = torch.zeros((b, h, dk, dk), dtype=torch.float32, device=r.device) \
        if s0 is None else s0.float()
    outs = []
    for i in range(t):
        rt, kt, vt = rf[:, i], kf[:, i], vf[:, i]           # (B, H, K)
        s_dec = w[:, i, ..., None] * s
        o = torch.einsum("bhk,bhkj->bhj", rt, s_dec)
        o = o + (rt * uf * kt).sum(-1, keepdim=True) * vt
        s = s_dec + kt[..., :, None] * vt[..., None, :]
        outs.append(o)
    if not outs:
        return rf.new_zeros((b, 0, h, dk)), s
    return torch.stack(outs, dim=1), s


def rwkv_chunked(r, k, v, log_w, u, s0=None, chunk: int = 32):
    """``repro``'s chunked parallel form: the chunk is halved until it
    divides T (so a prime T runs chunks of 1), then the pairwise chunk
    step of ``kernels.rwkv6.chunk_scan``; exact to fp32 tolerance."""
    t = r.shape[1]
    c = max(1, min(chunk, t))
    while t % c:
        c //= 2
    return chunk_scan(r, k, v, log_w, u, s0, chunk=c)


def apply_rwkv_timemix(p: dict, x: torch.Tensor, *,
                       state: Optional[dict] = None, decode: bool = False,
                       chunk: int = 32, force: Optional[str] = None):
    """x: (B, T, D).  state: {"shift": (B, 1, D), "s": (B, H, K, K)}.
    Prefill runs ``ops.rwkv6`` from the carried state (zeros when None),
    decode ``rwkv_ref``."""
    b, t, _ = x.shape
    prev = state["shift"] if state is not None else None
    shifted, new_shift = _token_shift(x, prev)
    r, k, v, g, log_w = _rwkv_rkvwg(p, x, shifted)
    u = p["bonus_u"].float()
    s0 = state["s"] if state is not None else None
    if decode:
        o, s = rwkv_ref(r, k, v, log_w, u, s0)
    else:
        o, s = ops.rwkv6(r, k, v, log_w, u, s0, chunk=chunk, force=force)
    h, dk = o.shape[2], o.shape[3]
    o = apply_norm(p["ln_x"], o.reshape(b, t, h * dk).to(COMPUTE_DTYPE),
                   "layernorm").reshape(b, t, h, dk)
    o = o * F.silu(g)
    out = torch.einsum("bthk,hkd->btd", o, cast(p["w_o"]))
    return out, {"shift": new_shift, "s": s}


def apply_rwkv_channelmix(p: dict, x: torch.Tensor,
                          state: Optional[torch.Tensor] = None):
    """RWKV channel-mix (squared-ReLU FFN with a receptance gate).
    state: (B, 1, D), the carried previous token."""
    shifted, new_shift = _token_shift(x, state)
    xk = _mix(x, shifted, p["mix_c"])
    xr = _mix(x, shifted, p["mix_rc"])
    hidden = torch.einsum("btd,df->btf", xk, cast(p["w_in"]))
    hidden = torch.square(torch.relu(hidden))
    out = torch.einsum("btf,fd->btd", hidden, cast(p["w_out"]))
    recept = torch.sigmoid(torch.einsum("btd,de->bte", xr, cast(p["w_r"])))
    return out * recept, new_shift


def rwkv_init_state(batch: int, d_model: int, n_heads: int, head_dim: int,
                    *, lead: tuple = (), device=None) -> dict:
    def zeros(shape, dtype):
        return torch.zeros(lead + shape, dtype=dtype, device=device)
    return {"shift": zeros((batch, 1, d_model), COMPUTE_DTYPE),
            "s": zeros((batch, n_heads, head_dim, head_dim), torch.float32),
            "cmix_shift": zeros((batch, 1, d_model), COMPUTE_DTYPE)}
