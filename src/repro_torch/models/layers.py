"""Basic building blocks: norms, rotary embeddings, the dense MLP, and the
token embedding and unembedding (``repro.models.layers``'s counterpart).

Plain functions over a dict of tensors. Params are fp32 and cast to bf16 at
use; norms and rope compute in fp32 and return the input's dtype, as in
``repro``. Initialisers draw from an explicit ``torch.Generator`` and take a
``lead`` shape, so that the layers of a stack are drawn as one tensor with a
leading unit axis.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape: tuple, *, lead: tuple = (),
               in_axis_size: Optional[int] = None) -> torch.Tensor:
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    return torch.randn(lead + tuple(shape), generator=gen,
                       device=gen.device, dtype=PARAM_DTYPE) * std


def embed_init(gen: torch.Generator, shape: tuple) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=PARAM_DTYPE) * 0.02


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def init_norm(kind: str, d: int, *, lead: tuple = (),
              device=None) -> dict:
    p = {"scale": torch.ones(lead + (d,), dtype=PARAM_DTYPE, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(lead + (d,), dtype=PARAM_DTYPE,
                                device=device)
    return p


def apply_norm(p: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"]
    elif kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        raise ValueError(kind)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); positions: (..., S) integer."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)   # (dh/2,)
    ang = positions[..., None].float() * freqs                 # (..., S, dh/2)
    sin = torch.sin(ang)[..., None, :]                         # over heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple) -> torch.Tensor:
    """Qwen2-VL's multimodal rope. x: (..., S, H, dh); positions3: (..., S,
    3) integer, the (t, h, w) position of each token. The dh/2 frequency
    bands are split over (t, h, w) by ``sections``, and each band turns by
    its axis's position; with equal axes this is :func:`apply_rope`, bit
    for bit. Each axis's position is repeated over its bands by slicing,
    not by an index tensor, so that nothing is copied from the host inside
    a CUDA graph capture."""
    half = x.shape[-1] // 2
    if len(sections) != 3 or sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not split {half}")
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)   # (half,)
    p = positions3.float()
    pos = torch.cat([p[..., i:i + 1].expand(*p.shape[:-1], n)
                     for i, n in enumerate(sections)], dim=-1)  # (..., S, half)
    ang = pos * freqs
    sin = torch.sin(ang)[..., None, :]                        # over heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense MLP (SwiGLU or plain GeLU)
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, gated: bool, *,
             lead: tuple = ()) -> dict:
    p = {"w_up": dense_init(gen, (d_model, d_ff), lead=lead),
         "w_down": dense_init(gen, (d_ff, d_model), lead=lead)}
    if gated:
        p["w_gate"] = dense_init(gen, (d_model, d_ff), lead=lead)
    return p


def apply_mlp(p: dict, x: torch.Tensor, gated: bool, *,
              force: Optional[str] = None) -> torch.Tensor:
    """Every projection goes through ``ops.matmul`` with the token axes
    flattened to M (``repro``'s ``_apply_mlp_kernels``); bias, SiLU and the
    gate stay torch ops."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    up = ops.matmul(x2, cast(p["w_up"]), force=force)
    if "b_up" in p:
        up = up + cast(p["b_up"])
    if gated:
        g = ops.matmul(x2, cast(p["w_gate"]), force=force)
        h = F.silu(g) * up
    else:
        h = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    out = ops.matmul(h.to(x.dtype), cast(p["w_down"]), force=force)
    if "b_down" in p:
        out = out + cast(p["b_down"])
    return out.reshape(*lead, out.shape[-1])


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------
def init_embeddings(gen: torch.Generator, vocab: int, d_model: int,
                    tie: bool) -> dict:
    p = {"tok_emb": embed_init(gen, (vocab, d_model))}
    if not tie:
        p["out_emb"] = dense_init(gen, (d_model, vocab))
    return p


def embed_tokens(p: dict, tokens: torch.Tensor, d_model: int) -> torch.Tensor:
    x = cast(p["tok_emb"])[tokens]
    return x * torch.tensor(math.sqrt(d_model), dtype=COMPUTE_DTYPE)


def unembed(p: dict, x: torch.Tensor, tie: bool,
            softcap: float = 0.0) -> torch.Tensor:
    if tie:
        logits = x @ cast(p["tok_emb"]).T
    else:
        logits = x @ cast(p["out_emb"])
    if softcap > 0.0:
        logits = (torch.tanh(logits.float() / softcap) * softcap
                  ).to(logits.dtype)
    return logits
