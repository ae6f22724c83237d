"""Attention: GQA projections, causal and unmasked (encoder and
cross-attention) prefill through the flash-attention kernel, sliding-window
(local) prefill, single-token decode and chunked-prefill attention against
a cache (``repro.models.attention``'s counterpart).

Layouts are ``repro``'s: ``wq`` (d, H, dh), ``wk``/``wv`` (d, KV, dh),
``wo`` (H, dh, d); activations (B, S, H, dh). The projections, local
prefill, decode and chunk attention are torch products, as they are XLA
einsums outside any Pallas kernel in ``repro``.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import COMPUTE_DTYPE, PARAM_DTYPE, cast, \
    dense_init

NEG_INF = -1e30


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, *, bias: bool = False,
                   lead: tuple = ()) -> dict:
    p = {
        "wq": dense_init(gen, (d_model, n_heads, head_dim), lead=lead),
        "wk": dense_init(gen, (d_model, n_kv, head_dim), lead=lead),
        "wv": dense_init(gen, (d_model, n_kv, head_dim), lead=lead),
        "wo": dense_init(gen, (n_heads, head_dim, d_model), lead=lead,
                         in_axis_size=n_heads * head_dim),
    }
    if bias:
        for name, heads in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros(lead + (heads, head_dim),
                                  dtype=PARAM_DTYPE, device=gen.device)
    return p


def qkv_proj(p: dict, x: torch.Tensor):
    q = torch.einsum("...d,dhk->...hk", x, cast(p["wq"]))
    k = torch.einsum("...d,dhk->...hk", x, cast(p["wk"]))
    v = torch.einsum("...d,dhk->...hk", x, cast(p["wv"]))
    if "bq" in p:
        q = q + cast(p["bq"])
        k = k + cast(p["bk"])
        v = v + cast(p["bv"])
    return q, k, v


def kv_proj(p: dict, x: torch.Tensor):
    """K and V of ``x`` alone: cross-attention's keys and values from the
    encoder output."""
    k = torch.einsum("...d,dhk->...hk", x, cast(p["wk"]))
    v = torch.einsum("...d,dhk->...hk", x, cast(p["wv"]))
    if "bk" in p:
        k = k + cast(p["bk"])
        v = v + cast(p["bv"])
    return k, v


def out_proj(p: dict, o: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...hk,hkd->...d", o, cast(p["wo"]))


def prefill_attention(q, k, v, *, mask_kind: str = "causal", window: int = 0,
                      force: Optional[str] = None) -> torch.Tensor:
    """Full-sequence attention through ``ops.flash_attention``: the kernel
    on a CUDA tensor, its plain version on the CPU."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    return ops.flash_attention(q, k, v, mask_kind=mask_kind, window=window,
                               force=force)


def local_attention_prefill(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, window: int,
                            q_chunk: int = 1024) -> torch.Tensor:
    """Sliding-window causal attention: query i sees keys j with
    i - window < j <= i. Each chunk of ``q_chunk`` queries touches only
    the keys its window reaches, so the work is O(S * window), not
    O(S^2). Scores are fp32 from bf16 inputs and P is rounded to bf16
    before P @ V, as in ``repro``. q: (B, S, H, dh); k, v: (B, S, KV,
    dh)."""
    b, sq, h, dh = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(dh)
    outs = []
    for q0 in range(0, sq, q_chunk):
        qc = min(q_chunk, sq - q0)
        k0 = max(0, q0 - window + 1)
        k1 = min(skv, q0 + qc)
        qblk = q[:, q0:q0 + qc].reshape(b, qc, kv, g, dh)
        s = torch.einsum("bqkgd,bckd->bkgqc",
                         qblk.to(COMPUTE_DTYPE).float(),
                         k[:, k0:k1].to(COMPUTE_DTYPE).float()) * scale
        qpos = q0 + torch.arange(qc, device=q.device)[:, None]
        kpos = k0 + torch.arange(k1 - k0, device=q.device)[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - window)
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqc,bckd->bqkgd", p.to(COMPUTE_DTYPE).float(),
                         v[:, k0:k1].to(COMPUTE_DTYPE).float())
        outs.append(o.reshape(b, qc, h, dh).to(COMPUTE_DTYPE))
    return torch.cat(outs, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """Single-token attention. q: (B, H, dh); caches (B, S, KV, dh).

    ``cache_len`` is the valid cache length: an int (lockstep decode) or a
    (B,) tensor (ragged decode, each row at its own position). Scores are
    fp32 from bf16 inputs and P is rounded to bf16 before P @ V, as in
    ``repro``."""
    b, h, dh = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(dh)
    qf = q.reshape(b, kv, g, dh).to(COMPUTE_DTYPE).float()
    s = torch.einsum("bkgd,bskd->bkgs", qf,
                     k_cache.to(COMPUTE_DTYPE).float()) * scale
    pos = torch.arange(k_cache.shape[1], device=q.device)
    if torch.is_tensor(cache_len) and cache_len.dim() == 1:
        cache_len = cache_len[:, None, None, None]      # per-row lengths
    s = torch.where(pos < cache_len, s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(COMPUTE_DTYPE).float(),
                     v_cache.to(COMPUTE_DTYPE).float())
    return o.reshape(b, h, dh).to(COMPUTE_DTYPE)


def chunk_prefill_attention(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor,
                            offset: Union[int, torch.Tensor]) -> torch.Tensor:
    """Chunked-prefill attention: a (B, C, H, dh) query chunk whose rows sit
    at positions ``offset .. offset + C`` attends causally over a cache
    (B, S, KV, dh) that already holds every earlier chunk's K/V and this
    chunk's own rows. Row ``i`` sees keys ``0 .. offset + i``, the key set a
    whole-prompt causal prefill gives it; rows past a bucketed final chunk's
    real length compute values that the caller never commits.

    ``offset`` is an int or a 0-d long tensor; nothing here reads it on the
    host, so a CUDA graph captured at one offset replays at any other.
    Scores are fp32 from bf16 inputs and P is rounded to bf16 before P @ V,
    as in ``repro``."""
    b, c, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(dh)
    qf = q.reshape(b, c, kv, g, dh).to(COMPUTE_DTYPE).float()
    sc = torch.einsum("bqkgd,bskd->bkgqs", qf,
                      k_cache.to(COMPUTE_DTYPE).float()) * scale
    qpos = offset + torch.arange(c, device=q.device)
    kpos = torch.arange(s, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]                  # (C, S)
    sc = torch.where(mask, sc, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(COMPUTE_DTYPE).float(),
                     v_cache.to(COMPUTE_DTYPE).float())
    return o.reshape(b, c, h, dh).to(COMPUTE_DTYPE)
