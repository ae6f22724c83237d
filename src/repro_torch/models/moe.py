"""Mixture-of-Experts: top-k routing, the dense and capacity strategies
(``repro.models.moe``'s counterpart).

Routing, as in ``repro``: a softmax router in fp32, top-k, the gates
renormalized over the selected experts, and the Switch load-balance and
router z-loss aux terms.

* ``dense``: every expert computes every token; the combine takes the
  top-k gates in fp32. This is what ``repro``'s engine serves (no mesh, so
  ``auto`` means dense).
* ``capacity``: a sort-based dispatch of each (token, slot) to its
  expert's capacity buffer, tokens beyond capacity dropped, the gated
  outputs summed back over k in bf16.

Both run their three expert products (gate, up, down) through
``ops.moe_gmm``, the grouped-matmul kernel on a CUDA tensor, where
``repro`` computes the same products as einsums. The dense strategy hands
the kernel one (T, D) activation broadcast to every expert, with no copy.
The shared expert is plain ``torch.matmul``, as ``repro`` computes it
outside any kernel. Expert parallelism (``repro``'s ``shard_map`` branch)
waits for the port of ``parallel/``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import COMPUTE_DTYPE, cast, dense_init


def init_moe(gen: torch.Generator, d_model: int, n_experts: int,
             moe_d_ff: int, shared: bool, d_ff_shared: int, *,
             lead: tuple = ()) -> dict:
    p = {
        "router": dense_init(gen, (d_model, n_experts), lead=lead),
        "experts": {
            "w_gate": dense_init(gen, (n_experts, d_model, moe_d_ff),
                                 lead=lead, in_axis_size=d_model),
            "w_up": dense_init(gen, (n_experts, d_model, moe_d_ff),
                               lead=lead, in_axis_size=d_model),
            "w_down": dense_init(gen, (n_experts, moe_d_ff, d_model),
                                 lead=lead, in_axis_size=moe_d_ff),
        },
    }
    if shared:
        p["shared"] = {
            "w_gate": dense_init(gen, (d_model, d_ff_shared), lead=lead),
            "w_up": dense_init(gen, (d_model, d_ff_shared), lead=lead),
            "w_down": dense_init(gen, (d_ff_shared, d_model), lead=lead),
        }
    return p


def route(p: dict, x: torch.Tensor, k: int):
    """Router: (gates (..., k) fp32, ids (..., k) int64, aux dict)."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k puts the lower index first among equal values;
    # torch.topk promises no order there, a stable descending sort does
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[..., :k], ids[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    e = logits.shape[-1]
    # Switch load-balance loss: E * sum_e f_e * p_e
    me = probs.reshape(-1, e).mean(0)
    flat = ids.reshape(-1, k)
    assign = torch.zeros(flat.shape[0], e, device=x.device).scatter_add_(
        1, flat, torch.ones(flat.shape, device=x.device))
    ce = assign.mean(0) / k
    lb_loss = e * (me * ce).sum()
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    return gates, ids, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss}


def _expert_ffn(w: dict, h_in: torch.Tensor,
                force: Optional[str]) -> torch.Tensor:
    """h_in (E, C, D), per-expert bf16 weights -> (E, C, D)."""
    g = ops.moe_gmm(h_in, w["w_gate"], force=force)
    u = ops.moe_gmm(h_in, w["w_up"], force=force)
    return ops.moe_gmm(F.silu(g) * u, w["w_down"], force=force)


def _shared_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ cast(p["w_gate"])
    u = x @ cast(p["w_up"])
    return (F.silu(g) * u) @ cast(p["w_down"])


def _experts(p: dict) -> dict:
    return {n: cast(t) for n, t in p["experts"].items()}


# ---------------------------------------------------------------------------
# dense strategy (what repro serves)
# ---------------------------------------------------------------------------
def apply_moe_dense(p: dict, x: torch.Tensor, k: int, *,
                    force: Optional[str] = None):
    gates, ids, aux = route(p, x, k)
    e = p["router"].shape[-1]
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    y_all = _expert_ffn(_experts(p), x2.expand(e, *x2.shape), force)
    combine = torch.zeros(gates.shape[:-1] + (e,), device=x.device) \
        .scatter_(-1, ids, gates).reshape(-1, e)       # (T, E) fp32
    y = torch.einsum("etd,te->td", y_all.float(), combine)
    y = y.to(x.dtype).reshape(x.shape)
    if "shared" in p:
        y = y + _shared_ffn(p["shared"], x)
    return y, aux


# ---------------------------------------------------------------------------
# capacity strategy (sort-based dispatch, token dropping)
# ---------------------------------------------------------------------------
def _capacity(tokens: int, k: int, n_experts: int, cf: float) -> int:
    c = int(tokens * k * cf / n_experts) + 1
    return max(c, 1)


def _dispatch_compute_combine(x_flat, ids, gates, w: dict, e_lo: int,
                              e_local: int, capacity: int,
                              force: Optional[str]):
    """Sort-based capacity dispatch for experts [e_lo, e_lo + e_local).

    x_flat (T, D); ids and bf16 gates (T, k). Returns the (T, D)
    contribution of the local experts (tokens routed elsewhere or dropped
    contribute zero)."""
    t, d = x_flat.shape
    k = ids.shape[-1]
    tk = t * k
    dev = x_flat.device
    flat_ids = ids.reshape(tk)
    flat_gates = gates.reshape(tk)
    local = (flat_ids >= e_lo) & (flat_ids < e_lo + e_local)
    local_ids = torch.where(local, flat_ids - e_lo,
                            torch.full_like(flat_ids, e_local))   # trash
    perm = torch.argsort(local_ids, stable=True)
    sorted_ids = local_ids[perm]
    # position within expert: index in sorted order minus the expert's
    # start (a scatter-add counts, where bincount would sync the host)
    counts = torch.zeros(e_local + 1, dtype=torch.long, device=dev) \
        .scatter_add_(0, sorted_ids, torch.ones_like(sorted_ids))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(tk, device=dev) - starts[sorted_ids]
    keep = (sorted_ids < e_local) & (pos_in_e < capacity)
    dest = torch.where(keep, sorted_ids * capacity + pos_in_e,
                       torch.full_like(sorted_ids, e_local * capacity))
    buf = torch.zeros(e_local * capacity + 1, d, dtype=x_flat.dtype,
                      device=dev)
    buf[dest] = x_flat[perm // k]            # the trash row takes the rest
    h_out = _expert_ffn(w, buf[:-1].reshape(e_local, capacity, d), force)
    out_flat = torch.cat([h_out.reshape(e_local * capacity, d),
                          torch.zeros(1, d, dtype=h_out.dtype, device=dev)])
    y_sorted = out_flat[dest] * flat_gates[perm][:, None].to(h_out.dtype)
    y_tk = torch.zeros(tk, d, dtype=h_out.dtype, device=dev)
    y_tk[perm] = y_sorted                    # unsort, then sum over k
    return y_tk.reshape(t, k, d).sum(1)


def apply_moe_capacity(p: dict, x: torch.Tensor, k: int,
                       capacity_factor: float, *, mesh=None,
                       force: Optional[str] = None):
    """Capacity-dispatch MoE on one device.  x: (B, S, D)."""
    if mesh is not None:
        raise NotImplementedError(
            "expert parallelism over a mesh waits for the port of "
            "parallel/ (see ROADMAP.md)")
    b, s, d = x.shape
    n_experts = p["router"].shape[-1]
    gates, ids, aux = route(p, x, k)
    cap = _capacity(b * s, k, n_experts, capacity_factor)
    y = _dispatch_compute_combine(
        x.reshape(b * s, d), ids.reshape(b * s, k),
        gates.reshape(b * s, k).to(COMPUTE_DTYPE), _experts(p), 0,
        n_experts, cap, force)
    y = y.reshape(b, s, d).to(x.dtype)
    if "shared" in p:
        y = y + _shared_ffn(p["shared"], x)
    return y, aux


def apply_moe(p: dict, x: torch.Tensor, k: int, capacity_factor: float,
              strategy: str = "auto", *, force: Optional[str] = None):
    """``auto`` is dense: the port has no mesh, and ``repro`` takes the
    capacity strategy under ``auto`` only on one."""
    if strategy == "capacity":
        return apply_moe_capacity(p, x, k, capacity_factor, force=force)
    if strategy in ("auto", "dense"):
        return apply_moe_dense(p, x, k, force=force)
    raise ValueError(f"moe strategy {strategy!r}")
