"""Plan -> pytree addressing: where a planned width lands in a model.

The optimizer and the serving planner speak in flat layer *names*
("mlp3", "attn0") with integer widths; a real model is a nested param
pytree whose layers live at structured addresses (stacked scan units,
unrolled leftovers).  This module is the shared vocabulary between the
two worlds:

  * ``ModuleRef`` — the address of one width-adjustable module: the
    decoder layer index plus the site within the layer ("mlp" slices the
    FFN hidden dim, "attn" slices attention heads).
  * ``snap_heads`` — attention widths are planned in channels
    (heads x head_dim) on the staircase grid, but can only be realized
    as whole heads, in multiples of the GQA group size (every kept query
    head must keep its KV head).  This snap is the one place the
    modeled grid and the realizable grid disagree.
  * ``plan_key`` — the canonical hashable identity of a width
    assignment, used to key materialized-param caches: two plans that
    realize the same widths share one sliced pytree.

``repro_torch.serving.width_swap`` materializes these addresses onto real
params; keeping the vocabulary here (core) lets profilers and future
backends address plans without importing the serving stack.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

# Sites a ModuleRef can point at.  "mlp" adjusts the FFN hidden width
# (w_up/w_gate columns, w_down rows); "attn" adjusts the attention width
# in head-channels (query heads, with KV heads following the GQA ratio).
MODULE_SITES = ("mlp", "attn")


@dataclasses.dataclass(frozen=True)
class ModuleRef:
    """Address of one width-adjustable module inside a decoder stack."""

    layer: int      # decoder layer index (0-based, pre-stacking order)
    site: str       # one of MODULE_SITES

    def __post_init__(self):
        if self.site not in MODULE_SITES:
            raise ValueError(
                f"unknown module site {self.site!r}; expected one of "
                f"{MODULE_SITES}")
        if self.layer < 0:
            raise ValueError(f"negative layer index {self.layer}")


def snap_heads(width: int, head_dim: int, n_heads: int,
               n_kv_heads: int) -> int:
    """Realizable query-head count for a planned attention width.

    ``width`` is in channels (the staircase axis: heads x head_dim).
    Rounds down to whole heads, then down to a multiple of the GQA group
    size g = n_heads // n_kv_heads so kept query heads map onto a prefix
    of KV heads; clamped to [g, n_heads] (at least one KV head's group
    always survives — a zero-head attention layer is not a width config,
    it is layer removal, which Algorithm 2 never proposes).
    """
    if n_heads % max(n_kv_heads, 1):
        raise ValueError(
            f"n_heads={n_heads} not divisible by n_kv_heads={n_kv_heads}")
    g = n_heads // max(n_kv_heads, 1)
    heads = (int(width) // max(head_dim, 1)) // g * g
    return max(g, min(heads, n_heads))


def plan_key(widths: Mapping[str, int]) -> tuple:
    """Canonical hashable identity of a width assignment."""
    return tuple(sorted((str(k), int(v)) for k, v in widths.items()))
