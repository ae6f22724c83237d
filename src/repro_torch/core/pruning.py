"""Structured filter-pruning baselines the paper compares against
(``repro.core.pruning``'s counterpart).

* HRank (Lin et al., CVPR'20): rank filters by the average matrix rank of
  their output feature maps on a probe batch; prune lowest-rank filters.
* SOFT / Soft Filter Pruning (He et al., IJCAI'18): rank filters by L2 norm;
  during training, zero the weakest filters each epoch but keep updating
  them (soft), hard-prune at the end.

Both produce *continuous* per-layer width targets; the paper's section 4.4
enhancement replaces those with the tail-free discrete candidate widths
(``tail_optimizer.discretize_pruning_space``): same criteria, wave-aligned
widths.

The scores are computed where the tensors lie (the card's SVD on the card)
and returned as numpy; the choice of filters stays numpy on the host, so
ties (common among HRank's means of integer ranks) break as in ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


def feature_map_rank_scores(acts, tol: float | None = None) -> np.ndarray:
    """HRank criterion: per-channel mean matrix rank of feature maps.

    ``acts``: (batch, H, W, C) activations from a probe batch. Returns (C,)
    fp32 scores, higher rank = more informative = keep. A map's rank
    counts its singular values (fp32) above the largest times ``tol``
    (max(H, W) x fp32 eps when None), as ``repro`` counts them; the ranks
    are integers, and their mean over the batch is their exact sum times
    the fp32 reciprocal of the batch, as XLA computes ``repro``'s mean.
    """
    acts = torch.as_tensor(acts).float()
    b, h, w, c = acts.shape
    maps = acts.permute(0, 3, 1, 2).reshape(b * c, h, w)
    sv = torch.linalg.svdvals(maps)                     # (b*c, min(h,w))
    if tol is None:
        tol = float(max(h, w)) * torch.finfo(torch.float32).eps
    thresh = sv[:, :1] * tol
    ranks = torch.sum(sv > thresh, dim=-1).reshape(b, c)
    inv = float(np.float32(1) / np.float32(b))
    return (ranks.float().sum(dim=0) * inv).cpu().numpy()


def l2_filter_scores(kernel) -> np.ndarray:
    """SOFT criterion: L2 norm per output filter.

    ``kernel``: (kh, kw, cin, cout) conv kernel or (din, dout) dense kernel.
    """
    k = torch.as_tensor(kernel).detach().float()
    flat = k.reshape(-1, k.shape[-1])
    return torch.linalg.vector_norm(flat, dim=0).cpu().numpy()


def keep_indices(scores: np.ndarray, keep: int) -> np.ndarray:
    """Indices of the ``keep`` highest-scoring filters, in original order."""
    keep = int(max(1, min(keep, len(scores))))
    idx = np.argsort(scores)[::-1][:keep]
    return np.sort(idx)


def soft_prune_mask(scores: np.ndarray, keep: int) -> np.ndarray:
    """SOFT's in-training mask: 1 for kept filters, 0 for softly-pruned."""
    mask = np.zeros(len(scores), dtype=np.float32)
    mask[keep_indices(scores, keep)] = 1.0
    return mask


@dataclasses.dataclass
class PrunePlan:
    """Per-layer width plan: layer name -> (keep_width, filter indices)."""
    widths: dict[str, int]
    indices: dict[str, np.ndarray]

    @property
    def total_width(self) -> int:
        return sum(self.widths.values())


def uniform_flops_plan(base_widths: dict[str, int], ratio: float
                       ) -> dict[str, int]:
    """The naive baseline: prune every layer's width by the same ratio,
    the 'FLOPs reduction as the objective' strategy the paper critiques."""
    return {k: max(1, int(round(v * ratio))) for k, v in base_widths.items()}


def build_plan(score_fn: Callable[[str], np.ndarray],
               target_widths: dict[str, int]) -> PrunePlan:
    idx = {name: keep_indices(score_fn(name), w)
           for name, w in target_widths.items()}
    widths = {name: len(v) for name, v in idx.items()}
    return PrunePlan(widths=widths, indices=idx)
