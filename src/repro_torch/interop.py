"""Weights and states between ``repro``'s trees and the port's.

Both packages use the same nested-dict layout, so conversion is a copy leaf
by leaf: the same keys, shapes and dtypes. The source side is numpy (as
``jax.device_get`` returns it), so this module imports no JAX. A bf16 leaf
(``ml_dtypes.bfloat16`` in numpy) moves as its 16-bit pattern, so the round
trip is bit-exact for every dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a.view(np.uint16), copy=True))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # the numpy bf16 type; needed only for bf16 leaves
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree, device="cpu"):
    """A nested dict of numpy arrays (``repro`` params or decode states,
    after ``jax.device_get``) -> the same dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _to_tensor(tree, device)


def params_to_numpy(tree):
    """The inverse: a nested dict of tensors -> numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return _to_numpy(tree)
