"""Checkpoints with atomic manifests and async writes
(``repro.train.checkpoint``'s counterpart, in its on-disk layout).

Layout: ``<dir>/step_<N>/arr_<i>.npy`` + ``manifest.json``, committed by
writing ``manifest.json`` last and then renaming the step directory from
``.tmp``. A crash mid-save leaves only a ``.tmp`` directory, which is
ignored (and removed by the next save), so a restart always sees the last
complete step.

The leaves are numbered in ``jax.tree.flatten``'s order: dict keys sorted,
tuples and NamedTuples (``AdamState``, ``Quantized``) in field order,
``None`` holding no leaf. So a checkpoint that either package writes of the
same (params, optimizer state) restores into the other. A bf16 leaf is
written as numpy's ``ml_dtypes.bfloat16``, as ``repro`` writes it, and moves
through its 16-bit pattern (``interop``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.interop import _to_numpy, _to_tensor

_STEP_RE = re.compile(r"^step_(\d+)$")


def flatten(tree) -> list:
    """The tensor leaves of ``tree`` in ``jax.tree.flatten``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in flatten(t)]
    return [tree]


def unflatten(like, leaves: list):
    """A tree of ``like``'s structure with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}        # like's key order
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         blocking: bool = True) -> Optional[threading.Thread]:
    """Save ``tree`` at ``step``. Non-blocking mode copies every leaf to
    the host first (synchronously) and writes the files on a daemon
    thread, which it returns. A CPU leaf's numpy view shares its storage,
    and the optimizer updates leaves in place, so that mode copies it: the
    files hold ``tree`` as it was at the call."""
    host_leaves = [np.array(_to_numpy(x), copy=True)
                   if not blocking and x.device.type == "cpu"
                   else _to_numpy(x) for x in flatten(tree)]

    def _write():
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for i, arr in enumerate(host_leaves):
            np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
        # repro writes its treedef's text here and reads it nowhere
        manifest = {"step": step, "n_arrays": len(host_leaves),
                    "treedef": None}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _gc(ckpt_dir: str, keep: int):
    steps = list_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)
    for name in os.listdir(ckpt_dir):
        if name.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def list_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load(path: str, like: torch.Tensor) -> torch.Tensor:
    arr = np.load(path)
    if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 and \
            arr.dtype.kind not in "fiu":
        # numpy reads ml_dtypes' bfloat16 back as 2-byte void: its bits
        bits = torch.from_numpy(np.array(arr.view(np.uint16), copy=True))
        return bits.view(torch.bfloat16).to(like.device)
    t = _to_tensor(arr, "cpu")
    return t.to(device=like.device, dtype=like.dtype)


def restore(ckpt_dir: str, step: int, like):
    """Restore step ``step`` into the structure of ``like``: new tensors of
    each leaf's dtype on its device."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = flatten(like)
    if manifest["n_arrays"] != len(leaves):
        raise ValueError(f"checkpoint has {manifest['n_arrays']} arrays, "
                         f"the tree needs {len(leaves)}")
    out = []
    for i, leaf in enumerate(leaves):
        t = _load(os.path.join(d, f"arr_{i}.npy"), leaf)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"arr_{i}: shape {tuple(t.shape)} != "
                             f"{tuple(leaf.shape)}")
        out.append(t)
    return unflatten(like, out)
