"""Deterministic, resumable synthetic and memmapped token streams
(``repro.train.data``'s counterpart, numpy only).

Every batch is a pure function of (seed, step), so a restarted run regains
its exact stream position from the checkpointed step, and the batches are
bit-equal to ``repro``'s for the same (seed, step).

Two sources:
  * ``SyntheticLM``: a token stream with a next-token rule (a bigram
    template with noise), so that a model measurably learns;
  * ``MemmapLM``: a packed uint16/uint32 token file read in deterministic
    windows (any tokenized corpus on disk).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    path: Optional[str] = None       # memmap token file
    dtype: str = "uint16"


class SyntheticLM:
    """x_{t+1} = (a * x_t + b) % V, with 10 % of the steps replaced by
    noise: learnable (a next-token rule exists) but not trivial."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        v = c.vocab_size
        b, s = c.global_batch, c.seq_len
        a, off = 31, 17
        x0 = rng.integers(0, v, size=(b, 1))
        toks = [x0]
        for _ in range(s):
            nxt = (toks[-1] * a + off) % v
            noise = rng.integers(0, v, size=(b, 1))
            flip = rng.random((b, 1)) < 0.1
            toks.append(np.where(flip, noise, nxt))
        seq = np.concatenate(toks, axis=1).astype(np.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


class MemmapLM:
    def __init__(self, cfg: DataConfig):
        if not (cfg.path and os.path.exists(cfg.path)):
            raise FileNotFoundError(f"token file {cfg.path!r}")
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=np.dtype(cfg.dtype), mode="r")
        self.n_windows = (len(self.data) - 1) // cfg.seq_len

    def batch(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        idx = rng.integers(0, self.n_windows, size=(c.global_batch,))
        starts = idx * c.seq_len
        rows = np.stack([self.data[s:s + c.seq_len + 1] for s in starts])
        rows = rows.astype(np.int32) % c.vocab_size
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def make_source(cfg: DataConfig):
    return MemmapLM(cfg) if cfg.path else SyntheticLM(cfg)


def augment_for_arch(batch: dict, mcfg: ModelConfig, seq_len: int,
                     step: int = 0) -> dict:
    """Add the stub inputs an arch needs: an encoder-decoder's audio frames
    (``src_embeds``), M-RoPE's (B, S, 3) ``positions``."""
    b = batch["tokens"].shape[0]
    if mcfg.is_encdec:
        rng = np.random.default_rng((7, step))
        batch = dict(batch, src_embeds=rng.standard_normal(
            (b, seq_len, mcfg.d_model)).astype(np.float32) * 0.02)
    if mcfg.rope_kind == "mrope":
        pos = np.broadcast_to(
            np.arange(seq_len, dtype=np.int32)[None, :, None],
            (b, seq_len, 3)).copy()
        batch = dict(batch, positions=pos)
    return batch
