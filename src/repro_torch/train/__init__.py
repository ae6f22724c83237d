"""Training (``repro.train``'s counterpart): the data sources, AdamW, the
train step and checkpoints."""

from repro_torch.train.optim import (
    AdamState, AdamWConfig, adamw_init, adamw_update, cosine_schedule,
    clip_by_global_norm, global_norm,
)
from repro_torch.train.step import TrainConfig, build_train_step, \
    build_eval_step
from repro_torch.train.data import DataConfig, SyntheticLM, MemmapLM, \
    make_source, augment_for_arch
from repro_torch.train import checkpoint

__all__ = [
    "AdamState", "AdamWConfig", "adamw_init", "adamw_update",
    "cosine_schedule", "clip_by_global_norm", "global_norm", "TrainConfig",
    "build_train_step", "build_eval_step", "DataConfig", "SyntheticLM",
    "MemmapLM", "make_source", "augment_for_arch", "checkpoint",
]
