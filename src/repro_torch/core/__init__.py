"""Core: the paper's contribution — tail-effect modeling and elimination
(``repro.core``'s counterpart, for the modules the port has)."""

from repro_torch.core.hardware import (
    H100_SXM, HardwareSpec, TPU_LITE, TPU_V4, TPU_V5E, TPU_V5P, get_hardware,
)
from repro_torch.core.tail_model import (
    GridWaveModel, LayerShape, ModelStairTable, StairPoint, StairTable,
    WaveQuantizationModel, ceil_div, staircase_edges,
)
from repro_torch.core.candidates import (
    analytic_candidates, model_profile_candidates, profile_candidates,
    realizable_candidates, snap_down, snap_nearest, snap_up,
)
from repro_torch.core.tail_optimizer import (
    Move, OptimizationResult, TailEffectOptimizer, TunableLayer,
    discretize_pruning_space, tunable_from_profile,
)
from repro_torch.core.table_cache import ProfileTableCache, \
    hardware_fingerprint
from repro_torch.core.plan_address import ModuleRef, plan_key, snap_heads
from repro_torch.core import pruning

__all__ = [
    "HardwareSpec", "TPU_V5E", "TPU_V4", "TPU_V5P", "TPU_LITE", "H100_SXM",
    "get_hardware", "LayerShape", "StairPoint", "StairTable",
    "ModelStairTable", "WaveQuantizationModel",
    "GridWaveModel", "staircase_edges", "ceil_div", "analytic_candidates",
    "profile_candidates", "model_profile_candidates",
    "realizable_candidates", "snap_down", "snap_up", "snap_nearest",
    "TailEffectOptimizer", "TunableLayer", "OptimizationResult", "Move",
    "discretize_pruning_space", "tunable_from_profile",
    "ProfileTableCache", "hardware_fingerprint", "ModuleRef", "plan_key",
    "snap_heads",
]
