from repro_torch.configs.base import (
    ModelConfig, ShapeConfig, SHAPES, shapes_for, all_cells, get_config,
    list_archs, reduced_config,
)

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "shapes_for", "all_cells",
    "get_config", "list_archs", "reduced_config",
]
