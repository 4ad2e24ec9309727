from repro_torch.configs.base import (
    ARCH_IDS,
    ArchConfig,
    get_config,
    list_archs,
)
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable

__all__ = ["ArchConfig", "get_config", "list_archs", "ARCH_IDS",
           "SHAPES", "ShapeSpec", "applicable"]
