"""Per-architecture configs (exact published sizes) + reduced smoke configs."""
from .base import (ARCH_IDS, SHAPES, ArchConfig, ShapeSpec, get_config,
                   get_smoke_config, shape_applicable)

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "ShapeSpec", "get_config",
           "get_smoke_config", "shape_applicable"]
