"""Arch registry: ``--arch <id>`` surface for every assigned architecture."""

from .registry import (
    ModelConfig,
    MoESpec,
    get_config,
    list_archs,
    register,
    smoke_config,
)
from .shapes import SHAPES, ShapeSpec, applicable_shapes, skip_reason

__all__ = [
    "ModelConfig",
    "MoESpec",
    "get_config",
    "list_archs",
    "register",
    "smoke_config",
    "SHAPES",
    "ShapeSpec",
    "applicable_shapes",
    "skip_reason",
]
