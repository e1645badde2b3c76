"""Architecture registry of the port, copied from ``repro.configs``.

Only ``llama3.2-3b`` and ``mamba2-130m`` are registered: the other
architectures come with the slices that port their blocks."""

from .base import (
    ModelConfig,
    ShapeConfig,
    SHAPES,
    get_config,
    list_configs,
    register_config,
    smoke_config,
)

# importing registers each config
from . import llama3_2_3b, mamba2_130m  # noqa: F401

ALL_ARCHS = list_configs()

__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "get_config",
    "list_configs",
    "register_config",
    "smoke_config",
    "ALL_ARCHS",
]
