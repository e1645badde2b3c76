"""Architecture registry of the port, copied from ``repro.configs``.

Three architectures are registered: ``llama3.2-3b``, ``mamba2-130m``
and ``zamba2-2.7b``. The others come with the slices that port their
blocks."""

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
from . import llama3_2_3b, mamba2_130m, zamba2_2_7b  # noqa: F401

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
