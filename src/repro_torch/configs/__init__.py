"""Architecture registry of the port, copied from ``repro.configs``.

Four architectures are registered: ``llama3.2-3b``, ``mamba2-130m``,
``zamba2-2.7b`` and ``granite-moe-3b-a800m``. The others come with the
slices that port their blocks."""

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
from . import (  # noqa: F401
    granite_moe_3b_a800m,
    llama3_2_3b,
    mamba2_130m,
    zamba2_2_7b,
)

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
