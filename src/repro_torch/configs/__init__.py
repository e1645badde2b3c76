"""Architecture registry of the port, copied from ``repro.configs``.

Seven architectures are registered: ``llama3.2-3b``, ``mamba2-130m``,
``zamba2-2.7b``, ``granite-moe-3b-a800m``, ``musicgen-large``,
``starcoder2-15b`` and ``qwen2-vl-72b``. The others (``gemma2-2b`` and
``h2o-danube-3-4b``, whose head dims the flash kernels do not take yet,
and ``qwen3-moe-235b-a22b``) come with the slices that port them."""

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
    musicgen_large,
    qwen2_vl_72b,
    starcoder2_15b,
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
