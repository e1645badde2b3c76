"""Architecture registry of the port, copied from ``repro.configs``.

Nine architectures are registered: ``llama3.2-3b``, ``mamba2-130m``,
``zamba2-2.7b``, ``granite-moe-3b-a800m``, ``musicgen-large``,
``starcoder2-15b``, ``qwen2-vl-72b``, ``gemma2-2b`` (head dim 256) and
``h2o-danube-3-4b`` (head dim 120). ``qwen3-moe-235b-a22b`` stays out: the
JAX package only dry-runs it."""

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
    gemma2_2b,
    granite_moe_3b_a800m,
    h2o_danube_3_4b,
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
