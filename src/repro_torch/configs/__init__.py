"""Architecture registry of the port, copied from ``repro.configs``.

All ten architectures of the JAX package are registered: ``llama3.2-3b``,
``mamba2-130m``, ``zamba2-2.7b``, ``granite-moe-3b-a800m``,
``musicgen-large``, ``starcoder2-15b``, ``qwen2-vl-72b``, ``gemma2-2b``
(head dim 256), ``h2o-danube-3-4b`` (head dim 120) and
``qwen3-moe-235b-a22b`` (235 B parameters, 438 GiB in bf16, which only the
dry run takes); and one the JAX package has not, ``zamba2-7b`` (Zamba-2's
own hybrid block, ``zamba_hybrid``: two alternating shared blocks over
the concatenated embedding, attention at head dim 224, Mamba-2 with two
groups)."""

from .base import (
    HybridConfig,
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
    qwen3_moe_235b_a22b,
    starcoder2_15b,
    zamba2_2_7b,
    zamba2_7b,
)

ALL_ARCHS = list_configs()

__all__ = [
    "HybridConfig",
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "get_config",
    "list_configs",
    "register_config",
    "smoke_config",
    "ALL_ARCHS",
]
