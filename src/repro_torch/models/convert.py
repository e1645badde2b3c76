"""Carry JAX-initialised parameters and train states over to the port.

:func:`params_from_jax` takes the NumPy leaves of
``repro.models.lm.init_params`` — the nested dict with the stacked
``(R, ...)`` ``slots/slot<i>/...`` layout — and returns the port's
parameter tree with the same names, shapes and layouts. The caller does
the ``np.asarray`` on the JAX side; nothing here imports JAX. Tests use
it to give both packages the same weights instead of matching two random
generators. :func:`train_state_from_jax` does the same for a whole
``repro.launch.steps.init_train_state`` tree (params, AdamW moments, step
counts).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import lm

__all__ = ["params_from_jax", "train_state_from_jax"]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def params_from_jax(cfg, tree: Dict[str, Any]) -> Dict[str, Any]:
    """Convert a tree of NumPy arrays (``bfloat16`` leaves as ml_dtypes
    arrays) to CPU tensors of the same dtypes (move them with
    :func:`repro_torch.models.lm.tree_map`). Raises ``ValueError`` if the
    tree's keys or shapes differ from what ``cfg`` gives."""

    def conv(node, want, path):
        if isinstance(want, dict):
            if not isinstance(node, dict) or set(node) != set(want):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"{path or '/'}: keys {got} != {sorted(want)}")
            return {k: conv(node[k], want[k], f"{path}/{k}") for k in want}
        arr = np.asarray(node)
        if tuple(arr.shape) != want:
            raise ValueError(f"{path}: shape {arr.shape} != {want}")
        if arr.dtype.name not in _DTYPES:
            raise ValueError(f"{path}: dtype {arr.dtype} not supported")
        # via fp32, which holds every bf16/fp16 value exactly
        return torch.tensor(np.asarray(arr, np.float32)).to(
            _DTYPES[arr.dtype.name])

    return conv(tree, lm.param_shapes(cfg), "")


def train_state_from_jax(cfg, tree: Dict[str, Any]) -> Dict[str, Any]:
    """Convert a JAX train state as NumPy (``{"params", "opt": {"mu",
    "nu", "count"}, "step"}``) to the port's: CPU tensors, the counts as
    int32 scalars (the port keeps them on the CPU)."""

    def count(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32)

    opt = tree["opt"]
    return {
        "params": params_from_jax(cfg, tree["params"]),
        "opt": {"mu": params_from_jax(cfg, opt["mu"]),
                "nu": params_from_jax(cfg, opt["nu"]),
                "count": count(opt["count"])},
        "step": count(tree["step"]),
    }
