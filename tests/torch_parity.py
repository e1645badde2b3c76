"""Helpers for the port's parity tests: the same NumPy inputs and the
same JAX-initialised weights for ``repro`` and ``repro_torch``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import lm as jax_lm
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.models.convert import params_from_jax

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def configs(arch="llama3.2-3b", compute_dtype="bfloat16"):
    """The smoke config of ``arch`` in both packages."""
    jcfg = dataclasses.replace(jax_smoke_config(arch),
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(torch_smoke_config(arch),
                               compute_dtype=compute_dtype)
    return jcfg, tcfg


def params(jcfg, tcfg, dtype="float32", seed=0):
    """JAX ``lm.init_params`` in ``dtype`` and its port twin."""
    jp = jax_lm.init_params(jcfg, jax.random.PRNGKey(seed))
    jp = jax.tree.map(lambda x: x.astype(jnp.dtype(dtype)), jp)
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    return jp, tp


def layer(tree, r=0):
    """Layer ``r`` of a stacked slot subtree (JAX or torch leaves)."""
    if isinstance(tree, dict):
        return {k: layer(v, r) for k, v in tree.items()}
    return tree[r]


def normal(rng, shape, dtype="float32"):
    """One array for both packages: numpy normals rounded to ``dtype``."""
    j = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(
        jnp.dtype(dtype))
    return j, to_torch(j)


def to_torch(x):
    arr = np.asarray(x)
    if arr.dtype.kind in "iu":
        return torch.from_numpy(np.array(arr))
    return torch.from_numpy(np.array(arr, np.float32)).to(
        TORCH_DTYPE[arr.dtype.name])


def to_np(x):
    """A torch tensor or JAX array as NumPy, floats widened to fp32."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    arr = np.asarray(x)
    return arr if arr.dtype.kind in "iub" else arr.astype(np.float32)


def tol(dtype):
    """tests/test_kernels.py::_tol by dtype name."""
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(
        rtol=2e-4, atol=2e-4)
