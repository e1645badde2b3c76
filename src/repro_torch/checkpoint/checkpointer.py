"""Checkpoint serialization: a tree of tensors ↔ a directory of ``.npy``
files and a manifest. Port of ``repro.checkpoint.checkpointer``, with its
layout byte for byte, so a checkpoint written by either package restores
in the other.

Layout (one checkpoint):
    <dir>/step_<N>/
        manifest.json       # {"step", "leaves": [{"key", "shape", "dtype"}]}
        <leaf-key>.npy      # one file per leaf

Leaves are taken in JAX's flatten order (dict keys sorted) and named by
their path joined with ``__``. bfloat16 leaves are stored as ``uint16``
views and ``float8_e4m3fn`` and ``float8_e5m2`` leaves as ``uint8`` views,
with the true dtype's name in the manifest, as the JAX package's
``_EXOTIC_STORE`` does (NumPy has none of the three; the port goes through
``torch.int16`` and ``torch.uint8`` views of the same bits) and restore
views them back before any cast. A stored dtype name the port does not
know is refused with ``ValueError``. Writes are
crash-safe: everything lands in ``step_<N>.tmp`` and is renamed once the
manifest is fsynced, so a half-written checkpoint is never visible to
``latest_step``. Restore places each leaf on the device its ``devices``
entry names, where the JAX package takes shardings; or, given a mesh and
a placements tree, on those placements (the elastic path: a state saved
on one mesh restores onto another).

A DTensor state (a sharded step) is saved collectively: every rank of
its mesh calls :func:`save_checkpoint`, each leaf's full value is
gathered, and the first rank of the process group writes it, so the files
are the JAX layout byte for byte, whatever mesh wrote them.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..sharding.local import is_dtensor

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "list_steps", "flatten_with_keys"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def flatten_with_keys(tree: Any, prefix: Tuple[str, ...] = ()
                      ) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) of a nested dict in JAX's flatten order (keys sorted),
    the key its path joined by ``__`` (``"root"`` for a bare leaf)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_with_keys(tree[k], prefix + (str(k),))
    else:
        yield "__".join(prefix) or "root", tree


def _unflatten_like(tree: Any, by_key: Dict[str, Any],
                    prefix: Tuple[str, ...] = ()) -> Any:
    """``tree``'s structure, in its own key order, with the leaf of each
    path taken from ``by_key``."""
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, by_key, prefix + (str(k),))
                for k, v in tree.items()}
    return by_key["__".join(prefix) or "root"]


# The dtypes NumPy cannot hold, by their manifest name: the torch dtype and
# the same-width integer view that torch and NumPy share (NumPy's uint16 is
# read through torch.int16, which holds the same bits).
_EXOTIC_STORE = {
    "bfloat16": (torch.bfloat16, torch.int16, np.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8, np.uint8),
}
_BY_DTYPE = {dtype: name for name, (dtype, *_) in _EXOTIC_STORE.items()}
# The NumPy dtype names stored as they are.
_PLAIN_STORE = ("bool", "uint8", "uint16", "uint32", "uint64", "int8",
                "int16", "int32", "int64", "float16", "float32", "float64",
                "complex64", "complex128")


def _to_storable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().cpu().contiguous()
    name = _BY_DTYPE.get(t.dtype)
    if name is not None:
        _, view, _, stored = _EXOTIC_STORE[name]
        return t.view(view).numpy().view(stored), name
    arr = t.numpy()
    return arr, arr.dtype.name


def _from_storable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _EXOTIC_STORE:
        dtype, _, np_view, _ = _EXOTIC_STORE[dtype_name]
        return torch.from_numpy(arr.view(np_view)).view(dtype)
    if dtype_name not in _PLAIN_STORE or arr.dtype.name != dtype_name:
        raise ValueError(
            f"stored dtype {dtype_name!r} (file dtype {arr.dtype.name}) is "
            "not one the port restores")
    return torch.from_numpy(arr)


def save_checkpoint(directory: str, step: int, state: Any) -> str:
    """Write a checkpoint of ``state`` (a nested dict of tensors, on any
    device); returns the final path. With DTensor leaves every rank calls
    it and the process group's rank 0 writes (see the module docstring)."""
    leaves = list(flatten_with_keys(state))
    if any(is_dtensor(leaf) for _, leaf in leaves):
        return _save_collective(directory, step, leaves)
    return _write(directory, step, _stored(leaves))


def _stored(leaves):
    """(key, array, dtype name) of each leaf, one leaf at a time (a
    DTensor leaf's gather is a collective, in the same order on every
    rank)."""
    for key, leaf in leaves:
        yield (key,) + _to_storable(leaf)


def _save_collective(directory: str, step: int, leaves) -> str:
    dist = torch.distributed
    final = os.path.join(directory, f"step_{step}")
    if dist.get_rank() == 0:
        _write(directory, step, _stored(leaves))
    else:
        for _ in _stored(leaves):
            pass
    dist.barrier()
    return final


def _write(directory: str, step: int, stored) -> str:
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    entries: List[Dict[str, Any]] = []
    for key, arr, dtype_name in stored:
        np.save(os.path.join(tmp, key + ".npy"), arr)
        entries.append({
            "key": key,
            "shape": list(arr.shape),
            "dtype": dtype_name,
        })
    manifest = {"step": step, "leaves": entries}
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def list_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(
    directory: str,
    step: int,
    target: Any,
    devices: Any = None,
    mesh: Any = None,
    placements: Any = None,
) -> Any:
    """Load ``step`` into the structure of ``target`` (a nested dict of
    tensors, which may lie on the meta device: only their shapes and
    dtypes are read). With ``devices`` (a matching tree of devices), each
    leaf is placed on its device; without, on the CPU. With ``mesh`` and
    ``placements`` (a matching tree of DTensor placements, as
    ``partition.placements`` gives them; None for a leaf that stays a plain
    tensor), each leaf becomes a DTensor on them, every rank reading the
    file and keeping its own shards (the JAX package's restore onto a
    sharding tree, mesh-independent). Raises ``KeyError`` for a leaf the
    checkpoint lacks and ``ValueError`` for a shape that differs."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    available = {e["key"]: e for e in manifest["leaves"]}

    leaves = list(flatten_with_keys(target))
    places = ([d for _, d in flatten_with_keys(devices)]
              if devices is not None else [None] * len(leaves))
    if len(places) != len(leaves):
        raise ValueError("devices tree does not match target tree")
    layouts = ([pl for _, pl in flatten_with_keys(placements)]
               if placements is not None else [None] * len(leaves))
    if len(layouts) != len(leaves):
        raise ValueError("placements tree does not match target tree")
    if placements is not None and mesh is None:
        raise ValueError("placements need the mesh they refer to")

    out = {}
    for (key, leaf), device, layout in zip(leaves, places, layouts):
        if key not in available:
            raise KeyError(f"checkpoint {path} missing leaf {key}")
        t = _from_storable(np.load(os.path.join(path, key + ".npy")),
                           available[key]["dtype"])
        want_shape = tuple(leaf.shape)
        if tuple(t.shape) != want_shape:
            raise ValueError(
                f"{key}: checkpoint shape {tuple(t.shape)} != target "
                f"{want_shape}"
            )
        if layout is not None:
            from torch.distributed.tensor import distribute_tensor

            out[key] = distribute_tensor(
                t.to(device=mesh.device_type, dtype=leaf.dtype), mesh,
                list(layout), src_data_rank=None)
            continue
        out[key] = t.to(device=device or "cpu", dtype=leaf.dtype)
    return _unflatten_like(target, out)
