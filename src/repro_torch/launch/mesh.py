"""Device meshes. Port of ``repro.launch.mesh``.

``make_production_mesh`` is a function (never a module-level constant), so
importing this module touches no process group or device, as in the JAX
package.

Deliberate differences from the JAX namesake:

* A mesh is a ``torch.distributed`` :class:`DeviceMesh` (built by
  ``init_device_mesh`` with ``mesh_dim_names``) over the ranks of an
  initialised process group, one rank a device: the JAX mesh takes
  devices from ``jax.devices()`` inside one process. So "devices" are the
  process group's ranks here, and every rank of the group calls
  ``make_mesh``. The mesh takes every rank: a group of another size than
  the mesh raises, where JAX takes the first ``n`` devices.
* The abstract mesh (axis names and sizes only, no process group) is
  ``repro_torch.sharding.partition.AbstractMesh``: the partition plan
  reads nothing else, and the kernels and models read the axis sizes
  through the plan's module, not this one.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ..sharding.partition import axis_sizes

__all__ = ["describe_mesh", "make_mesh", "make_production_mesh",
           "production_shape"]


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """16×16 ``("data", "model")`` (one pod, 256 devices) or 2×16×16
    ``("pod", "data", "model")`` (two pods, 512 devices)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _world_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None):
    """A :class:`DeviceMesh` of ``shape`` with axes ``axes`` over every
    rank of the initialised process group (``device_type`` defaults to
    ``"cuda"`` where a card is, else ``"cpu"``). Raises ``RuntimeError``
    when the group has another number of ranks than the mesh needs."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    n = math.prod(shape)
    world = _world_size()
    if world != n:
        raise RuntimeError(f"need {n} devices, have {world}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The production mesh (:func:`production_shape`) over the process
    group's ranks; raises ``RuntimeError`` when the group is smaller, as
    the JAX one does when there are fewer devices."""
    shape, axes = production_shape(multi_pod)
    n = math.prod(shape)
    world = _world_size()
    if world < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {world}: launch {n} "
            "ranks (one a card), or plan on AbstractMesh(shape, axes) "
            "without devices")
    return make_mesh(shape, axes, device_type)


def describe_mesh(mesh) -> str:
    """e.g. ``2datax4model``, as the JAX package writes it."""
    return "x".join(f"{size}{name}" for name, size in axis_sizes(mesh).items())
