"""Where a DTensor meets a kernel or a tensor built on one rank.

No JAX namesake: GSPMD partitions a whole jitted step, kernels and
locally built constants included. In the port a hand-written kernel sees
plain tensors only, so each kernel op runs inside a local map
(``torch.distributed.tensor.experimental.local_map``): its DTensor inputs
are redistributed to the layout the op is independent over (batch rows
over the FSDP axes, heads over ``model`` where that divides, every other
dim gathered), the op runs on each rank's shards, and its outputs are
DTensors of that layout. A plain tensor built on every rank alike (RoPE
tables, masks, the MoE's zero loss) joins a DTensor as a replicated one.

No op here gathers a whole tensor to run the op on every rank.

The reshapes the models make of DTensors go through helpers here where
DTensor cannot take them as the tensor lies: a head split that would cut
a head (:func:`split_last`), the merge whose backward would (:func:`merge_last`),
a fold behind a sharded dim (:func:`gather_dims`; torch 2.11's DTensor
folds only a fold's leading sharded dim) and a masked embedding read
twice (:func:`reduce_partial`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import sys

import torch

from .partition import axis_sizes

__all__ = ["is_dtensor", "refuse_dtensor", "replicate_like", "op_placements",
           "run_local", "split_last", "merge_last", "reduce_partial",
           "gather_dims"]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor. A DTensor exists only once
    ``torch.distributed.tensor`` is imported, so this imports nothing (it
    runs on every kernel call and decode layer)."""
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(x, module.DTensor)


def refuse_dtensor(where: str, *tensors) -> None:
    """Raise ``TypeError`` if any of ``tensors`` is a DTensor: a kernel
    takes the shards of one rank, given to it by its op's local map."""
    if any(is_dtensor(x) for x in tensors if x is not None):
        raise TypeError(
            f"{where} takes plain tensors: a DTensor reaches a kernel only "
            "through its op's local map (ops.attention, ops.ssd)")


def replicate_like(t: torch.Tensor, ref) -> torch.Tensor:
    """``t`` (a plain tensor every rank builds alike) as a replicated
    DTensor on ``ref``'s mesh when ``ref`` is a DTensor; else ``t``."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def op_placements(mesh, batch_dim: Optional[int] = None, batch: int = 0,
                  head_dim: Optional[int] = None, heads: int = 0) -> tuple:
    """Placements of a per-row, per-head op's operand: dim ``batch_dim``
    over the FSDP axes (``pod``, ``data``) when ``batch`` divides by their
    product, dim ``head_dim`` over ``model`` when ``heads`` divides by its
    size (``partition``'s rules), every other mesh dim replicated."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = axis_sizes(mesh)
    fsdp = [a for a in sizes if a in ("pod", "data")]
    n_fsdp = 1
    for a in fsdp:
        n_fsdp *= sizes[a]
    by_batch = batch_dim is not None and batch % n_fsdp == 0
    by_heads = (head_dim is not None and "model" in sizes
                and heads % sizes["model"] == 0)
    out = []
    for a in sizes:
        if a in fsdp and by_batch:
            out.append(Shard(batch_dim))
        elif a == "model" and by_heads:
            out.append(Shard(head_dim))
        else:
            out.append(Replicate())
    return tuple(out)


def run_local(fn: Callable, args: Sequence, in_placements: Sequence,
              out_placements, mesh, in_grad_placements=None):
    """``fn(*args)`` on each rank's shards: DTensor arguments redistributed
    to ``in_placements`` (None for an argument that is not a tensor), the
    outputs DTensors of ``out_placements`` (one placements tuple for a
    single output, a tuple of them for a tuple of outputs)."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map

    if all(isinstance(p, Placement) for p in out_placements):
        out_placements = list(out_placements)   # local_map's one output
    else:
        out_placements = tuple(list(p) for p in out_placements)
    mapped = local_map(fn, out_placements=out_placements,
                       in_placements=tuple(in_placements),
                       in_grad_placements=in_grad_placements,
                       device_mesh=mesh, redistribute_inputs=True)
    return mapped(*args)


def split_last(x: torch.Tensor, parts: int) -> torch.Tensor:
    """``x`` (..., parts · n) as (..., parts, n): the heads of a projection.
    A DTensor whose last dim is sharded over mesh dims whose shard count
    does not divide ``parts`` (a shard would cut a head: llama's 24 heads
    on a 16-way model axis) is first gathered on that dim, as GSPMD
    reshards before such a reshape; one that holds whole heads is split
    where it lies."""
    if is_dtensor(x):
        last, shards = x.ndim - 1, 1
        for i, p in enumerate(x.placements):
            if p.is_shard(last):
                shards *= x.device_mesh.size(i)
        if parts % shards:
            x = gather_dims(x, (last,))
    return x.reshape(*x.shape[:-1], parts, x.shape[-1] // parts)


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., parts, n) as (..., parts · n), the inverse of
    :func:`split_last`. A DTensor's gradient is brought back to the merged
    layout before the merge's backward splits it (a product's gradient may
    come sharded across head boundaries)."""
    y = x.reshape(*x.shape[:-2], -1)
    if is_dtensor(y):
        y = y.redistribute(y.device_mesh, y.placements)
    return y


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending sums reduced now (each partial mesh dim made
    Replicate); any other tensor as it is. A vocab-parallel embedding
    lookup whose rows are not split over the batch comes back partial
    (masked), and DTensor applies a masked reduction once only, where the
    residual stream is read twice (the norm and the residual add)."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def gather_dims(x: torch.Tensor, dims) -> torch.Tensor:
    """A DTensor with every mesh dim that shards one of ``dims`` made
    Replicate; any other tensor as it is."""
    if not is_dtensor(x):
        return x
    dims = {d % x.ndim for d in dims}
    if not any(p.is_shard() and p.dim in dims for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_shard() and p.dim in dims else p
        for p in x.placements])
