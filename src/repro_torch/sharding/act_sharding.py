"""Activation-sharding hints, threaded to the model through a context (the
model code stays mesh-agnostic). Port of ``repro.sharding.act_sharding``.

``activation_sharding(spec)`` makes every layer boundary constrain the
residual stream to ``spec``, e.g. ``(("data",), "model", None)``: batch
over the FSDP axes and the sequence over the model axis (sequence
parallelism). With full remat the saved per-layer residual is exactly
this buffer, so the constraint divides the dominant activation-memory
term by the model axis size.

Deliberate differences from the JAX namesake: a hint acts on a DTensor
by ``redistribute`` to the spec's placements on the tensor's own mesh
(``partition.placements``), where JAX puts a
``with_sharding_constraint`` for XLA to honour; on a plain tensor, or with
no ambient spec, each hint is the identity (the JAX one is the identity
only without a spec, as every JAX array is placed).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Sequence

import torch

from .local import is_dtensor
from .partition import placements

__all__ = ["activation_sharding", "constrain", "constrain_seq_gathered",
           "current_spec", "moe_weight_sharding", "current_moe_specs",
           "constrain_to"]

_SPEC: Optional[tuple] = None
_MOE_SPECS = None   # (gate/up spec, down spec) for gathered MoE weights


@contextmanager
def activation_sharding(spec: Optional[Sequence]):
    global _SPEC
    prev = _SPEC
    _SPEC = None if spec is None else tuple(spec)
    try:
        yield
    finally:
        _SPEC = prev


def current_spec() -> Optional[tuple]:
    return _SPEC


@contextmanager
def moe_weight_sharding(gate_up: Optional[Sequence],
                        down: Optional[Sequence]):
    """Compute-time layout of the gathered MoE expert weights: the
    FSDP-sharded d_model dim is gathered before the expert products while
    the expert or d_ff dim keeps its expert or tensor parallelism; the
    launcher pins the exact specs."""
    global _MOE_SPECS
    prev = _MOE_SPECS
    _MOE_SPECS = (gate_up, down)
    try:
        yield
    finally:
        _MOE_SPECS = prev


def current_moe_specs():
    return _MOE_SPECS


def constrain_to(x: torch.Tensor, spec: Optional[Sequence]) -> torch.Tensor:
    """``x`` redistributed to ``spec``'s placements on its own mesh when it
    is a DTensor and ``spec`` is not None; else ``x``."""
    if spec is None or not is_dtensor(x):
        return x
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def constrain(x: torch.Tensor) -> torch.Tensor:
    """Apply the ambient activation spec to a (B, S, M) tensor."""
    if _SPEC is None or x.ndim != 3:
        return x
    return constrain_to(x, _SPEC)


def constrain_seq_gathered(x: torch.Tensor) -> torch.Tensor:
    """Batch-sharded but sequence-replicated layout for a (B, S, ...)
    tensor: the explicit gather point before attention, pinned on the
    (small, bf16) K/V projections."""
    if _SPEC is None:
        return x
    batch_ax = _SPEC[0] if len(_SPEC) > 0 else None
    return constrain_to(x, (batch_ax,) + (None,) * (x.ndim - 1))
