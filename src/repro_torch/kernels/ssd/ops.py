"""Dispatching wrapper for the SSD primitive.

A CUDA tensor goes to the hand-written kernels (:mod:`.kernel`), which
launch or raise: through :class:`.kernel.SSDScan`, whose backward is the
CUDA backward, when grad mode is on, and straight to
:func:`.kernel.ssd_scan` when it is off. A CPU tensor goes to the plain
version (:func:`.ref.ssd_reference`), which autograd differentiates. A fake
tensor (the dry run's) goes to the kernels on any device, which count
their work and launch nothing (``kernels.fake``).
There is no fallback from the first to the second and no ``impl``
switch. Port of ``repro.kernels.ssd.ops.ssd``, with the initial and
final state of ``ssd_reference`` on both paths.

DTensor inputs (a sharded step) run in a local map
(``repro_torch.sharding.local``), as do those of :func:`decode_step`: the
scan is independent per batch row and per head, so the per-row inputs
(x, dt, B, C, the states; y) take the batch over the FSDP axes where it
divides and the heads over ``model`` where they divide (with the groups of
B and C where there are several; one group stays replicated), and a and
D take the heads' placement. The gradients come back in those
placements, but for a and D, which every batch row shares (their local
gradients are partial sums over the FSDP axes the batch is split on), and
a single group's B and C, partial over ``model`` where the heads are
split. A DTensor that reaches :mod:`.kernel` outside this map raises."""

from __future__ import annotations

from typing import Optional

import torch

from ...sharding.local import is_dtensor, op_placements, run_local
from ...sharding.partition import axis_sizes
from ..fake import is_fake
from . import kernel as _kernel
from . import ref as _ref

__all__ = ["ssd", "decode_step"]


def _layout(mesh, batch: int, heads: int, groups: int):
    """(placements of an operand with batch dim 0 and heads at ``dim``,
    given as a function of dim, of a and D, and of B and C, and the
    gradient placements of a/D and of B/C)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    by_heads = op_placements(mesh, head_dim=0, heads=heads)
    if groups > 1 and groups % axis_sizes(mesh).get("model", 1) != 0:
        by_heads = tuple(Replicate() for _ in by_heads)   # heads stay whole
    split = any(p.is_shard() for p in by_heads)
    rows = lambda dim: tuple(  # noqa: E731
        Shard(dim) if h.is_shard() else b
        for b, h in zip(op_placements(mesh, 0, batch), by_heads))
    per_row = op_placements(mesh, 0, batch)
    grad_shared = tuple(Partial() if b.is_shard() else h
                        for b, h in zip(per_row, by_heads))
    if groups > 1:
        bc = rows(2)
        bc_grad = bc
    else:
        bc = per_row
        bc_grad = tuple(Partial() if (h.is_shard() and split) else b
                        for b, h in zip(per_row, by_heads))
    return rows, by_heads, bc, grad_shared, bc_grad


def ssd(
    x: torch.Tensor,       # (B, L, H, P)
    dt: torch.Tensor,      # (B, L, H)
    a: torch.Tensor,       # (H,)
    b_mat: torch.Tensor,   # (B, L, G, N)
    c_mat: torch.Tensor,   # (B, L, G, N)
    chunk: int = 256,
    d_skip: Optional[torch.Tensor] = None,         # (H,)
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
    return_final_state: bool = False,
):
    if is_dtensor(x):
        mesh = x.device_mesh
        rows, heads, bc, g_shared, g_bc = _layout(mesh, x.shape[0],
                                                  x.shape[2], b_mat.shape[2])
        state = rows(1) if initial_state is not None else None

        def local(x_, dt_, a_, b_, c_, d_, s_):
            out = ssd(x_, dt_, a_, b_, c_, chunk=chunk, d_skip=d_,
                      initial_state=s_,
                      return_final_state=return_final_state)
            return out if return_final_state else (out,)

        outs = run_local(
            local, (x, dt, a, b_mat, c_mat, d_skip, initial_state),
            (rows(2), rows(2), heads, bc, bc,
             heads if d_skip is not None else None, state),
            (rows(2), rows(1)) if return_final_state else (rows(2),),
            mesh,
            in_grad_placements=(rows(2), rows(2), g_shared, g_bc, g_bc,
                                g_shared if d_skip is not None else None,
                                state))
        return outs if return_final_state else outs[0]
    if x.device.type == "cpu" and not is_fake(x):
        return _ref.ssd_reference(x, dt, a, b_mat, c_mat, chunk=chunk,
                                  d_skip=d_skip, initial_state=initial_state,
                                  return_final_state=return_final_state)
    if torch.is_grad_enabled():
        return _kernel.SSDScan.apply(x, dt, a, b_mat, c_mat, chunk, d_skip,
                                     initial_state, return_final_state)
    return _kernel.ssd_scan(x, dt, a, b_mat, c_mat, chunk=chunk,
                            d_skip=d_skip, initial_state=initial_state,
                            return_final_state=return_final_state)


def decode_step(
    x_t: torch.Tensor,     # (B, H, P)
    dt_t: torch.Tensor,    # (B, H)
    a: torch.Tensor,       # (H,)
    b_t: torch.Tensor,     # (B, G, N)
    c_t: torch.Tensor,     # (B, G, N)
    state: torch.Tensor,   # (B, H, P, N) fp32
    d_skip: Optional[torch.Tensor] = None,
):
    """The one-token recurrence of serving (:func:`.ref.ssd_decode_step`,
    plain PyTorch on both devices, as the JAX package leaves it to XLA);
    DTensor inputs run it in the local map :func:`ssd` uses (no
    gradients: serving)."""
    if not is_dtensor(x_t):
        return _ref.ssd_decode_step(x_t, dt_t, a, b_t, c_t, state,
                                    d_skip=d_skip)
    mesh = x_t.device_mesh
    rows, heads, _, _, _ = _layout(mesh, x_t.shape[0], x_t.shape[1],
                                   b_t.shape[1])
    bc = rows(1) if b_t.shape[1] > 1 else op_placements(mesh, 0,
                                                         x_t.shape[0])
    return run_local(
        lambda *args: _ref.ssd_decode_step(*args[:6], d_skip=args[6]),
        (x_t, dt_t, a, b_t, c_t, state, d_skip),
        (rows(1), rows(1), heads, bc, bc, rows(1),
         heads if d_skip is not None else None),
        (rows(1), rows(1)), mesh)
