"""Dispatching wrapper for the SSD primitive.

A CUDA tensor goes to the hand-written kernels (:mod:`.kernel`), which
launch or raise: through :class:`.kernel.SSDScan`, whose backward is the
CUDA backward, when grad mode is on, and straight to
:func:`.kernel.ssd_scan` when it is off. A CPU tensor goes to the plain
version (:func:`.ref.ssd_reference`), which autograd differentiates.
There is no fallback from the first to the second and no ``impl``
switch. Port of ``repro.kernels.ssd.ops.ssd``, with the initial and
final state of ``ssd_reference`` on both paths."""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel as _kernel
from . import ref as _ref

__all__ = ["ssd"]


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
    if x.device.type == "cpu":
        return _ref.ssd_reference(x, dt, a, b_mat, c_mat, chunk=chunk,
                                  d_skip=d_skip, initial_state=initial_state,
                                  return_final_state=return_final_state)
    if torch.is_grad_enabled():
        return _kernel.SSDScan.apply(x, dt, a, b_mat, c_mat, chunk, d_skip,
                                     initial_state, return_final_state)
    return _kernel.ssd_scan(x, dt, a, b_mat, c_mat, chunk=chunk,
                            d_skip=d_skip, initial_state=initial_state,
                            return_final_state=return_final_state)
