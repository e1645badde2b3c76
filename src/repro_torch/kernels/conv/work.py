"""The work of the causal conv + SiLU kernels, in closed form: the
operations and the bytes one call needs on a layer's conv inputs, each
(B, L, C_i) with weights (K, C_i).

One formula serves two readers: ``chip_smoke.py``'s kernel table (each
pass's bound) and the dry run, where a fake tensor reaching the kernels
takes their place and counts this work (``kernel.causal_conv_fwd``,
``kernel.causal_conv_bwd``). The backward's fp32 partials of dw are the
kernels' own scratch, not work the function needs, and are not counted."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["conv_backward_work", "conv_work"]


def _esize(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


def conv_work(b: int, l: int, widths: Sequence[int], k: int,
              dtype: torch.dtype) -> Tuple[float, int]:
    """(operations, bytes) of the forward: 2K operations an element for
    the taps and 4 for the SiLU (an exponential, a sum, a reciprocal, a
    product); x read and y written once, the weights read once."""
    c = sum(widths)
    flops = (2.0 * k + 4) * b * l * c
    return flops, _esize(dtype) * (2 * b * l * c + k * c)


def conv_backward_work(b: int, l: int, widths: Sequence[int], k: int,
                       dtype: torch.dtype) -> Tuple[float, int]:
    """(operations, bytes) of the backward: the forward's 2K + 4 an element
    again (the pre-activation recomputed), 5 for ds (the SiLU's
    derivative, times dy), 2K for dx and 2K for dw; x and dy read and dx
    written once, the weights read and dw written once."""
    c = sum(widths)
    flops = (6.0 * k + 9) * b * l * c
    return flops, _esize(dtype) * (3 * b * l * c + 2 * k * c)
