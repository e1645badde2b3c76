"""The work of one causal conv + SiLU call over a layer's conv inputs
(x, B and C, each (B, L, C_i) with weights (K, C_i)) and of its backward,
in closed form: the operations and the bytes each needs on given shapes.

A frozen copy of the program's ``kernels/conv/work.py``: the yardstick of
``conv_roofline.*`` stays as it is when the program's copy changes
(``tests/test_torch_conv.py`` holds the two equal at the cells' launch
shapes). The backward's fp32 partials of dw are the kernels' scratch, not
work the function needs, and are not counted."""

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
