"""The work of one attention call, in closed form: the operations and the
bytes it needs on given shapes, whatever kernel computes it.

A frozen copy of the program's ``kernels/flash_attention/work.py``: the
yardstick of ``flash_roofline.*`` stays as it is when the program's copy
changes (``perfbench/tests/test_perfbench_work.py`` holds the two equal at
the cells' launch shapes)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["attention_backward_work", "attention_work", "visible_pairs"]


def visible_pairs(s: int, t: int, window: Optional[int],
                  causal: bool = True) -> int:
    """The (query, key) pairs the mask keeps for one head of one request:
    with ``causal``, query i sees keys j ≤ i + (t - s) (aligned ends) and,
    with a window, j > i + (t - s) - window; without, every pair. Row i
    keeps min(i + t - s + 1, window) keys, an arithmetic run up to the
    window and the window after."""
    if not causal:
        return s * t
    first = t - s + 1                      # keys of row 0
    if window is None or first + s - 1 <= window:
        return s * first + s * (s - 1) // 2
    if first >= window:
        return s * window
    rising = window - first                # rows below the window
    return rising * first + rising * (rising - 1) // 2 + (s - rising) * window


def attention_work(b, s, t, h, k, d, window, dtype,
                   causal: bool = True) -> Tuple[float, int]:
    """(operations, bytes) the forward needs on these shapes: 4·D
    operations per visible (query, key) pair; q, k, v read once and o
    written once."""
    flops = 4.0 * d * visible_pairs(s, t, window, causal) * b * h
    esize = torch.finfo(dtype).bits // 8
    nbytes = esize * (2 * b * s * h * d + 2 * b * t * k * d)
    return flops, nbytes


def attention_backward_work(b, s, t, h, k, d, window, dtype,
                            causal: bool = True) -> Tuple[float, int]:
    """(operations, bytes) the backward needs on these shapes: five
    products of 2·D operations per visible (query, key) pair (S and dP
    recomputed, dV, dQ, dK); q, k, v, o, dO and the fp32 LSE read once,
    dq, dk, dv written once."""
    flops, _ = attention_work(b, s, t, h, k, d, window, dtype, causal)
    esize = torch.finfo(dtype).bits // 8
    nbytes = (esize * (4 * b * s * h * d + 4 * b * t * k * d)
              + 4 * b * h * s)
    return flops * 10 / 4, nbytes
