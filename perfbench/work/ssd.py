"""The work of one SSD scan call and of its backward, in closed form: the
operations and the bytes each needs on given shapes. A sequence of L
tokens is L // chunk full chunks and, where chunk does not divide L, one
ragged chunk of the rest.

A frozen copy of the program's ``kernels/ssd/work.py``: the yardstick of
``ssd_roofline.*`` stays as it is when the program's copy changes
(``perfbench/tests/test_perfbench_work.py`` holds the two equal at the
cells' launch shapes)."""

from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["ssd_backward_work", "ssd_work"]


def _over_chunks(l: int, chunk: int, per_chunk: Callable[[int], float]
                 ) -> float:
    full, rest = divmod(l, chunk)
    return full * per_chunk(chunk) + (per_chunk(rest) if rest else 0.0)


def ssd_work(b, l, h, p, g, n, chunk, dtype,
             with_state) -> Tuple[float, int]:
    """(operations, bytes) the scan needs on these shapes. Per chunk of q
    tokens: q(q+1)/2 (query, key) pairs at 2(N+P) operations (C·B and the
    gate times X) and 4·q·N·P for the carried-state term and the state
    update. Bytes: x, B, C, fp32 dt and the initial state read once, y and
    the final fp32 state written once."""
    flops = _over_chunks(l, chunk, lambda q: q * (q + 1) / 2 * 2 * (n + p)
                         + 4.0 * q * n * p) * b * h
    esize = torch.finfo(dtype).bits // 8
    state = 4 * b * h * p * n
    nbytes = (esize * (2 * b * l * h * p + 2 * b * l * g * n)
              + 4 * b * l * h + state * (2 if with_state else 1))
    return flops, nbytes


def ssd_backward_work(b, l, h, p, g, n, chunk, dtype,
                      with_state) -> Tuple[float, int]:
    """(operations, bytes) the backward needs on these shapes, counted as
    :func:`ssd_work` counts the forward. Per chunk of q tokens: q(q+1)/2
    (query, key) pairs at 2(3N + 2P) operations (C·B and dy·x recomputed,
    the gate times dy, M times B and times C) and 10·q·N·P for the five
    state products (the recomputed local state, its gradient's local term,
    the carried state's term of dC, G·B and Gᵀx). Bytes: x, dy, B, C and
    fp32 dt read once, dx, dB, dC and ddt written once; with a state, the
    initial state and the final state's gradient read and the initial
    state's gradient written."""
    flops = _over_chunks(l, chunk, lambda q: q * (q + 1) / 2 * 2
                         * (3 * n + 2 * p) + 10.0 * q * n * p) * b * h
    esize = torch.finfo(dtype).bits // 8
    nbytes = (esize * (3 * b * l * h * p + 4 * b * l * g * n) + 8 * b * l * h
              + (3 * 4 * b * h * p * n if with_state else 0))
    return flops, nbytes
