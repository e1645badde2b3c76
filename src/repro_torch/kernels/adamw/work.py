"""The work of the fused AdamW kernels, in closed form: the operations and
the bytes one call needs on a tree of leaves, each given as (elements,
gradient dtype).

One formula serves two readers: ``chip_smoke.py``'s kernel table (each
pass's bound) and the dry run, where a fake tensor reaching the kernels
takes their place and counts this work (``kernel.adamw_norm``,
``kernel.adamw_update``)."""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

__all__ = ["UPDATE_FLOPS", "adamw_norm_work", "adamw_update_work"]

# Operations of one element's update, as the plain version counts them:
# the clip's scale 1; mu 3 (two products, a sum); nu 4 (the square too);
# the denominator 3 (a quotient, a square root, a sum); the step 2 (two
# quotients) and its weight decay 2; the parameter's change 2.
UPDATE_FLOPS = 17


def _esize(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


def adamw_norm_work(leaves: Iterable[Tuple[int, torch.dtype]]
                    ) -> Tuple[float, int]:
    """(operations, bytes) of the norm pass: a product and a sum an
    element; each gradient read once and the fp32 sum of squares written
    once."""
    leaves = list(leaves)
    flops = 2.0 * sum(n for n, _ in leaves)
    return flops, sum(n * _esize(dt) for n, dt in leaves) + 4


def adamw_update_work(leaves: Iterable[Tuple[int, torch.dtype]]
                      ) -> Tuple[float, int]:
    """(operations, bytes) of the update pass: ``UPDATE_FLOPS`` an element;
    the gradient and the fp32 parameter and moments read once, the three
    fp32 tensors written once (26 bytes an element with a bf16 gradient),
    the sum of squares read and the norm written."""
    leaves = list(leaves)
    flops = float(UPDATE_FLOPS) * sum(n for n, _ in leaves)
    return flops, sum(n * (_esize(dt) + 24) for n, dt in leaves) + 8
