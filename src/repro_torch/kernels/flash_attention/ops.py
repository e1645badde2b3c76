"""Dispatching wrapper for attention.

A CUDA tensor goes to the hand-written kernel (:mod:`.kernel`), which
launches or raises; a CPU tensor goes to the plain version
(:mod:`.ref`). There is no fallback from the first to the second. Port
of ``repro.kernels.flash_attention.ops.attention``."""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel as _kernel
from . import ref as _ref

__all__ = ["attention"]


def attention(
    q: torch.Tensor,            # (B, S, H, D)
    k: torch.Tensor,            # (B, T, K, D)
    v: torch.Tensor,            # (B, T, K, D)
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    if q.device.type == "cpu":
        return _ref.attention_reference(q, k, v, causal=causal, window=window,
                                        softcap=softcap)
    return _kernel.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
