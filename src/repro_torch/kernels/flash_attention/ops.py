"""Dispatching wrapper for attention.

A CUDA tensor goes to :class:`.kernel.FlashAttention`, whose forward and
backward are the hand-written kernels, which launch or raise; a CPU
tensor goes to the plain version (:mod:`.ref`), differentiated by
autograd. There is no fallback from the first to the second. Port of
``repro.kernels.flash_attention.ops.attention``."""

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
    return _kernel.FlashAttention.apply(q, k, v, causal, window, softcap)
