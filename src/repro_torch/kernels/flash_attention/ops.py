"""Dispatching wrapper for attention.

A CUDA tensor goes to :class:`.kernel.FlashAttention`, whose forward and
backward are the hand-written kernels, which launch or raise; a CPU
tensor goes to the plain version (:mod:`.ref`), differentiated by
autograd. A fake tensor (the dry run's) goes to the kernels on any
device, which count their work and launch nothing (``kernels.fake``).
There is no fallback from the first to the second. Port of
``repro.kernels.flash_attention.ops.attention``.

DTensor inputs (a sharded step) run in a local map
(``repro_torch.sharding.local``): attention is independent per batch row
and per head, so q, k and v are redistributed to the batch over the FSDP
axes (where the batch divides) and the heads over ``model`` (where the
KV heads divide), the sequence and head dim gathered, and each rank runs
the path above on its shards: in placements those of q, k, v, out
placements the output's, the same; the gradients come back in them.
A DTensor that reaches :mod:`.kernel` outside this map raises."""

from __future__ import annotations

from typing import Optional

import torch

from ...sharding.local import is_dtensor, op_placements, run_local
from ..fake import is_fake
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
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``scale``: the softmax scale, D^-1/2 by default (Zamba-2's shared
    blocks take (D / 2)^-1/2)."""
    if is_dtensor(q):
        mesh = q.device_mesh
        pl = op_placements(mesh, 0, q.shape[0], 2, k.shape[2])
        return run_local(
            lambda q_, k_, v_: attention(q_, k_, v_, causal, window, softcap,
                                         scale),
            (q, k, v), (pl, pl, pl), pl, mesh)
    if q.device.type == "cpu" and not is_fake(q):
        return _ref.attention_reference(q, k, v, causal=causal, window=window,
                                        softcap=softcap, scale=scale)
    return _kernel.FlashAttention.apply(q, k, v, causal, window, softcap,
                                        scale)
