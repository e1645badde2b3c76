"""Shared neural building blocks: initializer, RMSNorm, rotary
embeddings, logit soft-capping. Port of ``repro.models.common``.

Parameters are plain tensors in nested dicts with the JAX package's
layouts (weights ``(in, out)``, used as ``x @ w``), stored in
``param_dtype`` and cast to the compute dtype at use.
``apply_mrope`` and ``chunked_softmax_xent`` come with the slices that
need them (Qwen2-VL, training).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

__all__ = [
    "truncated_normal",
    "rms_norm",
    "soft_cap",
    "rope_frequencies",
    "apply_rope",
]


def truncated_normal(generator: torch.Generator, shape: Sequence[int],
                     scale: float, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """Fan-in scaled truncated-normal initializer (standard normal cut at
    ±2, times ``scale / sqrt(shape[0])``), drawn in fp32 on ``device``
    from ``generator`` and cast to ``dtype``."""
    stddev = scale / math.sqrt(max(1, shape[0]))
    x = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return x.mul_(stddev).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 accumulation; returns x.dtype."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def soft_cap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings, shape (head_dim//2,)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Apply rotation given per-(pos, half-dim) angles; the two halves of
    the head dim are the pairs (half-split, not interleaved).

    x: (..., S, H, D); angles: broadcastable to (..., S, 1, D/2).
    """
    dtype = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    sin, cos = torch.sin(angles), torch.cos(angles)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Standard RoPE. x: (B, S, H, D); positions: (B, S) int."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None, None].float() * freqs      # (B,S,1,D/2)
    return _rotate(x, angles)
