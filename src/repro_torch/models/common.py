"""Shared neural building blocks: initializer, RMSNorm, rotary
embeddings, logit soft-capping, chunked cross-entropy. Port of
``repro.models.common``.

Parameters are plain tensors in nested dicts with the JAX package's
layouts (weights ``(in, out)``, used as ``x @ w``), stored in
``param_dtype`` and cast to the compute dtype at use.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

__all__ = [
    "truncated_normal",
    "rms_norm",
    "soft_cap",
    "rope_frequencies",
    "apply_rope",
    "apply_mrope",
    "chunked_softmax_xent",
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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: Sequence[int],
                theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL multimodal rotary embedding (M-RoPE).

    The half-dim frequency bands are split into ``sections`` (e.g.
    (16, 24, 24) = temporal/height/width for D=128) and each section
    rotates by its own position stream. x: (B, S, H, D); positions:
    (3, B, S) int. With the stub frontend all three streams are the same
    ``arange``, and M-RoPE equals RoPE.
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} must sum to {half}")
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    # band i takes the position stream its section names
    stream_idx = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(list(sections), device=x.device))          # (half,)
    pos_per_band = positions.float()[stream_idx]              # (half, B, S)
    angles = pos_per_band.movedim(0, -1)[..., None, :] * freqs  # (B,S,1,half)
    return _rotate(x, angles)


# At most this many fp32 logits in one chunk of chunked_softmax_xent. The
# configs' loss_chunk counts tokens (16384); at gemma2-2b's 256,000-word
# vocabulary one 8192-token chunk holds 7.8 GiB of logits a copy, and its
# soft-cap and gradients take three more beside a 47.7 GiB train state,
# over an 80 GB card. 2^29 (2 GiB a copy) leaves every other config's
# chunk on the card as the config sizes it (llama3.2-3b's 2 x 2048 tokens
# at 128,256 words is 525 M).
LOSS_CHUNK_ELEMENTS = 1 << 29


def _xent_chunk(h, unembed, y, final_softcap):
    logits = (h @ unembed.to(h.dtype)).float()
    logits = soft_cap(logits, final_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, 1, y.clamp_min(0).long()[:, None])[:, 0]
    mask = (y >= 0).float()
    return torch.sum((lse - picked) * mask), torch.sum(mask)


def chunked_softmax_xent(
    hidden: torch.Tensor,
    unembed: torch.Tensor,
    labels: torch.Tensor,
    chunk: int = 16384,
    final_softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy over a large vocabulary without materializing the
    full (tokens, vocab) logits tensor.

    hidden: (T, M); unembed: (M, V); labels: (T,) int (-1 = masked).
    Loops over token chunks; per-chunk logits are fp32. Returns (sum_loss,
    token_count), both fp32. The JAX version pads the tokens to a multiple
    of ``chunk`` with masked rows; here the last chunk is shorter instead,
    which gives the same sum and gradient without building the padded
    rows. Under grad mode each chunk runs under activation checkpointing,
    so one chunk's logits are alive at a time. A chunk is also cut to
    ``LOSS_CHUNK_ELEMENTS`` logits (a different grouping of the same sum).
    """
    chunk = max(1, min(chunk, LOSS_CHUNK_ELEMENTS // unembed.shape[1]))
    loss = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, hidden.shape[0], chunk):
        args = (hidden[c0:c0 + chunk], unembed, labels[c0:c0 + chunk],
                final_softcap)
        if torch.is_grad_enabled():
            part, n = checkpoint(_xent_chunk, *args, use_reentrant=False)
        else:
            part, n = _xent_chunk(*args)
        loss = loss + part
        count = count + n
    return loss, count
