"""Plain PyTorch version of the flash-attention kernel: full-softmax GQA
attention with causal/sliding-window masking and logit soft-capping.
Materializes the whole score matrix — the correctness reference, and the
path :func:`..ops.attention` takes for tensors on the CPU.

Port of ``repro.kernels.flash_attention.ref.attention_reference``."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_reference"]


def attention_reference(
    q: torch.Tensor,            # (B, S, H, D)
    k: torch.Tensor,            # (B, T, K, D)
    v: torch.Tensor,            # (B, T, K, D)
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    b, s, h, d = q.shape
    t, nk = k.shape[1], k.shape[2]
    g = h // nk
    qr = q.reshape(b, s, nk, g, d).float()
    scores = torch.einsum("bskgd,btkd->bskgt", qr, k.float()) * (d ** -0.5)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        # aligned ends: query i attends to keys ≤ i + (t - s)
        mask &= cols <= rows + (t - s)
        if window is not None:
            mask &= cols > rows + (t - s) - window
    scores = torch.where(mask[None, :, None, None, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bskgt,btkd->bskgd", p, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)
