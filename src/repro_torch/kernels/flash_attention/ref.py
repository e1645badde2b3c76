"""Plain PyTorch version of the flash-attention kernel: full-softmax GQA
attention with causal/sliding-window masking, logit soft-capping and a
softmax scale (D^-1/2 unless one is given).
Materializes the whole score matrix — the correctness reference, and the
path :func:`..ops.attention` takes for tensors on the CPU, where autograd
differentiates it.

:func:`attention_reference` ports
``repro.kernels.flash_attention.ref.attention_reference``;
:func:`attention_reference_lse` also returns the row log-sum-exp the
CUDA forward writes, and :func:`attention_backward_reference` is the CUDA
backward's algebra step by step (its plain version)."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_backward_reference", "attention_reference",
           "attention_reference_lse"]


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


def _scores(q, k, causal, window, softcap, scale=None):
    """Scaled, soft-capped scores (B, S, K, G, T) in fp32, the visibility
    mask (S, T) and, with a soft-cap, tanh of the scaled scores over it;
    ``scale`` the softmax scale (default D^-1/2)."""
    b, s, h, d = q.shape
    t, nk = k.shape[1], k.shape[2]
    qr = q.reshape(b, s, nk, h // nk, d).float()
    scores = torch.einsum("bskgd,btkd->bskgt", qr, k.float()) * _scale(q,
                                                                       scale)
    th = None
    if softcap is not None:
        th = torch.tanh(scores / softcap)
        scores = softcap * th
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        # aligned ends: query i attends to keys ≤ i + (t - s)
        mask &= cols <= rows + (t - s)
        if window is not None:
            mask &= cols > rows + (t - s) - window
    return scores, mask, th


def _attend(q, k, v, causal, window, softcap, scale=None):
    """(output in q's dtype, masked scores (B, S, K, G, T) fp32)."""
    b, s, h, d = q.shape
    scores, mask, _ = _scores(q, k, causal, window, softcap, scale)
    scores = torch.where(mask[None, :, None, None, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bskgt,btkd->bskgd", p, v.float())
    return out.reshape(b, s, h, d).to(q.dtype), scores


def attention_reference(
    q: torch.Tensor,            # (B, S, H, D)
    k: torch.Tensor,            # (B, T, K, D)
    v: torch.Tensor,            # (B, T, K, D)
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    return _attend(q, k, v, causal, window, softcap, scale)[0]


def attention_reference_lse(
    q: torch.Tensor,            # (B, S, H, D)
    k: torch.Tensor,            # (B, T, K, D)
    v: torch.Tensor,            # (B, T, K, D)
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
):
    """(output in q's dtype, log-sum-exp (B, H, S) fp32 of each row's
    scaled, soft-capped, masked scores)."""
    b, s, h, _ = q.shape
    out, scores = _attend(q, k, v, causal, window, softcap, scale)
    lse = torch.logsumexp(scores, dim=-1).reshape(b, s, h).transpose(1, 2)
    return out, lse.contiguous()


def attention_backward_reference(
    q: torch.Tensor,            # (B, S, H, D)
    k: torch.Tensor,            # (B, T, K, D)
    v: torch.Tensor,            # (B, T, K, D)
    o: torch.Tensor,            # (B, S, H, D), the forward's output
    lse: torch.Tensor,          # (B, H, S), the forward's log-sum-exp
    do: torch.Tensor,           # (B, S, H, D), the gradient of o
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
):
    """(dq, dk, dv) in the inputs' dtypes, computed in fp32 as
    ``csrc/flash_bwd.cu`` computes them: P = exp(s - lse) recomputed on
    visible pairs (0 elsewhere, by selection), Delta = rowsum(dO ∘ O),
    dV = Pᵀ dO, dP = dO Vᵀ, dS = P ∘ (dP − Delta) ∘ (1 − tanh²) with a
    soft-cap, dQ = scale dS K, dK = scale dSᵀ Q, dK and dV summed over
    each GQA group."""
    b, s, h, d = q.shape
    t, nk = k.shape[1], k.shape[2]
    g = h // nk
    scores, mask, th = _scores(q, k, causal, window, softcap, scale)
    lse_r = lse.float().transpose(1, 2).reshape(b, s, nk, g)[..., None]
    p = torch.where(mask[None, :, None, None, :], torch.exp(scores - lse_r),
                    0.0)
    dor = do.reshape(b, s, nk, g, d).float()
    delta = (dor * o.reshape(b, s, nk, g, d).float()).sum(-1)
    dv = torch.einsum("bskgt,bskgd->btkd", p, dor)
    dp = torch.einsum("bskgd,btkd->bskgt", dor, v.float())
    ds = p * (dp - delta[..., None])
    if th is not None:
        ds = ds * (1.0 - th * th)
    scale = _scale(q, scale)
    dq = torch.einsum("bskgt,btkd->bskgd", ds, k.float()) * scale
    dk = torch.einsum("bskgt,bskgd->btkd", ds,
                      q.reshape(b, s, nk, g, d).float()) * scale
    return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
