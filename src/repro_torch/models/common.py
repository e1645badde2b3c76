"""Shared neural building blocks: initializer, RMSNorm, rotary
embeddings, logit soft-capping, chunked cross-entropy. Port of
``repro.models.common``.

Parameters are plain tensors in nested dicts with the JAX package's
layouts (weights ``(in, out)``, used as ``x @ w``), stored in
``param_dtype`` and cast to the compute dtype at use.

On DTensors (a sharded step), the rotary tables, built alike on every
rank, join the activations as replicated DTensors, and the chunked loss
runs vocab-parallel in a local map (:func:`chunked_softmax_xent`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..sharding.local import is_dtensor, op_placements, replicate_like, run_local

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
    angles = replicate_like(angles, x)
    sin, cos = torch.sin(angles), torch.cos(angles)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Standard RoPE. x: (B, S, H, D); positions: (B, S) int."""
    freqs = replicate_like(
        rope_frequencies(x.shape[-1], theta, device=x.device), positions)
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
    if is_dtensor(positions):   # a few ints: every rank takes them all
        positions = positions.full_tensor()
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    # band i takes the position stream its section names
    # (built from the config's ints, not by a repeat whose output size a
    # tensor gives: the dry run's fake tensors hold no values)
    stream_idx = torch.tensor([i for i, n in enumerate(sections)
                               for _ in range(n)], device=x.device)  # (half,)
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


def _xent_chunk(h, unembed, y, final_softcap, v0=0, group=None):
    """(sum of the masked rows' cross-entropy, their count) for one chunk
    of rows. With a ``group``, ``unembed`` is the vocab slice ``[v0, v0 +
    V_local)`` of a vocabulary split over it: the row max, sum of
    exponentials and label logit are reduced over the group."""
    logits = (h @ unembed.to(h.dtype)).float()
    logits = soft_cap(logits, final_softcap)
    if group is None:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, 1, y.clamp_min(0).long()[:, None])[:, 0]
    else:
        m = logits.detach().amax(dim=-1)
        torch.distributed.all_reduce(m, op=torch.distributed.ReduceOp.MAX,
                                     group=group)
        sumexp = torch.exp(logits - m[:, None]).sum(dim=-1)
        local = y.long() - v0
        inside = (local >= 0) & (local < logits.shape[1])
        picked = torch.gather(
            logits, 1, local.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
        picked = torch.where(inside, picked, torch.zeros_like(picked))
        lse = torch.log(_SumOver.apply(sumexp, group)) + m
        picked = _SumOver.apply(picked, group)
    mask = (y >= 0).float()
    return torch.sum((lse - picked) * mask), torch.sum(mask)


def _xent_chunks(hidden, unembed, labels, chunk, final_softcap, v0=0,
                 group=None):
    """The loop of :func:`chunked_softmax_xent` over row chunks of at most
    ``LOSS_CHUNK_ELEMENTS`` logits, each under activation checkpointing in
    grad mode (``v0``, ``group``: :func:`_xent_chunk`'s vocab slice)."""
    chunk = max(1, min(chunk, LOSS_CHUNK_ELEMENTS // unembed.shape[1]))
    loss = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, hidden.shape[0], chunk):
        args = (hidden[c0:c0 + chunk], unembed, labels[c0:c0 + chunk],
                final_softcap, v0, group)
        if torch.is_grad_enabled():
            part, n = checkpoint(_xent_chunk, *args, use_reentrant=False)
        else:
            part, n = _xent_chunk(*args)
        loss = loss + part
        count = count + n
    return loss, count


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

    DTensor inputs run vocab-parallel in a local map: in placements, the
    rows of ``hidden`` and ``labels`` over the FSDP axes where they divide
    and replicated over ``model``, ``unembed``'s vocab over ``model`` where
    it divides and its d_model gathered; each rank takes its rows' logits
    over its vocab slice, in chunks of at most ``LOSS_CHUNK_ELEMENTS`` of
    them, and the row max, sum of exponentials and label logit are reduced
    over ``model`` (the same sum grouped otherwise). Out placements: both
    sums partial over the FSDP axes the rows are split on, else
    replicated. Gradient placements: ``hidden``'s partial over ``model``
    where the vocab is split, ``unembed``'s partial over the FSDP axes the
    rows are split on.
    """
    if is_dtensor(hidden):
        return _vocab_parallel_xent(hidden, unembed, labels, chunk,
                                    final_softcap)
    return _xent_chunks(hidden, unembed, labels, chunk, final_softcap)


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over ``group`` whose backward is the identity: the
    sum is a replicated value every rank of the group goes on with alike,
    so each rank's gradient of its own term is the upstream one."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _vocab_parallel_xent(hidden, unembed, labels, chunk, final_softcap):
    from torch.distributed.tensor import Partial, Replicate

    mesh = hidden.device_mesh
    vocab = unembed.shape[1]
    rows = op_placements(mesh, 0, hidden.shape[0])
    cols = op_placements(mesh, head_dim=1, heads=vocab)
    split = any(p.is_shard() for p in cols)
    group = mesh.get_group("model") if split else None
    sums = tuple(Partial() if r.is_shard() else Replicate() for r in rows)

    def local(h, u, y):
        v0 = mesh.get_local_rank("model") * u.shape[1] if split else 0
        return _xent_chunks(h, u, y, chunk, final_softcap, v0, group)

    h_grad = tuple(Partial() if c.is_shard() else r
                   for r, c in zip(rows, cols))
    u_grad = tuple(Partial() if r.is_shard() else c
                   for r, c in zip(rows, cols))
    return run_local(local, (hidden, unembed, labels), (rows, cols, rows),
                     (sums, sums), mesh,
                     in_grad_placements=(h_grad, u_grad, rows))
