"""Plain PyTorch versions of the Mamba-2 mixer's causal depthwise conv and
its SiLU: the forward as ``repro.models.ssm`` computes it, and its
backward written out in closed form.

:func:`causal_conv` is the plain version of the CUDA kernels
(``csrc/conv.cu``), the path :func:`..ops.causal_conv_silu` takes for
tensors on the CPU, and decode's one-token conv on every device
(``models/ssm.py`` calls it as ``_causal_conv``). Summed in x's dtype in
the JAX package's order (tap 0 first), every op rounded where XLA rounds
it, so bf16 agrees with the JAX package; float64 inputs make it a more
exact evaluation of the same function, the kernels' yardstick on the card.

:func:`causal_conv_silu_backward_reference` is the backward of
``causal_conv`` (without a tail) from its definition, not produced by
autograd, in float64:

    s[t]  = sum_{i<K} w[i] x[t - K + 1 + i]          (x before t = 0 is 0)
    y[t]  = s[t] sigmoid(s[t])
    ds[t] = dy[t] sig (1 + s (1 - sig)),            sig = sigmoid(s[t])
    dx[t] = sum_i w[i] ds[t + K - 1 - i]            (ds past L - 1 is 0)
    dw[i] = sum_{b, t} ds[t] x[t - K + 1 + i]
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["causal_conv", "causal_conv_silu_backward_reference", "silu"]


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA evaluates it, x * (1 / (1 + exp(-x))) with
    every op rounded to x's dtype, so bf16 rounds where the JAX package
    does (``F.silu`` rounds once, which moves about a third of bf16
    outputs by one ulp)."""
    return x * (1 / (1 + torch.exp(-x)))


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SiLU of the depthwise causal conv. x: (B, L, C); w: (K, C); tail:
    (B, K-1, C) carries context across calls (decode). Summed in x's
    dtype in the JAX package's order (i = 0..K-1), so bf16 rounds where
    JAX does."""
    k = w.shape[0]
    if tail is None:
        # zeros before the sequence (a concatenation, not F.pad: torch
        # 2.11's DTensor gives a pad's output one placement whatever the
        # mesh's dims)
        xp = torch.cat([x.new_zeros((x.shape[0], k - 1, x.shape[2])), x],
                       dim=1)
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
    # windows: out[:, t] = sum_i w[i] * xp[:, t + i]
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i: i + x.shape[1], :] * w[i].to(x.dtype)
    return silu(out)


def causal_conv_silu_backward_reference(
        x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``causal_conv(x, w)`` from dy, the gradient of its
    output, by the formulas of the module docstring, in float64 (the
    result is float64 whatever the inputs' dtype)."""
    x, w, dy = x.double(), w.double(), dy.double()
    k, length = w.shape[0], x.shape[1]
    pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([pad, x], dim=1)
    s = sum(xp[:, i: i + length] * w[i] for i in range(k))
    sig = torch.sigmoid(s)
    ds = dy * sig * (1 + s * (1 - sig))
    dsp = torch.cat([ds, pad], dim=1)
    dx = sum(dsp[:, k - 1 - i: k - 1 - i + length] * w[i] for i in range(k))
    dw = torch.stack([(ds * xp[:, i: i + length]).sum((0, 1))
                      for i in range(k)])
    return dx, dw
