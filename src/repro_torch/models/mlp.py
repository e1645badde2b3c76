"""Dense gated feed-forward blocks. Port of ``repro.models.mlp``: the
SwiGLU block; and Zamba-2's gated exact-GELU block with a low-rank adapter
of its own on the gate-and-up product (:func:`adapted_mlp_forward`)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import truncated_normal

__all__ = ["init_mlp_params", "init_adapter_params", "mlp_forward",
           "adapted_mlp_forward"]


def init_mlp_params(generator: torch.Generator, cfg, dtype=torch.float32,
                    device=None) -> Dict[str, torch.Tensor]:
    m, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": truncated_normal(generator, (m, f), 1.0, dtype, device),
        "w_up": truncated_normal(generator, (m, f), 1.0, dtype, device),
        "w_down": truncated_normal(generator, (f, m), 1.0, dtype, device),
    }


def init_adapter_params(generator: torch.Generator, cfg, dtype=torch.float32,
                        device=None) -> Dict[str, torch.Tensor]:
    """One application's adapter: A (M, rank) and B (rank, 2F), B's first F
    columns adding to the gate, the last F to the up product."""
    m, r, f = cfg.d_model, cfg.adapter_rank, cfg.d_ff
    return {
        "adapter_a": truncated_normal(generator, (m, r), 1.0, dtype, device),
        "adapter_b": truncated_normal(generator, (r, 2 * f), 1.0, dtype,
                                      device),
    }


def mlp_forward(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = F.silu(x @ p["w_gate"].to(dt))
    u = x @ p["w_up"].to(dt)
    return (g * u) @ p["w_down"].to(dt)


def adapted_mlp_forward(p: Dict[str, torch.Tensor], a: torch.Tensor,
                        b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(GELU(x W_gate + x A B[:, :F]) * (x W_up + x A B[:, F:])) W_down: the
    shared block's feed-forward ``p`` with one application's adapter A
    (M, rank), B (rank, 2F) added to its gate-and-up product; the exact
    (erf) GELU, Zamba-2's ``hidden_act``."""
    dt = x.dtype
    f = p["w_gate"].shape[-1]
    low = (x @ a.to(dt)) @ b.to(dt)
    g = F.gelu(x @ p["w_gate"].to(dt) + low[..., :f])
    u = x @ p["w_up"].to(dt) + low[..., f:]
    return (g * u) @ p["w_down"].to(dt)
