"""Dense SwiGLU feed-forward block. Port of ``repro.models.mlp``."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import truncated_normal

__all__ = ["init_mlp_params", "mlp_forward"]


def init_mlp_params(generator: torch.Generator, cfg, dtype=torch.float32,
                    device=None) -> Dict[str, torch.Tensor]:
    m, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": truncated_normal(generator, (m, f), 1.0, dtype, device),
        "w_up": truncated_normal(generator, (m, f), 1.0, dtype, device),
        "w_down": truncated_normal(generator, (f, m), 1.0, dtype, device),
    }


def mlp_forward(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = F.silu(x @ p["w_gate"].to(dt))
    u = x @ p["w_up"].to(dt)
    return (g * u) @ p["w_down"].to(dt)
