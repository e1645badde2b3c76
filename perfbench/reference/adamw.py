"""AdamW as the program's configuration states it, written plainly in
float32: a warmup-cosine learning rate, clipping to a global gradient
norm, bias-corrected moments and decoupled weight decay on every leaf."""

from __future__ import annotations

import math
from typing import List

import torch

__all__ = ["learning_rate", "adamw_step"]


def learning_rate(opt: dict, step: int) -> float:
    """The rate at 0-based ``step``."""
    warm = min((step + 1) / max(1, opt["warmup_steps"]), 1.0)
    decay = max(1, opt["total_steps"] - opt["warmup_steps"])
    frac = min(max((step - opt["warmup_steps"]) / decay, 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * frac))
    return opt["lr"] * warm * (opt["min_lr_ratio"]
                               + (1 - opt["min_lr_ratio"]) * cos)


CHUNK = 1 << 26          # elements updated at once


@torch.no_grad()
def adamw_step(opt: dict, step: int, params: List[torch.Tensor],
               grads: List[torch.Tensor], mu: List[torch.Tensor],
               nu: List[torch.Tensor]) -> float:
    """One update in place, a slice of ``CHUNK`` elements at a time (the
    moments may live in host memory); returns the global gradient norm."""
    gnorm = math.sqrt(sum(float(torch.linalg.vector_norm(g)) ** 2
                          for g in grads))
    scale = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9))
    lr = learning_rate(opt, step)
    b1c = 1.0 - opt["b1"] ** (step + 1)
    b2c = 1.0 - opt["b2"] ** (step + 1)
    for p, g, m, v in zip(params, grads, mu, nu):
        pf, gf, mf, vf = (t.reshape(-1) for t in (p, g, m, v))
        for a in range(0, pf.numel(), CHUNK):
            pc, gc = pf[a:a + CHUNK], gf[a:a + CHUNK] * scale
            mc = mf[a:a + CHUNK].to(pc.device)
            vc = vf[a:a + CHUNK].to(pc.device)
            mc.mul_(opt["b1"]).add_(gc, alpha=1 - opt["b1"])
            vc.mul_(opt["b2"]).add_(gc * gc, alpha=1 - opt["b2"])
            upd = (mc / b1c) / ((vc / b2c).sqrt() + opt["eps"])
            pc.sub_(lr * (upd + opt["weight_decay"] * pc))
            if mc.data_ptr() != mf[a:a + CHUNK].data_ptr():
                mf[a:a + CHUNK].copy_(mc)
                vf[a:a + CHUNK].copy_(vc)
    return gnorm
