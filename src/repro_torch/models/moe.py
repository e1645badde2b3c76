"""Top-k Mixture-of-Experts with GShard-style einsum dispatch/combine.
Port of ``repro.models.moe``, with the same parameter tree and the same
arithmetic, step by step.

Tokens are reshaped into dispatch groups of ``moe_group_size`` (the
largest divisor of the token count that is no larger); each group routes
its tokens to ``num_experts_per_token`` experts under a per-group
capacity ``C = ceil(S·k/E · capacity_factor)`` (tokens over capacity are
dropped: the gate weight is zeroed and the residual carries them).
Dispatch and combine are dense one-hot einsums, built in the compute
dtype (GShard, arXiv:2006.16668; Switch, arXiv:2101.03961). The Switch
load-balancing auxiliary loss (§2.2) is returned for training.

Top-k breaks ties toward the lower expert index, as ``jax.lax.top_k``
does, through a stable descending sort: ``torch.topk`` picks otherwise
on ties (equal bf16 router probabilities are common at full width), and
a routing that differs from the reference's on ties is a different
model. The expert weights are cast to the compute dtype and, as in the
JAX package's ``_gathered_weight``, a DTensor weight takes the layout the
launcher pins (``act_sharding.moe_weight_sharding``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..sharding.act_sharding import constrain_to, current_moe_specs
from ..sharding.local import gather_dims, replicate_like
from .common import truncated_normal

__all__ = ["init_moe_params", "moe_forward", "moe_capacity", "route",
           "dispatch_tensors", "expert_ffn", "top_k"]


def init_moe_params(generator: torch.Generator, cfg, dtype=torch.float32,
                    device=None) -> Dict[str, torch.Tensor]:
    m, f = cfg.d_model, cfg.moe_d_ff
    e = cfg.num_experts
    ep = cfg.moe_experts_physical   # ≥ e; extra experts are never routed
    return {
        "router": truncated_normal(generator, (m, e), 1.0, dtype, device),
        "w_gate": truncated_normal(generator, (ep, m, f), 1.0, dtype, device),
        "w_up": truncated_normal(generator, (ep, m, f), 1.0, dtype, device),
        "w_down": truncated_normal(generator, (ep, f, m), 1.0, dtype, device),
    }


def moe_capacity(cfg, group_size: int) -> int:
    c = math.ceil(
        group_size * cfg.num_experts_per_token / cfg.num_experts
        * cfg.capacity_factor
    )
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values of the last axis and their indices, in
    descending order, equal values in ascending index order: the order of
    ``jax.lax.top_k``."""
    with torch.no_grad():
        indices = torch.sort(x, dim=-1, descending=True,
                             stable=True).indices[..., :k]
    # the values gathered at the indices, the same as the sort's: the
    # gradient then flows through a gather, whose backward DTensor takes
    # (torch 2.11's cannot take the sort's, a scatter into a plain tensor)
    return torch.gather(x, -1, indices), indices


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    classes = replicate_like(torch.arange(n, device=idx.device), idx)
    return (idx[..., None] == classes).to(dtype)


def route(cfg, router: torch.Tensor, xg: torch.Tensor):
    """Routing of the token groups ``xg`` (g, gs, M) in fp32: (router
    probabilities (g, gs, e), the top-k probabilities renormalised over the
    k chosen (g, gs, k), the chosen experts (g, gs, k), their one-hots
    (g, gs, k, ep) fp32, and each assignment's capacity slot (g, gs, k)
    int32: the assignments to the same expert before it in the group, in
    token-major order; one at or past the capacity is dropped)."""
    ep = cfg.moe_experts_physical   # one-hot width (padded experts are
    #                                 dead: the router has no logit for them)
    g, gs, _ = xg.shape
    k = cfg.num_experts_per_token
    logits = (xg @ router.to(xg.dtype)).float()                   # (g,gs,e)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k(probs, k)                                 # (g,gs,k)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # --- capacity assignment: earlier tokens (and lower k) win ---
    eh = _one_hot(top_i, ep, torch.float32)                       # (g,gs,k,ep)
    # flatten (token, k) token-major (the GShard priority) and count
    # earlier assignments to the same expert:
    ehf = eh.reshape(g, gs * k, ep)
    pos = torch.cumsum(ehf, dim=1) - ehf                          # (g,gs*k,ep)
    pos_k = torch.sum(pos * ehf, dim=-1).reshape(g, gs, k)
    return probs, top_p, top_i, eh, pos_k.to(torch.int32)


def dispatch_tensors(eh: torch.Tensor, pos_k: torch.Tensor,
                     top_p: torch.Tensor, capacity: int, cdt):
    """The one-hot dispatch and combine tensors (g, gs, ep, C) in the
    compute dtype ``cdt``: an assignment past the capacity is dropped, and
    combine carries each kept assignment's gate (its renormalised top-k
    probability). These are the fattest MoE intermediates (tokens × E ×
    C), built directly in the compute dtype."""
    keep = (pos_k < capacity).to(torch.float32)
    gate = top_p * keep
    ch = _one_hot(pos_k, capacity, cdt)                           # (g,gs,k,c)
    eh_c = eh.to(cdt)
    dispatch = torch.einsum("gske,gskc->gsec",
                            eh_c * keep[..., None].to(cdt), ch)
    combine = torch.einsum("gske,gskc->gsec",
                           eh_c * gate[..., None].to(cdt), ch)
    return dispatch, combine


def _gathered_weight(w: torch.Tensor, cdt, which: str) -> torch.Tensor:
    """An expert weight cast to the compute dtype, at the compute-time
    layout the launcher pins (``moe_weight_sharding``: the FSDP-sharded
    d_model dim gathered, the expert or d_ff dim kept sharded) when it is
    a DTensor; else just cast."""
    w = w.to(cdt)
    specs = current_moe_specs()
    if specs is not None:
        w = constrain_to(w, specs[0] if which in ("gate", "up") else specs[1])
    return w


def expert_ffn(p: Dict[str, torch.Tensor], xin: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its capacity slots: xin (g, ep, C, M) →
    (g, ep, C, M), in xin's dtype."""
    cdt = xin.dtype
    w_gate = _gathered_weight(p["w_gate"], cdt, "gate")    # (ep, M, f)
    w_up = _gathered_weight(p["w_up"], cdt, "up")          # (ep, M, f)
    w_down = _gathered_weight(p["w_down"], cdt, "down")    # (ep, f, M)
    h_gate = F.silu(torch.einsum("gecm,emf->gecf", xin, w_gate))
    h_up = torch.einsum("gecm,emf->gecf", xin, w_up)
    return torch.einsum("gecf,efm->gecm", h_gate * h_up, w_down)


def moe_forward(cfg, p: Dict[str, torch.Tensor],
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, M) → (y (B, S, M) in x.dtype, aux loss fp32 scalar)."""
    b, s, m = x.shape
    e = cfg.num_experts
    tokens = b * s
    gs = min(cfg.moe_group_size, tokens)
    while tokens % gs != 0:   # fall back to the largest divisor group
        gs -= 1
    g = tokens // gs
    c = moe_capacity(cfg, gs)
    cdt = x.dtype
    xg = x.reshape(g, gs, m)

    # --- routing (fp32) and capacity slots ---
    probs, top_p, top_i, eh, pos_k = route(cfg, p["router"], xg)
    dispatch, combine = dispatch_tensors(eh, pos_k, top_p, c, cdt)

    # --- expert computation (compute dtype) ---
    xin = torch.einsum("gsm,gsec->gecm", xg, dispatch)
    out = expert_ffn(p, xin)
    # the combine contracts (expert, slot) as one dim: a product over the
    # folded pair, of which only the leading (expert) dim may stay sharded
    # (torch 2.11's DTensor folds no other sharded dim)
    e_c = out.shape[1] * out.shape[2]
    y = torch.bmm(gather_dims(combine, (3,)).reshape(g, gs, e_c),
                  gather_dims(out, (2,)).reshape(g, e_c, m))

    # --- Switch load-balance aux loss (over the e *logical* experts) ---
    frac_tokens = torch.mean(eh[..., :e].sum(2), dim=1)           # (g,e)
    frac_probs = torch.mean(probs, dim=1)                         # (g,e)
    aux = e * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))

    return y.reshape(b, s, m), aux
