"""AdamW with a warmup-cosine schedule and global-norm clipping. Port of
``repro.optim.adamw``.

The optimizer state is a tree shaped like the parameters (``mu``,
``nu``) plus a step ``count``. The update is the JAX version's arithmetic,
in place on the parameters and moments (the JAX version builds new
arrays; the values are the same). It is not ``torch.optim.AdamW``, whose
schedule and clipping differ.

The dispatch is by device only, as the kernels' wrappers do: CUDA leaves
go to the hand-written fused pair (``kernels.adamw``: one multi-tensor
pass for the global norm, one for the update, the clip's scale computed
on the device), which launches or raises; CPU leaves take the plain
version, the same arithmetic written out as tensor ops, leaf by leaf
(:func:`adamw_update_reference`, which runs on any device: on the card it
is the kernels' reference). A fake tensor (the dry run's) goes to the
kernels on any device, which count their work and launch nothing. There
is no switch and no fallback. The schedule, the step count and the bias
corrections stay on the host either way.

``grad_dtype="bfloat16"`` casts the gradients to bf16 before the norm and
the update, as the JAX version does before its data-parallel reduction.

With a DTensor state (a sharded step), each gradient is first
redistributed to its parameter's placements (a gradient that autograd
returns partial over the FSDP axes is reduce-scattered, as GSPMD inserts
it), so no in-place op runs on a partial tensor; the update, elementwise
over identically placed tensors, then runs on each rank's shards. The
global norm sums each rank's squares, a replicated shard counted by one
rank of its replicas, and is reduced once over the process group, which
the mesh spans (``launch.mesh.make_mesh``): on the card the norm pass's
sum of squares is that partial.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels.adamw import kernel as _fused
from ..kernels.fake import is_fake
from ..sharding.local import is_dtensor

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update",
           "adamw_update_reference", "update_leaf"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    grad_dtype: Optional[str] = None        # e.g. "bfloat16" (compression)


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def init_opt_state(params) -> Dict[str, Any]:
    """Zero moments shaped like ``params`` and a step count of 0 (an int32
    scalar on the CPU: the schedule is computed on the host)."""
    return {
        "mu": _map(torch.zeros_like, params),
        "nu": _map(torch.zeros_like, params),
        "count": torch.zeros((), dtype=torch.int32),
    }


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (fp32 arithmetic, as the JAX version)."""
    step = step.to(torch.float32)
    warm = torch.clamp_max((step + 1) / max(1, cfg.warmup_steps), 1.0)
    decay_steps = max(1, cfg.total_steps - cfg.warmup_steps)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _norm_terms(grads):
    """Each gradient leaf's local tensor, whether this rank counts its
    squares, and the mesh (None without DTensors): a shard held by several
    ranks (replicated over a mesh dim) counts once, on the ranks at
    coordinate 0 of those dims."""
    terms, mesh = [], None
    for g in _leaves(grads):
        counted = True
        if is_dtensor(g):
            mesh = g.device_mesh
            coord = mesh.get_coordinate()
            counted = all(c == 0 for c, p in zip(coord, g.placements)
                          if not p.is_shard())
            g = g.to_local()
        terms.append((g, counted))
    return terms, mesh


def _global_norm(grads) -> torch.Tensor:
    terms, mesh = _norm_terms(grads)
    total = None
    for g, counted in terms:
        sq = torch.sum(torch.square(g.to(torch.float32)))
        if not counted:
            sq = torch.zeros_like(sq)
        total = sq if total is None else total + sq
    if mesh is not None:   # a mesh spans the process group (make_mesh)
        torch.distributed.all_reduce(total)
    return torch.sqrt(total)


def _as_placed(g, p):
    """``g`` redistributed to ``p``'s placements when both are DTensors."""
    if not is_dtensor(p):
        return g
    if tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def _prepare(cfg: AdamWConfig, params, grads, opt_state):
    """The gradients cast and placed as the update takes them, the new
    step count, the learning rate and, as host floats, the rate and the
    bias corrections."""
    if cfg.grad_dtype is not None:
        grads = _map(lambda g: g.to(getattr(torch, cfg.grad_dtype)), grads)
    grads = _map(_as_placed, grads, params)
    count = opt_state["count"] + 1
    lr = _schedule(cfg, opt_state["count"])
    b1c = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** count.float()
    b2c = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** count.float()
    return grads, count, lr, (float(lr), float(b1c), float(b2c))


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig, params, grads, opt_state
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step. Updates ``params`` and the moments of ``opt_state``
    in place and returns (params, new opt state, {"grad_norm", "lr"}).
    ``grads`` may be in another dtype than ``params`` (the bf16 gradients
    of a bf16 forward); each is widened to fp32 element by element. CPU
    leaves take :func:`adamw_update_reference`; any other leaves the fused
    kernels, which raise for what they do not take."""
    first = _local(next(_leaves(params)))
    if first.device.type == "cpu" and not is_fake(first):
        return adamw_update_reference(cfg, params, grads, opt_state)
    grads, count, lr, (lr_f, b1c_f, b2c_f) = _prepare(cfg, params, grads,
                                                      opt_state)
    terms, mesh = _norm_terms(grads)
    sumsq = _fused.adamw_norm([g for g, counted in terms if counted],
                              device=first.device)
    if mesh is not None:   # a mesh spans the process group (make_mesh)
        torch.distributed.all_reduce(sumsq)
    # each rank's shards, paired by key as the plain version pairs them
    quads = []
    _map(lambda *leaf: quads.append([_local(t) for t in leaf]),
         params, grads, opt_state["mu"], opt_state["nu"])
    ps, gs, mus, nus = zip(*quads)
    gnorm = _fused.adamw_update(
        ps, gs, mus, nus, sumsq, lr=lr_f, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
        weight_decay=cfg.weight_decay, grad_clip=cfg.grad_clip,
        b1c=b1c_f, b2c=b2c_f)
    new_state = {"mu": opt_state["mu"], "nu": opt_state["nu"], "count": count}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def adamw_update_reference(
    cfg: AdamWConfig, params, grads, opt_state
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """:func:`adamw_update` as plain tensor ops, leaf by leaf, on any
    device: the CPU path, and on the card the fused kernels' reference."""
    grads, count, lr, (lr_f, b1c_f, b2c_f) = _prepare(cfg, params, grads,
                                                      opt_state)
    gnorm = _global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    _map(lambda p, g, mu, nu: update_leaf(cfg, p, g, mu, nu, scale, lr_f,
                                          b1c_f, b2c_f),
         params, grads, opt_state["mu"], opt_state["nu"])
    new_state = {"mu": opt_state["mu"], "nu": opt_state["nu"], "count": count}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


def update_leaf(cfg: AdamWConfig, p, g, mu, nu, scale, lr: float, b1c: float,
                b2c: float) -> None:
    """The plain version's update of one leaf, in place on ``p``, ``mu``
    and ``nu``: the gradient times the clip's ``scale``, the learning rate
    ``lr`` and the bias corrections ``b1c``, ``b2c`` of the step."""
    # identically placed DTensors: each rank's shards
    p, g, mu, nu = (_local(t) for t in (p, g, mu, nu))
    # two fp32 temporaries of the leaf's size: g (then the denominator)
    # and the step
    g = g.to(torch.float32) * scale
    mu.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    nu.mul_(cfg.b2).add_(g.square_(), alpha=1 - cfg.b2)
    denom = torch.div(nu, b2c, out=g).sqrt_().add_(cfg.eps)
    step = torch.div(mu, b1c).div_(denom)
    step.add_(p, alpha=cfg.weight_decay)
    p.sub_(step, alpha=lr)
