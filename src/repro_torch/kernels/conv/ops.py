"""Dispatching wrapper for the Mamba-2 mixer's causal conv + SiLU.

A CUDA tensor goes to the hand-written kernels (:mod:`.kernel`), which
launch or raise: through :class:`.kernel.CausalConvSilu`, whose backward
is the CUDA backward, when grad mode is on, and straight to
:func:`.kernel.causal_conv_fwd` when it is off (prefill). A CPU tensor
goes to the plain version (:func:`.ref.causal_conv`, unchanged), which
autograd differentiates. A fake tensor (the dry run's) goes to the
kernels on any device, which count their work and launch nothing
(``kernels.fake``). There is no fallback from the first to the second and
no ``impl`` switch.

DTensor inputs (a sharded step) run in a local map
(``repro_torch.sharding.local``): the conv is independent per batch row
and per channel, so each input keeps its batch split over the FSDP axes
and its channels split over ``model`` where it has them (its weight then
split alike), and is gathered on any other split (the sequence, a partial
sum). The weights' gradients come back partial over the axes the batch is
split on."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ...sharding.local import is_dtensor, replicate_like, run_local
from ..fake import is_fake
from . import kernel as _kernel
from . import ref as _ref

__all__ = ["causal_conv_silu"]


def _layout(x):
    """(placements of x, of its weight, of the weight's gradient) for a
    DTensor x (B, L, C): the batch split kept (the weight whole, its
    gradient partial), the channels' split kept (the weight's alike), any
    other placement replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    xp, wp, gp = [], [], []
    for p in x.placements:
        if p.is_shard(0):
            xp.append(Shard(0))
            wp.append(Replicate())
            gp.append(Partial())
        elif p.is_shard(2):
            xp.append(Shard(2))
            wp.append(Shard(1))
            gp.append(Shard(1))
        else:
            xp.append(Replicate())
            wp.append(Replicate())
            gp.append(Replicate())
    return tuple(xp), tuple(wp), tuple(gp)


def causal_conv_silu(xs: Sequence[torch.Tensor],
                     ws: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """``ref.causal_conv(x, w)`` for each x (B, L, C_x) of ``xs`` and its
    weight w (K, C_x) of ``ws``, the weights taken in x's dtype: the plain
    version on the CPU, one launch of the kernels on the card."""
    xs, ws = tuple(xs), tuple(ws)
    n = len(xs)
    if any(is_dtensor(x) for x in xs):
        layouts = [_layout(x) for x in xs]
        return run_local(
            lambda *t: causal_conv_silu(t[:n], t[n:]),
            xs + tuple(replicate_like(w, x) for w, x in zip(ws, xs)),
            [lay[0] for lay in layouts] + [lay[1] for lay in layouts],
            tuple(lay[0] for lay in layouts), xs[0].device_mesh,
            in_grad_placements=tuple([lay[0] for lay in layouts]
                                     + [lay[2] for lay in layouts]))
    if xs[0].device.type == "cpu" and not is_fake(xs[0]):
        return tuple(_ref.causal_conv(x, w) for x, w in zip(xs, ws))
    ws = tuple(w.to(x.dtype) for w, x in zip(ws, xs))
    if torch.is_grad_enabled():
        return _kernel.CausalConvSilu.apply(*xs, *ws)
    return _kernel.causal_conv_fwd(xs, ws)
