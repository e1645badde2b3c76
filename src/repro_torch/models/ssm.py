"""Mamba-2 mixer block (SSD core + projections, causal conv, gated norm).
Port of ``repro.models.ssm``.

Separate projections for z (gate), x, B, C and dt, a short causal
depthwise conv over x/B/C, the SSD recurrence, a gated RMSNorm and the
output projection. Decode carries (conv tails, SSD state) per layer. With
``ssm_groups`` G > 1 (B and C shared by groups of H / G heads) the gated
norm is taken per group of d_inner / G channels, as mamba_ssm's
``RMSNormGated(group_size=d_inner // ngroups)`` takes it; at G 1 it is the
norm over all of d_inner, the JAX package's.

Both branches of :func:`ssm_forward` go through
:func:`repro_torch.kernels.conv.ops.causal_conv_silu` (the conv and its
SiLU over x, B and C in one call) and
:func:`repro_torch.kernels.ssd.ops.ssd`: the hand-written CUDA kernels for
tensors on the card, their plain versions for tensors on the CPU. The
conv's plain version, :func:`repro_torch.kernels.conv.ref.causal_conv`,
is this module's ``_causal_conv`` and decode's one-token conv on every
device. The training branch (``build_cache=False``) differentiates end to
end: on the card through the CUDA backwards (``CausalConvSilu``,
``SSDScan``), on the CPU by autograd through the plain versions. Prefill
(``build_cache=True``) asks the same call for the final state, where the
JAX package calls ``ssd_reference`` directly because its Pallas kernel
has no final-state output; the function computed is the same.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels.conv import ops as conv_ops
from ..kernels.conv.ref import causal_conv as _causal_conv
from ..kernels.conv.ref import silu as _silu
from ..kernels.ssd import ops as ssd_ops
from ..sharding.local import merge_last, split_last
from .common import rms_norm, truncated_normal

__all__ = ["init_ssm_params", "ssm_forward", "init_ssm_cache", "ssm_decode",
           "gated_norm"]


def init_ssm_params(generator: torch.Generator, cfg, dtype=torch.float32,
                    device=None) -> Dict[str, torch.Tensor]:
    """Random block parameters in the JAX package's tree. Each weight is
    its own draw (the JAX package draws ``wdt`` and ``wo`` from one key)."""
    m = cfg.d_model
    d_in = cfg.ssm_d_inner
    h = cfg.ssm_heads
    gn = cfg.ssm_groups * cfg.ssm_state
    dc = cfg.ssm_conv

    def tn(shape):
        return truncated_normal(generator, shape, 1.0, dtype, device)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "wz": tn((m, d_in)),
        "wx": tn((m, d_in)),
        "wb": tn((m, gn)),
        "wc": tn((m, gn)),
        "wdt": tn((m, h)),
        "dt_bias": full((h,), 0.0),
        "a_log": full((h,), 0.0),            # A = -exp(a_log) = -1
        "d_skip": full((h,), 1.0),
        "conv_x": tn((dc, d_in)),
        "conv_b": tn((dc, gn)),
        "conv_c": tn((dc, gn)),
        "norm": full((d_in,), 0.0),
        "wo": tn((d_in, m)),
    }


def _project(cfg, p, h):
    cdt = h.dtype
    z = h @ p["wz"].to(cdt)
    x = h @ p["wx"].to(cdt)
    b = h @ p["wb"].to(cdt)
    c = h @ p["wc"].to(cdt)
    dt = F.softplus((h @ p["wdt"].to(cdt)).float() + p["dt_bias"].float())
    return z, x, b, c, dt


def _decay_rates(p) -> torch.Tensor:
    return -torch.exp(p["a_log"].float())


def gated_norm(cfg, y: torch.Tensor, z: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """RMSNorm of y * silu(z) over all of d_inner at G 1 (the JAX
    package's); per group of d_inner / G channels at G > 1."""
    g = cfg.ssm_groups
    if g == 1:
        return rms_norm(y * _silu(z), scale)
    return rms_norm((y * _silu(z)).unflatten(-1, (g, -1)),
                    scale.unflatten(-1, (g, -1))).flatten(-2)


def ssm_forward(cfg, p: Dict[str, torch.Tensor], h: torch.Tensor,
                build_cache: bool = False):
    """Full-sequence forward. h: (B, L, M) (post-norm input).

    With ``build_cache`` also returns the decode carry (final SSD state +
    conv tails), for the prefill→decode handoff of SSM layers.
    """
    nh, g = cfg.ssm_heads, cfg.ssm_groups
    k = cfg.ssm_conv
    z, x_raw, b_raw, c_raw, dt = _project(cfg, p, h)
    x, b, c = conv_ops.causal_conv_silu(
        (x_raw, b_raw, c_raw), (p["conv_x"], p["conv_b"], p["conv_c"]))
    out = ssd_ops.ssd(
        split_last(x, nh), dt, _decay_rates(p),
        split_last(b, g), split_last(c, g),
        chunk=cfg.ssm_chunk, d_skip=p["d_skip"].float(),
        return_final_state=build_cache,
    )
    y, state = out if build_cache else (out, None)
    y = gated_norm(cfg, merge_last(y), z, p["norm"])
    out = y @ p["wo"].to(y.dtype)
    if not build_cache:
        return out
    cdt = getattr(torch, cfg.compute_dtype)
    cache = {
        "state": state,
        "conv_x": x_raw[:, -(k - 1):].to(cdt),
        "conv_b": b_raw[:, -(k - 1):].to(cdt),
        "conv_c": c_raw[:, -(k - 1):].to(cdt),
    }
    return out, cache


def init_ssm_cache(cfg, batch: int, dtype=torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
    d_in = cfg.ssm_d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    k = cfg.ssm_conv
    return {
        "state": torch.zeros(
            (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, k - 1, d_in), dtype=dtype,
                              device=device),
        "conv_b": torch.zeros((batch, k - 1, gn), dtype=dtype, device=device),
        "conv_c": torch.zeros((batch, k - 1, gn), dtype=dtype, device=device),
    }


def ssm_decode(
    cfg, p: Dict[str, torch.Tensor], h: torch.Tensor,
    cache: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. h: (B, 1, M). Returns (out, new cache); the new
    state and conv tails are new tensors and ``cache`` is not modified
    (the caller writes them back where it keeps the cache)."""
    nh, g = cfg.ssm_heads, cfg.ssm_groups
    z, x, b, c, dt = _project(cfg, p, h)
    new_cache = dict(cache)
    outs = {}
    for name, val in (("conv_x", x), ("conv_b", b), ("conv_c", c)):
        tail = cache[name]
        outs[name] = _causal_conv(val, p[name], tail=tail)
        new_cache[name] = torch.cat([tail[:, 1:], val.to(tail.dtype)], dim=1)
    x, b, c = outs["conv_x"], outs["conv_b"], outs["conv_c"]
    y, state = ssd_ops.decode_step(
        split_last(x[:, 0], nh),
        dt[:, 0],
        _decay_rates(p),
        split_last(b[:, 0], g),
        split_last(c[:, 0], g),
        cache["state"],
        d_skip=p["d_skip"].float(),
    )
    new_cache["state"] = state
    y = merge_last(y).unsqueeze(1)   # (B, 1, d_inner)
    y = gated_norm(cfg, y, z, p["norm"])
    return y @ p["wo"].to(y.dtype), new_cache
