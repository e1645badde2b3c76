"""The numbers that decide ``correct``, each worked out from what the
program produced and what the plain reference gives on the same inputs;
their limits are in ``limits/<cell>.json``.

Training (the first three steps, through the window's own call):
  * ``loss_rel``: the largest gap between the program's and the
    reference's cross-entropy over the steps, over the reference's;
  * ``grad_rel``: the first step's gradient as the optimizer got it, per
    leaf: the worst gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and its median
    leaf's; the program's norm is read from its first moment after one
    step, ``|mu| / (1 - b1)``, unclipped by the step's reported global
    norm;
  * ``change_rel``: the same gap for each leaf's change from its starting
    value after the three steps, over the leaves whose reference gradient
    is at least a thousandth of the median leaf's (a leaf whose gradient
    is nought to rounding, such as a bias under a softmax, moves under
    AdamW by round-off alone);
  * ``grad_diff`` and ``change_diff``: the same, with the norm of the
    difference of the two leaves in place of the gap between their norms
    (a gap of norms is of second order in an error that is not a scale:
    it tells a half batch from a whole one, not float8 products from
    bf16 ones).
Serving, over the compared requests' served tokens, the gap by which a
served token's reference logit lies below the reference's best logit at
its position (greedy serving):
  * ``gap_max``: the widest;
  * ``gap_mean``: the mean, steadier from seed to seed.
Both: ``talp_invalid``, the number of TALP hierarchies of the window's
report that fail their multiplicative check (limit 0)."""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

__all__ = ["train_numbers", "token_gaps", "gap_numbers", "talp_invalid",
           "MOVING_SHARE"]

MOVING_SHARE = 1e-3


def _rel_worst(prog: Sequence[float], ref: Sequence[float],
               keep: Sequence[bool], scale: Sequence[float] = None) -> float:
    """The worst kept leaf's |prog - ref| over the larger of its reference
    norm (``scale``, by default ``ref``) and the median kept leaf's."""
    scale = ref if scale is None else scale
    rows = [(p, r, n) for p, r, n, k in zip(prog, ref, scale, keep) if k]
    median = sorted(n for _, _, n in rows)[len(rows) // 2]
    return max(abs(p - r) / max(n, median, 1e-30) for p, r, n in rows)


def train_numbers(prog: Dict[str, list], ref: Dict[str, list]
                  ) -> Dict[str, float]:
    """``prog`` and ``ref``: {"loss": per step, "grad": first gradient
    norm per leaf, "change": change norm per leaf}, leaves in one order."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                   ref["loss"]))
    every = [True] * len(ref["grad"])
    median_grad = sorted(ref["grad"])[len(ref["grad"]) // 2]
    moving = [g >= MOVING_SHARE * median_grad for g in ref["grad"]]
    out = {
        "loss_rel": loss,
        "grad_rel": _rel_worst(prog["grad"], ref["grad"], every),
        "change_rel": _rel_worst(prog["change"], ref["change"], moving),
    }
    if "grad_diff" in ref:
        zero = [0.0] * len(ref["grad"])
        out["grad_diff"] = _rel_worst(ref["grad_diff"], zero, every,
                                      ref["grad"])
        out["change_diff"] = _rel_worst(ref["change_diff"], zero, moving,
                                        ref["change"])
    return out


def token_gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per row, the reference's best logit less its logit of ``tokens``:
    logits (B, V) float32, tokens (B,) int."""
    picked = logits.gather(-1, tokens.long()[:, None])[:, 0]
    return logits.max(-1).values - picked


def gap_numbers(gaps: torch.Tensor) -> Dict[str, float]:
    """The serving numbers from every compared token's gap (1-D)."""
    gaps = gaps.double()
    return {"gap_max": float(gaps.max()), "gap_mean": float(gaps.mean())}


def talp_invalid(result) -> int:
    """How many host and device hierarchies of a TALP result fail their
    multiplicative check."""
    bad = 0
    for region in result.regions.values():
        for frame in (region.host, region.device):
            if frame is None:
                continue
            try:
                frame.validate(tol=1e-9)
            except AssertionError:
                bad += 1
            values = [v for v in frame.as_dict().values()
                      if isinstance(v, float)]
            if not all(math.isfinite(v) for v in values):
                bad += 1
    return bad


NORM_CHUNK = 1 << 26


def norm(x: torch.Tensor) -> float:
    """The norm of a leaf, summed in float64 (a float32 sum over a CPU
    tensor of a hundred million elements loses a per cent or more), a
    slice of ``NORM_CHUNK`` elements at a time, so that a leaf of a
    billion elements takes no float64 copy of itself beside the state."""
    flat = x.detach().reshape(-1)
    total = 0.0
    for i in range(0, flat.numel(), NORM_CHUNK):
        total += float(torch.linalg.vector_norm(
            flat[i:i + NORM_CHUNK], dtype=torch.float64)) ** 2
    return math.sqrt(total)
