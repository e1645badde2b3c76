"""The reference's first training steps, from the same weights and on the
same batches as the program: per step the cross-entropy, the first step's
gradient of every leaf (unclipped) and, after the last step, every leaf's
change from its starting value, each as its norm and, against another
run's (``against``: the program's, or in a calibration the float32
reference's), as the norm of the difference."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..judge import norm
from ..sizes import Sizes
from ..weights import leaves, make_params, named_leaves
from .adamw import adamw_step
from .lm import MOE_AUX_WEIGHT, Model, Products, exact_fp32

__all__ = ["reference_steps"]


def _moments_device(params, device) -> torch.device:
    """Where AdamW's moments live: on the card while two more copies of the
    parameters leave half its free memory, else in host memory."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    need = 2 * sum(p.numel() * 4 for p in params)
    return dev if need < torch.cuda.mem_get_info(dev)[0] / 2 else \
        torch.device("cpu")


def reference_steps(sizes: Sizes, seed: int, batches: List[Dict], opt: dict,
                    device, products: Products = None,
                    against: Optional[Dict[str, list]] = None,
                    keep: bool = False) -> Dict[str, list]:
    """``batches``: one {"inputs", "labels"} of int tensors per step.
    ``against``: {"grad": [...], "change": [...]} host tensors per leaf;
    ``keep``: return this run's own as host tensors too."""
    out: Dict[str, list] = {"loss": []}
    with exact_fp32():
        tree = make_params(sizes, seed, device, torch.float32)
        names, params = zip(*named_leaves(tree))
        for p in params:
            p.requires_grad_(True)
        where = _moments_device(params, device)
        mu = [torch.zeros_like(p, device=where) for p in params]
        nu = [torch.zeros_like(p, device=where) for p in params]
        model = Model(sizes, tree, products)
        for step, batch in enumerate(batches):
            ce, aux = model.loss(batch["inputs"].to(device),
                                 batch["labels"].to(device))
            total = ce + MOE_AUX_WEIGHT * aux if sizes.is_moe else ce
            grads = torch.autograd.grad(total, params)
            out["loss"].append(float(ce.detach()))
            if step == 0:
                _record(out, "grad", grads, against, keep)
            adamw_step(opt, step, [p.data for p in params], list(grads), mu,
                       nu)
            del grads, total, ce, aux
        del mu, nu, model
        for i, (name, p, (name0, p0)) in enumerate(zip(names, params, leaves(
                sizes, seed, device, torch.float32))):
            if name != name0:
                raise ValueError(f"leaf order differs: {name} / {name0}")
            _record(out, "change", [p.detach() - p0], against, keep, i)
    out["names"] = list(names)
    return out


def _record(out, key, tensors, against, keep, index: int = 0) -> None:
    """Norms of ``tensors`` (leaves from ``index`` on) under ``key``; with
    ``against`` the norms of their differences under ``key + "_diff"``;
    with ``keep`` host copies under ``key + "_host"``."""
    for i, x in enumerate(tensors, start=index):
        x = x.detach()
        out.setdefault(key, []).append(norm(x))
        if against is not None:
            other = against[key][i].to(x.device)
            out.setdefault(key + "_diff", []).append(norm(x - other))
        if keep:
            out.setdefault(key + "_host", []).append(x.cpu())
