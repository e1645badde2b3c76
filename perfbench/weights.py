"""Random weights from a seed, in the tree and layouts the program's
``repro_torch.models.lm`` takes: ``embed``, ``slots/slot<i>`` (each
pattern slot's block parameters stacked over repeats), ``shared`` (the one
parameter set every ``shared_attn`` slot applies), ``final_norm`` and
``unembed``; weights ``(in, out)``.

The distributions follow the program's own initialiser (a truncated
normal cut at two standard deviations, scaled by one over the square root
of the unstacked leaf's first dimension; zeros for norm scales,
``dt_bias`` and ``a_log``, ones for ``d_skip``) in all but two things,
which GPT-2 and Megatron-LM initialise so too: the embedding has unit
scale, and the output projection of every residual branch (``attn/wo``,
``mlp/w_down``, ``moe/w_down``, ``ssm/wo``) is scaled down by the square
root of twice the layer count. Under the program's own scales a deep
random model is chaotic: its bf16 and float32 evaluations part on most
served tokens and on a tenth of a leaf's gradient, as far as a float8
evaluation does, so no comparison could tell a sound program from a
lower precision (``PERF.md``). Each leaf is drawn in one call on
the device from one ``torch.Generator`` seeded by ``--seed``, in the
tree's order, so :func:`leaves` gives the same values again one leaf at
a time (the training comparison's starting point) without holding a
second copy of the tree."""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

from .sizes import Sizes

__all__ = ["leaf_specs", "leaves", "make_params", "named_leaves",
           "tree_from_leaves"]

# (path, shape, init, std): init is "normal", "zeros" or "ones"
Spec = Tuple[str, Tuple[int, ...], str, float]
# the output projections of the residual branches
BRANCH_OUTPUTS = ("attn/wo", "mlp/w_down", "moe/w_down", "ssm/wo")


def _attn_block(s: Sizes, stack: Tuple[int, ...]) -> list:
    m, hd = s.d_model, s.head_dim
    h, k = s.num_heads, s.num_kv_heads
    out = [
        ("ln1", stack + (m,), "zeros", 1),
        ("attn/wq", stack + (m, h * hd), "normal", m),
        ("attn/wk", stack + (m, k * hd), "normal", m),
        ("attn/wv", stack + (m, k * hd), "normal", m),
        ("attn/wo", stack + (h * hd, m), "normal", h * hd),
    ]
    if s.is_moe:
        ep, f = s.experts_physical, s.moe_d_ff
        out += [
            ("ln2", stack + (m,), "zeros", 1),
            ("moe/router", stack + (m, s.num_experts), "normal", m),
            # the program's initialiser scales by the unstacked leaf's
            # first dimension, here the expert count
            ("moe/w_gate", stack + (ep, m, f), "normal", ep),
            ("moe/w_up", stack + (ep, m, f), "normal", ep),
            ("moe/w_down", stack + (ep, f, m), "normal", ep),
        ]
    elif s.d_ff:
        out += [
            ("ln2", stack + (m,), "zeros", 1),
            ("mlp/w_gate", stack + (m, s.d_ff), "normal", m),
            ("mlp/w_up", stack + (m, s.d_ff), "normal", m),
            ("mlp/w_down", stack + (s.d_ff, m), "normal", s.d_ff),
        ]
    return out


def _ssm_block(s: Sizes, stack: Tuple[int, ...]) -> list:
    m, d_in, h = s.d_model, s.ssm_d_inner, s.ssm_heads
    gn, dc = s.ssm_groups * s.ssm_state, s.ssm_conv
    return [
        ("ln", stack + (m,), "zeros", 1),
        ("ssm/wz", stack + (m, d_in), "normal", m),
        ("ssm/wx", stack + (m, d_in), "normal", m),
        ("ssm/wb", stack + (m, gn), "normal", m),
        ("ssm/wc", stack + (m, gn), "normal", m),
        ("ssm/wdt", stack + (m, h), "normal", m),
        ("ssm/dt_bias", stack + (h,), "zeros", 1),
        ("ssm/a_log", stack + (h,), "zeros", 1),
        ("ssm/d_skip", stack + (h,), "ones", 1),
        ("ssm/conv_x", stack + (dc, d_in), "normal", dc),
        ("ssm/conv_b", stack + (dc, gn), "normal", dc),
        ("ssm/conv_c", stack + (dc, gn), "normal", dc),
        ("ssm/norm", stack + (d_in,), "zeros", 1),
        ("ssm/wo", stack + (d_in, m), "normal", d_in),
    ]


def leaf_specs(s: Sizes) -> List[Spec]:
    """Every leaf of the tree, in the order it is drawn, with the standard
    deviation of a normal one."""
    branch = 1.0 / math.sqrt(2 * s.num_layers)
    return [(path, shape, init,
             (1.0 if path == "embed" else 1.0 / math.sqrt(fan))
             * (branch if path.endswith(BRANCH_OUTPUTS) else 1.0))
            for path, shape, init, fan in _fan_in_specs(s)]


def _fan_in_specs(s: Sizes) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """Every leaf with the fan-in the program's initialiser scales by."""
    specs = [("embed", (s.padded_vocab, s.d_model), "normal",
              s.padded_vocab)]
    for i, kind in enumerate(s.pattern):
        if kind == "shared_attn":
            continue
        block = (_ssm_block if kind == "ssm" else _attn_block)(
            s, (s.repeats,))
        specs += [(f"slots/slot{i}/{p}", shape, init, fan)
                  for p, shape, init, fan in block]
    if "shared_attn" in s.pattern:
        specs += [(f"shared/{p}", shape, init, fan)
                  for p, shape, init, fan in _attn_block(s, ())]
    specs += [("final_norm", (s.d_model,), "zeros", 1),
              ("unembed", (s.d_model, s.padded_vocab), "normal", s.d_model)]
    return specs


def leaves(s: Sizes, seed: int, device, dtype) -> Iterator[Tuple[str,
                                                                 torch.Tensor]]:
    """(path, tensor) of every leaf in order, drawn in fp32 on ``device``
    and stored in ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for path, shape, init, std in leaf_specs(s):
        if init == "normal":
            x = torch.empty(shape, dtype=torch.float32, device=device)
            torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
            x = x.mul_(std).to(dtype)
        elif init == "zeros":
            x = torch.zeros(shape, dtype=dtype, device=device)
        else:
            x = torch.ones(shape, dtype=dtype, device=device)
        yield path, x


def tree_from_leaves(pairs) -> Dict:
    tree: Dict = {}
    for path, x in pairs:
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = x
    return tree


def make_params(s: Sizes, seed: int, device, dtype) -> Dict:
    """The whole tree, in ``dtype`` on ``device``."""
    return tree_from_leaves(leaves(s, seed, device, dtype))


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str,
                                                           torch.Tensor]]:
    """(path, tensor) of a nested dict's tensors, in insertion order."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from named_leaves(v, path)
        else:
            yield path, v
