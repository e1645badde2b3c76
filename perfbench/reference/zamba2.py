"""Plain PyTorch reference of Zamba-2's hybrid language model (Zyphra's
Zamba2, arXiv:2411.15242; the published modelling code is
``transformers``' ``Zamba2ForCausalLM``), in float32 with TF32 off, and
its weights, first training steps and operation count, for cells whose
configuration names ``"reference": "zamba2"``.

The model, written from the published equations and not from the
program's code: a token embedding e and a residual stream x = e; layers
of ``pattern`` repeated, where an ``ssm`` layer is

    x ← x + Mamba2(RMSNorm(x))

and a ``zamba_hybrid`` layer is application r of shared block
b = r mod ``shared_blocks``:

    u  = RMSNorm_2M([x ; e])                  (the block's ln_in)
    q, k, v = u W_q, u W_k, u W_v; RoPE on all D of q and k
    a  = softmax(q kᵀ (D / 2)^-1/2, causal) v W_o
    g  = RMSNorm_M(a)                         (ln_ff; no residual)
    [γ ; υ] = g [W_gate ; W_up] + (g A_r) B_r
    T  = ((GELU(γ) ⊙ υ) W_down) L_r           (exact GELU)
    x ← x + Mamba2_r(RMSNorm_r(x + T))

then a final RMSNorm and the output projection. Mamba2 is the Mamba-2
mixer: z, x, B, C and dt projections, a depthwise causal conv of width 4
with SiLU over x, B and C, softplus(dt + dt_bias), A = -exp(A_log), the
SSD recurrence with the D skip (B and C shared by groups of H / G heads),
the gated RMSNorm of y ⊙ SiLU(z) per group of d_inner / G channels, and
the output projection.

Departures from the published model, each also in the configuration's
file: RMSNorm eps 1e-6 with scale 1 + w (w starts at 0) in place of
1e-5 with w starting at 1 (the Mamba mixer's gated norm too, whose eps
the published code fixes at 1e-5); no conv bias; an output projection of
its own (the published head is tied to the embedding); the vocabulary's
rows padded to a multiple of 256; dt is not clamped below at
``time_step_min`` (the published CUDA path, with ``time_step_limit``
null, clamps nothing; the plain ``torch_forward`` clamps at 0.001); and
the layer order is the pattern's period repeated (the published 81
layers put the first hybrids at 6 and 11 and end on three Mamba layers).

Weights (:func:`leaf_specs`) follow ``perfbench/weights.py``'s rules in
the program's tree: a truncated normal cut at two standard deviations,
scaled by one over the square root of the unstacked leaf's first
dimension; zeros for norm scales, ``dt_bias`` and ``a_log``; ones for
``d_skip``; unit scale for the embedding; and each Mamba layer's output
projection ``ssm/wo``, the one residual branch, scaled down by the square
root of twice the layer count. The shared blocks' ``attn/wo`` and
``mlp/w_down`` keep the fan-in scale: their outputs are normed (``a``) or
enter only the Mamba layer's normed input (T), never the stream itself.

It imports nothing of the program and nothing of JAX."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..sizes import Sizes
from ..weights import _ssm_block, named_leaves, tree_from_leaves
from .adamw import adamw_step
from .lm import (Products, attention, causal_conv, exact_fp32, rms_norm,
                 rope, ssd)
from .train import _moments_device, _record

__all__ = ["Hybrid", "ModelFlops", "Model", "bind", "leaf_specs", "leaves",
           "make_params", "reference_steps"]


@dataclass(frozen=True)
class Hybrid:
    """The sizes of the ``zamba_hybrid`` kind that ``Sizes`` does not
    hold, from the configuration's ``port`` section."""

    shared_blocks: int
    adapter_rank: int

    @classmethod
    def of(cls, port: dict) -> "Hybrid":
        return cls(port["shared_blocks"], port["adapter_rank"])


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
def _application(s: Sizes, z: Hybrid, stack) -> list:
    """A ``zamba_hybrid`` slot's own leaves: its Mamba-2 layer (the ``ssm``
    kind's leaves), L_r and the adapter."""
    m, f, r = s.d_model, s.d_ff, z.adapter_rank
    return _ssm_block(s, stack) + [
        ("proj", stack + (m, m), "normal", m),
        ("adapter_a", stack + (m, r), "normal", m),
        ("adapter_b", stack + (r, 2 * f), "normal", r),
    ]


def _shared_block(s: Sizes, z: Hybrid, stack) -> list:
    a, m, f = 2 * s.d_model, s.d_model, s.d_ff
    hq, hk = s.num_heads * s.head_dim, s.num_kv_heads * s.head_dim
    return [
        ("ln_in", stack + (a,), "zeros", 1),
        ("attn/wq", stack + (a, hq), "normal", a),
        ("attn/wk", stack + (a, hk), "normal", a),
        ("attn/wv", stack + (a, hk), "normal", a),
        ("attn/wo", stack + (hq, m), "normal", hq),
        ("ln_ff", stack + (m,), "zeros", 1),
        ("mlp/w_gate", stack + (m, f), "normal", m),
        ("mlp/w_up", stack + (m, f), "normal", m),
        ("mlp/w_down", stack + (f, m), "normal", f),
    ]


def leaf_specs(s: Sizes, z: Hybrid) -> List[Tuple[str, Tuple[int, ...], str,
                                                 float]]:
    """Every leaf (path, shape, init, std of a normal one) in the order it
    is drawn."""
    specs = [("embed", (s.padded_vocab, s.d_model), "normal", None)]
    for i, kind in enumerate(s.pattern):
        block = (_ssm_block(s, (s.repeats,)) if kind == "ssm" else
                 _application(s, z, (s.repeats,)))
        specs += [(f"slots/slot{i}/{p}", *rest) for p, *rest in block]
    specs += [(f"shared_blocks/{p}", *rest)
              for p, *rest in _shared_block(s, z, (z.shared_blocks,))]
    specs += [("final_norm", (s.d_model,), "zeros", 1),
              ("unembed", (s.d_model, s.padded_vocab), "normal", s.d_model)]
    branch = 1.0 / math.sqrt(2 * s.num_layers)
    return [(path, shape, init,
             1.0 if fan is None else
             (branch if path.endswith("ssm/wo") else 1.0) / math.sqrt(fan))
            for path, shape, init, fan in specs]


def leaves(s: Sizes, z: Hybrid, seed: int, device,
           dtype) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf in order, each drawn in one call in
    fp32 on ``device`` from one generator seeded by ``seed``, stored in
    ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for path, shape, init, std in leaf_specs(s, z):
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


def make_params(s: Sizes, z: Hybrid, seed: int, device, dtype) -> Dict:
    return tree_from_leaves(leaves(s, z, seed, device, dtype))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def group_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                   groups: int) -> torch.Tensor:
    """RMSNorm over each of ``groups`` equal parts of the last dim, with
    the one scale 1 + w."""
    split = lambda t: t.unflatten(-1, (groups, -1))  # noqa: E731
    return rms_norm(split(x), split(scale)).flatten(-2)


class Model:
    """The reference over a float32 weight tree of :func:`make_params`."""

    def __init__(self, sizes: Sizes, hybrid: Hybrid, params: Dict,
                 products: Products = None):
        self.s, self.z, self.p = sizes, hybrid, params
        self.mm = products or Products()

    def _row(self, tree, r: int):
        return {k: self._row(v, r) if isinstance(v, dict) else v[r]
                for k, v in tree.items()}

    def _mamba(self, bp, x):
        """Mamba2(RMSNorm(x)) of the layer ``bp`` (its ``ln`` and ``ssm``)."""
        s = self.s
        b, n, _ = x.shape
        sp = bp["ssm"]
        h = rms_norm(x, bp["ln"])
        z = self.mm.mm(h, sp["wz"])
        tail = lambda c: x.new_zeros((b, s.ssm_conv - 1, c))  # noqa: E731
        conv = {name: causal_conv(self.mm.mm(h, sp[w]), sp[name],
                                  tail(sp[name].shape[-1]))
                for name, w in (("conv_x", "wx"), ("conv_b", "wb"),
                                ("conv_c", "wc"))}
        dt = F.softplus(self.mm.mm(h, sp["wdt"]) + sp["dt_bias"])
        g = s.ssm_groups
        y, _ = ssd(conv["conv_x"].reshape(b, n, s.ssm_heads, s.ssm_head_dim),
                   dt, -torch.exp(sp["a_log"]),
                   conv["conv_b"].reshape(b, n, g, s.ssm_state),
                   conv["conv_c"].reshape(b, n, g, s.ssm_state),
                   sp["d_skip"], x.new_zeros((b, s.ssm_heads, s.ssm_head_dim,
                                              s.ssm_state)), s.ssm_chunk)
        y = group_rms_norm(y.reshape(b, n, -1) * F.silu(z), sp["norm"], g)
        return self.mm.mm(y, sp["wo"])

    def shared_out(self, sb, bp, x, e):
        """T of one application: shared block ``sb``, the application's
        adapter and projection in ``bp``."""
        s = self.s
        b, n, _ = x.shape
        u = rms_norm(torch.cat([x, e], dim=-1), sb["ln_in"])
        heads = lambda t, h: t.reshape(b, n, h, s.head_dim)  # noqa: E731
        q = rope(heads(self.mm.mm(u, sb["attn"]["wq"]), s.num_heads), 0,
                 s.rope_theta)
        k = rope(heads(self.mm.mm(u, sb["attn"]["wk"]), s.num_kv_heads), 0,
                 s.rope_theta)
        v = heads(self.mm.mm(u, sb["attn"]["wv"]), s.num_kv_heads)
        # Zamba-2's softmax scale (D/2)^-1/2 is sqrt(2) times the D^-1/2
        # that lm.attention applies: the factor goes on q, in float32
        o = attention(q * math.sqrt(2.0), k, v, 0)
        g = rms_norm(self.mm.mm(o.reshape(b, n, -1), sb["attn"]["wo"]),
                     sb["ln_ff"])
        low = self.mm.mm(self.mm.mm(g, bp["adapter_a"]), bp["adapter_b"])
        mp, f = sb["mlp"], s.d_ff
        gate = self.mm.mm(g, mp["w_gate"]) + low[..., :f]
        up = self.mm.mm(g, mp["w_up"]) + low[..., f:]
        y = self.mm.mm(F.gelu(gate) * up, mp["w_down"])
        return self.mm.mm(y, bp["proj"])

    def _layer(self, r: int, i: int, kind: str, app: int, x, e):
        bp = self._row(self.p["slots"][f"slot{i}"], r)
        if kind == "ssm":
            return x + self._mamba(bp, x)
        sb = self._row(self.p["shared_blocks"], app % self.z.shared_blocks)
        return x + self._mamba(bp, x + self.shared_out(sb, bp, x, e))

    def hidden(self, tokens: torch.Tensor, remat: bool = False):
        """The final normed hidden state (B, S, M); ``remat`` recomputes
        each layer in the backward."""
        x = self.p["embed"][tokens.long()]
        e, app = x, 0
        for r in range(self.s.repeats):
            for i, kind in enumerate(self.s.pattern):
                if remat:
                    x = checkpoint(self._layer, r, i, kind, app, x, e,
                                   use_reentrant=False)
                else:
                    x = self._layer(r, i, kind, app, x, e)
                app += kind == "zamba_hybrid"
        return rms_norm(x, self.p["final_norm"])

    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """Every position's logits over the padded vocabulary (B, S, V)."""
        return self.mm.mm(self.hidden(tokens), self.p["unembed"])

    def loss(self, inputs: torch.Tensor, labels: torch.Tensor):
        """The mean cross-entropy over the padded vocabulary."""
        h = self.hidden(inputs, remat=True)
        logits = self.mm.mm(h, self.p["unembed"]).reshape(
            -1, self.s.padded_vocab)
        return F.cross_entropy(logits, labels.reshape(-1).long())


# ---------------------------------------------------------------------------
# the first training steps
# ---------------------------------------------------------------------------
def reference_steps(sizes: Sizes, hybrid: Hybrid, seed: int,
                    batches: List[Dict], opt: dict, device,
                    products: Products = None,
                    against: Optional[Dict[str, list]] = None,
                    keep: bool = False) -> Dict[str, list]:
    """As ``reference/train.py``'s: per step the cross-entropy, the first
    step's gradient of every leaf (unclipped) and each leaf's change after
    the last step, each as its norm, against ``against`` as the norm of
    the difference, with ``keep`` as host tensors too."""
    out: Dict[str, list] = {"loss": []}
    with exact_fp32():
        tree = make_params(sizes, hybrid, seed, device, torch.float32)
        names, params = zip(*named_leaves(tree))
        for p in params:
            p.requires_grad_(True)
        where = _moments_device(params, device)
        mu = [torch.zeros_like(p, device=where) for p in params]
        nu = [torch.zeros_like(p, device=where) for p in params]
        model = Model(sizes, hybrid, tree, products)
        for step, batch in enumerate(batches):
            ce = model.loss(batch["inputs"].to(device),
                            batch["labels"].to(device))
            grads = torch.autograd.grad(ce, params)
            out["loss"].append(float(ce.detach()))
            if step == 0:
                _record(out, "grad", grads, against, keep)
            adamw_step(opt, step, [p.data for p in params], list(grads), mu,
                       nu)
            del grads, ce
        del mu, nu, model
        for i, (name, p, (name0, p0)) in enumerate(zip(names, params, leaves(
                sizes, hybrid, seed, device, torch.float32))):
            if name != name0:
                raise ValueError(f"leaf order differs: {name} / {name0}")
            _record(out, "change", [p.detach() - p0], against, keep, i)
    out["names"] = list(names)
    return out


# ---------------------------------------------------------------------------
# operations
# ---------------------------------------------------------------------------
def _attention_flops(s: Sizes, b: int, t: int) -> float:
    """One application's attention, forward and backward, by the frozen
    formulas of ``work/flash.py``."""
    from ..work.flash import attention_backward_work, attention_work

    args = (b, t, t, s.num_heads, s.num_kv_heads, s.head_dim, None,
            torch.bfloat16)
    return attention_work(*args)[0] + attention_backward_work(*args)[0]


def _scan_flops(s: Sizes, b: int, t: int) -> float:
    """One Mamba layer's SSD scan, forward and backward, by the frozen
    formulas of ``work/ssd.py``."""
    from ..work.ssd import ssd_backward_work, ssd_work

    args = (b, t, s.ssm_heads, s.ssm_head_dim, s.ssm_groups, s.ssm_state,
            s.ssm_chunk, torch.bfloat16, False)
    return ssd_work(*args)[0] + ssd_backward_work(*args)[0]


class ModelFlops:
    """The model's operations per training step: three times the
    forward's weight products (the backward twice) and, for attention and
    the scan, the forward and the backward by their formulas; remat's
    recomputed forward is not counted. A ``zamba_hybrid`` layer counts its
    Mamba layer, its L_r and adapter, and the shared block's products and
    attention at every application."""

    def __init__(self, hybrid: Hybrid):
        self.z = hybrid

    def mamba_params(self, s: Sizes) -> int:
        m, gn = s.d_model, s.ssm_groups * s.ssm_state
        return 2 * m * s.ssm_d_inner + 2 * m * gn + m * s.ssm_heads \
            + s.ssm_d_inner * m

    def shared_params(self, s: Sizes) -> int:
        a, m, f = 2 * s.d_model, s.d_model, s.d_ff
        hq, hk = s.num_heads * s.head_dim, s.num_kv_heads * s.head_dim
        return a * hq + 2 * a * hk + hq * m + 3 * m * f

    def application_params(self, s: Sizes) -> int:
        """L_r and the adapter (A_r, B_r) of one application."""
        m, r = s.d_model, self.z.adapter_rank
        return m * m + r * (m + 2 * s.d_ff)

    def applications(self, s: Sizes) -> int:
        return s.repeats * sum(k == "zamba_hybrid" for k in s.pattern)

    def body_params(self, s: Sizes) -> int:
        """Weight parameters one token passes through in all the layers."""
        apps = self.applications(s)
        return (s.num_layers * self.mamba_params(s)
                + apps * (self.application_params(s) + self.shared_params(s)))

    def train_step(self, s: Sizes, batch: int, seq: int) -> float:
        dense = 6.0 * (self.body_params(s) + s.d_model * s.padded_vocab) \
            * batch * seq
        return (dense + self.applications(s) * _attention_flops(s, batch, seq)
                + s.num_layers * _scan_flops(s, batch, seq))


def bind(port: dict) -> dict:
    """The four names ``drivers/train.py`` draws on (``make_params``,
    ``leaves``, ``reference_steps``, ``model_flops``), with the hybrid's
    own sizes from ``port`` bound in and the signatures of
    ``perfbench/weights.py``, ``reference/train.py`` and
    ``work/model_flops.py``."""
    z = Hybrid.of(port)

    def make(s, seed, device, dtype):
        return make_params(s, z, seed, device, dtype)

    def draw(s, seed, device, dtype):
        return leaves(s, z, seed, device, dtype)

    def steps(s, seed, batches, opt, device, products=None, against=None,
              keep=False):
        return reference_steps(s, z, seed, batches, opt, device, products,
                               against, keep)

    return {"make_params": make, "leaves": draw, "reference_steps": steps,
            "model_flops": ModelFlops(z)}
