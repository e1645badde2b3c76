"""Plain PyTorch reference of the program's language model, in float32.

It follows the program's equations, written here from them and not taken
from its code: RMSNorm (eps 1e-6, scale 1 + w), rotary embeddings on the
two halves of each head, causal softmax attention with grouped KV heads,
a SwiGLU MLP, the Mamba-2 block (projections, a depthwise causal conv of
width 4 with SiLU, the SSD recurrence in its chunked form, a gated RMSNorm
and the output projection), the top-k MoE with the program's capacity
rule (groups of ``moe_group_size`` tokens or the largest divisor of the
token count below it, capacity ceil(gs·k/E·cf) rounded up to a multiple
of 4, earlier tokens and earlier choices first, ties to the lower expert,
the chosen probabilities renormalised, tokens over capacity dropped) and
its Switch load-balancing loss, and a Zamba-2 shared block (one parameter
set applied at every ``shared_attn`` slot).

It takes the weight tree of ``perfbench/weights.py`` (the program's
layout) and imports nothing of the program. Products run in float32 with
TF32 off (:func:`exact_fp32`); :class:`Products` with ``fp8=True`` rounds
both operands of every weight product to float8 e4m3 first (one scale per
tensor), the control that a correct comparison must fail. Attention and
the SSD recurrence run on the host's own blocks of rows so that the
reference fits on the card: attention in blocks of rows and queries of at
most 2^27 scores, the scan a chunk at a time. Serving runs with a
cache of its own, prefill then one token at a time, so that an MoE groups
its tokens as the program's decode does (the whole batch's one token
each)."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..sizes import Sizes

__all__ = ["Products", "Model", "exact_fp32", "MOE_AUX_WEIGHT", "EPS"]

EPS = 1e-6
MOE_AUX_WEIGHT = 0.01
SCORES = 1 << 27            # attention scores held at once
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its largest magnitude
    to 448), back in float32; the gradient passes straight through."""
    scale = FP8_MAX / x.detach().abs().amax().clamp_min(1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach()


class Products:
    """The weight products: float32, or with float8 operands."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, eq: str, a: torch.Tensor, w: torch.Tensor):
        if self.fp8:
            a, w = _fp8(a), _fp8(w)
        return torch.einsum(eq, a, w)

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self("...i,io->...o", a, w)


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * (
        1.0 + scale)


def rope(x: torch.Tensor, pos0: int, theta: float) -> torch.Tensor:
    """x (B, S, H, D) at positions pos0 .. pos0 + S - 1."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    pos = torch.arange(pos0, pos0 + x.shape[1], dtype=torch.float32,
                       device=x.device)
    ang = (pos[:, None] * freqs)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * ang.cos() - x2 * ang.sin(),
                      x2 * ang.cos() + x1 * ang.sin()], dim=-1)


def attention(q, k, v, pos0: int) -> torch.Tensor:
    """Causal attention of q (B, S, H, D) at positions pos0.. over k, v
    (B, T, K, D) at positions 0..T-1; (B, S, H, D). Rows and queries go in
    blocks of at most ``SCORES`` scores."""
    b, s, h, d = q.shape
    t = k.shape[1]
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    kpos = torch.arange(t, device=q.device)
    qb = max(1, min(s, SCORES // (h * t)))
    rb = max(1, SCORES // (h * qb * t))
    rows = []
    for r0 in range(0, b, rb):
        blocks = []
        for q0 in range(0, s, qb):
            qs = q[r0:r0 + rb, q0:q0 + qb] * d ** -0.5          # (r,q,H,D)
            qpos = torch.arange(pos0 + q0, pos0 + q0 + qs.shape[1],
                                device=q.device)
            sc = torch.einsum("bqhd,bthd->bhqt", qs, k[r0:r0 + rb])
            sc = sc.masked_fill(kpos > qpos[:, None], -math.inf)
            blocks.append(torch.einsum("bhqt,bthd->bqhd", sc.softmax(-1),
                                       v[r0:r0 + rb]))
        rows.append(torch.cat(blocks, 1))
    return torch.cat(rows, 0)


def causal_conv(x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor):
    """Depthwise causal conv of x (B, L, C) with w (K, C) after ``tail``
    (B, K-1, C) of earlier inputs; SiLU of the sum."""
    xp = torch.cat([tail, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(w.shape[0]))
    return F.silu(out)


def ssd(x, dt, a, bm, cm, d_skip, state, chunk: int):
    """The SSD recurrence s_t = exp(dt_t a) s_{t-1} + dt_t x_t B_tᵀ,
    y_t = s_t C_t + D x_t, evaluated a chunk at a time in its dual form:
    x (B, L, H, P), dt (B, L, H), a (H,), bm/cm (B, L, G, N), state
    (B, H, P, N). Returns (y (B, L, H, P), final state)."""
    h = x.shape[2]
    bm = bm.repeat_interleave(h // bm.shape[2], dim=2)
    cm = cm.repeat_interleave(h // cm.shape[2], dim=2)
    ys = []
    for c0 in range(0, x.shape[1], chunk):
        xs, dts = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        bs, cs = bm[:, c0:c0 + chunk], cm[:, c0:c0 + chunk]
        q = xs.shape[1]
        acum = torch.cumsum(dts * a, dim=1)                        # (B,Q,H)
        later = torch.ones((q, q), dtype=torch.bool,
                           device=x.device).triu(1)[None, :, :, None]
        decay = torch.exp((acum[:, :, None] - acum[:, None, :])
                          .masked_fill(later, -math.inf))          # (B,Q,Q,H)
        scores = torch.einsum("bihn,bjhn->bijh", cs, bs) * decay
        xdt = xs * dts[..., None]
        y = torch.einsum("bijh,bjhp->bihp", scores, xdt)
        y = y + torch.einsum("bihn,bhpn->bihp", cs, state) * torch.exp(
            acum)[..., None]
        ys.append(y + xs * d_skip[:, None])
        to_end = torch.exp(acum[:, -1:] - acum)                     # (B,Q,H)
        state = state * torch.exp(acum[:, -1])[..., None, None] + torch.einsum(
            "bjhp,bjhn->bhpn", xdt * to_end[..., None], bs)
    return torch.cat(ys, dim=1), state


class Model:
    """The reference over a float32 weight tree in the program's layout."""

    def __init__(self, sizes: Sizes, params: Dict, products: Products = None):
        self.s = sizes
        self.p = params
        self.mm = products or Products()

    # -- blocks ------------------------------------------------------------
    def _block_params(self, r: int, i: int, kind: str):
        if kind == "shared_attn":
            return self.p["shared"]

        def row(tree):
            return {k: row(v) if isinstance(v, dict) else v[r]
                    for k, v in tree.items()}

        return row(self.p["slots"][f"slot{i}"])

    def _attn(self, bp, x, pos0: int, cache):
        s = self.s
        b, n, _ = x.shape
        h = rms_norm(x, bp["ln1"])
        split = lambda t, heads: t.reshape(b, n, heads, s.head_dim)  # noqa
        q = rope(split(self.mm.mm(h, bp["attn"]["wq"]), s.num_heads), pos0,
                 s.rope_theta)
        k = rope(split(self.mm.mm(h, bp["attn"]["wk"]), s.num_kv_heads),
                 pos0, s.rope_theta)
        v = split(self.mm.mm(h, bp["attn"]["wv"]), s.num_kv_heads)
        if cache is not None:
            if "k" in cache:
                k = torch.cat([cache["k"], k], dim=1)
                v = torch.cat([cache["v"], v], dim=1)
            cache["k"], cache["v"] = k, v
        o = attention(q, k, v, pos0).reshape(b, n, -1)
        x = x + self.mm.mm(o, bp["attn"]["wo"])
        aux = x.new_zeros(())
        if s.is_moe:
            y, aux = self._moe(bp["moe"], rms_norm(x, bp["ln2"]))
            x = x + y
        elif s.d_ff:
            h = rms_norm(x, bp["ln2"])
            mp = bp["mlp"]
            x = x + self.mm.mm(F.silu(self.mm.mm(h, mp["w_gate"]))
                               * self.mm.mm(h, mp["w_up"]), mp["w_down"])
        return x, aux

    def _moe(self, mp, x):
        s = self.s
        b, n, m = x.shape
        tokens = b * n
        gs = min(s.moe_group_size, tokens)
        while tokens % gs:
            gs -= 1
        e, k = s.num_experts, s.top_k
        cap = math.ceil(gs * k / e * s.capacity_factor)
        cap = max(4, -(-cap // 4) * 4)
        xg = x.reshape(-1, gs, m)
        probs = self.mm("gsm,me->gse", xg, mp["router"]).softmax(-1)
        choice = torch.sort(probs.detach(), dim=-1, descending=True,
                            stable=True).indices[..., :k]          # (g,gs,k)
        gate = probs.gather(-1, choice)
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        # each choice's place in its expert's queue, token-major order
        flat = choice.reshape(xg.shape[0], gs * k)
        onehot = F.one_hot(flat, e)
        place = (onehot.cumsum(1) - onehot).gather(-1, flat[..., None])
        kept = (place[..., 0] < cap).reshape(choice.shape)
        weight = torch.zeros_like(probs).scatter_add(
            -1, choice, gate * kept)                                # (g,gs,e)
        # every expert on every token of a block, weighted by its gate
        xt, wt = xg.reshape(tokens, m), weight.reshape(tokens, e)
        out = []
        for t0 in range(0, tokens, 1024):
            xb = xt[t0:t0 + 1024]
            hg = self.mm("tm,emf->tef", xb, mp["w_gate"][:e])
            hu = self.mm("tm,emf->tef", xb, mp["w_up"][:e])
            y = self.mm("tef,efm->tem", F.silu(hg) * hu, mp["w_down"][:e])
            out.append(torch.einsum("tem,te->tm", y, wt[t0:t0 + 1024]))
        chosen = F.one_hot(choice, e).sum(2).float()                # (g,gs,e)
        aux = e * (chosen.mean(1) * probs.mean(1)).sum(-1).mean()
        return torch.cat(out).reshape(b, n, m), aux

    def _ssm(self, bp, x, cache):
        s = self.s
        b, n, _ = x.shape
        sp = bp["ssm"]
        h = rms_norm(x, bp["ln"])
        z = self.mm.mm(h, sp["wz"])
        raw = {name: self.mm.mm(h, sp[w]) for name, w in
               (("conv_x", "wx"), ("conv_b", "wb"), ("conv_c", "wc"))}
        dt = F.softplus(self.mm.mm(h, sp["wdt"]) + sp["dt_bias"])
        conv = {}
        for name, val in raw.items():
            tail = (cache[name] if cache is not None and name in cache else
                    val.new_zeros((b, s.ssm_conv - 1, val.shape[-1])))
            conv[name] = causal_conv(val, sp[name], tail)
            if cache is not None:
                cache[name] = torch.cat([tail, val], 1)[:, -(s.ssm_conv - 1):]
        state = (cache["state"] if cache is not None and "state" in cache
                 else x.new_zeros((b, s.ssm_heads, s.ssm_head_dim,
                                   s.ssm_state)))
        g = s.ssm_groups
        y, state = ssd(
            conv["conv_x"].reshape(b, n, s.ssm_heads, s.ssm_head_dim), dt,
            -torch.exp(sp["a_log"]),
            conv["conv_b"].reshape(b, n, g, s.ssm_state),
            conv["conv_c"].reshape(b, n, g, s.ssm_state),
            sp["d_skip"], state, s.ssm_chunk)
        if cache is not None:
            cache["state"] = state
        y = rms_norm(y.reshape(b, n, -1) * F.silu(z), sp["norm"])
        return x + self.mm.mm(y, sp["wo"])

    def _layer(self, r, i, kind, x, pos0, cache):
        bp = self._block_params(r, i, kind)
        if kind == "ssm":
            return self._ssm(bp, x, cache), x.new_zeros(())
        return self._attn(bp, x, pos0, cache)

    # -- the stack ---------------------------------------------------------
    def hidden(self, tokens: torch.Tensor, pos0: int = 0,
               caches: Optional[Dict] = None, remat: bool = False):
        """(final normed hidden state (B, S, M), the MoE loss summed over
        layers). ``caches`` (a dict, filled on the first call) carries
        attention keys and values and SSM states from call to call;
        ``remat`` recomputes each layer in the backward."""
        x = self.p["embed"][tokens.long()]
        aux = x.new_zeros(())
        for r in range(self.s.repeats):
            for i, kind in enumerate(self.s.pattern):
                cache = None
                if caches is not None:
                    cache = caches.setdefault((r, i), {})
                if remat:
                    x, a = checkpoint(self._layer, r, i, kind, x, pos0, None,
                                      use_reentrant=False)
                else:
                    x, a = self._layer(r, i, kind, x, pos0, cache)
                aux = aux + a
        return rms_norm(x, self.p["final_norm"]), aux

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return self.mm.mm(h, self.p["unembed"])

    def loss(self, inputs: torch.Tensor, labels: torch.Tensor):
        """(mean cross-entropy over the padded vocabulary, MoE loss)."""
        h, aux = self.hidden(inputs, remat=True)
        logits = self.logits(h).reshape(-1, self.s.padded_vocab)
        ce = F.cross_entropy(logits, labels.reshape(-1).long())
        return ce, aux
