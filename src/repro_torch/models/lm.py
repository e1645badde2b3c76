"""Decoder-only LM assembled from config-driven block patterns. Port of
``repro.models.lm`` for the dense attention kinds (``attn``,
``attn_local``, ``attn_global``), the shared attention block
(``shared_attn``, the JAX package's Zamba-2 stand-in) and Mamba-2 blocks
(``ssm``), each attention block's feed-forward a dense SwiGLU or a top-k
MoE (``models.moe``), whose load-balancing loss ``train_loss`` adds
(``MOE_AUX_WEIGHT``); and one kind the JAX package has not, Zamba-2's own
hybrid layer (``zamba_hybrid``, below). Both
frontends: ``token`` (an embedding table) and ``embed`` (precomputed
(B, S, M) frame or patch embeddings, the VLM/audio stub, with no input
table); RoPE, or M-RoPE where ``cfg.mrope_sections`` is set, whose
positions are (3, B, S).

Parameters keep the JAX package's tree and layouts: ``slots/slot<i>``
holds each pattern slot's block parameters stacked over repeats
(``(R, ...)``), except ``shared_attn`` slots, whose one parameter set,
``shared``, every repeat applies (unstacked). Weights are ``(in, out)``,
and decode caches are stacked over repeats (``(R, B, T, K, D)`` for
attention, a shared block included: one KV cache per repeat;
``(R, B, H, P, N)`` SSD states and ``(R, B, K-1, C)`` conv tails for SSM
blocks). The JAX
``lax.scan`` over repeats is a Python loop over layers here; with
``cfg.remat == "full"`` each repeat runs under activation checkpointing
when gradients are taken, as the JAX scan body runs under
``jax.checkpoint``: the recomputed forward is the same computation on
the same inputs, so an MoE layer routes as it did the first time.

Given DTensor parameters (a sharded step, ``repro_torch.sharding``), the
same code runs on the mesh: each repeat's boundaries take the ambient
activation spec (``act_sharding.constrain``, where the JAX scan body
does), and the kernels run in their ops' local maps.

``zamba_hybrid`` (Zamba-2, arXiv:2411.15242): application r of a shared
block, block b = r mod ``cfg.shared_blocks``, on the residual stream x and
the token embedding e, which the stack keeps for the whole pass:

    u = RMSNorm([x ; e])                          (the block's ln_in, 2·M)
    a = Attention(u) W_o                          (softmax scale (D/2)^-1/2)
    g = RMSNorm(a)                                (ln_ff; no residual)
    f = FFN_act(g; W_gate + A_r B_r[:, :F], W_up + A_r B_r[:, F:]) W_down
    x ← x + Mamba2_r(RMSNorm_r(x + f L_r))

The shared blocks are ``shared_blocks`` (stacked (NB, ...), unstacked per
application, so a block's gradient sums over its applications); the
application's own leaves (its Mamba-2 layer with ``ln``, the projection
``proj`` L_r, the adapter ``adapter_a`` A_r and ``adapter_b`` B_r) are its
slot's, stacked over repeats. Its decode cache is one dict holding both
kinds of state, the SSD state and conv tails beside its own KV cache. In
the full-sequence forward each application's shared part (attention,
feed-forward, adapter, L_r) runs in a ``shared_block`` phase span
(``core/telemetry/phases.py``), under remat recomputed in ``backward``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core.telemetry import phases
from ..sharding.act_sharding import constrain, constrain_seq_gathered
from ..sharding.local import reduce_partial, replicate_like
from .attention import (attn_decode, attn_forward, init_attn_params,
                        init_kv_cache)
from .common import chunked_softmax_xent, rms_norm, soft_cap, truncated_normal
from .mlp import (adapted_mlp_forward, init_adapter_params, init_mlp_params,
                  mlp_forward)
from .moe import init_moe_params, moe_forward
from .ssm import init_ssm_cache, init_ssm_params, ssm_decode, ssm_forward

__all__ = [
    "init_params",
    "tree_map",
    "param_shapes",
    "param_count",
    "prefill",
    "grow_caches",
    "consolidate_caches",
    "init_decode_caches",
    "decode_step",
    "train_loss",
    "MOE_AUX_WEIGHT",
]

MOE_AUX_WEIGHT = 0.01

_KINDS = ("attn", "attn_local", "attn_global", "shared_attn", "ssm",
          "zamba_hybrid")
_FRONTENDS = ("token", "embed")


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a block kind or frontend the port
    does not have (every one the JAX package has is ported). Every
    supported config also trains (the flash backward's head-dim limit and
    the train state's size on the card are checked by
    ``launch.train.train``, which knows the device)."""
    for kind in cfg.pattern:
        if kind not in _KINDS:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported")
    if cfg.frontend not in _FRONTENDS:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend!r} frontend is not ported")
    if "zamba_hybrid" in cfg.pattern and (
            getattr(cfg, "shared_blocks", 0) < 1 or cfg.frontend != "token"
            or cfg.is_moe or not cfg.d_ff):
        raise ValueError(
            f"{cfg.name}: zamba_hybrid wants a HybridConfig with "
            "shared_blocks >= 1, the token frontend and a dense feed-forward")


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict (a parameter tree)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_block(cfg, kind, generator, dtype, device) -> Dict[str, Any]:
    if kind == "ssm":
        return {
            "ln": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
            "ssm": init_ssm_params(generator, cfg, dtype, device),
        }
    if kind == "zamba_hybrid":   # the application's own leaves
        m = cfg.d_model
        return {
            "ln": torch.zeros((m,), dtype=dtype, device=device),
            "ssm": init_ssm_params(generator, cfg, dtype, device),
            "proj": truncated_normal(generator, (m, m), 1.0, dtype, device),
            **init_adapter_params(generator, cfg, dtype, device),
        }
    p: Dict[str, Any] = {
        "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "attn": init_attn_params(generator, cfg, dtype, device),
    }
    if cfg.is_moe:
        p["ln2"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
        p["moe"] = init_moe_params(generator, cfg, dtype, device)
    elif cfg.d_ff:
        p["ln2"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
        p["mlp"] = init_mlp_params(generator, cfg, dtype, device)
    return p


def _init_shared_block(cfg, generator, dtype, device) -> Dict[str, Any]:
    """One shared block of a ``zamba_hybrid`` pattern: attention over the
    2·M-wide concatenation [x ; e], its norms and feed-forward."""
    a, m = 2 * cfg.d_model, cfg.d_model
    hd, h, k = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads

    def tn(shape):
        return truncated_normal(generator, shape, 1.0, dtype, device)

    return {
        "ln_in": torch.zeros((a,), dtype=dtype, device=device),
        "attn": {"wq": tn((a, h * hd)), "wk": tn((a, k * hd)),
                 "wv": tn((a, k * hd)), "wo": tn((h * hd, m))},
        "ln_ff": torch.zeros((m,), dtype=dtype, device=device),
        "mlp": init_mlp_params(generator, cfg, dtype, device),
    }


def _stacked(make, n: int):
    """``n`` trees from ``make()``, stacked leaf by leaf: (n, ...)."""
    stacked = None
    for r in range(n):
        block = make()
        if stacked is None:
            stacked = tree_map(
                lambda x: x.new_empty((n,) + tuple(x.shape)), block)
        _copy_into(stacked, block, r)
    return stacked


def _copy_into(dst, src, r: int) -> None:
    for key, val in src.items():
        if isinstance(val, dict):
            _copy_into(dst[key], val, r)
        else:
            dst[key][r].copy_(val)


def init_params(cfg, generator, device=None, dtype=None) -> Dict[str, Any]:
    """Random parameters in the JAX package's tree, drawn tensor by
    tensor on ``device`` and stored in ``dtype`` (default
    ``cfg.param_dtype``), so no fp32 copy of the whole model exists at
    once. The values differ from ``repro.models.lm.init_params`` (another
    generator); the distribution is the same. Tests carry the JAX values
    over with :func:`repro_torch.models.convert.params_from_jax`."""
    check_supported(cfg)
    dtype = dtype or getattr(torch, cfg.param_dtype)
    params: Dict[str, Any] = {}
    if cfg.frontend == "token":   # the embed frontend has no input table
        params["embed"] = truncated_normal(
            generator, (cfg.padded_vocab, cfg.d_model), 1.0, dtype, device)
    slots: Dict[str, Any] = {}
    for i, kind in enumerate(cfg.pattern):
        if kind == "shared_attn":
            continue
        slots[f"slot{i}"] = _stacked(
            lambda: _init_block(cfg, kind, generator, dtype, device),
            cfg.repeats)
    params["slots"] = slots
    if "shared_attn" in cfg.pattern:
        params["shared"] = _init_block(cfg, "shared_attn", generator, dtype,
                                       device)
    if "zamba_hybrid" in cfg.pattern:
        params["shared_blocks"] = _stacked(
            lambda: _init_shared_block(cfg, generator, dtype, device),
            cfg.shared_blocks)
    params["final_norm"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                       device=device)
    params["unembed"] = truncated_normal(
        generator, (cfg.d_model, cfg.padded_vocab), 1.0, dtype, device)
    return params


def param_shapes(cfg) -> Dict[str, Any]:
    """The parameter tree's shapes (no memory: built on the meta device)."""
    meta = init_params(cfg, None, device="meta")
    return tree_map(lambda x: tuple(x.shape), meta)


def param_count(params) -> int:
    return sum(x.numel() for x in _leaves(params))


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------
def _norm_gathered(x, scale):
    """The block's normed input, the sequence gathered where the ambient
    activation spec shards it (sequence parallelism: gathered after the
    norm, once for every product of the block, as Megatron-LM's SP does;
    DTensor cannot fold a sequence-sharded (B, S, M) into the (B·S, M) a
    product takes, and torch 2.11's refuses to); the identity without a
    spec."""
    return constrain_seq_gathered(rms_norm(x, scale))


def _residual(x, y):
    """``x + y``, the block's output ``y`` first brought to the ambient
    activation spec by an explicit redistribution (sequence parallelism's
    reduce-scatter), whose backward returns ``y``'s gradient to ``y``'s own
    layout: otherwise the gradient reaches the block's last product
    sequence-sharded, which DTensor cannot fold for the product's
    backward. Without a spec, just ``x + y``."""
    return x + constrain(y)


def _ffn(cfg, bp, x, aux):
    """The feed-forward half of an attention block; ``aux`` accumulates
    the MoE's load-balancing loss."""
    if cfg.is_moe:
        h = _norm_gathered(x, bp["ln2"])
        y, a = moe_forward(cfg, bp["moe"], h)
        return _residual(x, y), aux + a
    if cfg.d_ff:
        h = _norm_gathered(x, bp["ln2"])
        return _residual(x, mlp_forward(bp["mlp"], h)), aux
    return x, aux


def _zamba_scale(cfg) -> float:
    """Zamba-2's softmax scale, (D / 2)^-1/2: its attention reads a
    concatenation twice the stream's width."""
    return (cfg.resolved_head_dim / 2) ** -0.5


def _zamba_shared_out(cfg, bp, a, positions=None, build_cache=False,
                      decode=None):
    """T = FFN_r(RMSNorm(Attention(u) W_o)) L_r of one application, from
    the normed concatenation ``u``: attention over the sequence (with
    ``build_cache``, also its KV cache), or with ``decode`` = (pos, cache)
    one token through the cache. Returns (T, KV cache or None)."""
    sp = bp["shared"]
    if decode is None:
        y, kv = attn_forward(cfg, sp["attn"], a, positions, "zamba_hybrid",
                             build_cache=build_cache, scale=_zamba_scale(cfg))
    else:
        y, kv = attn_decode(cfg, sp["attn"], a, *decode, "zamba_hybrid",
                            scale=_zamba_scale(cfg))
    g = rms_norm(y, sp["ln_ff"])
    f = adapted_mlp_forward(sp["mlp"], bp["adapter_a"], bp["adapter_b"], g)
    return f @ bp["proj"].to(f.dtype), kv


def _zamba_fwd(cfg, bp, x, emb, positions, build_cache):
    """One ``zamba_hybrid`` application over the full sequence: (x, cache:
    the SSD state and conv tails beside the KV cache, or None)."""
    with phases.section("shared_block"):
        u = _norm_gathered(torch.cat([x, emb], dim=-1), bp["shared"]["ln_in"])
        t, kv = _zamba_shared_out(cfg, bp, u, positions, build_cache)
    h = _norm_gathered(x + t, bp["ln"])
    if build_cache:
        y, cache = ssm_forward(cfg, bp["ssm"], h, build_cache=True)
        return _residual(x, y), {**cache, **kv}
    return _residual(x, ssm_forward(cfg, bp["ssm"], h)), None


def _block_fwd(cfg, kind, bp, x, positions, aux, build_cache, emb=None):
    """Full-sequence application (train / prefill): (x, aux, cache);
    ``emb`` the token embedding (``zamba_hybrid`` reads it)."""
    if kind == "zamba_hybrid":
        x, cache = _zamba_fwd(cfg, bp, x, emb, positions, build_cache)
        return x, aux, cache
    if kind == "ssm":
        h = _norm_gathered(x, bp["ln"])
        if build_cache:
            y, cache = ssm_forward(cfg, bp["ssm"], h, build_cache=True)
            return _residual(x, y), aux, cache
        return _residual(x, ssm_forward(cfg, bp["ssm"], h)), aux, None
    h = _norm_gathered(x, bp["ln1"])
    y, cache = attn_forward(cfg, bp["attn"], h, positions, kind,
                            build_cache=build_cache)
    x, aux = _ffn(cfg, bp, _residual(x, y), aux)
    return x, aux, cache


def _block_decode(cfg, kind, bp, x, pos, cache, emb=None):
    if kind == "zamba_hybrid":
        u = rms_norm(torch.cat([x, emb], dim=-1), bp["shared"]["ln_in"])
        t, cache = _zamba_shared_out(cfg, bp, u, decode=(pos, cache))
        y, cache = ssm_decode(cfg, bp["ssm"], rms_norm(x + t, bp["ln"]),
                              cache)
        return x + y, cache
    if kind == "ssm":
        h = rms_norm(x, bp["ln"])
        y, cache = ssm_decode(cfg, bp["ssm"], h, cache)
        return x + y, cache
    h = rms_norm(x, bp["ln1"])
    y, cache = attn_decode(cfg, bp["attn"], h, pos, cache, kind)
    x, _ = _ffn(cfg, bp, x + y, 0.0)   # the aux loss is dropped
    return x, cache


# ---------------------------------------------------------------------------
# stack (loop over repeats)
# ---------------------------------------------------------------------------
def _unbind(tree, repeats: int) -> List[Dict[str, Any]]:
    """The ``repeats`` per-layer views of a stacked ``(R, ...)`` subtree,
    one ``unbind`` per leaf. Under autograd its backward stacks the R layer
    gradients once; indexing ``a[r]`` per layer would instead build a zero
    tensor the size of the whole stack for every layer."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, repeats) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(repeats)]
    return list(tree.unbind(0))


def _repeat(cfg, layer, x, aux, positions, build_cache, emb=None):
    """One repeat of the block pattern (the JAX scan body), its residual
    stream constrained to the ambient activation spec at both ends;
    ``emb`` the token embedding where the pattern reads it."""
    caches = {}
    x = constrain(x)   # layer-boundary activation sharding (SP)
    for i, kind in enumerate(cfg.pattern):
        key = f"slot{i}"
        x, aux, cache = _block_fwd(cfg, kind, layer[key], x, positions, aux,
                                   build_cache, emb)
        if build_cache:
            caches[key] = cache
    x = constrain(x)
    return x, aux, caches


def _remat_repeat(cfg, x, aux, layer, positions, emb=None):
    return _repeat(cfg, layer, x, aux, positions, False, emb)[:2]


def _hybrid_block(cfg, r: int, i: int) -> int:
    """The shared block that repeat ``r``'s ``zamba_hybrid`` slot ``i``
    applies: its application's number, counted over the stack, mod
    ``cfg.shared_blocks``."""
    per_repeat = [j for j, kind in enumerate(cfg.pattern)
                  if kind == "zamba_hybrid"]
    return (r * len(per_repeat) + per_repeat.index(i)) % cfg.shared_blocks


def _layer_rows(cfg, params) -> List[Dict[str, Any]]:
    """Each repeat's block parameters by slot: row r of every stacked slot,
    and the one ``shared`` set for every ``shared_attn`` slot; a
    ``zamba_hybrid`` slot's row also holds, under ``shared``, the shared
    block its application applies."""
    rows = {key: _unbind(slot, cfg.repeats)
            for key, slot in params["slots"].items()}
    shared = {f"slot{i}": params["shared"]
              for i, kind in enumerate(cfg.pattern) if kind == "shared_attn"}
    out = [{**{key: rows[key][r] for key in rows}, **shared}
           for r in range(cfg.repeats)]
    if "zamba_hybrid" in cfg.pattern:
        blocks = _unbind(params["shared_blocks"], cfg.shared_blocks)
        for r, layer in enumerate(out):
            for i, kind in enumerate(cfg.pattern):
                if kind == "zamba_hybrid":
                    layer[f"slot{i}"] = {
                        **layer[f"slot{i}"],
                        "shared": blocks[_hybrid_block(cfg, r, i)]}
    return out


def _stack_fwd(cfg, params, x, positions, build_cache=False):
    """(x, aux: the MoE loss summed over layers, fp32, caches)."""
    remat = (cfg.remat == "full" and torch.is_grad_enabled()
             and not build_cache)
    aux = replicate_like(
        torch.zeros((), dtype=torch.float32, device=x.device), x)
    # the token embedding, which zamba_hybrid slots read at every layer
    emb = x if "zamba_hybrid" in cfg.pattern else None
    cache_rows: Dict[str, list] = {}
    for layer in _layer_rows(cfg, params):
        if remat:
            x, aux = checkpoint(_remat_repeat, cfg, x, aux, layer, positions,
                                emb, use_reentrant=False)
            continue
        x, aux, caches = _repeat(cfg, layer, x, aux, positions, build_cache,
                                 emb)
        for key, cache in caches.items():
            cache_rows.setdefault(key, []).append(cache)
    caches = None
    if build_cache:
        caches = {
            key: {name: torch.stack([row[name] for row in per_layer])
                  for name in per_layer[0]}
            for key, per_layer in cache_rows.items()
        }
    return x, aux, caches


def _stack_decode(cfg, params, x, pos, caches):
    emb = x   # the token embedding, which zamba_hybrid slots read
    for r in range(cfg.repeats):
        for i, kind in enumerate(cfg.pattern):
            key = f"slot{i}"
            bp = (params["shared"] if kind == "shared_attn" else
                  tree_map(lambda a: a[r], params["slots"][key]))
            if kind == "zamba_hybrid":
                b = _hybrid_block(cfg, r, i)
                bp = {**bp, "shared": tree_map(lambda a: a[b],
                                               params["shared_blocks"])}
            # views of row r: attention's hot-ring writes land in the
            # stacked cache; an SSM block returns a new state and new conv
            # tails, which are written back into row r here
            cache_r = {name: c[r] for name, c in caches[key].items()}
            x, new_r = _block_decode(cfg, kind, bp, x, pos, cache_r, emb)
            for name, val in new_r.items():
                if val is not cache_r[name]:
                    cache_r[name].copy_(val)
    return x, caches


# ---------------------------------------------------------------------------
# frontend / positions
# ---------------------------------------------------------------------------
def _embed(cfg, params, inputs):
    """Token embedding by gather, or the precomputed (B, S, M) embeddings
    cast to the compute dtype (the ``embed`` frontend). The JAX package's
    one-hot matmul option (``embed_onehot``) gives the same values
    exactly, so it is not a separate path here."""
    cdt = getattr(torch, cfg.compute_dtype)
    if cfg.frontend == "token":
        return reduce_partial(
            torch.nn.functional.embedding(inputs, params["embed"].to(cdt)))
    return inputs.to(cdt)   # precomputed embeddings (VLM/audio stub)


def _positions(cfg, batch: int, seq: int, device=None):
    """(B, S) ``arange`` rows; (3, B, S) with M-RoPE, every stream that
    ``arange`` (the stub frontend has no image grid)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)
    if cfg.mrope_sections is not None:
        return pos.expand(3, batch, seq)
    return pos.expand(batch, seq)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def _logits(cfg, params, h):
    out = (h @ params["unembed"].to(h.dtype)).float()
    return soft_cap(out, cfg.final_logit_softcap)


def train_loss(cfg, params, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """batch: {"inputs": (B, S) int tokens or (B, S, M) embeddings,
    "labels": (B, S) int, -1 = masked}. Returns (mean loss over unmasked labels, {"loss": the same,
    detached, "tokens": their count}), both fp32. An MoE model adds
    ``MOE_AUX_WEIGHT`` times its load-balancing loss to the loss it returns
    and reports that loss as ``metrics["moe_aux"]``; ``metrics["loss"]``
    stays the cross-entropy, as in the JAX package."""
    check_supported(cfg)
    inputs, labels = batch["inputs"], batch["labels"]
    b, s = labels.shape
    x = _embed(cfg, params, inputs)
    x, aux, _ = _stack_fwd(cfg, params, x,
                           _positions(cfg, b, s, labels.device))
    h = _norm_gathered(x, params["final_norm"])
    loss_sum, count = chunked_softmax_xent(
        h.reshape(-1, cfg.d_model),
        params["unembed"],
        labels.reshape(-1),
        chunk=cfg.loss_chunk,
        final_softcap=cfg.final_logit_softcap,
    )
    loss = loss_sum / torch.clamp_min(count, 1.0)
    metrics = {"loss": loss.detach(), "tokens": count}
    if cfg.is_moe:
        metrics["moe_aux"] = aux.detach()
        loss = loss + MOE_AUX_WEIGHT * aux
    return loss, metrics


def prefill(cfg, params, inputs) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Full-sequence prefill of (B, S) int tokens or (B, S, M)
    embeddings; returns (last-token logits (B, V) fp32, stacked caches,
    pos (B,) = S)."""
    b, s = inputs.shape[:2]
    x = _embed(cfg, params, inputs)
    x, _, caches = _stack_fwd(cfg, params, x,
                              _positions(cfg, b, s, inputs.device),
                              build_cache=True)
    h = rms_norm(x[:, -1:], params["final_norm"])
    pos = torch.full((b,), s, dtype=torch.int32, device=inputs.device)
    return _logits(cfg, params, h)[:, 0], caches, pos


def init_decode_caches(cfg, batch: int, cache_len: int, filled: bool = False,
                       device=None) -> Dict[str, Any]:
    """Stacked (R-leading) decode caches, zeros in the compute dtype (SSD
    states fp32), in the JAX package's tree (``init_kv_cache`` for every
    attention slot, a shared block's included; ``init_ssm_cache`` for
    every SSM slot). ``filled=True`` marks every prefix slot as holding a
    real token, the last ``t`` positions before ``cache_len`` (a cache
    after ``cache_len`` tokens of prefill), as the JAX one does. Built on
    ``device`` (``"meta"``: shapes only)."""
    check_supported(cfg)
    r = cfg.repeats
    dtype = getattr(torch, cfg.compute_dtype)

    def stack(tree):
        return tree_map(
            lambda x: x.unsqueeze(0).expand((r,) + tuple(x.shape)).clone(),
            tree)

    caches: Dict[str, Any] = {}
    for i, kind in enumerate(cfg.pattern):
        slot = {}
        if kind in ("ssm", "zamba_hybrid"):
            slot.update(stack(init_ssm_cache(cfg, batch, dtype, device)))
        if kind != "ssm":   # a zamba_hybrid slot holds both kinds of state
            c = init_kv_cache(cfg, batch, cache_len, kind, dtype, device)
            if filled:
                t = c["kv_pos"].shape[1]
                c["kv_pos"] = torch.arange(
                    cache_len - t, cache_len, dtype=torch.int32,
                    device=device).expand(batch, t).contiguous()
            slot.update(stack(c))
        caches[f"slot{i}"] = slot
    return caches


def _pad_seq(x: torch.Tensor, pad: int, value) -> torch.Tensor:
    """Append ``pad`` slots filled with ``value`` on axis 2 (T of a
    stacked (R, B, T, ...) cache)."""
    shape = list(x.shape)
    shape[2] = pad
    return torch.cat([x, x.new_full(shape, value)], dim=2)


def grow_caches(cfg, caches, new_len: int):
    """Extend prefill caches to ``new_len`` slots for decoding (windowed
    layers cap at their window; SSM carries, whose size does not grow with
    the sequence, pass through). New prefix slots are empty
    (``kv_pos = -1``); the hot ring passes through untouched. A
    ``shared_attn`` block is never windowed, as in the JAX package, nor is
    a ``zamba_hybrid`` block, whose SSM carries pass through beside its
    grown KV cache.

    Decode writes only the hot ring, at ``pos % decode_hot_len``, and
    nothing here or in the serve loop flushes it into the prefix
    (:func:`consolidate_caches` would), so after ``decode_hot_len``
    generated tokens the ring overwrites its own oldest entries — as in
    the JAX package, whose serve loop does not call ``consolidate_caches``
    either."""
    out = {}
    for i, kind in enumerate(cfg.pattern):
        key = f"slot{i}"
        if key not in caches:
            continue
        c = caches[key]
        if kind == "ssm":  # constant-size carry: nothing to grow
            out[key] = c
            continue
        t_new = new_len
        if kind == "attn_local" or (kind == "attn" and cfg.window is not None):
            t_new = min(new_len, cfg.window)
        t_cur = c["k"].shape[2]  # stacked: (R, B, T, K, D)
        if t_new <= t_cur:
            out[key] = c
            continue
        pad = t_new - t_cur
        grown = dict(c)  # hot-ring keys pass through untouched
        grown["k"] = _pad_seq(c["k"], pad, 0)
        grown["v"] = _pad_seq(c["v"], pad, 0)
        grown["kv_pos"] = _pad_seq(c["kv_pos"], pad, -1)
        out[key] = grown
    return out


def _scatter_slots(prefix: torch.Tensor, hot: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """A copy of ``prefix`` (R, B, T, ...) with ``hot[r, b, j]`` written at
    slot ``idx[r, b, j]`` of row (r, b); an index of T is dropped. Where
    two hot slots name one prefix slot the later hot slot wins, as XLA's
    scatter applies its updates in order."""
    r, b, t = prefix.shape[:3]
    n = idx.shape[-1]
    later = torch.ones((n, n), dtype=torch.bool, device=idx.device).triu(1)
    shadowed = ((idx[..., :, None] == idx[..., None, :]) & later).any(-1)
    idx = torch.where(shadowed, torch.full_like(idx, t), idx)
    out = torch.cat([prefix, prefix.new_zeros((r, b, 1) + prefix.shape[3:])],
                    dim=2)   # slot t takes the drops
    index = idx.reshape(idx.shape + (1,) * (hot.dim() - 3)).expand_as(hot)
    out.scatter_(2, index.to(torch.int64), hot)
    return out[:, :, :t].contiguous()


def consolidate_caches(cfg, caches):
    """Flush hot-ring entries into the prefix cache and reset the rings, as
    ``repro.models.lm.consolidate_caches``: every valid hot slot
    (``h_pos >= 0``) is written at prefix slot ``h_pos % T`` (ring
    semantics, so windowed and full layers share the path), the rings come
    back zero with ``h_pos = -1``, and SSM carries pass through. Returns new
    caches; the given ones are left as they are. Neither driver calls it,
    as in the JAX package."""
    out = {}
    for i, kind in enumerate(cfg.pattern):
        key = f"slot{i}"
        if key not in caches:
            continue
        c = caches[key]
        if kind == "ssm" or "hk" not in c:
            out[key] = c
            continue
        t = c["k"].shape[2]
        h_pos = c["h_pos"]
        idx = torch.where(h_pos >= 0, torch.remainder(h_pos, t),
                          torch.full_like(h_pos, t))
        out[key] = {   # a zamba_hybrid slot's SSM carries pass through
            **c,
            "k": _scatter_slots(c["k"], c["hk"], idx),
            "v": _scatter_slots(c["v"], c["hv"], idx),
            "kv_pos": _scatter_slots(c["kv_pos"], h_pos, idx),
            "hk": torch.zeros_like(c["hk"]),
            "hv": torch.zeros_like(c["hv"]),
            "h_pos": torch.full_like(h_pos, -1),
        }
    return out


def decode_step(cfg, params, token, pos, caches):
    """One-token serve step. token: (B, 1) int (or (B, 1, M) embeddings);
    pos: (B,) tokens so far.
    Returns (logits (B, V) fp32, caches, pos + 1). ``caches`` is updated
    in place (repro.launch.serve donates the cache): attention's hot rings,
    SSM states and conv tails; the returned caches are the same tensors."""
    x = _embed(cfg, params, token)
    x, caches = _stack_decode(cfg, params, x, pos, caches)
    h = rms_norm(x, params["final_norm"])
    return _logits(cfg, params, h)[:, 0], caches, pos + 1
