"""Decoder-only LM assembled from config-driven block patterns. Port of
``repro.models.lm`` for the dense attention kinds (``attn``,
``attn_local``, ``attn_global``) with the token frontend.

Parameters keep the JAX package's tree and layouts: ``slots/slot<i>``
holds each pattern slot's block parameters stacked over repeats
(``(R, ...)``), weights are ``(in, out)``, and decode caches are stacked
``(R, B, T, K, D)``. The JAX ``lax.scan`` over repeats is a Python loop
over layers here.

SSM blocks, MoE, the precomputed-embedding frontend and M-RoPE raise
``NotImplementedError``; they come with later slices.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .attention import attn_decode, attn_forward, init_attn_params
from .common import rms_norm, soft_cap, truncated_normal
from .mlp import init_mlp_params, mlp_forward

__all__ = [
    "init_params",
    "tree_map",
    "param_shapes",
    "param_count",
    "prefill",
    "grow_caches",
    "decode_step",
]

_DENSE_KINDS = ("attn", "attn_local", "attn_global")


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    for kind in cfg.pattern:
        if kind not in _DENSE_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet")
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: MoE is not ported yet")
    if cfg.frontend != "token":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend!r} frontend is not ported yet")
    if cfg.mrope_sections is not None:
        raise NotImplementedError(f"{cfg.name}: M-RoPE is not ported yet")


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
def _init_block(cfg, generator, dtype, device) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "attn": init_attn_params(generator, cfg, dtype, device),
    }
    if cfg.d_ff:
        p["ln2"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
        p["mlp"] = init_mlp_params(generator, cfg, dtype, device)
    return p


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
    params: Dict[str, Any] = {
        "embed": truncated_normal(generator, (cfg.padded_vocab, cfg.d_model),
                                  1.0, dtype, device),
    }
    slots: Dict[str, Any] = {}
    for i, _kind in enumerate(cfg.pattern):
        stacked = None
        for r in range(cfg.repeats):
            block = _init_block(cfg, generator, dtype, device)
            if stacked is None:
                stacked = tree_map(
                    lambda x: x.new_empty((cfg.repeats,) + tuple(x.shape)),
                    block)
            _copy_into(stacked, block, r)
        slots[f"slot{i}"] = stacked
    params["slots"] = slots
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
def _ffn(cfg, bp, x):
    if cfg.d_ff:
        h = rms_norm(x, bp["ln2"])
        return x + mlp_forward(bp["mlp"], h)
    return x


def _block_fwd(cfg, kind, bp, x, positions, build_cache):
    """Full-sequence application (prefill)."""
    h = rms_norm(x, bp["ln1"])
    y, cache = attn_forward(cfg, bp["attn"], h, positions, kind,
                            build_cache=build_cache)
    x = _ffn(cfg, bp, x + y)
    return x, cache


def _block_decode(cfg, kind, bp, x, pos, cache):
    h = rms_norm(x, bp["ln1"])
    y, cache = attn_decode(cfg, bp["attn"], h, pos, cache, kind)
    return _ffn(cfg, bp, x + y), cache


# ---------------------------------------------------------------------------
# stack (loop over repeats)
# ---------------------------------------------------------------------------
def _stack_fwd(cfg, params, x, positions, build_cache=False):
    cache_rows: Dict[str, list] = {}
    for r in range(cfg.repeats):
        for i, kind in enumerate(cfg.pattern):
            key = f"slot{i}"
            bp = tree_map(lambda a: a[r], params["slots"][key])
            x, cache = _block_fwd(cfg, kind, bp, x, positions, build_cache)
            if build_cache:
                cache_rows.setdefault(key, []).append(cache)
    caches = None
    if build_cache:
        caches = {
            key: {name: torch.stack([row[name] for row in rows])
                  for name in rows[0]}
            for key, rows in cache_rows.items()
        }
    return x, caches


def _stack_decode(cfg, params, x, pos, caches):
    for r in range(cfg.repeats):
        for i, kind in enumerate(cfg.pattern):
            key = f"slot{i}"
            bp = tree_map(lambda a: a[r], params["slots"][key])
            # views of row r: the hot-ring writes land in the stacked cache
            cache_r = {name: c[r] for name, c in caches[key].items()}
            x, _ = _block_decode(cfg, kind, bp, x, pos, cache_r)
    return x, caches


# ---------------------------------------------------------------------------
# frontend / positions
# ---------------------------------------------------------------------------
def _embed(cfg, params, inputs):
    """Token embedding by gather. The JAX package's one-hot matmul option
    (``embed_onehot``) gives the same values exactly, so it is not a
    separate path here."""
    table = params["embed"].to(getattr(torch, cfg.compute_dtype))
    return torch.nn.functional.embedding(inputs, table)


def _positions(cfg, batch: int, seq: int, device=None):
    pos = torch.arange(seq, dtype=torch.int32, device=device)
    return pos.expand(batch, seq)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def _logits(cfg, params, h):
    out = (h @ params["unembed"].to(h.dtype)).float()
    return soft_cap(out, cfg.final_logit_softcap)


def prefill(cfg, params, inputs) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Full-sequence prefill of (B, S) int tokens; returns (last-token
    logits (B, V) fp32, stacked caches, pos (B,) = S)."""
    b, s = inputs.shape
    x = _embed(cfg, params, inputs)
    x, caches = _stack_fwd(cfg, params, x,
                           _positions(cfg, b, s, inputs.device),
                           build_cache=True)
    h = rms_norm(x[:, -1:], params["final_norm"])
    pos = torch.full((b,), s, dtype=torch.int32, device=inputs.device)
    return _logits(cfg, params, h)[:, 0], caches, pos


def _pad_seq(x: torch.Tensor, pad: int, value) -> torch.Tensor:
    """Append ``pad`` slots filled with ``value`` on axis 2 (T of a
    stacked (R, B, T, ...) cache)."""
    shape = list(x.shape)
    shape[2] = pad
    return torch.cat([x, x.new_full(shape, value)], dim=2)


def grow_caches(cfg, caches, new_len: int):
    """Extend prefill caches to ``new_len`` slots for decoding (windowed
    layers cap at their window). New prefix slots are empty
    (``kv_pos = -1``); the hot ring passes through untouched.

    Decode writes only the hot ring, at ``pos % decode_hot_len``, and
    nothing here or in the serve loop flushes it into the prefix, so
    after ``decode_hot_len`` generated tokens the ring overwrites its own
    oldest entries — as in the JAX package, whose serve loop does not call
    ``consolidate_caches`` either."""
    out = {}
    for i, kind in enumerate(cfg.pattern):
        key = f"slot{i}"
        if key not in caches:
            continue
        c = caches[key]
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


def decode_step(cfg, params, token, pos, caches):
    """One-token serve step. token: (B, 1) int; pos: (B,) tokens so far.
    Returns (logits (B, V) fp32, caches, pos + 1). The hot rings of
    ``caches`` are updated in place (repro.launch.serve donates the cache);
    the returned caches are the same tensors."""
    x = _embed(cfg, params, token)
    x, caches = _stack_decode(cfg, params, x, pos, caches)
    h = rms_norm(x, params["final_norm"])
    return _logits(cfg, params, h)[:, 0], caches, pos + 1
