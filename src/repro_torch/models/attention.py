"""GQA attention with sliding window, logit soft-capping, RoPE, prefill
cache construction and ring-buffer decode. Port of
``repro.models.attention``.

Prefill attention (:func:`attn_forward`) goes through
:func:`repro_torch.kernels.flash_attention.ops.attention`: the
hand-written CUDA kernel for tensors on the card, its plain version for
tensors on the CPU. Decode attention (:func:`attn_decode`) reads the
prefix cache and the hot ring through :func:`attention_parts` (plain
PyTorch ops, as the JAX package left it to XLA) and merges the two
partial softmaxes with :func:`combine_parts`.

Decode uses a uniform ring-buffer cache: every slot remembers the token
position it holds (``kv_pos``; -1 = empty), so full-attention and
windowed layers share one code path.

On DTensors (a sharded step) K and V take the ambient activation spec's
gather point after RoPE (``act_sharding.constrain_seq_gathered``, where
the JAX package puts it), prefill attention runs in ``ops.attention``'s
local map, and decode attention in its own (:func:`attn_decode`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.flash_attention import ops as flash_ops
from ..sharding.act_sharding import constrain_seq_gathered
from ..sharding.local import (is_dtensor, merge_last, op_placements,
                              replicate_like, run_local, split_last)
from .common import apply_mrope, apply_rope, truncated_normal

__all__ = [
    "init_attn_params",
    "attn_forward",
    "init_kv_cache",
    "attn_decode",
    "attention_parts",
    "combine_parts",
    "chunked_attention",
]

NEG_INF = -1e30


def init_attn_params(generator: torch.Generator, cfg, dtype=torch.float32,
                     device=None) -> Dict[str, torch.Tensor]:
    m = cfg.d_model
    hd = cfg.resolved_head_dim
    h, k = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": truncated_normal(generator, (m, h * hd), 1.0, dtype, device),
        "wk": truncated_normal(generator, (m, k * hd), 1.0, dtype, device),
        "wv": truncated_normal(generator, (m, k * hd), 1.0, dtype, device),
        "wo": truncated_normal(generator, (h * hd, m), 1.0, dtype, device),
    }


def _project_qkv(cfg, p, h):
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    nh, nk = cfg.num_heads, cfg.num_kv_heads
    cdt = h.dtype
    q = split_last(h @ p["wq"].to(cdt), nh)
    k = split_last(h @ p["wk"].to(cdt), nk)
    v = split_last(h @ p["wv"].to(cdt), nk)
    return q, k, v


def _rope(cfg, x, positions):
    if cfg.mrope_sections is not None:
        return apply_mrope(x, positions, cfg.mrope_sections, cfg.rope_theta)
    return apply_rope(x, positions, cfg.rope_theta)


def _pos_1d(positions):
    """positions may be (B,S) or (3,B,S) (M-RoPE); masks use stream 0."""
    return positions[0] if positions.dim() == 3 else positions


def _window(cfg, kind: str) -> Optional[int]:
    if kind == "attn_local" or (kind == "attn" and cfg.window is not None):
        return cfg.window
    return None


def attention_parts(
    q: torch.Tensor,            # (B, S, H, D)
    k: torch.Tensor,            # (B, T, K, D)
    v: torch.Tensor,            # (B, T, K, D)
    q_pos: torch.Tensor,        # (B, S)
    kv_pos: torch.Tensor,       # (B, T)  (-1 = empty slot)
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    kv_chunk: int = 1024,
    scale: Optional[float] = None,
):
    """Unnormalized online-softmax accumulation over one KV source.

    Returns (m, l, acc): running max (B,S,K,G), denominator and fp32
    accumulator (B,S,K,G,D). Several sources (a prefix cache and a hot
    decode ring) combine exactly via :func:`combine_parts`. As in the JAX
    version, q is scaled in its own dtype and the products take the
    inputs' values exactly with fp32 accumulation. ``scale`` is the
    softmax scale (default D^-1/2).
    """
    b, s, h, d = q.shape
    t, nk = k.shape[1], k.shape[2]
    g = h // nk
    scale = d ** -0.5 if scale is None else scale
    qr = q.reshape(b, s, nk, g, d) * torch.tensor(scale, dtype=q.dtype)
    qr = qr.float()
    kv_chunk = min(kv_chunk, t)
    if t % kv_chunk != 0:
        pad = kv_chunk - t % kv_chunk
        k = torch.cat([k, k.new_zeros((b, pad) + k.shape[2:])], dim=1)
        v = torch.cat([v, v.new_zeros((b, pad) + v.shape[2:])], dim=1)
        kv_pos = torch.cat([kv_pos, kv_pos.new_full((b, pad), -1)], dim=1)
        t = t + pad
    m_i = torch.full((b, s, nk, g), NEG_INF, dtype=torch.float32,
                     device=q.device)
    l_i = torch.zeros((b, s, nk, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s, nk, g, d), dtype=torch.float32, device=q.device)
    for c0 in range(0, t, kv_chunk):
        k_i = k[:, c0:c0 + kv_chunk].float()
        v_i = v[:, c0:c0 + kv_chunk].float()
        p_i = kv_pos[:, c0:c0 + kv_chunk]
        sc = torch.einsum("bskgd,bckd->bskgc", qr, k_i)
        if softcap is not None:
            sc = softcap * torch.tanh(sc / softcap)
        valid = (p_i[:, None, :] >= 0) & (p_i[:, None, :] <= q_pos[:, :, None])
        if window is not None:
            valid &= p_i[:, None, :] > (q_pos[:, :, None] - window)
        sc = torch.where(valid[:, :, None, None, :], sc, NEG_INF)
        m_new = torch.maximum(m_i, sc.amax(dim=-1))
        alpha = torch.exp(m_i - m_new)
        pexp = torch.exp(sc - m_new[..., None])
        l_i = l_i * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bskgc,bckd->bskgd", pexp, v_i)
        m_i = m_new
    return m_i, l_i, acc


def combine_parts(parts, out_shape, dtype):
    """Merge (m, l, acc) partial softmaxes from independent KV sources."""
    m = parts[0][0]
    for mp, _, _ in parts[1:]:
        m = torch.maximum(m, mp)
    l_tot = 0.0
    acc_tot = 0.0
    for mp, lp, ap in parts:
        alpha = torch.exp(mp - m)
        l_tot = l_tot + lp * alpha
        acc_tot = acc_tot + ap * alpha[..., None]
    out = acc_tot / torch.clamp_min(l_tot, 1e-30)[..., None]
    return out.reshape(out_shape).to(dtype)


def chunked_attention(
    q: torch.Tensor,            # (B, S, H, D)
    k: torch.Tensor,            # (B, T, K, D)
    v: torch.Tensor,            # (B, T, K, D)
    q_pos: torch.Tensor,        # (B, S)
    kv_pos: torch.Tensor,       # (B, T)  (-1 = empty slot)
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Causal online-softmax attention at explicit positions, scanning KV
    in chunks (plain PyTorch)."""
    b, s, h, d = q.shape
    _, l, acc = attention_parts(q, k, v, q_pos, kv_pos, window=window,
                                softcap=softcap, kv_chunk=kv_chunk)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, s, h, d).to(q.dtype)


def attn_forward(
    cfg,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,            # (B, S, M) — post-norm input
    positions: torch.Tensor,    # (B, S) or (3, B, S): arange(S) in every row
    kind: str = "attn",
    build_cache: bool = False,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Prefill attention over a full sequence; ``scale`` is the softmax
    scale (default D^-1/2).

    ``positions`` must be ``arange(S)`` in every row, as
    :func:`repro_torch.models.lm._positions` gives them; with M-RoPE they
    are (3, B, S), each stream rotating its own frequency bands, and the
    masks read stream 0, which is that ``arange``. With it the JAX
    version's ``chunked_attention(q, k, v, pos1, pos1)`` is exactly the
    flash kernel's aligned-end causal mask with T = S, which is what this
    function computes.
    """
    q, k, v = _project_qkv(cfg, p, x)
    q = _rope(cfg, q, positions)
    k = _rope(cfg, k, positions)
    # the gather point before attention: K and V batch-sharded, the
    # sequence whole (the queries keep their layout)
    k = constrain_seq_gathered(k)
    v = constrain_seq_gathered(v)
    out = flash_ops.attention(q, k, v, causal=True, window=_window(cfg, kind),
                              softcap=cfg.attn_logit_softcap, scale=scale)
    b, s, _, _ = out.shape
    y = merge_last(out) @ p["wo"].to(out.dtype)
    cache = None
    if build_cache:
        hot = cfg.decode_hot_len
        nk, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        cache = {
            "k": k,
            "v": v,
            "kv_pos": _pos_1d(positions).expand(b, s).to(torch.int32,
                                                         copy=True),
            # empty hot ring, filled during decode
            "hk": k.new_zeros((b, hot, nk, hd)),
            "hv": v.new_zeros((b, hot, nk, hd)),
            "h_pos": torch.full((b, hot), -1, dtype=torch.int32,
                                device=x.device),
        }
    return y, cache


def init_kv_cache(cfg, batch: int, cache_len: int, kind: str,
                  dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """Split decode cache for one attention layer: the prefix
    ``k/v/kv_pos`` (filled by prefill) and the hot ring ``hk/hv/h_pos``
    (written by decode). Windowed layers allocate only ``window`` prefix
    slots."""
    t = cache_len
    window = _window(cfg, kind)
    if window is not None:
        t = min(cache_len, window)
    hd = cfg.resolved_head_dim
    hot = cfg.decode_hot_len
    nk = cfg.num_kv_heads

    def zeros(n):
        return torch.zeros((batch, n, nk, hd), dtype=dtype, device=device)

    return {
        "k": zeros(t),
        "v": zeros(t),
        "kv_pos": torch.full((batch, t), -1, dtype=torch.int32, device=device),
        "hk": zeros(hot),
        "hv": zeros(hot),
        "h_pos": torch.full((batch, hot), -1, dtype=torch.int32,
                            device=device),
    }


def _ring_write(cache_arr, new, idx):
    """In place: cache_arr[b, idx[b]] = new[b, 0] for every row b.
    cache_arr: (B, T, ...); new: (B, 1, ...); idx: (B,) slot index."""
    rows = torch.arange(cache_arr.shape[0], device=cache_arr.device)
    cache_arr[rows, idx] = new[:, 0]
    return cache_arr


def attn_decode(
    cfg,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,            # (B, 1, M) post-norm
    pos: torch.Tensor,          # (B,) current token position
    cache: Dict[str, torch.Tensor],
    kind: str = "attn",
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode: write to the hot ring, read prefix + hot ring,
    combine the two partial softmaxes exactly (flash-decoding split);
    ``scale`` is the softmax scale (default D^-1/2).

    The hot ring is updated in place, where repro.launch.serve donates the
    cache; the returned dict is ``cache`` itself."""
    b = x.shape[0]
    positions = pos[:, None]
    # M-RoPE: the three position streams of a decoded token are its pos
    rot_pos = (positions.expand(3, b, 1) if cfg.mrope_sections is not None
               else positions)
    q, k_new, v_new = _project_qkv(cfg, p, x)
    q = _rope(cfg, q, rot_pos)
    k_new = _rope(cfg, k_new, rot_pos)
    kw = dict(window=_window(cfg, kind), softcap=cfg.attn_logit_softcap)
    if scale is not None:
        kw["scale"] = scale
    names = ("k", "v", "kv_pos", "hk", "hv", "h_pos")
    if is_dtensor(q):
        out = _decode_attend_sharded(q, k_new, v_new, positions, cache,
                                     names, kw)
    else:
        out = _decode_attend(q, k_new, v_new, positions,
                             *(cache[n] for n in names), **kw)
    y = merge_last(out) @ p["wo"].to(out.dtype)
    return y, cache


def _decode_attend(q, k_new, v_new, positions, k, v, kv_pos, hk, hv, h_pos,
                   window=None, softcap=None, scale=None):
    """Write the new token into the hot ring (in place), then attend over
    the prefix and the ring and combine the two partial softmaxes."""
    b = q.shape[0]
    hot = hk.shape[1]
    slot = (positions[:, 0] % hot).long()
    _ring_write(hk, k_new.to(hk.dtype), slot)
    _ring_write(hv, v_new.to(hv.dtype), slot)
    _ring_write(h_pos, positions.to(torch.int32), slot)
    kw = dict(window=window, softcap=softcap, scale=scale)
    parts = [
        attention_parts(q, k, v, positions, kv_pos, kv_chunk=k.shape[1],
                        **kw),
        attention_parts(q, hk, hv, positions, h_pos, kv_chunk=hot, **kw),
    ]
    return combine_parts(parts, (b, 1, q.shape[2], q.shape[3]), q.dtype)


def _decode_attend_sharded(q, k_new, v_new, positions, cache, names, kw):
    """:func:`_decode_attend` in a local map. In placements: q, the new K
    and V and the caches with the batch over the FSDP axes where it
    divides and the heads over ``model`` where the KV heads divide
    (``op_placements``), positions by the batch alone; a sequence-sharded
    prefix (``cache_pspec``'s fallback) is gathered. The hot ring must
    already lie so (``cache_pspec`` places it so), since its in-place
    writes land in the shards. Out placements: those of q."""
    mesh = q.device_mesh
    b, nk = q.shape[0], k_new.shape[2]
    heads = op_placements(mesh, 0, b, 2, nk)
    rows = op_placements(mesh, 0, b)
    want = dict(k=heads, v=heads, kv_pos=rows, hk=heads, hv=heads,
                h_pos=rows)
    for n in ("hk", "hv", "h_pos"):
        if tuple(cache[n].placements) != want[n]:
            raise ValueError(
                f"hot ring {n} is placed {tuple(cache[n].placements)}; its "
                f"in-place writes need {want[n]} (partition.cache_pspec)")
    positions = replicate_like(positions, q)
    return run_local(
        lambda *args: _decode_attend(*args, **kw),
        (q, k_new, v_new, positions, *(cache[n] for n in names)),
        (heads, heads, heads, rows, *(want[n] for n in names)),
        heads, mesh)
