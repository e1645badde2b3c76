"""Plain PyTorch versions of the Mamba-2 SSD (state-space duality)
primitive: the chunked dual form, the token-by-token recurrence and the
one-token decode step. Port of ``repro.kernels.ssd.ref``, with the JAX
package's layouts at every function; its ``lax.scan`` over chunks and
over tokens is a Python loop here.

:func:`ssd_reference` is the correctness reference of the CUDA kernel
(``csrc/ssd_fwd.cu``) and the path :func:`..ops.ssd` takes for tensors on
the CPU. :func:`ssd_backward_reference` is its backward written out from
the chunked form (not produced by autograd), the plain version of the
CUDA backward (``csrc/ssd_bwd.cu``).

Arithmetic is fp32, as in the JAX package, for fp32 and bf16 inputs;
float64 inputs (which JAX, without x64, never sees) are computed in
float64, which makes :func:`ssd_reference` on upcast inputs a more exact
evaluation of the same function.

Recurrence (per head h, with Δ = dt):
    s_t = exp(Δ_t A) s_{t-1} + Δ_t B_t x_tᵀ           s ∈ R^{P×N}
    y_t = C_tᵀ s_t + D x_t
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["ssd_reference", "ssd_backward_reference", "ssd_sequential",
           "ssd_decode_step"]


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j < k <= i} x[..., k] for i >= j, -inf
    otherwise. x: (..., Q)."""
    q = x.shape[-1]
    cum = torch.cumsum(x, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, torch.full_like(diff, -torch.inf))


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _heads(m: torch.Tensor, rep: int, axis: int) -> torch.Tensor:
    """Repeat B/C groups to heads (``jnp.repeat``)."""
    return torch.repeat_interleave(m, rep, dim=axis)


def _chunked(chunk: int, x, dt, b_mat, c_mat, *like_x):
    """The inputs by chunk in the accumulation dtype: (xc (B,nc,Q,H,P),
    dtc (B,nc,Q,H), bc and cc (B,nc,Q,H,N) repeated to heads, then each of
    ``like_x`` as xc). The token axis is zero-padded to a multiple of
    ``chunk``: dt = 0 there gives decay 1 and no state contribution, so
    the final state is unaffected, and padded rows are sliced off."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    pad = -l % chunk
    if pad:
        x, b_mat, c_mat, *like_x = (F.pad(t, (0, 0, 0, 0, 0, pad))
                                    for t in (x, b_mat, c_mat, *like_x))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (l + pad) // chunk
    acc = _acc_dtype(x)
    by_chunk = lambda t: t.reshape(bsz, nc, chunk, h, p).to(acc)  # noqa: E731
    grouped = lambda t: _heads(  # noqa: E731
        t.reshape(bsz, nc, chunk, g, n), h // g, 3).to(acc)
    return (by_chunk(x), dt.reshape(bsz, nc, chunk, h).to(acc),
            grouped(b_mat), grouped(c_mat), *map(by_chunk, like_x))


def _carried_states(s_local, chunk_decay, initial_state):
    """The recurrence over the chunks, S_z = S_{z-1} exp(cum_last_z) +
    local_z from the initial state (zero if None): (the state carried into
    each chunk (B,nc,H,P,N), the final state)."""
    bsz, nc, h, p, n = s_local.shape
    s = (initial_state.to(s_local.dtype) if initial_state is not None
         else s_local.new_zeros((bsz, h, p, n)))
    s_prevs = []
    for z in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, z, :, None, None] + s_local[:, z]
    return torch.stack(s_prevs, dim=1), s


def ssd_reference(
    x: torch.Tensor,       # (B, L, H, P)
    dt: torch.Tensor,      # (B, L, H)           (already softplus'd, > 0)
    a: torch.Tensor,       # (H,)                (negative decay rates)
    b_mat: torch.Tensor,   # (B, L, G, N)
    c_mat: torch.Tensor,   # (B, L, G, N)
    chunk: int = 256,
    d_skip: Optional[torch.Tensor] = None,         # (H,)
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
    return_final_state: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Chunked SSD forward. G (B/C groups) broadcasts over H (H % G == 0).
    Returns y (B, L, H, P) in x's dtype and, if asked, the final state
    (B, H, P, N) fp32 (float64 for float64 x)."""
    bsz, l, h, p = x.shape
    xc, dtc, bc, cc = _chunked(chunk, x, dt, b_mat, c_mat)
    acc = xc.dtype

    da = dtc * a.to(acc)[None, None, None, :]              # (B,nc,Q,H)
    cum = torch.cumsum(da, dim=2)                          # (B,nc,Q,H)

    # ---- intra-chunk (dual / attention-like form) ----
    seg = _segsum(torch.movedim(da, -1, 2))                # (B,nc,H,Q,Q)
    decay = torch.exp(seg)
    scores = torch.einsum("bzihn,bzjhn->bzhij", cc, bc)    # (B,nc,H,Q,Q)
    dt_j = torch.movedim(dtc, -1, 2)[:, :, :, None, :]     # (B,nc,H,1,Q)
    gate = decay * scores * dt_j
    y_intra = torch.einsum("bzhij,bzjhp->bzihp", gate, xc)  # (B,nc,Q,H,P)

    # ---- inter-chunk state recurrence ----
    last = cum[:, :, -1:, :]                               # (B,nc,1,H)
    w = torch.exp(last - cum) * dtc                        # (B,nc,Q,H)
    s_local = torch.einsum("bzjh,bzjhp,bzjhn->bzhpn", w, xc, bc)
    chunk_decay = torch.exp(last[:, :, 0, :])              # (B,nc,H)

    s_prevs, s = _carried_states(s_local, chunk_decay, initial_state)

    # y_inter_i = exp(cum_i) * C_i · S_prev
    y_inter = torch.einsum("bzih,bzihn,bzhpn->bzihp", torch.exp(cum), cc,
                           s_prevs)

    y = y_intra + y_inter
    if d_skip is not None:
        y = y + d_skip.to(acc)[None, None, None, :, None] * xc
    y = y.reshape(bsz, -1, h, p)[:, :l].to(x.dtype)
    if return_final_state:
        return y, s
    return y


def ssd_backward_reference(
    x: torch.Tensor,       # (B, L, H, P)
    dt: torch.Tensor,      # (B, L, H)
    a: torch.Tensor,       # (H,)
    b_mat: torch.Tensor,   # (B, L, G, N)
    c_mat: torch.Tensor,   # (B, L, G, N)
    dy: torch.Tensor,      # (B, L, H, P)
    chunk: int = 256,
    d_skip: Optional[torch.Tensor] = None,         # (H,)
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
    d_final_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
):
    """Gradients of :func:`ssd_reference` for the output gradient ``dy``
    and, optionally, the gradient of the final state. Returns (dx, ddt,
    da, dB, dC, dd_skip, d_initial_state), each in its input's dtype;
    dd_skip and d_initial_state are None where that input is None.

    Per chunk z, with cum the in-chunk cumsum of dt·a, L_ij =
    exp(cum_i - cum_j) for j <= i (0 above the diagonal), S_prev the
    state carried into the chunk, S_out the state it hands on, and G the
    gradient of S_out:
      G_{z-1} = dS_prev,z = Σ_i exp(cum_i) dy_i C_iᵀ + exp(cum_last) G_z,
        a reverse recurrence over the chunks seeded by the final-state
        gradient; its last value is the initial state's gradient;
      dx_j = Σ_{i>=j} L_ij (C_i·B_j) dt_j dy_i + w_j G B_j + D dy_j,
        w_j = exp(cum_last - cum_j) dt_j;
      dC_i = Σ_{j<=i} M_ij B_j + exp(cum_i) S_prevᵀ dy_i,
        M_ij = (dy_i·x_j) L_ij dt_j;
      dB_j = Σ_{i>=j} M_ij C_i + w_j Gᵀ x_j;
      ddt_j = Σ_i F_ij + exp(cum_last - cum_j) (x_j·G B_j) + a·dda_j,
        F_ij = L_ij (C_i·B_j)(dy_i·x_j);
      dcum_i = Σ_j F_ij dt_j - dt_i Σ_i' F_i'i + C_i·(exp(cum_i)
        S_prevᵀ dy_i) - w_i (x_i·G B_i), and at the chunk's last row also
        <G, S_out> (every term of S_out scales with exp(cum_last));
      dda = the reverse in-chunk cumsum of dcum; da = Σ dt·dda.
    dB and dC sum over the heads of each group; dd_skip = Σ dy·x."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    # zero padding: x = B = C = dy = 0 and dt = 0 on the padded rows, which
    # add nothing to any gradient
    xc, dtc, bc, cc, dyc = _chunked(chunk, x, dt, b_mat, c_mat, dy)
    nc, rep = xc.shape[1], h // g
    af = a.to(xc.dtype)

    cum = torch.cumsum(dtc * af[None, None, None, :], dim=2)  # (B,nc,Q,H)
    last = cum[:, :, -1:, :]
    decay_in = torch.exp(last - cum)                         # (B,nc,Q,H)
    w = decay_in * dtc
    chunk_decay = torch.exp(last[:, :, 0, :])                # (B,nc,H)
    e_cum = torch.exp(cum)

    # ---- the states carried into (S_prev) and out of (S_out) each chunk
    s_local = torch.einsum("bzjh,bzjhp,bzjhn->bzhpn", w, xc, bc)
    s_prevs, s = _carried_states(s_local, chunk_decay, initial_state)
    s_outs = torch.cat([s_prevs[:, 1:], s[:, None]], dim=1)  # (B,nc,H,P,N)

    # ---- reverse recurrence: G_z, the gradient of the state out of z
    d_local = torch.einsum("bzih,bzihp,bzihn->bzhpn", e_cum, dyc, cc)
    gz = (d_final_state.to(xc.dtype) if d_final_state is not None
          else torch.zeros_like(s))
    gs = [None] * nc
    for z in reversed(range(nc)):
        gs[z] = gz
        gz = d_local[:, z] + chunk_decay[:, z, :, None, None] * gz
    gs = torch.stack(gs, dim=1)                              # (B,nc,H,P,N)
    d_s0 = gz

    # ---- intra-chunk terms, (B, nc, H, Q_i, Q_j)
    cum_h = torch.movedim(cum, -1, 2)                        # (B,nc,H,Q)
    live = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    diff = cum_h[..., :, None] - cum_h[..., None, :]
    # selected, never multiplied: above the diagonal exp can overflow
    ell = torch.where(live, torch.exp(torch.where(live, diff, 0.0)), 0.0)
    scores = torch.einsum("bzihn,bzjhn->bzhij", cc, bc)
    dots = torch.einsum("bzihp,bzjhp->bzhij", dyc, xc)
    dt_j = torch.movedim(dtc, -1, 2)[:, :, :, None, :]       # (B,nc,H,1,Q)
    gate = ell * scores * dt_j
    m = dots * ell * dt_j
    f = ell * scores * dots
    dx = torch.einsum("bzhij,bzihp->bzjhp", gate, dyc)
    dc = torch.einsum("bzhij,bzjhn->bzihn", m, bc)
    db = torch.einsum("bzhij,bzihn->bzjhn", m, cc)
    f_cols = torch.movedim(f.sum(dim=-2), 2, -1)             # (B,nc,Q,H)
    f_rows = torch.movedim((f * dt_j).sum(dim=-1), 2, -1)
    ddt = f_cols
    dcum = f_rows - dtc * f_cols

    # ---- terms through the carried state and the state handed on
    dc_state = torch.einsum("bzih,bzhpn,bzihp->bzihn", e_cum, s_prevs, dyc)
    dc = dc + dc_state
    dcum = dcum + (cc * dc_state).sum(-1)
    gb = torch.einsum("bzhpn,bzjhn->bzjhp", gs, bc)          # G B_j
    dw = (xc * gb).sum(-1)                                   # (B,nc,Q,H)
    dx = dx + w[..., None] * gb
    db = db + w[..., None] * torch.einsum("bzhpn,bzjhp->bzjhn", gs, xc)
    ddt = ddt + decay_in * dw
    dcum = dcum - w * dw
    dcum[:, :, -1, :] += (gs * s_outs).sum((-1, -2))

    # ---- through cum = cumsum(dt·a)
    dda = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    ddt = ddt + af * dda
    da = (dtc * dda).sum((0, 1, 2))

    dd = None
    if d_skip is not None:
        dx = dx + d_skip.to(xc.dtype)[None, None, None, :, None] * dyc
        dd = (dyc * xc).sum((0, 1, 2, 4)).to(d_skip.dtype)

    def groups(t):                                           # heads -> G
        return t.reshape(bsz, nc, chunk, g, rep, n).sum(4).reshape(
            bsz, -1, g, n)[:, :l]

    dx = dx.reshape(bsz, -1, h, p)[:, :l].to(x.dtype)
    ddt = ddt.reshape(bsz, -1, h)[:, :l].to(dt.dtype)
    db = groups(db).to(b_mat.dtype)
    dc = groups(dc).to(c_mat.dtype)
    d_s0 = d_s0.to(initial_state.dtype) if initial_state is not None else None
    return dx, ddt, da.to(a.dtype), db, dc, dd, d_s0


def ssd_sequential(x, dt, a, b_mat, c_mat, d_skip=None, initial_state=None,
                   return_final_state: bool = False):
    """Token-by-token recurrence — the independent (slow) oracle of the
    chunked form."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    acc = _acc_dtype(x)
    bb = _heads(b_mat, rep, 2).to(acc)
    cb = _heads(c_mat, rep, 2).to(acc)
    s = (initial_state.to(acc) if initial_state is not None
         else torch.zeros((bsz, h, p, n), dtype=acc, device=x.device))
    xf, dtf, af = x.to(acc), dt.to(acc), a.to(acc)
    ys = []
    for t in range(l):
        dec = torch.exp(dtf[:, t] * af)                    # (B,H)
        s = s * dec[..., None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dtf[:, t], xf[:, t], bb[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", cb[:, t], s))
    y = torch.stack(ys, dim=1)
    if d_skip is not None:
        y = y + d_skip.to(acc)[None, None, :, None] * xf
    y = y.to(x.dtype)
    if return_final_state:
        return y, s
    return y


def ssd_decode_step(
    x_t: torch.Tensor,     # (B, H, P)
    dt_t: torch.Tensor,    # (B, H)
    a: torch.Tensor,       # (H,)
    b_t: torch.Tensor,     # (B, G, N)
    c_t: torch.Tensor,     # (B, G, N)
    state: torch.Tensor,   # (B, H, P, N) fp32
    d_skip: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence for serving; returns (y (B, H, P) in
    x_t's dtype, new state). ``state`` is not modified."""
    h = x_t.shape[1]
    rep = h // b_t.shape[1]
    f32 = torch.float32
    bb = _heads(b_t, rep, 1).to(f32)
    cb = _heads(c_t, rep, 1).to(f32)
    dec = torch.exp(dt_t.to(f32) * a.to(f32))
    state = state * dec[..., None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt_t.to(f32), x_t.to(f32), bb)
    y = torch.einsum("bhn,bhpn->bhp", cb, state)
    if d_skip is not None:
        y = y + d_skip.to(f32)[None, :, None] * x_t.to(f32)
    return y.to(x_t.dtype), state
