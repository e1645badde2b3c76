"""Plain PyTorch versions of the Mamba-2 SSD (state-space duality)
primitive: the chunked dual form, the token-by-token recurrence and the
one-token decode step. Port of ``repro.kernels.ssd.ref``, with the JAX
package's layouts at every function; its ``lax.scan`` over chunks and
over tokens is a Python loop here.

:func:`ssd_reference` is the correctness reference of the CUDA kernel
(``csrc/ssd_fwd.cu``) and the path :func:`..ops.ssd` takes for tensors on
the CPU.

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

__all__ = ["ssd_reference", "ssd_sequential", "ssd_decode_step"]


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
    g, n = b_mat.shape[2], b_mat.shape[3]
    l_orig = l
    if l % chunk != 0:
        # pad the tail: dt=0 ⇒ decay=1 and no state contribution, so the
        # final state is unaffected; padded outputs are sliced off.
        pad = chunk - l % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
        l = l + pad
    nc = l // chunk
    rep = h // g

    acc = _acc_dtype(x)
    xc = x.reshape(bsz, nc, chunk, h, p).to(acc)
    dtc = dt.reshape(bsz, nc, chunk, h).to(acc)
    bc = _heads(b_mat.reshape(bsz, nc, chunk, g, n), rep, 3).to(acc)
    cc = _heads(c_mat.reshape(bsz, nc, chunk, g, n), rep, 3).to(acc)

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

    s = (initial_state.to(acc) if initial_state is not None
         else torch.zeros((bsz, h, p, n), dtype=acc, device=x.device))
    s_prevs = []
    for z in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, z, :, None, None] + s_local[:, z]
    s_prevs = torch.stack(s_prevs, dim=1)                  # (B,nc,H,P,N)

    # y_inter_i = exp(cum_i) * C_i · S_prev
    y_inter = torch.einsum("bzih,bzihn,bzhpn->bzihp", torch.exp(cum), cc,
                           s_prevs)

    y = (y_intra + y_inter).reshape(bsz, l, h, p)
    if d_skip is not None:
        y = y + d_skip.to(acc)[None, None, :, None] * x.to(acc)
    y = y[:, :l_orig].to(x.dtype)
    if return_final_state:
        return y, s
    return y


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
