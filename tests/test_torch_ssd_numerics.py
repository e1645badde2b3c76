"""Why the bf16 SSD kernels split their fp32 operands into bf16 hi + lo.

``csrc/ssd_fwd.cu`` multiplies on the tensor cores in bf16. C·Bᵀ is exact
from the bf16 inputs, but three operands are fp32 in the TPU kernel's
arithmetic: the gate exp(cum_i − cum_j)(C_i·B_j)dt_j, the w-weighted x of
the chunk-state product and the carried state. The kernel splits each into
hi + lo bf16 parts. This test emulates that arithmetic in float64 with the
same roundings (bf16 operands, fp32 gate, state and recurrence) at the
serving head shape (P 64, N 128, chunk 256) and holds it, as the card's
check does, against the plain version evaluated in float64: with all
three split, every output is within ``_tol``; with any one of them
rounded once to bf16, some are not. The second half does the same for the
backward (``csrc/ssd_bwd.cu``) and its six fp32 operands, against autograd
through the plain version in float64. It runs on the CPU and imports no
JAX; the kernels themselves are checked on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd import ref  # noqa: E402

B, L, H, P, N, Q = 1, 2048, 8, 64, 128, 256
TOL_Y, TOL_STATE = 2e-2, 2e-4   # tests/test_kernels.py::_tol, bf16 and fp32


def _inputs():
    rng = np.random.default_rng(0)
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    x = t(B, L, H, P).bfloat16()
    dt = torch.nn.functional.softplus(t(B, L, H))
    a = -torch.exp(t(H) * 0.3)
    bm, cm = t(B, L, 1, N).bfloat16(), t(B, L, 1, N).bfloat16()
    return x, dt, a, bm, cm


def _round(t, split):
    """fp32 value t as the kernel multiplies it: bf16 hi + lo, or bf16."""
    t = t.float()
    hi = t.bfloat16().float()
    if not split:
        return hi.double()
    return hi.double() + (t - hi).bfloat16().double()


def _emulate(x, dt, a, bm, cm, split_w, split_s, split_g):
    nc = L // Q
    xs = x.double().reshape(B, nc, Q, H, P)
    bs = bm.double().reshape(B, nc, Q, N)
    cs = cm.double().reshape(B, nc, Q, N)
    dts = dt.reshape(B, nc, Q, H)
    cum = torch.cumsum((dts * a).double(), 2)               # fp64 cumsum
    last = cum[:, :, -1:, :]
    w = (torch.exp((last - cum).float()) * dts).double()     # fp32
    local = torch.einsum("bzjhp,bzjn->bzhpn",
                         _round(w[..., None] * xs, split_w), bs).float()
    decay = torch.exp(last[:, :, 0, :].float())
    s = torch.zeros(B, H, P, N)
    carried = []
    for z in range(nc):                                      # fp32 recurrence
        carried.append(s)
        s = s * decay[:, z, :, None, None] + local[:, z]
    y = torch.einsum("bzin,bzhpn->bzihp", cs,
                     _round(torch.stack(carried, 1), split_s))
    y = y * torch.exp(cum.float()).double()[..., None]
    score = torch.einsum("bzin,bzjn->bzij", cs, bs).float().double()
    ct = cum.permute(0, 1, 3, 2)                             # (B, nc, H, Q)
    live = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    expo = torch.where(live, ct[..., :, None] - ct[..., None, :], 0.0)
    gate = torch.exp(expo.float()).double() * score[:, :, None] * \
        dts.permute(0, 1, 3, 2).double()[..., None, :]
    gate = _round(torch.where(live, gate, 0.0), split_g)
    y = y + torch.einsum("bzhij,bzjhp->bzihp", gate, xs)
    return y.reshape(B, L, H, P) + 0.5 * x.double(), s.double()


@pytest.fixture(scope="module")
def exact():
    x, dt, a, bm, cm = _inputs()
    y64, s64 = ref.ssd_reference(
        x.double(), dt.double(), a.double(), bm.double(), cm.double(),
        chunk=Q, d_skip=torch.full((H,), 0.5, dtype=torch.float64),
        return_final_state=True)
    return (x, dt, a, bm, cm), y64.bfloat16().float(), s64


def _outside(exact, split_w, split_s, split_g):
    inputs, want_y, want_s = exact
    y, s = _emulate(*inputs, split_w, split_s, split_g)
    err_y = (y.bfloat16().float() - want_y).abs()
    err_s = (s - want_s).abs()
    return (int((err_y > TOL_Y + TOL_Y * want_y.abs()).sum()),
            int((err_s > TOL_STATE + TOL_STATE * want_s.abs()).sum()))


def test_hi_lo_splits_keep_every_output_within_tol(exact):
    assert _outside(exact, True, True, True) == (0, 0)


@pytest.mark.parametrize("rounded", ["gate", "carried_state", "weighted_x"])
def test_rounding_any_split_operand_once_breaks_tol(exact, rounded):
    y_out, s_out = _outside(exact, rounded != "weighted_x",
                            rounded != "carried_state", rounded != "gate")
    assert (s_out if rounded == "weighted_x" else y_out) > 0


# ---- the backward ----------------------------------------------------------
#
# csrc/ssd_bwd.cu's bf16 path multiplies on the tensor cores in bf16 with
# fp32 accumulation. C·Bᵀ and dy·xᵀ are exact from the bf16 inputs; six
# operands are fp32: the w-weighted x of the local state and the
# exp(cum)-weighted dy of the state gradient's local term, the carried
# state S_prev (dC's carried term), the state gradient G (dx's and dB's
# state terms), the gate and M. The sums that feed dcum are fp64. The
# emulation below takes each product as the kernel does, with each of the
# six operands split hi + lo or rounded once to bf16, and holds every
# gradient as the card holds the bf16 rows: divided by its float64
# autograd reference's max-abs, at TOL_Y.

BWD_SPLITS = ("weighted_x", "weighted_dy", "carried_state", "state_grad",
              "gate", "m")


def _bwd_inputs():
    x, dt, a, bm, cm = _inputs()
    rng = np.random.default_rng(1)
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    return x, dt, a, bm, cm, t(B, L, H, P).bfloat16(), t(B, H, P, N), \
        t(B, H, P, N)


def _f32(t):
    """An fp32 accumulator's or product's result, held in float64."""
    return t.float().double()


def _recur(local, decay, init, reverse):
    """The fp32 recurrence over the chunks: (value carried into or out of
    each chunk, the last value)."""
    nc = local.shape[1]
    s = init.float()
    out = [None] * nc
    for z in (reversed(range(nc)) if reverse else range(nc)):
        out[z] = s
        s = s * decay[:, z, :, None, None] + local[:, z].float()
    return torch.stack(out, 1).double(), s.double()


def _emulate_backward(x, dt, a, bm, cm, dy, s0, dfin, split):
    """The bf16 kernel's arithmetic, with split[name] choosing hi + lo or
    one bf16 rounding for each fp32 operand of BWD_SPLITS."""
    nc = L // Q
    xs = x.double().reshape(B, nc, Q, H, P)
    dys = dy.double().reshape(B, nc, Q, H, P)
    bs = bm.double().reshape(B, nc, Q, N)
    cs = cm.double().reshape(B, nc, Q, N)
    dts = dt.reshape(B, nc, Q, H)
    cum = torch.cumsum((dts * a).double(), 2)                # fp64 cumsum
    last = cum[:, :, -1:, :]
    w = (torch.exp((last - cum).float()) * dts).double()     # fp32
    ecum = torch.exp(cum.float()).double()
    decay = torch.exp(last[:, :, 0, :].float())

    # passes 1-4: local terms and the two recurrences
    wx = (w[..., None].float() * x.float().reshape(B, nc, Q, H, P)).double()
    local = _f32(torch.einsum("bzjhp,bzjn->bzhpn",
                              _round(wx, split["weighted_x"]), bs))
    s_prev, s_last = _recur(local, decay, s0, False)
    edy = (ecum[..., None].float() * dy.float().reshape(B, nc, Q, H, P))
    dlocal = _f32(torch.einsum("bzihp,bzin->bzhpn",
                               _round(edy.double(), split["weighted_dy"]), cs))
    gs, ds0 = _recur(dlocal, decay, dfin, True)

    # the pairwise tiles, (B, nc, H, i, j)
    score = _f32(torch.einsum("bzin,bzjn->bzij", cs, bs))[:, :, None]
    dot = _f32(torch.einsum("bzihp,bzjhp->bzhij", dys, xs))
    ct = cum.permute(0, 1, 3, 2)                             # (B, nc, H, Q)
    live = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    expo = torch.where(live, ct[..., :, None] - ct[..., None, :], 0.0)
    ell = torch.exp(expo.float()).double()
    dt_j = dts.permute(0, 1, 3, 2).double()[..., None, :]
    m = torch.where(live, _f32(_f32(dot * ell) * dt_j), 0.0)
    gate = torch.where(live, _f32(_f32(ell * score) * dt_j), 0.0)
    f = torch.where(live, _f32(_f32(ell * score) * dot), 0.0)

    # pass 5: dC and the query side of dcum
    dc_state = _f32(torch.einsum("bzihp,bzhpn->bzihn", dys,
                                 _round(s_prev, split["carried_state"])))
    dc_state = _f32(dc_state * ecum[..., None])
    dcum = (_f32(cs[:, :, :, None] * dc_state)).sum(-1)
    dcum = dcum + _f32(score * m).sum(-1).permute(0, 1, 3, 2)
    dc = dc_state + torch.einsum("bzhij,bzjn->bzihn",
                                 _round(m, split["m"]), bs)

    # pass 6: dx, dB, the direct ddt and the key side of dcum
    g_r = _round(gs, split["state_grad"])
    gb = _f32(torch.einsum("bzjn,bzhpn->bzjhp", bs, g_r))
    dw = _f32(xs * gb).sum(-1)
    gx = _f32(torch.einsum("bzjhp,bzhpn->bzjhn", xs, g_r))
    dx = (_f32(w[..., None] * gb)
          + torch.einsum("bzhij,bzihp->bzjhp", _round(gate, split["gate"]), dys)
          + 0.5 * dys)
    db = (_f32(w[..., None] * gx)
          + torch.einsum("bzhij,bzin->bzjhn", _round(m, split["m"]), cs))
    fcol = f.sum(-2).permute(0, 1, 3, 2)
    ddt = _f32(fcol + torch.exp((last - cum).float()).double() * dw)
    dcum = dcum - dts.double() * fcol - w * dw

    # pass 7 onwards: <G, S_out>, the reverse cumsum, da, dD, the groups
    s_out = torch.cat([s_prev[:, 1:], s_last[:, None]], 1)
    dcum[:, :, -1] += (gs * s_out).sum((-1, -2))
    dda = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    ddt = _f32(ddt + _f32(a.double() * _f32(dda)))
    da = (dts.double() * dda).sum((0, 1, 2))
    dd = (dys * xs).sum((0, 1, 2, 4))
    return (dx.reshape(B, L, H, P).bfloat16(), ddt.reshape(B, L, H), da,
            _f32(db.sum(3)).reshape(B, L, 1, N).bfloat16(),
            _f32(dc.sum(3)).reshape(B, L, 1, N).bfloat16(), dd, ds0)


@pytest.fixture(scope="module")
def exact_grads():
    x, dt, a, bm, cm, dy, s0, dfin = inputs = _bwd_inputs()
    leaves = [t.double().requires_grad_() for t in (x, dt, a, bm, cm)]
    d = torch.full((H,), 0.5, dtype=torch.float64, requires_grad=True)
    s0_ = s0.double().requires_grad_()
    y, s = ref.ssd_reference(*leaves, chunk=Q, d_skip=d, initial_state=s0_,
                             return_final_state=True)
    want = torch.autograd.grad([y, s], leaves + [d, s0_],
                               [dy.double(), dfin.double()])
    return inputs, want


GRADS = ("dx", "ddt", "da", "dB", "dC", "dD", "ds0")


def _errors(exact_grads, unsplit=None):
    """Each gradient's largest error over its reference's max-abs, and how
    many elements lie outside TOL_Y of the normalised reference, with every
    operand split but `unsplit`."""
    inputs, want = exact_grads
    split = {name: name != unsplit for name in BWD_SPLITS}
    got = _emulate_backward(*inputs, split)
    worst, outside = {}, 0
    for name, g, w in zip(GRADS, got, want):
        m = w.abs().max()
        err = (g.double() - w) / m
        worst[name] = float(err.abs().max())
        outside += int((err.abs() > TOL_Y + TOL_Y * (w / m).abs()).sum())
    return worst, outside


def test_backward_hi_lo_splits_keep_every_gradient_within_tol(exact_grads):
    worst, outside = _errors(exact_grads)
    assert outside == 0 and max(worst.values()) < TOL_Y / 4, worst


# What rounding each operand once to bf16 costs at this shape, on the
# gradient it moves most (the error of that gradient over its max-abs, all
# split -> this one rounded): the weighted x 4.4e-5 -> 2.7e-2 on da, past
# TOL_Y; G 4.4e-5 -> 1.9e-2 on da; the weighted dy 4.2e-6 -> 3.1e-3 on the
# initial state's gradient; S_prev 1.7e-6 -> 3.1e-4 on ddt; the gate
# 2.0e-3 -> 3.8e-3 on dx; M 2.6e-3 -> 3.1e-3 on dC. No single rounding
# puts an element outside the normalised tolerance here, but the first two
# leave da no margin, and rounding all six does break it. The kernel
# splits all six.
BWD_COSTS = [
    ("weighted_x", "da", 100.0),
    ("state_grad", "da", 100.0),
    ("weighted_dy", "ds0", 100.0),
    ("carried_state", "ddt", 10.0),
    ("gate", "dx", 1.5),
    ("m", "dC", 1.1),
]


@pytest.mark.parametrize("operand,grad,factor", BWD_COSTS,
                         ids=[c[0] for c in BWD_COSTS])
def test_backward_rounding_a_split_operand_once_costs(exact_grads, operand,
                                                      grad, factor):
    split, _ = _errors(exact_grads)
    once, _ = _errors(exact_grads, unsplit=operand)
    assert once[grad] > factor * split[grad], (split[grad], once[grad])


def test_backward_rounding_every_operand_once_breaks_tol(exact_grads):
    inputs, want = exact_grads
    got = _emulate_backward(*inputs, {name: False for name in BWD_SPLITS})
    m = want[2].abs().max()
    err = (got[2] - want[2]) / m
    assert int((err.abs() > TOL_Y + TOL_Y * (want[2] / m).abs()).sum()) > 0
