"""Why the bf16 SSD kernel splits its fp32 operands into bf16 hi + lo.

``csrc/ssd_fwd.cu`` multiplies on the tensor cores in bf16. C·Bᵀ is exact
from the bf16 inputs, but three operands are fp32 in the TPU kernel's
arithmetic: the gate exp(cum_i − cum_j)(C_i·B_j)dt_j, the w-weighted x of
the chunk-state product and the carried state. The kernel splits each into
hi + lo bf16 parts. This test emulates that arithmetic in float64 with the
same roundings (bf16 operands, fp32 gate, state and recurrence) at the
serving head shape (P 64, N 128, chunk 256) and holds it, as the card's
check does, against the plain version evaluated in float64: with all
three split, every output is within ``_tol``; with any one of them
rounded once to bf16, some are not. It runs on the CPU; the kernel itself
is checked on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
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
