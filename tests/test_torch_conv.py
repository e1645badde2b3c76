"""The Mamba-2 mixer's causal conv + SiLU on the CPU: the closed-form
backward against autograd, the dispatch (CPU tensors take the plain
version bit for bit; fake CUDA tensors reach the kernels' wrappers, which
count their work and launch nothing), the wrappers' checks, the work
formulas and the launch counters. The kernels themselves run only on the
card (tests/test_torch_gpu.py)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from perfbench.work import conv as frozen  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.conv import kernel, ops, ref  # noqa: E402
from repro_torch.kernels.conv.work import (  # noqa: E402
    conv_backward_work, conv_work)
from repro_torch.models import ssm  # noqa: E402

# (B, L, widths of x, B and C) of the benchmark's cells: mamba2-2.7b at
# 4 x 2048 (d_inner 5120, G·N 128) and zamba2-7b at 2 x 4096 (7168, 2·64)
CELLS = {"mamba2": (4, 2048, (5120, 128, 128)),
         "zamba2_7b": (2, 4096, (7168, 128, 128))}
# bytes a call, forward and backward, in bf16 at K 4 (weights included)
CELL_BYTES = {"mamba2": (176_203_776, 264_327_168),
              "zamba2_7b": (243_329_024, 365_023_232)}


class _Recorder(FakeTensorMode):
    """A fake mode that keeps every kernel's work given to it."""

    def __init__(self):
        super().__init__()
        self.work = []

    def record_kernel(self, name, flops, nbytes):
        self.work.append((name, flops, nbytes))


@pytest.fixture
def no_library(monkeypatch):
    """Loading the kernels' library raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("the conv kernels' library was loaded")

    monkeypatch.setattr(kernel, "library", refuse)


@pytest.fixture
def no_plain_version(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a fake tensor reached the plain version")

    monkeypatch.setattr(ref, "causal_conv", refuse)


def _inputs(b, l, widths, k, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    xs = [torch.randn((b, l, c), generator=gen).to(dtype) for c in widths]
    ws = [(0.5 * torch.randn((k, c), generator=gen)).to(dtype)
          for c in widths]
    return xs, ws


@pytest.mark.parametrize("b,l,c,k", [(2, 37, 13, 4), (3, 2, 13, 4),
                                     (1, 1, 5, 4), (2, 20, 16, 3),
                                     (1, 9, 6, 2)],
                         ids=["ragged", "l_below_k", "one_step", "k3", "k2"])
def test_closed_form_backward_equals_autograd(b, l, c, k):
    """ref.causal_conv_silu_backward_reference against autograd through
    ref.causal_conv, both in float64, to 1e-12 relative: widths that are
    not multiples of 8, L below K, one step, K 2 and 3."""
    (x,), (w,) = _inputs(b, l, (c,), k, torch.float64)
    dy = torch.randn((b, l, c), generator=torch.Generator().manual_seed(9),
                     dtype=torch.float64)
    x.requires_grad_(True)
    w.requires_grad_(True)
    want_dx, want_dw = torch.autograd.grad(ref.causal_conv(x, w), (x, w), dy)
    dx, dw = ref.causal_conv_silu_backward_reference(x.detach(), w.detach(),
                                                     dy)
    assert dx.dtype == dw.dtype == torch.float64
    torch.testing.assert_close(dx, want_dx, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dw, want_dw, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cpu_dispatch_is_the_plain_version(dtype, no_library):
    """ops.causal_conv_silu on CPU tensors returns ref.causal_conv of each
    input bit for bit (fp32 weights against bf16 inputs too, cast where
    the plain version casts them), its gradients are autograd's through
    the plain version bit for bit, and no launch counter moves."""
    before = launch_counts()
    xs, ws = _inputs(2, 11, (24, 8, 8), 4, dtype)
    ws = [w.float() for w in ws]
    for t in xs + ws:
        t.requires_grad_(True)
    got = ops.causal_conv_silu(xs, ws)
    want = [ref.causal_conv(x, w) for x, w in zip(xs, ws)]
    assert len(got) == 3
    for g, y in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, y)
    dys = [torch.randn_like(y) for y in want]
    grads = torch.autograd.grad(got, xs + ws, dys)
    plain = torch.autograd.grad(want, xs + ws, dys)
    assert all(torch.equal(g, p) for g, p in zip(grads, plain))
    assert launch_counts() == before


def test_ssm_forward_keeps_its_cpu_conv():
    """models.ssm's _causal_conv and _silu are the plain version's, and
    ssm_forward on the CPU computes what the three plain calls compute."""
    assert ssm._causal_conv is ref.causal_conv and ssm._silu is ref.silu
    cfg = smoke_config("mamba2-130m")
    p = ssm.init_ssm_params(torch.Generator().manual_seed(0), cfg)
    h = torch.randn((2, 12, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    got = ssm.ssm_forward(cfg, p, h)
    calls = []
    real = ref.causal_conv

    def spy(x, w, tail=None):
        calls.append(tuple(x.shape))
        return real(x, w, tail)

    ref.causal_conv = spy
    try:
        again = ssm.ssm_forward(cfg, p, h)
    finally:
        ref.causal_conv = real
    gn = cfg.ssm_groups * cfg.ssm_state
    assert calls == [(2, 12, cfg.ssm_d_inner), (2, 12, gn), (2, 12, gn)]
    assert torch.equal(got, again)


@pytest.mark.parametrize("device,grad", [("cuda", False), ("cpu", True)],
                         ids=["cuda_no_grad", "cpu_grad"])
def test_fake_tensors_count_their_work(device, grad, no_plain_version):
    """Fake tensors go to the kernels' wrappers on any device (with grad
    through CausalConvSilu, whose backward is the CUDA backward; autograd
    runs fake CPU tensors here, as a CPU mesh's dry run does): the
    outputs' shapes and dtypes, exactly work.py's work given to the fake
    mode, and no launch counted."""
    before = launch_counts()
    rec = _Recorder()
    b, l, widths, k = 2, 40, (24, 16, 16), 4
    with rec:
        xs = [torch.empty((b, l, c), dtype=torch.bfloat16, device=device,
                          requires_grad=grad) for c in widths]
        ws = [torch.empty((k, c), dtype=torch.float32, device=device,
                          requires_grad=grad) for c in widths]
        with torch.set_grad_enabled(grad):
            ys = ops.causal_conv_silu(xs, ws)
            if grad:
                grads = torch.autograd.grad(ys, xs + ws,
                                            [torch.ones_like(y) for y in ys])
    assert [tuple(y.shape) for y in ys] == [(b, l, c) for c in widths]
    assert all(y.dtype == torch.bfloat16 and y.device.type == device
               for y in ys)
    args = (b, l, widths, k, torch.bfloat16)
    want = [("causal_conv_fwd", *conv_work(*args))]
    if grad:
        want.append(("causal_conv_bwd", *conv_backward_work(*args)))
        assert [tuple(g.shape) for g in grads] == (
            [(b, l, c) for c in widths] + [(k, c) for c in widths])
        assert [g.dtype for g in grads] == [torch.bfloat16] * 3 + [
            torch.float32] * 3
    assert rec.work == want
    assert launch_counts() == before


def test_fake_ssm_layer_makes_one_conv_call():
    """A mamba2 smoke layer's forward on fake CUDA tensors calls the conv
    kernels once for its three inputs, at the layer's widths."""
    cfg = dataclasses.replace(smoke_config("mamba2-130m"),
                              compute_dtype="bfloat16")
    rec = _Recorder()
    shapes = {name: t.shape for name, t in ssm.init_ssm_params(
        None, cfg, device="meta").items()}
    with rec, torch.no_grad():
        p = {name: torch.empty(shape, dtype=torch.bfloat16, device="cuda")
             for name, shape in shapes.items()}
        ssm.ssm_forward(cfg, p, torch.empty((2, 64, cfg.d_model),
                                            dtype=torch.bfloat16,
                                            device="cuda"))
    gn = cfg.ssm_groups * cfg.ssm_state
    convs = [w for w in rec.work if w[0].startswith("causal_conv")]
    assert convs == [("causal_conv_fwd", *conv_work(
        2, 64, (cfg.ssm_d_inner, gn, gn), cfg.ssm_conv, torch.bfloat16))]


def _cuda_like(shape, dtype=torch.bfloat16):
    """A CPU tensor: the wrappers' device check refuses it."""
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("case", [
    "cpu", "k5", "k3", "k1", "dtype", "fp32", "weight_dtype", "width",
    "batch", "too_many", "strided", "dy_shape", "empty"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case, no_library):
    """ValueError before any library is loaded, for each input the
    kernels do not take."""
    x, w = _cuda_like((2, 8, 16)), _cuda_like((4, 16))
    xs, ws, dys = [x], [w], None
    if case == "k5":
        ws = [_cuda_like((5, 16))]
    elif case == "k3":
        ws = [_cuda_like((3, 16))]
    elif case == "k1":
        ws = [_cuda_like((1, 16))]
    elif case == "dtype":
        xs, ws = [x.half()], [w.half()]
    elif case == "fp32":
        xs, ws = [x.float()], [w.float()]
    elif case == "weight_dtype":
        ws = [w.float()]
    elif case == "width":
        ws = [_cuda_like((4, 15))]
    elif case == "batch":
        xs, ws = [x, _cuda_like((3, 8, 16))], [w, w]
    elif case == "too_many":
        xs, ws = [x] * 5, [w] * 5
    elif case == "strided":
        xs = [_cuda_like((2, 16, 8)).transpose(1, 2)]
        ws = [_cuda_like((4, 16))]
    elif case == "dy_shape":
        dys = [_cuda_like((2, 7, 16))]
    elif case == "empty":
        xs = [_cuda_like((2, 0, 16))]
    match = {"cpu": "CUDA tensors", "k5": "K in", "k3": "K in", "k1": "K in",
             "dtype": "takes bfloat16", "fp32": "takes bfloat16",
             "weight_dtype": "one dtype",
             "width": "width", "batch": "one", "too_many": "1 to 4",
             "strided": "contiguous", "dy_shape": "dy",
             "empty": "empty"}[case]
    with pytest.raises(ValueError, match=match):
        if dys is None:
            kernel.causal_conv_fwd(xs, ws)
        else:
            kernel.causal_conv_bwd(xs, ws, dys)


def test_forward_refuses_inputs_that_require_grad():
    x = torch.zeros((1, 4, 8), requires_grad=True)
    with pytest.raises(RuntimeError, match="CausalConvSilu"):
        kernel.causal_conv_fwd([x], [torch.zeros((4, 8))])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_work_bytes_at_the_cells(cell):
    """work.py's bytes at both cells' layer shapes (bf16, K 4): 2·B·L·C·2
    forward and 3·B·L·C·2 backward, with the weights read (and dw
    written); the benchmark's frozen copy gives the same work."""
    b, l, widths = CELLS[cell]
    args = (b, l, widths, 4, torch.bfloat16)
    fwd, bwd = conv_work(*args), conv_backward_work(*args)
    assert (fwd[1], bwd[1]) == CELL_BYTES[cell]
    c = sum(widths)
    assert fwd[0] == 12.0 * b * l * c and bwd[0] == 33.0 * b * l * c
    assert frozen.conv_work(*args) == fwd
    assert frozen.conv_backward_work(*args) == bwd


def test_partial_rows_follow_the_runs():
    """One partial row of dw per batch row and block of 8 runs of 32
    steps: mamba2's cell 4 x 8, one step 1, 257 steps 2."""
    assert kernel.partial_rows(4, 2048) == 32
    assert kernel.partial_rows(2, 4096) == 32
    assert kernel.partial_rows(1, 1) == 1
    assert kernel.partial_rows(1, 257) == 2


def test_launch_counts_hold_the_conv_keys():
    counts = launch_counts()
    assert counts["causal_conv_fwd"] == kernel.causal_conv_fwd.launches
    assert counts["causal_conv_bwd"] == kernel.causal_conv_bwd.launches
