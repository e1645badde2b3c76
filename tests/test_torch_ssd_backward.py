"""The SSD backward's plain version (repro_torch.kernels.ssd.ref.
ssd_backward_reference) on the CPU, against autograd through the port's
ssd_reference and against jax.vjp of the JAX package's ssd_reference, on
the same numpy inputs; and the CUDA backward wrapper's refusals, which
need no card. The CUDA kernel itself runs only on the card:
tests/test_torch_gpu.py and chip_smoke.py.

Tolerance: tests/test_kernels.py::_tol of the row's dtype, on every
gradient divided by its reference's max-abs, the criterion chip_smoke.py
holds the flash and SSD backward kernels to. Two fp32 evaluations of the
same gradients (the chunked cumsum of dt·a in fp32, sums of terms a few
hundred large) differ by up to 4e-3 on a da of max-abs 400 (each is that
far from the float64 evaluation), which an elementwise 2e-4 cannot hold
where terms cancel; autograd in bf16 rounds each head's dB and dC to bf16
before summing the heads of a group. test_backward_reference_is_exact_in_
float64 holds the formulas themselves to 1e-10."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd import ref as jref  # noqa: E402
from repro_torch.kernels.ssd import kernel, ops, ref  # noqa: E402
from test_kernels import SSD_SWEEP, _tol  # noqa: E402
from test_torch_ssd import _inputs, _ok_inputs, _split  # noqa: E402
from torch_parity import normal, to_np  # noqa: E402

# (B, L, H, P, G, N, chunk, dtype, with_state): the kernel sweep without
# states, then ragged L (a short last chunk, L below one chunk), G > 1
# and G == H, an initial state in and a final-state gradient, in fp32 and
# bf16.
ROWS = [row + (False,) for row in SSD_SWEEP] + [
    (2, 100, 4, 16, 2, 32, 64, jnp.float32, True),
    (1, 37, 4, 8, 4, 8, 64, jnp.float32, True),
    (1, 200, 6, 16, 3, 16, 32, jnp.float32, True),
    (1, 128, 4, 64, 1, 64, 64, jnp.float32, True),
    (1, 300, 4, 16, 1, 32, 128, jnp.bfloat16, True),
    (2, 96, 4, 16, 2, 32, 32, jnp.bfloat16, True),
]
IDS = ([f"ssd{i}" for i in range(len(SSD_SWEEP))]
       + [f"state{i}" for i in range(len(ROWS) - len(SSD_SWEEP))])
NAMES = ("dx", "ddt", "da", "dB", "dC", "dD", "ds0")


def _row_inputs(b, l, h, p, g, n, dtype, with_state, seed=21):
    """The forward's inputs (as _inputs), dy in x's dtype, and with_state's
    initial state and final-state gradient (fp32): (jax, torch) lists."""
    dname = "bfloat16" if dtype == jnp.bfloat16 else "float32"
    jargs, targs = _split(_inputs(seed, b, l, h, p, g, n, dname))
    rng = np.random.default_rng(seed + 1)
    jdy, tdy = normal(rng, (b, l, h, p), dname)
    if with_state:
        (js0, ts0), (jdf, tdf) = (normal(rng, (b, h, p, n)) for _ in range(2))
    else:
        js0 = ts0 = jdf = tdf = None
    return (jargs, jdy, js0, jdf), (targs, tdy, ts0, tdf)


def _close(got, want, dtype, what):
    assert got.shape == want.shape, what
    got, want = to_np(got), to_np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, err_msg=what,
                               **_tol(dtype))


@pytest.mark.parametrize("b,l,h,p,g,n,chunk,dtype,with_state", ROWS, ids=IDS)
def test_backward_reference_equals_autograd(b, l, h, p, g, n, chunk, dtype,
                                            with_state):
    _, (targs, dy, s0, dfin) = _row_inputs(b, l, h, p, g, n, dtype,
                                           with_state)
    x, dt, a, bm, cm, d = targs
    got = ref.ssd_backward_reference(x, dt, a, bm, cm, dy, chunk=chunk,
                                     d_skip=d, initial_state=s0,
                                     d_final_state=dfin)
    leaves = [t.clone().requires_grad_() for t in targs]
    s0_leaf = s0.clone().requires_grad_() if with_state else None
    y, s_out = ref.ssd_reference(*leaves[:5], chunk=chunk, d_skip=leaves[5],
                                 initial_state=s0_leaf,
                                 return_final_state=True)
    outs, grads_out = [y], [dy]
    if with_state:
        outs.append(s_out)
        grads_out.append(dfin)
    want = torch.autograd.grad(outs, leaves + ([s0_leaf] if with_state
                                               else []), grads_out)
    assert got[6] is None if not with_state else got[6].dtype == torch.float32
    for name, gg, ww, inp in zip(NAMES, got, want, leaves + [s0_leaf]):
        assert gg.dtype == inp.dtype, name
        _close(gg, ww, dtype, name)


@pytest.mark.parametrize("b,l,h,p,g,n,chunk,dtype,with_state", ROWS, ids=IDS)
def test_backward_reference_matches_jax_vjp(b, l, h, p, g, n, chunk, dtype,
                                            with_state):
    (jargs, jdy, js0, jdf), (targs, dy, s0, dfin) = _row_inputs(
        b, l, h, p, g, n, dtype, with_state)
    x, dt, a, bm, cm, d = targs
    got = ref.ssd_backward_reference(x, dt, a, bm, cm, dy, chunk=chunk,
                                     d_skip=d, initial_state=s0,
                                     d_final_state=dfin)
    if with_state:
        def fn(*args):
            return jref.ssd_reference(*args[:5], chunk=chunk, d_skip=args[5],
                                      initial_state=args[6],
                                      return_final_state=True)
        args, cot = tuple(jargs) + (js0,), (jdy, jdf)
    else:
        def fn(*args):
            return jref.ssd_reference(*args[:5], chunk=chunk, d_skip=args[5])
        args, cot = tuple(jargs), jdy
    # jitted: the JAX package's chunk loop runs op by op otherwise
    want = jax.jit(lambda a, c: jax.vjp(fn, *a)[1](c))(args, cot)
    for name, gg, ww in zip(NAMES, got, want):
        _close(gg, ww, dtype, name)


def test_backward_reference_is_exact_in_float64():
    """On float64 inputs the written-out backward and autograd through the
    float64 forward agree far below fp32 rounding: the formulas, not only
    their rounding, are the same."""
    _, (targs, dy, s0, dfin) = _row_inputs(2, 90, 4, 8, 2, 16, jnp.float32,
                                           True)
    up = [t.double() for t in targs]
    got = ref.ssd_backward_reference(*up[:5], dy.double(), chunk=32,
                                     d_skip=up[5], initial_state=s0.double(),
                                     d_final_state=dfin.double())
    leaves = [t.clone().requires_grad_() for t in up + [s0.double()]]
    y, s_out = ref.ssd_reference(*leaves[:5], chunk=32, d_skip=leaves[5],
                                 initial_state=leaves[6],
                                 return_final_state=True)
    want = torch.autograd.grad([y, s_out], leaves, [dy.double(),
                                                    dfin.double()])
    for name, gg, ww in zip(NAMES, got, want):
        assert gg.dtype == torch.float64, name
        np.testing.assert_allclose(gg.numpy(), ww.numpy(), rtol=1e-10,
                                   atol=1e-10, err_msg=name)


def test_ops_ssd_on_the_cpu_differentiates_the_plain_version():
    """ops.ssd takes the plain version for CPU tensors, and autograd through
    it gives ssd_backward_reference's gradients."""
    _, (targs, dy, s0, dfin) = _row_inputs(1, 70, 4, 16, 2, 16, jnp.float32,
                                           True)
    leaves = [t.clone().requires_grad_() for t in targs + [s0]]
    y, s_out = ops.ssd(*leaves[:5], chunk=32, d_skip=leaves[5],
                       initial_state=leaves[6], return_final_state=True)
    grads = torch.autograd.grad([y, s_out], leaves, [dy, dfin])
    want = ref.ssd_backward_reference(*targs[:5], dy, chunk=32,
                                      d_skip=targs[5], initial_state=s0,
                                      d_final_state=dfin)
    for name, gg, ww in zip(NAMES, grads, want):
        _close(gg, ww, jnp.float32, name)


def _bwd_args(dtype=torch.bfloat16, p=64, n=128):
    """tests/test_torch_ssd.py::_ok_inputs and a dy of x's shape."""
    args = _ok_inputs(dtype, p, n)
    return {**args, "dy": torch.zeros_like(args["x"])}


@pytest.mark.parametrize("case", [
    "head_dim", "state_size", "dtype", "fp32", "dy_dtype", "dy_shape",
    "mixed_dtype", "dt_dtype", "groups", "chunk", "final_state_grad",
    "cpu_tensor",
])
def test_cuda_backward_refuses_before_the_library_loads(case, monkeypatch):
    """ssd_scan_backward raises ValueError for every input its kernel does
    not take, before it builds or loads the library and before it counts
    a launch; a CPU tensor is refused too (no fallback to the plain
    version), and fp32 x, B, C and dy for their dtype, the kernels taking
    bf16 only."""
    args = _bwd_args()
    kw = dict(chunk=64)
    if case == "head_dim":
        args = _bwd_args(p=80)
    elif case == "state_size":
        args = _bwd_args(n=48)
    elif case == "dtype":
        args = {k: v.half() if k in ("x", "b_mat", "c_mat", "dy") else v
                for k, v in args.items()}
    elif case == "fp32":
        args = _bwd_args(torch.float32)
    elif case == "dy_dtype":
        args["dy"] = args["dy"].float()
    elif case == "dy_shape":
        args["dy"] = torch.zeros(1, 64, 4, 32, dtype=torch.bfloat16)
    elif case == "mixed_dtype":
        args["c_mat"] = args["c_mat"].float()
    elif case == "dt_dtype":
        args["dt"] = args["dt"].bfloat16()
    elif case == "groups":
        args["b_mat"] = torch.zeros(1, 64, 3, 128, dtype=torch.bfloat16)
        args["c_mat"] = args["b_mat"].clone()
    elif case == "chunk":
        kw["chunk"] = kernel.MAX_CHUNK + 1
    elif case == "final_state_grad":
        kw["d_final_state"] = torch.zeros(1, 4, 64, 64)

    def no_build():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(kernel, "backward_library", no_build)
    before = kernel.ssd_scan_backward.launches
    with pytest.raises(ValueError,
                       match="want all bfloat16" if case == "fp32" else None):
        kernel.ssd_scan_backward(**args, **kw)
    assert kernel.ssd_scan_backward.launches == before


def test_autograd_function_refuses_cpu_tensors():
    """SSDScan is the card's differentiable path: on CPU tensors its
    forward raises instead of running the plain version."""
    args = _bwd_args()
    args.pop("dy")
    x = args.pop("x").requires_grad_()
    with pytest.raises(ValueError):
        kernel.SSDScan.apply(x, *args.values(), 64, None, None, False)


def test_cuda_forward_refuses_inputs_that_require_grad():
    """kernel.ssd_scan returns a tensor with no autograd graph: under grad
    mode it refuses inputs that require grad (it would cut their gradient)
    before any other check; ops.ssd's SSDScan is the differentiable path."""
    args = _ok_inputs()
    args["dt"] = args["dt"].requires_grad_()
    before = kernel.ssd_scan.launches
    with pytest.raises(RuntimeError, match="SSDScan"):
        kernel.ssd_scan(**args, chunk=64)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        kernel.ssd_scan(**args, chunk=64)
    assert kernel.ssd_scan.launches == before
