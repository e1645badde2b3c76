"""The port's SSD primitive (repro_torch.kernels.ssd) on the CPU: its
plain versions against the JAX package's oracles and Pallas kernel
(interpreted), the chunked form against the token-by-token recurrence,
the state carry, the dispatching wrapper, and the launch checks of the
CUDA wrapper. The CUDA kernel itself runs only on the card:
tests/test_torch_gpu.py.

Tolerances: tests/test_kernels.py::_tol for the kernel sweep; 5e-4 for
chunked against sequential and 1e-4 for the state carry, as the JAX
package's own tests of the same properties."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd import ref as jref  # noqa: E402
from repro.kernels.ssd.kernel import ssd_pallas  # noqa: E402
from repro_torch.kernels.ssd import kernel, ops, ref  # noqa: E402
from test_kernels import SSD_SWEEP, _tol  # noqa: E402
from torch_parity import normal, to_np  # noqa: E402

_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _inputs(seed, b, l, h, p, g, n, dtype="float32"):
    """x, dt (softplus of a normal, fp32), a (negative), B, C, d_skip:
    the same values for both packages, as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    x = normal(rng, (b, l, h, p), dtype)
    dt_np = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(
        np.float32)
    a_np = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    bm = normal(rng, (b, l, g, n), dtype)
    cm = normal(rng, (b, l, g, n), dtype)
    d_np = np.full((h,), 0.5, np.float32)
    pair = lambda v: (jnp.asarray(v), torch.from_numpy(v))  # noqa: E731
    return x, pair(dt_np), pair(a_np), bm, cm, pair(d_np)


def _split(args):
    return [a[0] for a in args], [a[1] for a in args]


def _dname(dtype):
    return "bfloat16" if dtype == jnp.bfloat16 else "float32"


@pytest.mark.parametrize(
    "b,l,h,p,g,n,chunk,dtype", SSD_SWEEP,
    ids=[f"ssd{i}" for i in range(len(SSD_SWEEP))],
)
def test_plain_ssd_vs_jax_reference_and_pallas(b, l, h, p, g, n, chunk,
                                               dtype):
    (jx, jdt, ja, jb, jc, jd), (tx, tdt, ta, tb, tc, td) = _split(
        _inputs(7, b, l, h, p, g, n, _dname(dtype)))
    got = ref.ssd_reference(tx, tdt, ta, tb, tc, chunk=chunk, d_skip=td)
    assert got.dtype == _TORCH[dtype] and got.shape == (b, l, h, p)
    want = jref.ssd_reference(jx, jdt, ja, jb, jc, chunk=chunk, d_skip=jd)
    np.testing.assert_allclose(to_np(got), to_np(want), **_tol(dtype))
    pallas = ssd_pallas(jx, jdt, ja, jb, jc, chunk=chunk, d_skip=jd,
                        interpret=True)
    np.testing.assert_allclose(to_np(got), to_np(pallas), **_tol(dtype))
    # the wrapper takes the plain version for CPU tensors, bit for bit
    via_ops = ops.ssd(tx, tdt, ta, tb, tc, chunk=chunk, d_skip=td)
    assert torch.equal(via_ops, got)


@pytest.mark.parametrize("l,chunk", [(64, 16), (100, 32), (37, 64)],
                         ids=["even", "ragged", "short"])
def test_final_state_and_initial_state_match_jax(l, chunk):
    """Initial state in, final state out, ragged L (padded path)."""
    b, h, p, g, n = 2, 4, 16, 2, 32
    (jx, jdt, ja, jb, jc, jd), (tx, tdt, ta, tb, tc, td) = _split(
        _inputs(11, b, l, h, p, g, n))
    js0, ts0 = normal(np.random.default_rng(12), (b, h, p, n))
    ty, ts = ref.ssd_reference(tx, tdt, ta, tb, tc, chunk=chunk, d_skip=td,
                               initial_state=ts0, return_final_state=True)
    jy, js = jref.ssd_reference(jx, jdt, ja, jb, jc, chunk=chunk, d_skip=jd,
                                initial_state=js0, return_final_state=True)
    assert ts.dtype == torch.float32 and ts.shape == (b, h, p, n)
    np.testing.assert_allclose(to_np(ty), to_np(jy), **_tol(jnp.float32))
    np.testing.assert_allclose(to_np(ts), to_np(js), **_tol(jnp.float32))
    via_ops = ops.ssd(tx, tdt, ta, tb, tc, chunk=chunk, d_skip=td,
                      initial_state=ts0, return_final_state=True)
    assert torch.equal(via_ops[0], ty) and torch.equal(via_ops[1], ts)


def test_ssd_chunked_ref_vs_sequential():
    """The port's chunked form equals its token-by-token recurrence, at
    every chunk size including a non-divisible one; the recurrence equals
    the JAX package's."""
    b, l, h, p, g, n = 2, 96, 4, 8, 2, 16
    (jx, jdt, ja, jb, jc, _), (tx, tdt, ta, tb, tc, _) = _split(
        _inputs(3, b, l, h, p, g, n))
    seq = ref.ssd_sequential(tx, tdt, ta, tb, tc)
    np.testing.assert_allclose(
        to_np(seq), to_np(jref.ssd_sequential(jx, jdt, ja, jb, jc)),
        rtol=5e-4, atol=5e-4)
    for chunk in (16, 32, 48, 96, 40):
        out = ref.ssd_reference(tx, tdt, ta, tb, tc, chunk=chunk)
        np.testing.assert_allclose(to_np(out), to_np(seq), rtol=5e-4,
                                   atol=5e-4, err_msg=f"chunk={chunk}")


def test_ssd_state_carry_across_calls():
    """The final state of one call seeds the next (prefill→decode
    contract), and equals the recurrence's final state."""
    b, l, h, p, g, n = 1, 64, 2, 8, 1, 16
    _, (x, dt, a, bm, cm, _) = _split(_inputs(9, b, l, h, p, g, n))
    full, s_full = ref.ssd_reference(x, dt, a, bm, cm, chunk=16,
                                     return_final_state=True)
    half = l // 2
    y1, s1 = ref.ssd_reference(x[:, :half], dt[:, :half], a, bm[:, :half],
                               cm[:, :half], chunk=16,
                               return_final_state=True)
    y2, s2 = ref.ssd_reference(x[:, half:], dt[:, half:], a, bm[:, half:],
                               cm[:, half:], chunk=16, initial_state=s1,
                               return_final_state=True)
    np.testing.assert_allclose(to_np(torch.cat([y1, y2], dim=1)),
                               to_np(full), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(s2), to_np(s_full), rtol=1e-4,
                               atol=1e-4)
    _, s_seq = ref.ssd_sequential(x, dt, a, bm, cm, return_final_state=True)
    np.testing.assert_allclose(to_np(s_full), to_np(s_seq), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_step_vs_jax(dtype):
    b, h, p, g, n = 2, 4, 16, 2, 32
    rng = np.random.default_rng(21)
    jx, tx = normal(rng, (b, h, p), dtype)
    jdt_np = np.log1p(np.exp(rng.standard_normal((b, h)))).astype(np.float32)
    ja_np = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    jb, tb = normal(rng, (b, g, n), dtype)
    jc, tc = normal(rng, (b, g, n), dtype)
    js, ts = normal(rng, (b, h, p, n))
    d = np.full((h,), 0.5, np.float32)
    ty, tstate = ref.ssd_decode_step(tx, torch.from_numpy(jdt_np),
                                     torch.from_numpy(ja_np), tb, tc, ts,
                                     d_skip=torch.from_numpy(d))
    jy, jstate = jref.ssd_decode_step(jx, jnp.asarray(jdt_np),
                                      jnp.asarray(ja_np), jb, jc, js,
                                      d_skip=jnp.asarray(d))
    assert ty.dtype == tx.dtype and tstate.dtype == torch.float32
    np.testing.assert_allclose(to_np(ty), to_np(jy), **_tol(
        jnp.bfloat16 if dtype == "bfloat16" else jnp.float32))
    np.testing.assert_allclose(to_np(tstate), to_np(jstate),
                               **_tol(jnp.float32))


def _ok_inputs(dtype=torch.bfloat16, p=64, n=128):
    b, l, h, g = 1, 64, 4, 1
    return dict(
        x=torch.zeros(b, l, h, p, dtype=dtype),
        dt=torch.zeros(b, l, h),
        a=torch.zeros(h),
        b_mat=torch.zeros(b, l, g, n, dtype=dtype),
        c_mat=torch.zeros(b, l, g, n, dtype=dtype),
    )


@pytest.mark.parametrize("case", [
    "head_dim", "state_size", "dtype", "fp32", "mixed_dtype", "dt_dtype",
    "groups", "shape", "noncontig", "chunk", "state_shape", "cpu_tensor",
])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(case):
    """Every refusal raises before any launch; a CPU tensor is refused too
    (the wrapper never falls back to the plain version), and fp32 x, B and
    C for their dtype, the kernels taking bf16 only."""
    args = _ok_inputs()
    kw = dict(chunk=64)
    if case == "head_dim":
        args = _ok_inputs(p=80)
    elif case == "state_size":
        args = _ok_inputs(n=48)
    elif case == "dtype":
        args = {k: v.half() for k, v in args.items()}
    elif case == "fp32":
        args = _ok_inputs(torch.float32)
    elif case == "mixed_dtype":
        args["b_mat"] = args["b_mat"].float()
    elif case == "dt_dtype":
        args["dt"] = args["dt"].bfloat16()
    elif case == "groups":
        args["b_mat"] = torch.zeros(1, 64, 3, 128, dtype=torch.bfloat16)
        args["c_mat"] = args["b_mat"].clone()
    elif case == "shape":
        args["dt"] = torch.zeros(1, 32, 4)
    elif case == "noncontig":
        args["x"] = torch.zeros(1, 4, 64, 64,
                                dtype=torch.bfloat16).transpose(1, 2)
    elif case == "chunk":
        kw["chunk"] = kernel.MAX_CHUNK + 1
    elif case == "state_shape":
        kw["initial_state"] = torch.zeros(1, 4, 64, 64)
    before = kernel.ssd_scan.launches
    with pytest.raises(ValueError,
                       match="want all bfloat16" if case == "fp32" else None):
        kernel.ssd_scan(**args, **kw)
    assert kernel.ssd_scan.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_ssd_n64_vs_jax_reference_and_pallas(dtype):
    """zamba2-2.7b's SSD head shape (P 64, N 64, chunk 256, G 1): the plain
    version against the JAX oracle and the Pallas kernel, interpreted, at
    _tol, in fp32 and bf16."""
    test_plain_ssd_vs_jax_reference_and_pallas(
        1, 512, 4, 64, 1, 64, 256, getattr(jnp, dtype))


def test_gpu_sweep_copy_matches_ssd_sweep():
    """tests/test_torch_gpu.py runs on the card, where JAX is absent, so it
    keeps its own copy of SSD_SWEEP; the copy must stay the same."""
    from test_torch_gpu import SSD_SWEEP as GPU_SSD_SWEEP

    assert [row[:-1] + (_TORCH[row[-1]],) for row in SSD_SWEEP] == \
        GPU_SSD_SWEEP


def test_plain_ssd_computes_float64_inputs_in_float64():
    """Upcast inputs give a float64 evaluation of the same function (the
    exact side of the kernel's check on the card): the chunked form and
    the recurrence agree far below fp32 rounding, and the fp32 evaluation
    is within _tol of it."""
    b, l, h, p, g, n = 1, 80, 2, 16, 1, 32
    _, (x, dt, a, bm, cm, d) = _split(_inputs(5, b, l, h, p, g, n))
    up = [t.double() for t in (x, dt, a, bm, cm)]
    y64, s64 = ref.ssd_reference(*up, chunk=32, d_skip=d.double(),
                                 return_final_state=True)
    assert y64.dtype == s64.dtype == torch.float64
    y_seq, s_seq = ref.ssd_sequential(*up, d_skip=d.double(),
                                      return_final_state=True)
    np.testing.assert_allclose(y64.numpy(), y_seq.numpy(), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(s64.numpy(), s_seq.numpy(), rtol=1e-10,
                               atol=1e-10)
    y32 = ref.ssd_reference(x, dt, a, bm, cm, chunk=32, d_skip=d)
    np.testing.assert_allclose(y32.numpy(), y64.numpy(), **_tol(jnp.float32))
