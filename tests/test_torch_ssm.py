"""Module parity: repro_torch.models.ssm against the JAX functions it
ports, on the mamba2-130m smoke config, with the same NumPy inputs and
the JAX-initialised weights carried over by ``params_from_jax``.
Tolerances are tests/test_kernels.py::_tol; in bf16 the conv sums in
x's dtype in the JAX package's order, so both round at the same places."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from torch_parity import configs, layer, normal, params, to_np, tol  # noqa: E402

DTYPES = ["float32", "bfloat16"]
ARCH = "mamba2-130m"


def _block(dtype, seed=0):
    jcfg, tcfg = configs(ARCH, compute_dtype=dtype)
    jp, tp = params(jcfg, tcfg, dtype=dtype, seed=seed)
    jb, tb = layer(jp["slots"]["slot0"]), layer(tp["slots"]["slot0"])
    return jcfg, tcfg, jb["ssm"], tb["ssm"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_tail", [False, True], ids=["pad", "tail"])
def test_causal_conv(dtype, with_tail):
    rng = np.random.default_rng(0)
    jx, tx = normal(rng, (2, 9, 24), dtype)
    jw, tw = normal(rng, (4, 24), dtype)
    jt, tt = normal(rng, (2, 3, 24), dtype) if with_tail else (None, None)
    got = tssm._causal_conv(tx, tw, tail=tt)
    want = jssm._causal_conv(jx, jw, tail=jt)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(to_np(got), to_np(want), **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("build_cache", [False, True])
def test_ssm_forward(dtype, build_cache):
    """Both branches; L 40 with chunk 32 takes the ragged path."""
    jcfg, tcfg, jb, tb = _block(dtype)
    jh, th = normal(np.random.default_rng(1), (2, 40, 64), dtype)
    if not build_cache:
        got = tssm.ssm_forward(tcfg, tb, th)
        want = jssm.ssm_forward(jcfg, jb, jh)
        np.testing.assert_allclose(to_np(got), to_np(want), **tol(dtype))
        return
    got, tc = tssm.ssm_forward(tcfg, tb, th, build_cache=True)
    want, jc = jssm.ssm_forward(jcfg, jb, jh, build_cache=True)
    np.testing.assert_allclose(to_np(got), to_np(want), **tol(dtype))
    assert set(tc) == set(jc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        assert to_np(tc[name]).dtype == to_np(jc[name]).dtype, name
        np.testing.assert_allclose(to_np(tc[name]), to_np(jc[name]),
                                   **tol(dtype), err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_decode_after_prefill(dtype):
    """Prefill a layer, then decode 3 tokens, each from the cache the
    previous step returned: outputs, states and conv tails match, and the
    cache handed in is not modified."""
    jcfg, tcfg, jb, tb = _block(dtype, seed=1)
    rng = np.random.default_rng(2)
    jh, th = normal(rng, (2, 20, 64), dtype)
    _, jc = jssm.ssm_forward(jcfg, jb, jh, build_cache=True)
    _, tc = tssm.ssm_forward(tcfg, tb, th, build_cache=True)
    for _ in range(3):
        jn, tn = normal(rng, (2, 1, 64), dtype)
        jy, jc = jssm.ssm_decode(jcfg, jb, jn, jc)
        before = {k: v.clone() for k, v in tc.items()}
        ty, tc2 = tssm.ssm_decode(tcfg, tb, tn, tc)
        assert all(torch.equal(before[k], tc[k]) for k in tc)
        tc = tc2
        np.testing.assert_allclose(to_np(ty), to_np(jy), **tol(dtype))
    for name in jc:
        np.testing.assert_allclose(to_np(tc[name]), to_np(jc[name]),
                                   **tol(dtype), err_msg=name)


def test_init_ssm_cache_matches_jax():
    jcfg, tcfg = configs(ARCH)
    want = jssm.init_ssm_cache(jcfg, 2, jnp.bfloat16)
    got = tssm.init_ssm_cache(tcfg, 2, torch.bfloat16)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == (torch.float32 if name == "state"
                                   else torch.bfloat16)
        np.testing.assert_array_equal(to_np(got[name]), to_np(want[name]))


def test_init_ssm_params_tree_matches_jax():
    """Names, shapes and the constant leaves (dt_bias, a_log, d_skip,
    norm) of a fresh draw equal the JAX package's."""
    import jax

    jcfg, tcfg = configs(ARCH)
    want = jssm.init_ssm_params(jax.random.PRNGKey(0), jcfg)
    got = tssm.init_ssm_params(torch.Generator().manual_seed(0), tcfg)
    assert set(got) == set(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape, name
    for name in ("dt_bias", "a_log", "d_skip", "norm"):
        np.testing.assert_array_equal(to_np(got[name]), to_np(want[name]))
