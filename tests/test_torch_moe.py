"""MoE parity: repro_torch.models.moe against repro.models.moe on
smoke_config("granite-moe-3b-a800m") (4 experts, top-2, 64-token
groups), the same NumPy inputs and the JAX-initialised weights carried
over by ``params_from_jax``.

fp32 throughout, at tests/test_kernels.py::_tol (rtol = atol = 2e-4) for
the output and the aux loss; the routing (each assignment's expert, its
capacity slot and whether it is kept) must be equal. The JAX side's
routing is recomputed here from ``repro.models.moe.moe_forward``'s own
lines (``jax.lax.top_k``, the token-major cumsum), since that function
returns only the output and the loss."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from torch_parity import configs, layer, params, to_np, tol  # noqa: E402

ARCH = "granite-moe-3b-a800m"


def _setup(capacity_factor=None, seed=0, **change):
    jcfg, tcfg = configs(ARCH, compute_dtype="float32")
    if capacity_factor is not None:
        change["capacity_factor"] = capacity_factor
    jcfg = dataclasses.replace(jcfg, **change)
    tcfg = dataclasses.replace(tcfg, **change)
    jp, tp = params(jcfg, tcfg, seed=seed)
    return (jcfg, tcfg, layer(jp["slots"]["slot0"])["moe"],
            layer(tp["slots"]["slot0"])["moe"])


def _x(shape, seed, scale=1.0, shift=0.0):
    x = (scale * np.random.default_rng(seed).standard_normal(shape)
         + shift).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _jax_route(cfg, p, x):
    """(expert indices, capacity slots, keep) as repro.models.moe computes
    them, in the (groups, group size, k) layout."""
    b, s, m = x.shape
    tokens = b * s
    gs = min(cfg.moe_group_size, tokens)
    while tokens % gs != 0:
        gs -= 1
    g, c = tokens // gs, jmoe.moe_capacity(cfg, gs)
    xg = x.reshape(g, gs, m)
    logits = (xg @ p["router"].astype(x.dtype)).astype(jnp.float32)
    _, top_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                             cfg.num_experts_per_token)
    eh = jax.nn.one_hot(top_i, cfg.moe_experts_physical, dtype=jnp.float32)
    ehf = eh.reshape(g, gs * cfg.num_experts_per_token, -1)
    pos = jnp.cumsum(ehf, axis=1) - ehf
    pos_k = jnp.sum(pos * ehf, axis=-1).reshape(top_i.shape).astype(jnp.int32)
    return np.asarray(top_i), np.asarray(pos_k), np.asarray(pos_k < c)


def _torch_route(cfg, p, x):
    b, s, m = x.shape
    tokens = b * s
    gs = min(cfg.moe_group_size, tokens)
    while tokens % gs != 0:
        gs -= 1
    _, _, top_i, _, pos_k = tmoe.route(cfg, p["router"],
                                       x.reshape(tokens // gs, gs, m))
    c = tmoe.moe_capacity(cfg, gs)
    return top_i.numpy(), pos_k.numpy(), (pos_k < c).numpy()


def _assert_moe_matches(jcfg, tcfg, jp, tp, jx, tx):
    """Output and aux at fp32 _tol, and the routing equal; returns the
    number of dropped (token, k) assignments."""
    jy, jaux = jmoe.moe_forward(jcfg, jp, jx)
    ty, taux = tmoe.moe_forward(tcfg, tp, tx)
    assert ty.shape == tx.shape and ty.dtype == tx.dtype
    assert taux.dtype == torch.float32 and taux.shape == ()
    np.testing.assert_allclose(to_np(ty), to_np(jy), **tol("float32"))
    np.testing.assert_allclose(float(taux), float(jaux), **tol("float32"))
    for got, want, what in zip(_torch_route(tcfg, tp, tx),
                               _jax_route(jcfg, jp, jx),
                               ("experts", "capacity slots", "kept")):
        np.testing.assert_array_equal(got, want, err_msg=what)
    return int((~_torch_route(tcfg, tp, tx)[2]).sum())


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 1.0])
def test_moe_forward_matches_jax(capacity_factor):
    """The smoke config's capacity factor 8 drops no token; 1.25 (granite's
    own) and 1.0 drop some, on inputs scaled by 4 and shifted by 1, so that
    the router favours some experts. The dropped assignments are the same
    ones in both packages."""
    jcfg, tcfg, jp, tp = _setup(capacity_factor)
    jx, tx = _x((4, 64, jcfg.d_model), seed=1, scale=4.0, shift=1.0)
    dropped = _assert_moe_matches(jcfg, tcfg, jp, tp, jx, tx)
    if capacity_factor == 8.0:
        assert dropped == 0
    else:
        assert dropped > 0, "no assignment dropped: the test shows nothing"


@pytest.mark.parametrize("group_size", [1, 3, 16, 64, 100, 256, 1000])
@pytest.mark.parametrize("arch", [ARCH, "qwen3-moe-235b-a22b"])
def test_moe_capacity_formula(arch, group_size):
    """tests/test_model_properties.py::test_moe_capacity_formula's rule,
    ceil(S·k/E·cf) rounded up to a multiple of 4 and at least 4, equal to
    repro.models.moe.moe_capacity, on the JAX package's full and smoke
    configs."""
    from repro.configs import get_config as jax_get_config
    from repro.configs import smoke_config as jax_smoke_config

    for cfg in (jax_get_config(arch), jax_smoke_config(arch)):
        c = tmoe.moe_capacity(cfg, group_size)
        raw = -(-group_size * cfg.num_experts_per_token * cfg.capacity_factor
                // cfg.num_experts)
        assert c >= 4 and c % 4 == 0
        assert c == max(4, int(-(-raw // 4) * 4))
        assert c == jmoe.moe_capacity(cfg, group_size)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_moe_conservation(seed):
    """tests/test_model_properties.py::test_moe_conservation on the port,
    and at a capacity factor of 0.25, where whole tokens are dropped: a
    token none of whose assignments is kept comes out exactly zero (the
    residual carries it), every output is finite, the aux loss is at
    least 1 (its minimum at perfect balance); both against JAX."""
    for cf in (8.0, 0.25):
        jcfg, tcfg, jp, tp = _setup(cf, seed=seed)
        jx, tx = _x((2, 64, jcfg.d_model), seed=100 + seed)
        _assert_moe_matches(jcfg, tcfg, jp, tp, jx, tx)
        y, aux = tmoe.moe_forward(tcfg, tp, tx)
        assert torch.isfinite(y).all()
        assert float(aux) >= 0.99
        _, _, kept = _torch_route(tcfg, tp, tx)
        gone = ~kept.reshape(-1, tcfg.num_experts_per_token).any(-1)
        if cf == 0.25:
            assert gone.any()
        assert torch.all(y.reshape(-1, tcfg.d_model)[torch.from_numpy(gone)]
                         == 0)


def test_top_k_breaks_ties_as_jax():
    """On 1,000 rows of small integers (many ties) the port's top_k gives
    jax.lax.top_k's values and indices, in its order."""
    rows = np.random.default_rng(0).integers(0, 4, (1000, 40)).astype(
        np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(rows), 8)
    got_v, got_i = tmoe.top_k(torch.from_numpy(rows), 8)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_moe_forward_with_tied_router_logits_matches_jax():
    """A router whose columns repeat (experts 1, 2 and 3 have equal
    logits for every token, expert 0 a lower one): each token's top-2 is a
    tie, which jax.lax.top_k breaks toward the lower index (experts 1 and
    2), where torch.topk picks experts 2 and 3 on the CPU; the port
    routes as JAX and gives the same output."""
    jcfg, tcfg, jp, tp = _setup()
    col = np.random.default_rng(5).standard_normal(
        (jcfg.d_model, 1)).astype(np.float32)
    router = np.concatenate([col - 1e3, col, col, col], axis=1)
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = np.abs(np.random.default_rng(6).standard_normal(
        (2, 64, jcfg.d_model))).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _assert_moe_matches(jcfg, tcfg, jp, tp, jx, tx)
    experts, _, _ = _torch_route(tcfg, tp, tx)
    assert (experts == np.array([1, 2])).all()


@pytest.mark.parametrize("tokens,group", [(6, 4), (8, 64), (7, 64), (12, 5)])
def test_decode_group_size_fallback(tokens, group):
    """A token count the group size does not divide (decode: B tokens)
    falls back to the largest divisor no larger than the group: 6 tokens
    in groups of 4 run as two groups of 3; 7 tokens as one group of 7."""
    jcfg, tcfg, jp, tp = _setup(1.0, moe_group_size=group)
    jx, tx = _x((tokens, 1, jcfg.d_model), seed=tokens, scale=4.0, shift=1.0)
    _assert_moe_matches(jcfg, tcfg, jp, tp, jx, tx)


def test_moe_params_tree_matches_jax():
    """The port draws the JAX package's tree: router (M, E) over the
    logical experts, the three expert weights over the physical slots."""
    jcfg, tcfg = configs(ARCH)
    tcfg = dataclasses.replace(tcfg, moe_pad_experts_to=6)
    jcfg = dataclasses.replace(jcfg, moe_pad_experts_to=6)
    got = tmoe.init_moe_params(torch.Generator().manual_seed(0), tcfg)
    want = jmoe.init_moe_params(jax.random.PRNGKey(0), jcfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert tuple(got["w_gate"].shape) == (6, 64, 64)
    assert tuple(got["router"].shape) == (64, 4)
