"""Slice parity: the port's serving path (prefill → grow_caches → greedy
decode) against the JAX package's on smoke_config("llama3.2-3b"), with
the JAX-initialised weights carried over by ``params_from_jax``.

fp32 (compute dtype and weights): logits within 1e-3 and identical greedy
tokens. The tolerance is looser than _tol's 2e-4 because reduction-order
differences accumulate over two layers and a 512-wide unembed.
bf16: logits within rtol = atol = 0.15, the tolerance
tests/test_arch_smoke.py::test_decode_matches_prefill_continuation uses
between prefill and decode; both sides are fed the same (JAX-greedy)
tokens, so a near-tie in bf16 cannot make the sequences diverge.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from torch_parity import configs, params, to_np, to_torch  # noqa: E402

B, S, STEPS = 2, 16, 6


def _run_both(dtype, own_greedy):
    jcfg, tcfg = configs(compute_dtype=dtype)
    jp, tp = params(jcfg, tcfg, dtype=dtype)
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jlog, jc, jpos = jlm.prefill(jcfg, jp, jnp.asarray(prompts))
    tlog, tc, tpos = tlm.prefill(tcfg, tp, to_torch(prompts))
    jc = jlm.grow_caches(jcfg, jc, S + STEPS)
    tc = tlm.grow_caches(tcfg, tc, S + STEPS)
    jlogits, tlogits, jtoks, ttoks = [jlog], [tlog], [], []
    for _ in range(STEPS):
        jt = np.argmax(to_np(jlog)[:, : jcfg.vocab_size], -1).astype(np.int32)
        tt = tlog[:, : tcfg.vocab_size].argmax(-1).to(torch.int32)
        jtoks.append(jt)
        ttoks.append(tt.numpy())
        feed = tt if own_greedy else torch.from_numpy(jt)
        jlog, jc, jpos = jlm.decode_step(jcfg, jp, jnp.asarray(jt)[:, None],
                                         jpos, jc)
        tlog, tc, tpos = tlm.decode_step(tcfg, tp, feed[:, None], tpos, tc)
        jlogits.append(jlog)
        tlogits.append(tlog)
    np.testing.assert_array_equal(to_np(tpos), to_np(jpos))
    return (np.stack([to_np(x) for x in jlogits]),
            np.stack([to_np(x) for x in tlogits]),
            np.stack(jtoks), np.stack(ttoks), jc, tc)


def test_serving_path_fp32_matches_jax():
    jl, tl, jt, tt, jc, tc = _run_both("float32", own_greedy=True)
    assert tl.shape == jl.shape == (STEPS + 1, B, 512)
    np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(tt, jt)
    # the stacked caches agree too: prefix and the in-place hot ring
    for name in ("k", "v", "kv_pos", "hk", "hv", "h_pos"):
        np.testing.assert_allclose(to_np(tc["slot0"][name]),
                                   to_np(jc["slot0"][name]),
                                   rtol=1e-3, atol=1e-3, err_msg=name)


def test_serving_path_bf16_matches_jax():
    jl, tl, _, _, _, _ = _run_both("bfloat16", own_greedy=False)
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=0.15, atol=0.15)


def test_param_tree_and_count_match_jax():
    jcfg, tcfg = configs()
    jp, tp = params(jcfg, tcfg)
    assert tlm.param_count(tp) == jlm.param_count(jp)
    shapes = tlm.param_shapes(tcfg)
    assert shapes["slots"]["slot0"]["attn"]["wq"] == (2, 64, 64)
    drawn = tlm.init_params(tcfg, torch.Generator().manual_seed(0))
    assert tlm.param_count(drawn) == jlm.param_count(jp)
    assert tlm.tree_map(lambda x: tuple(x.shape), drawn) == shapes


def test_full_config_shapes_match_jax_without_memory():
    """Full-width llama3.2-3b: the port's tree of shapes (meta device) is
    JAX's (eval_shape), leaf for leaf."""
    import functools

    import jax

    from repro.configs import get_config as jax_get_config

    want = jax.eval_shape(functools.partial(
        jlm.init_params, jax_get_config("llama3.2-3b")), jax.random.PRNGKey(0))
    want = jax.tree.map(lambda x: tuple(x.shape), want)
    got = tlm.param_shapes(get_config("llama3.2-3b"))
    assert got == want
    assert got["slots"]["slot0"]["attn"]["wk"] == (28, 3072, 1024)


@pytest.mark.parametrize("change", [
    dict(pattern=("ssm",)),
    dict(num_experts=4, num_experts_per_token=2, moe_d_ff=64),
    dict(frontend="embed"),
    dict(mrope_sections=(2, 3, 3)),
])
def test_unported_features_raise(change):
    cfg = dataclasses.replace(smoke_config("llama3.2-3b"), **change)
    with pytest.raises(NotImplementedError):
        tlm.init_params(cfg, torch.Generator().manual_seed(0))
