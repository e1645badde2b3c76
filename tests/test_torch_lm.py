"""Slice parity: the port's serving path (prefill → grow_caches → greedy
decode) against the JAX package's on smoke_config("llama3.2-3b"),
smoke_config("mamba2-130m"), smoke_config("zamba2-2.7b"),
smoke_config("granite-moe-3b-a800m"), and the ``embed``-frontend configs
smoke_config("musicgen-large") and smoke_config("qwen2-vl-72b") (M-RoPE,
(3, B, S) positions), fed the same (B, S, M) prompt and (B, 1, M) decode
embeddings, with the JAX-initialised weights carried over by
``params_from_jax``. The mamba
and zamba2 prompts (16 tokens) are shorter than their ssm_chunk (32), so
the SSD's ragged path runs; six decode steps, so a decode that dropped
the SSM state it returns would show. zamba2's smoke config applies its
one shared attention block at layers 6 and 12, each repeat with its own
KV cache row.

fp32 (compute dtype and weights): logits within 1e-3 and identical greedy
tokens. The tolerance is looser than _tol's 2e-4 because reduction-order
differences accumulate over two layers and a 512-wide unembed.
bf16: logits within rtol = atol = 0.15, the tolerance
tests/test_arch_smoke.py::test_decode_matches_prefill_continuation uses
between prefill and decode; both sides are fed the same (JAX-greedy)
tokens, so a near-tie in bf16 cannot make the sequences diverge.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from torch_parity import configs, params, to_np, to_torch, tol  # noqa: E402

B, S, STEPS = 2, 16, 6


def _run_both(dtype, own_greedy, arch="llama3.2-3b", s=S, **change):
    """Prefill of ``s`` tokens, grow and STEPS decode steps in both
    packages. Token models
    decode greedily (the port on its own tokens with ``own_greedy``, else
    on JAX's); an ``embed``-frontend model is fed the same random fp32
    embeddings in both, (B, S, M) for the prompt and (B, 1, M) a step."""
    jcfg, tcfg = configs(arch, compute_dtype=dtype)
    jcfg = dataclasses.replace(jcfg, **change)
    tcfg = dataclasses.replace(tcfg, **change)
    jp, tp = params(jcfg, tcfg, dtype=dtype)
    rng = np.random.default_rng(0)
    embed = jcfg.frontend == "embed"
    if embed:
        prompts = rng.standard_normal((B, s, jcfg.d_model)).astype(np.float32)
        frames = rng.standard_normal(
            (STEPS, B, 1, jcfg.d_model)).astype(np.float32)
    else:
        prompts = rng.integers(0, jcfg.vocab_size, (B, s)).astype(np.int32)
    jlog, jc, jpos = jlm.prefill(jcfg, jp, jnp.asarray(prompts))
    tlog, tc, tpos = tlm.prefill(tcfg, tp, to_torch(prompts))
    jc = jlm.grow_caches(jcfg, jc, s + STEPS)
    tc = tlm.grow_caches(tcfg, tc, s + STEPS)
    jlogits, tlogits, jtoks, ttoks = [jlog], [tlog], [], []
    for i in range(STEPS):
        jt = np.argmax(to_np(jlog)[:, : jcfg.vocab_size], -1).astype(np.int32)
        tt = tlog[:, : tcfg.vocab_size].argmax(-1).to(torch.int32)
        jtoks.append(jt)
        ttoks.append(tt.numpy())
        if embed:
            jfeed, feed = jnp.asarray(frames[i]), torch.from_numpy(frames[i])
        else:
            jfeed = jnp.asarray(jt)[:, None]
            feed = (tt if own_greedy else torch.from_numpy(jt))[:, None]
        jlog, jc, jpos = jlm.decode_step(jcfg, jp, jfeed, jpos, jc)
        tlog, tc, tpos = tlm.decode_step(tcfg, tp, feed, tpos, tc)
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
    dict(pattern=("attn", "cross_attn")),
    dict(frontend="pixels"),
    dict(pattern=("mlstm",)),
])
def test_unported_features_raise(change):
    """A block kind or frontend neither package has is refused (the
    ``embed`` frontend and M-RoPE, once refused here, are ported and
    tested below)."""
    cfg = dataclasses.replace(smoke_config("llama3.2-3b"), **change)
    with pytest.raises(NotImplementedError):
        tlm.init_params(cfg, torch.Generator().manual_seed(0))


def test_mamba_serving_path_fp32_matches_jax():
    jl, tl, jt, tt, jc, tc = _run_both("float32", own_greedy=True,
                                       arch="mamba2-130m")
    assert tl.shape == jl.shape == (STEPS + 1, B, 512)
    np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(tt, jt)
    # the stacked caches agree too: the SSD states and conv tails that
    # every decode step writes back
    assert set(tc["slot0"]) == {"state", "conv_x", "conv_b", "conv_c"}
    for name in tc["slot0"]:
        assert tuple(tc["slot0"][name].shape) == jc["slot0"][name].shape
        np.testing.assert_allclose(to_np(tc["slot0"][name]),
                                   to_np(jc["slot0"][name]),
                                   rtol=1e-3, atol=1e-3, err_msg=name)


def test_mamba_serving_path_bf16_matches_jax():
    jl, tl, _, _, _, _ = _run_both("bfloat16", own_greedy=False,
                                   arch="mamba2-130m")
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=0.15, atol=0.15)


def test_mamba_decode_updates_the_stacked_cache_in_place():
    """decode_step returns the same cache tensors, with the new SSD state
    and conv tails written into them."""
    _, tcfg = configs("mamba2-130m", compute_dtype="float32")
    tp = tlm.init_params(tcfg, torch.Generator().manual_seed(0))
    prompts = torch.randint(0, tcfg.vocab_size, (B, S),
                            generator=torch.Generator().manual_seed(1))
    logits, caches, pos = tlm.prefill(tcfg, tp, prompts)
    caches = tlm.grow_caches(tcfg, caches, S + 1)
    before = {k: v.clone() for k, v in caches["slot0"].items()}
    tok = logits.argmax(-1)[:, None]
    _, after, _ = tlm.decode_step(tcfg, tp, tok, pos, caches)
    assert after is caches
    for name, val in after["slot0"].items():
        assert val is caches["slot0"][name]
        assert not torch.equal(val, before[name]), name


def test_mamba_param_tree_and_count_match_jax():
    """params_from_jax takes the mamba tree (slots/slot0/{ln, ssm/...});
    the port's own draw has the same tree and count."""
    jcfg, tcfg = configs("mamba2-130m")
    jp, tp = params(jcfg, tcfg)
    assert tlm.param_count(tp) == jlm.param_count(jp)
    shapes = tlm.param_shapes(tcfg)
    assert set(shapes["slots"]["slot0"]) == {"ln", "ssm"}
    assert set(shapes["slots"]["slot0"]["ssm"]) == {
        "wz", "wx", "wb", "wc", "wdt", "dt_bias", "a_log", "d_skip",
        "conv_x", "conv_b", "conv_c", "norm", "wo"}
    drawn = tlm.init_params(tcfg, torch.Generator().manual_seed(0))
    assert tlm.tree_map(lambda x: tuple(x.shape), drawn) == shapes
    broken = dict(jax.tree.map(np.asarray, jp))
    broken["slots"] = {"slot0": dict(broken["slots"]["slot0"], ln=None)}
    broken["slots"]["slot0"]["ssm"] = {
        k: v for k, v in broken["slots"]["slot0"]["ssm"].items()
        if k != "wo"}
    with pytest.raises(ValueError):
        params_from_jax(tcfg, broken)


def test_mamba_full_config_shapes_match_jax_without_memory():
    """Full-width mamba2-130m: the port's tree of shapes (meta device) is
    JAX's (eval_shape), leaf for leaf, and so is its parameter count."""
    import functools

    from repro.configs import get_config as jax_get_config

    want = jax.eval_shape(functools.partial(
        jlm.init_params, jax_get_config("mamba2-130m")),
        jax.random.PRNGKey(0))
    want = jax.tree.map(lambda x: tuple(x.shape), want)
    got = tlm.param_shapes(get_config("mamba2-130m"))
    assert got == want
    assert got["slots"]["slot0"]["ssm"]["wx"] == (24, 768, 1536)
    assert got["slots"]["slot0"]["ssm"]["conv_b"] == (24, 4, 128)


def test_shared_attn_pattern_initialises_one_shared_block():
    """A pattern with a shared attention block: one unstacked ``shared``
    subtree and no stacked slot for it."""
    cfg = dataclasses.replace(smoke_config("llama3.2-3b"),
                              pattern=("attn", "shared_attn"))
    tp = tlm.init_params(cfg, torch.Generator().manual_seed(0))
    assert set(tp["slots"]) == {"slot0"}
    assert set(tp["shared"]) == {"ln1", "attn", "ln2", "mlp"}
    assert tuple(tp["shared"]["attn"]["wq"].shape) == (64, 64)
    assert tuple(tp["slots"]["slot0"]["attn"]["wq"].shape) == (
        cfg.repeats, 64, 64)


def _zamba_caches_match(jc, tc):
    """Every stacked cache equal: the shared block's KV rows (slot5, one
    per repeat) and the SSD states and conv tails of slot0..4."""
    assert set(tc) == set(jc) == {f"slot{i}" for i in range(6)}
    assert set(tc["slot5"]) == {"k", "v", "kv_pos", "hk", "hv", "h_pos"}
    for key in tc:
        assert set(tc[key]) == set(jc[key]), key
        for name in tc[key]:
            assert tuple(tc[key][name].shape) == jc[key][name].shape
            np.testing.assert_allclose(to_np(tc[key][name]),
                                       to_np(jc[key][name]), rtol=1e-3,
                                       atol=1e-3, err_msg=f"{key}/{name}")
    # the two repeats of the shared block each wrote their own cache row
    assert not np.array_equal(to_np(tc["slot5"]["k"][0]),
                              to_np(tc["slot5"]["k"][1]))


def test_zamba_serving_path_fp32_matches_jax():
    jl, tl, jt, tt, jc, tc = _run_both("float32", own_greedy=True,
                                       arch="zamba2-2.7b")
    assert tl.shape == jl.shape == (STEPS + 1, B, 512)
    np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(tt, jt)
    _zamba_caches_match(jc, tc)


def test_zamba_serving_path_bf16_matches_jax():
    jl, tl, _, _, _, _ = _run_both("bfloat16", own_greedy=False,
                                   arch="zamba2-2.7b")
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=0.15, atol=0.15)


def test_zamba_param_tree_and_count_match_jax():
    """params_from_jax takes the zamba2 tree (five stacked SSM slots and the
    unstacked ``shared`` block); the port's own draw has the same tree and
    count, and a tree without ``shared`` is refused."""
    jcfg, tcfg = configs("zamba2-2.7b")
    jp, tp = params(jcfg, tcfg)
    assert tlm.param_count(tp) == jlm.param_count(jp)
    assert set(tp["slots"]) == {f"slot{i}" for i in range(5)}
    np.testing.assert_array_equal(to_np(tp["shared"]["attn"]["wq"]),
                                  to_np(jp["shared"]["attn"]["wq"]))
    shapes = tlm.param_shapes(tcfg)
    drawn = tlm.init_params(tcfg, torch.Generator().manual_seed(0))
    assert tlm.param_count(drawn) == jlm.param_count(jp)
    assert tlm.tree_map(lambda x: tuple(x.shape), drawn) == shapes
    broken = dict(jax.tree.map(np.asarray, jp))
    del broken["shared"]
    with pytest.raises(ValueError):
        params_from_jax(tcfg, broken)


def test_zamba_full_config_shapes_match_jax_without_memory():
    """Full-width zamba2-2.7b: the port's tree of shapes (meta device) is
    JAX's (eval_shape), leaf for leaf, and so is its count. The config's
    n_params() (the 6ND model-flops count) leaves out the final norm and,
    in each of the 45 SSM blocks, the conv weights, dt_bias, a_log, d_skip
    and the gated norm, while counting 2 d_model of norms where the tree
    has one: 1,073,200 parameters fewer."""
    import functools

    from repro.configs import get_config as jax_get_config

    jcfg = jax_get_config("zamba2-2.7b")
    want = jax.eval_shape(functools.partial(jlm.init_params, jcfg),
                          jax.random.PRNGKey(0))
    want = jax.tree.map(lambda x: tuple(x.shape), want)
    tcfg = get_config("zamba2-2.7b")
    got = tlm.param_shapes(tcfg)
    assert got == want
    assert got["shared"]["attn"]["wq"] == (2560, 2560)
    assert got["slots"]["slot0"]["ssm"]["wx"] == (9, 2560, 5120)
    meta = tlm.init_params(tcfg, None, device="meta")
    count = tlm.param_count(meta)
    assert count == sum(math.prod(x) for x in jax.tree.leaves(
        want, is_leaf=lambda x: isinstance(x, tuple))) == 2_063_439_920
    d_in, m = tcfg.ssm_d_inner, tcfg.d_model
    left_out = 45 * (tcfg.ssm_conv * (d_in + 2 * tcfg.ssm_state)
                     + 3 * tcfg.ssm_heads + d_in - m) + m
    assert count - left_out == jcfg.n_params() == 2_062_366_720


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
def test_granite_serving_path_fp32_matches_jax(capacity_factor):
    """The MoE model's serving path: the smoke config's capacity factor 8
    (no drop) and granite's own 1.25, at which a 32-token prefill group
    has a capacity of 20 per expert and decode's 2-token group one of 4."""
    jl, tl, jt, tt, jc, tc = _run_both("float32", own_greedy=True,
                                       arch="granite-moe-3b-a800m",
                                       capacity_factor=capacity_factor)
    assert tl.shape == jl.shape == (STEPS + 1, B, 512)
    np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(tt, jt)
    for name in ("k", "v", "kv_pos", "hk", "hv", "h_pos"):
        np.testing.assert_allclose(to_np(tc["slot0"][name]),
                                   to_np(jc["slot0"][name]),
                                   rtol=1e-3, atol=1e-3, err_msg=name)


def test_granite_serving_path_bf16_matches_jax():
    jl, tl, _, _, _, _ = _run_both("bfloat16", own_greedy=False,
                                   arch="granite-moe-3b-a800m")
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=0.15, atol=0.15)


def test_granite_param_tree_and_count_match_jax():
    """params_from_jax takes the MoE tree (``ln2`` and ``moe``: ``router``
    over the logical experts, ``w_gate``/``w_up``/``w_down`` over the
    physical slots, stacked over layers); the port's own draw has the same
    tree and count, and a tree that lacks the MoE is refused."""
    jcfg, tcfg = configs("granite-moe-3b-a800m")
    jp, tp = params(jcfg, tcfg)
    assert tlm.param_count(tp) == jlm.param_count(jp)
    block = tp["slots"]["slot0"]
    assert set(block) == {"ln1", "attn", "ln2", "moe"}
    # the smoke config keeps the padding to 48 slots: 44 dead experts
    assert tuple(block["moe"]["w_gate"].shape) == (2, 48, 64, 64)
    assert tuple(block["moe"]["router"].shape) == (2, 64, 4)
    np.testing.assert_array_equal(to_np(block["moe"]["w_down"]),
                                  to_np(jp["slots"]["slot0"]["moe"]["w_down"]))
    shapes = tlm.param_shapes(tcfg)
    drawn = tlm.init_params(tcfg, torch.Generator().manual_seed(0))
    assert tlm.param_count(drawn) == jlm.param_count(jp)
    assert tlm.tree_map(lambda x: tuple(x.shape), drawn) == shapes
    broken = jax.tree.map(np.asarray, jp)
    del broken["slots"]["slot0"]["moe"]
    with pytest.raises(ValueError):
        params_from_jax(tcfg, broken)


def test_granite_full_config_shapes_match_jax_without_memory():
    """Full-width granite-moe-3b-a800m: the port's tree of shapes (meta
    device) is JAX's (eval_shape), leaf for leaf, with the 8 dead expert
    slots of ``moe_pad_experts_to=48``: 3,979,052,544 parameters, the
    config's n_params() (3,979,051,008) and the final norm."""
    import functools

    from repro.configs import get_config as jax_get_config

    jcfg = jax_get_config("granite-moe-3b-a800m")
    want = jax.eval_shape(functools.partial(jlm.init_params, jcfg),
                          jax.random.PRNGKey(0))
    want = jax.tree.map(lambda x: tuple(x.shape), want)
    tcfg = get_config("granite-moe-3b-a800m")
    got = tlm.param_shapes(tcfg)
    assert got == want
    assert got["slots"]["slot0"]["moe"]["w_gate"] == (32, 48, 1536, 512)
    assert got["slots"]["slot0"]["moe"]["router"] == (32, 1536, 40)
    count = tlm.param_count(tlm.init_params(tcfg, None, device="meta"))
    assert count == sum(math.prod(x) for x in jax.tree.leaves(
        want, is_leaf=lambda x: isinstance(x, tuple))) == 3_979_052_544
    assert count - tcfg.d_model == jcfg.n_params() == 3_979_051_008


EMBED_ARCHS = ["musicgen-large", "qwen2-vl-72b"]


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_embed_serving_path_fp32_matches_jax(arch):
    """The ``embed`` frontend's serving path (musicgen-large: MHA; qwen2-vl-
    72b: GQA and M-RoPE, sections (2, 3, 3) at the smoke head dim 16) on
    the same embeddings: logits of the prefill and 6 decode steps within
    fp32 _tol, the same greedy tokens, and every cache leaf within _tol
    (the hot ring's h_pos, written from stream 0 of the (3, B, 1) decode
    positions, included)."""
    jl, tl, jt, tt, jc, tc = _run_both("float32", own_greedy=True, arch=arch)
    assert tl.shape == jl.shape == (STEPS + 1, B, 512)
    np.testing.assert_allclose(tl, jl, **tol("float32"))
    np.testing.assert_array_equal(tt, jt)
    assert set(tc) == set(jc) == {"slot0"}
    for name in ("k", "v", "kv_pos", "hk", "hv", "h_pos"):
        assert tuple(tc["slot0"][name].shape) == jc["slot0"][name].shape
        np.testing.assert_allclose(to_np(tc["slot0"][name]),
                                   to_np(jc["slot0"][name]),
                                   err_msg=name, **tol("float32"))


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_embed_serving_path_bf16_matches_jax(arch):
    """The same in bf16 weights and compute, logits within bf16 _tol."""
    jl, tl, _, _, jc, tc = _run_both("bfloat16", own_greedy=False, arch=arch)
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, **tol("bfloat16"))
    for name in ("k", "v", "hk", "hv"):
        np.testing.assert_allclose(to_np(tc["slot0"][name]),
                                   to_np(jc["slot0"][name]),
                                   err_msg=name, **tol("bfloat16"))


def test_mrope_positions_are_three_streams_of_arange():
    """_positions gives (3, B, S) under M-RoPE, (B, S) otherwise, each row
    the arange of JAX's _positions."""
    for arch, lead in (("qwen2-vl-72b", (3,)), ("musicgen-large", ())):
        jcfg, tcfg = configs(arch)
        got = tlm._positions(tcfg, 2, 5)
        want = jlm._positions(jcfg, 2, 5)
        assert tuple(got.shape) == want.shape == lead + (2, 5)
        np.testing.assert_array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_embed_frontend_param_tree_has_no_input_table(arch):
    """Under the ``embed`` frontend the tree has no ``embed`` leaf, as JAX's;
    params_from_jax takes JAX's tree and refuses one with an ``embed``
    leaf added; the port's own draw has the same tree; and the count is
    the config's n_params() and the final norm (which n_params leaves
    out), as for every other config."""
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg, tcfg)
    assert "embed" not in tp and "embed" not in jp
    assert set(tp) == {"slots", "final_norm", "unembed"}
    assert tlm.param_count(tp) == jlm.param_count(jp)
    drawn = tlm.init_params(tcfg, torch.Generator().manual_seed(0))
    assert tlm.tree_map(lambda x: tuple(x.shape), drawn) == \
        tlm.param_shapes(tcfg)
    assert tlm.param_count(drawn) - tcfg.d_model == tcfg.n_params()
    broken = dict(jax.tree.map(np.asarray, jp))
    broken["embed"] = np.zeros((tcfg.padded_vocab, tcfg.d_model), np.float32)
    with pytest.raises(ValueError):
        params_from_jax(tcfg, broken)


@pytest.mark.parametrize("arch,count", [
    ("musicgen-large", 3_225_618_432),
    ("starcoder2-15b", 21_995_427_840),
    ("qwen2-vl-72b", 71_459_676_160),
    ("gemma2-2b", 3_204_046_080),
    ("h2o-danube-3-4b", 3_961_839_360),
])
def test_new_full_config_shapes_match_jax_without_memory(arch, count):
    """The embed-frontend, code and windowed configs at full width
    (gemma2-2b at head dim 256, h2o-danube-3-4b at 120): the port's tree
    of shapes (meta device) is JAX's (eval_shape), leaf for leaf, and its
    count the config's n_params() and the final norm."""
    import functools

    from repro.configs import get_config as jax_get_config

    jcfg = jax_get_config(arch)
    want = jax.eval_shape(functools.partial(jlm.init_params, jcfg),
                          jax.random.PRNGKey(0))
    want = jax.tree.map(lambda x: tuple(x.shape), want)
    tcfg = get_config(arch)
    assert tlm.param_shapes(tcfg) == want
    n = tlm.param_count(tlm.init_params(tcfg, None, device="meta"))
    assert n == count and n - tcfg.d_model == jcfg.n_params()


# Sliding-window attention at every layer (h2o-danube-3-4b) and local and
# global layers in turn with attention and final soft-caps (gemma2-2b):
# the smoke window is 64, so an 80-token prompt crosses it and the
# windowed caches wrap.
WINDOWED_ARCHS = ["gemma2-2b", "h2o-danube-3-4b"]
LONG = 80


@pytest.mark.parametrize("arch", WINDOWED_ARCHS)
def test_windowed_serving_path_fp32_matches_jax(arch):
    """An 80-token prompt past the smoke window of 64, then 6 greedy decode
    steps: logits within 1e-3, the same greedy tokens, and every cache leaf
    of every slot within 1e-3."""
    jl, tl, jt, tt, jc, tc = _run_both("float32", own_greedy=True, arch=arch,
                                       s=LONG)
    assert tl.shape == jl.shape == (STEPS + 1, B, 512)
    np.testing.assert_allclose(tl, jl, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(tt, jt)
    assert set(tc) == set(jc)
    for slot in jc:
        assert set(tc[slot]) == set(jc[slot])
        for name in jc[slot]:
            assert tuple(tc[slot][name].shape) == jc[slot][name].shape
            np.testing.assert_allclose(to_np(tc[slot][name]),
                                       to_np(jc[slot][name]), rtol=1e-3,
                                       atol=1e-3, err_msg=f"{slot}/{name}")


@pytest.mark.parametrize("arch", WINDOWED_ARCHS)
def test_windowed_serving_path_bf16_matches_jax(arch):
    """The same in bf16 weights and compute, fed JAX's tokens: logits
    within rtol = atol = 0.15."""
    jl, tl, _, _, _, _ = _run_both("bfloat16", own_greedy=False, arch=arch,
                                   s=LONG)
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=0.15, atol=0.15)

