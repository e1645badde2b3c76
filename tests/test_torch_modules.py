"""Module parity: repro_torch.models.{common,attention,mlp} against the
JAX functions they port, on the llama3.2-3b smoke config, with the same
NumPy inputs and the JAX-initialised weights carried over by
``params_from_jax``. Tolerances are tests/test_kernels.py::_tol."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from torch_parity import configs, layer, normal, params, to_np, to_torch, tol  # noqa: E402

DTYPES = ["float32", "bfloat16"]


def _block(dtype, seed=0):
    jcfg, tcfg = configs(compute_dtype=dtype)
    jp, tp = params(jcfg, tcfg, dtype=dtype, seed=seed)
    return jcfg, tcfg, layer(jp["slots"]["slot0"]), layer(tp["slots"]["slot0"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    jx, tx = normal(rng, (2, 8, 64), dtype)
    js, ts = normal(rng, (64,), "float32")
    np.testing.assert_allclose(to_np(tcommon.rms_norm(tx, ts)),
                               to_np(jcommon.rms_norm(jx, js)), **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope(dtype):
    rng = np.random.default_rng(1)
    jx, tx = normal(rng, (2, 8, 4, 16), dtype)
    pos = np.arange(8, dtype=np.int32)[None] + np.array([[0], [300]], np.int32)
    got = tcommon.apply_rope(tx, torch.from_numpy(pos), 500000.0)
    want = jcommon.apply_rope(jx, jnp.asarray(pos), 500000.0)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(to_np(got), to_np(want), **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_forward(dtype):
    _, _, jb, tb = _block(dtype)
    jx, tx = normal(np.random.default_rng(2), (2, 8, 64), dtype)
    np.testing.assert_allclose(to_np(tmlp.mlp_forward(tb["mlp"], tx)),
                               to_np(jmlp.mlp_forward(jb["mlp"], jx)),
                               **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("build_cache", [False, True])
def test_attn_forward(dtype, build_cache):
    jcfg, tcfg, jb, tb = _block(dtype)
    b, s = 2, 24
    jx, tx = normal(np.random.default_rng(3), (b, s, 64), dtype)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jy, jc = jattn.attn_forward(jcfg, jb["attn"], jx, jnp.asarray(pos),
                                build_cache=build_cache)
    ty, tc = tattn.attn_forward(tcfg, tb["attn"], tx, to_torch(pos),
                                build_cache=build_cache)
    np.testing.assert_allclose(to_np(ty), to_np(jy), **tol(dtype))
    if not build_cache:
        assert jc is None and tc is None
        return
    assert set(tc) == set(jc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        np.testing.assert_allclose(to_np(tc[name]), to_np(jc[name]),
                                   **tol(dtype), err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attn_decode_after_prefill(dtype):
    """Prefill a layer, then decode 3 tokens: outputs and the hot ring
    (written in place on the torch side) match."""
    jcfg, tcfg, jb, tb = _block(dtype, seed=1)
    b, s = 2, 20
    rng = np.random.default_rng(4)
    jx, tx = normal(rng, (b, s, 64), dtype)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    _, jc = jattn.attn_forward(jcfg, jb["attn"], jx, jnp.asarray(pos),
                               build_cache=True)
    _, tc = tattn.attn_forward(tcfg, tb["attn"], tx, to_torch(pos),
                               build_cache=True)
    for t in range(s, s + 3):
        jn, tn = normal(rng, (b, 1, 64), dtype)
        p = np.full((b,), t, np.int32)
        jy, jc = jattn.attn_decode(jcfg, jb["attn"], jn, jnp.asarray(p), jc)
        ty, tc2 = tattn.attn_decode(tcfg, tb["attn"], tn, torch.from_numpy(p),
                                    tc)
        assert tc2 is tc
        np.testing.assert_allclose(to_np(ty), to_np(jy), **tol(dtype))
    for name in ("hk", "hv", "h_pos"):
        np.testing.assert_allclose(to_np(tc[name]), to_np(jc[name]),
                                   **tol(dtype), err_msg=name)


@pytest.mark.parametrize("window,softcap", [(None, None), (5, 30.0)])
def test_chunked_attention(window, softcap):
    """Explicit positions with empty (-1) slots and a chunk that does not
    divide T (padded path)."""
    rng = np.random.default_rng(5)
    b, s, t, h, k, d = 2, 6, 21, 4, 2, 16
    jq, tq = normal(rng, (b, s, h, d))
    jk, tk = normal(rng, (b, t, k, d))
    jv, tv = normal(rng, (b, t, k, d))
    q_pos = np.broadcast_to(np.arange(14, 20, dtype=np.int32), (b, s))
    kv_pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    kv_pos[:, -2:] = -1
    kv_pos[1, 3] = -1
    args = dict(window=window, softcap=softcap, kv_chunk=8)
    want = jattn.chunked_attention(jq, jk, jv, jnp.asarray(q_pos),
                                   jnp.asarray(kv_pos), **args)
    got = tattn.chunked_attention(tq, tk, tv, to_torch(q_pos),
                                  to_torch(kv_pos), **args)
    np.testing.assert_allclose(to_np(got), to_np(want), **tol("float32"))


def test_init_kv_cache_matches_jax():
    jcfg, tcfg = configs()
    want = jattn.init_kv_cache(jcfg, 2, 40, "attn")
    got = tattn.init_kv_cache(tcfg, 2, 40, "attn")
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(to_np(got[name]), to_np(want[name]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,sections", [(16, (2, 3, 3)), (128, (16, 24, 24))],
                         ids=["smoke_d16", "qwen2_vl_d128"])
def test_apply_mrope_with_distinct_streams(dtype, d, sections):
    """M-RoPE against repro.models.common.apply_mrope with three different
    random position streams (temporal, height, width): only then does a
    wrong band-to-stream split show, since with equal streams M-RoPE is
    RoPE. fp32 within 1e-6, bf16 within _tol; at the smoke head dim and at
    qwen2-vl-72b's D 128 with its published sections and rope theta."""
    rng = np.random.default_rng(5)
    jx, tx = normal(rng, (2, 8, 4, d), dtype)
    pos = rng.integers(0, 4096, (3, 2, 8)).astype(np.int32)
    assert all(not np.array_equal(pos[i], pos[j])
               for i, j in ((0, 1), (0, 2), (1, 2)))
    got = tcommon.apply_mrope(tx, torch.from_numpy(pos), sections, 1e6)
    want = jcommon.apply_mrope(jx, jnp.asarray(pos), sections, 1e6)
    assert got.dtype == tx.dtype
    t = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else tol(dtype)
    np.testing.assert_allclose(to_np(got), to_np(want), **t)
    # each stream moves only its own bands: shifting the width stream
    # leaves the temporal and height bands as they were
    moved = pos.copy()
    moved[2] += 7
    other = tcommon.apply_mrope(tx, torch.from_numpy(moved), sections, 1e6)
    half, cut = d // 2, sections[0] + sections[1]
    for lo in (0, half):
        np.testing.assert_array_equal(to_np(other)[..., lo:lo + cut],
                                      to_np(got)[..., lo:lo + cut])
        assert not np.array_equal(to_np(other)[..., lo + cut:lo + half],
                                  to_np(got)[..., lo + cut:lo + half])


def test_apply_mrope_equals_rope_when_streams_coincide():
    rng = np.random.default_rng(6)
    _, tx = normal(rng, (2, 8, 4, 16))
    pos = torch.from_numpy(rng.integers(0, 100, (2, 8)).astype(np.int32))
    torch.testing.assert_close(
        tcommon.apply_mrope(tx, pos.expand(3, 2, 8), (2, 3, 3)),
        tcommon.apply_rope(tx, pos), rtol=0, atol=0)


def test_apply_mrope_refuses_sections_that_miss_half_the_head_dim():
    _, tx = normal(np.random.default_rng(7), (1, 4, 2, 16))
    pos = torch.zeros((3, 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="sum to 8"):
        tcommon.apply_mrope(tx, pos, (2, 3, 2))
    with pytest.raises(ValueError, match="sum to 8"):
        jcommon.apply_mrope(jnp.asarray(to_np(tx)), jnp.asarray(pos.numpy()),
                            (2, 3, 2))
