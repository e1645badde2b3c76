"""The port's AdamW (repro_torch.optim.adamw) against the JAX package's
over five steps on a random tree: params, moments, learning rate and
gradient norm within _tol(float32), through warmup and cosine decay, with
the global-norm clip active, with and without bf16 gradients."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from torch_parity import to_np, to_torch, tol  # noqa: E402

SHAPES = {"a": (4, 8), "b": {"c": (16,), "d": (3, 5)}}


def _tree(fn, shapes):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v) for k, v in shapes.items()}
    return fn(shapes)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("grad_dtype", [None, "bfloat16"],
                         ids=["fp32_grads", "bf16_grads"])
def test_adamw_matches_jax_over_five_steps(grad_dtype):
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, grad_dtype=grad_dtype)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    p0 = _tree(lambda s: rng.standard_normal(s).astype(np.float32), SHAPES)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), p0)
    jopt, topt = jadamw.init_opt_state(jp), tadamw.init_opt_state(tp)
    clipped = 0
    for step in range(5):
        # leaf "a" carries a large gradient, so the global norm exceeds the
        # clip (1.0) and every leaf is scaled down
        g = _tree(lambda s: rng.standard_normal(s).astype(np.float32), SHAPES)
        g["a"] = g["a"] * 10.0
        jp, jopt, jm = jadamw.adamw_update(jcfg, jp, jax.tree.map(
            jnp.asarray, g), jopt)
        tp, topt, tm = tadamw.adamw_update(tcfg, tp, jax.tree.map(
            lambda x: torch.from_numpy(np.array(x)), g), topt)
        clipped += float(jm["grad_norm"]) > jcfg.grad_clip
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), **tol("float32"))
        assert int(topt["count"]) == int(jopt["count"]) == step + 1
        for name, want in (("params", jp), ("mu", jopt["mu"]),
                           ("nu", jopt["nu"])):
            got = {"params": tp, "mu": topt["mu"], "nu": topt["nu"]}[name]
            for (path, g_leaf), (_, w_leaf) in zip(_flat(got), _flat(want)):
                np.testing.assert_allclose(to_np(g_leaf), to_np(w_leaf),
                                           err_msg=f"{name}{path} step {step}",
                                           **tol("float32"))
    assert clipped == 5


def test_schedule_matches_jax_through_warmup_and_decay():
    cfg_kw = dict(lr=3e-4, warmup_steps=10, total_steps=50, min_lr_ratio=0.1)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg_kw), tadamw.AdamWConfig(**cfg_kw)
    for step in (0, 1, 5, 9, 10, 11, 30, 49, 50, 80):
        want = float(jadamw._schedule(jcfg, jnp.int32(step)))
        got = float(tadamw._schedule(tcfg, torch.tensor(step)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_bf16_params_update_keeps_dtype():
    """A bf16 gradient tree updates fp32 params leaf by leaf (the train
    step's path): the result equals the update from the same gradients
    widened to fp32 first."""
    rng = np.random.default_rng(1)
    cfg = tadamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=3)
    p = {"w": torch.from_numpy(rng.standard_normal((8, 8)).astype(
        np.float32))}
    g = {"w": to_torch(jnp.asarray(rng.standard_normal((8, 8)),
                                   jnp.bfloat16))}
    p1 = {"w": p["w"].clone()}
    tadamw.adamw_update(cfg, p, g, tadamw.init_opt_state(p))
    tadamw.adamw_update(cfg, p1, {"w": g["w"].float()},
                        tadamw.init_opt_state(p1))
    assert p["w"].dtype == torch.float32
    assert torch.equal(p["w"], p1["w"])
