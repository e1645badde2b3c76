"""Checkpoints of the port (repro_torch.checkpoint) against the JAX
package's (repro.checkpoint): the same state written by both gives the
same files byte for byte, bf16 and float8 leaves included; each restores
what the other wrote; and the behaviours of tests/test_substrate.py (atomic
``.tmp``, shape mismatch, rotation, async saves, empty directory, the
restart loop) hold on the port. The JAX side runs on the CPU."""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpointer as jckpt  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint import checkpointer as tckpt  # noqa: E402
from repro_torch.checkpoint.manager import host_snapshot  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import train_state_from_jax  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    FaultToleranceReport,
    Heartbeat,
    run_with_restarts,
)
from torch_parity import configs, to_torch  # noqa: E402


def _jax_state(arch="llama3.2-3b"):
    """A JAX train state of the smoke config, and its port twin."""
    jcfg, tcfg = configs(arch, compute_dtype="float32")
    jstate = jsteps.init_train_state(jcfg, jax.random.PRNGKey(0))
    # nonzero moments and counts, so that every leaf's bytes say something
    jstate = jax.tree.map(lambda x: x + 1 if x.dtype == jnp.int32 else x,
                          jstate)
    jstate["opt"]["mu"] = jax.tree.map(lambda x: 0.5 * x, jstate["params"])
    tstate = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate))
    return jcfg, tcfg, jstate, tstate


def _mixed_state():
    """Float32, bfloat16 and int32 leaves, nested, keys out of order."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    b = rng.standard_normal((4, 2)).astype(np.float32)
    jstate = {"zeta": {"w": jnp.asarray(a),
                       "h": jnp.asarray(b).astype(jnp.bfloat16)},
              "alpha": jnp.int32(7), "mid": jnp.arange(6, dtype=jnp.int32)}
    tstate = {"zeta": {"w": to_torch(jstate["zeta"]["w"]),
                       "h": to_torch(jstate["zeta"]["h"])},
              "alpha": torch.tensor(7, dtype=torch.int32),
              "mid": torch.arange(6, dtype=torch.int32)}
    return jstate, tstate


def _files(path):
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


@pytest.mark.parametrize("which", ["mixed", "train_state", "bf16_params",
                                   "embed_train_state"])
def test_files_are_byte_identical_to_jax(which, tmp_path):
    """manifest.json and every .npy file the port writes equal, byte for
    byte, what repro.checkpoint writes for the same state: a small tree of
    fp32, bf16 and int32 leaves; the smoke llama train state (params, both
    moments, counts); the smoke granite parameters cast to bf16; and the
    smoke musicgen-large train state (the ``embed`` frontend: no input
    table in either tree)."""
    if which == "mixed":
        jstate, tstate = _mixed_state()
    elif which == "train_state":
        _, _, jstate, tstate = _jax_state()
    elif which == "embed_train_state":
        _, _, jstate, tstate = _jax_state("musicgen-large")
        assert "embed" not in tstate["params"]
    else:
        _, _, jstate, tstate = _jax_state("granite-moe-3b-a800m")
        jstate = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                              jstate["params"])
        tstate = lm.tree_map(lambda x: x.to(torch.bfloat16),
                             tstate["params"])
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), 3, jstate)
    tpath = tckpt.save_checkpoint(str(tmp_path / "torch"), 3, tstate)
    jfiles, tfiles = _files(tmp_path / "jax" / "step_3"), _files(
        tmp_path / "torch" / "step_3")
    assert tpath.endswith("step_3") and jpath.endswith("step_3")
    assert jfiles.keys() == tfiles.keys()
    for name in jfiles:
        assert tfiles[name] == jfiles[name], name
    manifest = json.loads(tfiles["manifest.json"])
    dtypes = {e["dtype"] for e in manifest["leaves"]}
    if which not in ("train_state", "embed_train_state"):
        assert "bfloat16" in dtypes
    if which == "mixed":   # JAX's flatten order: keys sorted, level by level
        assert [e["key"] for e in manifest["leaves"]] == [
            "alpha", "mid", "zeta__h", "zeta__w"]


def test_port_restores_a_jax_checkpoint(tmp_path):
    """A train state written by repro.checkpoint restores into the port's
    train_state_shapes (meta target): every leaf equal, in the target's
    dtype, float leaves on the device asked for, counts on the CPU."""
    jcfg, tcfg, jstate, tstate = _jax_state("granite-moe-3b-a800m")
    jckpt.save_checkpoint(str(tmp_path), 4, jstate)
    shapes = tsteps.train_state_shapes(tcfg)
    assert shapes["params"]["embed"].device.type == "meta"
    devices = tsteps.train_state_devices(shapes, "cpu")
    got = tckpt.restore_checkpoint(str(tmp_path), 4, shapes, devices)
    want = dict(tckpt.flatten_with_keys(tstate))
    leaves = dict(tckpt.flatten_with_keys(got))
    assert leaves.keys() == want.keys()
    for key in want:
        assert leaves[key].dtype == want[key].dtype, key
        assert leaves[key].device.type == "cpu"
        assert torch.equal(leaves[key], want[key]), key
    assert int(got["step"]) == 1 and int(got["opt"]["count"]) == 1
    # the target's key order is kept
    assert list(got) == list(shapes)
    assert list(got["params"]["slots"]["slot0"]) == list(
        shapes["params"]["slots"]["slot0"])


def test_jax_restores_a_port_checkpoint(tmp_path):
    """The reverse: a train state written by the port restores through
    repro.checkpoint into jsteps.train_state_shapes, every leaf equal."""
    jcfg, tcfg, jstate, tstate = _jax_state()
    tckpt.save_checkpoint(str(tmp_path), 2, tstate)
    got = jckpt.restore_checkpoint(str(tmp_path), 2,
                                   jsteps.train_state_shapes(jcfg))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), got, jstate)
    # and the mixed tree, bf16 included
    jmixed, tmixed = _mixed_state()
    tckpt.save_checkpoint(str(tmp_path), 9, tmixed)
    got = jckpt.restore_checkpoint(str(tmp_path), 9, jax.eval_shape(
        lambda: jmixed))
    assert got["zeta"]["h"].dtype == jnp.bfloat16
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a, np.float32), np.asarray(b, np.float32)), got, jmixed)


FLOAT8 = ("float8_e4m3fn", "float8_e5m2")
FLOAT8_VALUES = [0.5, 1.5, -2.0, 3.0, -0.0, 448.0 / 4]


def _float8_state():
    """One leaf of each float8 dtype (and an fp32 one beside them), in both
    packages."""
    vals = np.asarray(FLOAT8_VALUES, np.float32)
    jstate = {name: jnp.asarray(vals).astype(getattr(jnp, name))
              for name in FLOAT8}
    jstate["w"] = jnp.asarray(vals)
    tstate = {name: torch.tensor(FLOAT8_VALUES).to(getattr(torch, name))
              for name in FLOAT8}
    tstate["w"] = torch.tensor(FLOAT8_VALUES)
    return jstate, tstate


def test_port_restores_jax_float8_leaves_as_their_values(tmp_path):
    """float8_e4m3fn and float8_e5m2 leaves written by repro.checkpoint
    (uint8 views, the dtype's name in the manifest) restore to equal values:
    into float8 targets bit for bit, and into fp32 targets as the numbers
    they hold, not as their raw codes."""
    jstate, _ = _float8_state()
    jckpt.save_checkpoint(str(tmp_path), 1, jstate)
    f8 = {name: torch.empty(len(FLOAT8_VALUES), dtype=getattr(torch, name),
                            device="meta") for name in FLOAT8}
    f8["w"] = torch.empty(len(FLOAT8_VALUES), device="meta")
    got = tckpt.restore_checkpoint(str(tmp_path), 1, f8)
    for name in FLOAT8:
        assert got[name].dtype == getattr(torch, name)
        want = np.asarray(jstate[name]).view(np.uint8)
        np.testing.assert_array_equal(got[name].view(torch.uint8).numpy(),
                                      want)
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      np.asarray(FLOAT8_VALUES, np.float32))
    as_fp32 = tckpt.restore_checkpoint(
        str(tmp_path), 1, {k: torch.empty(len(FLOAT8_VALUES), device="meta")
                           for k in f8})
    for name in f8:
        np.testing.assert_array_equal(as_fp32[name].numpy(),
                                      np.asarray(FLOAT8_VALUES, np.float32))


def test_float8_files_are_byte_identical_to_jax(tmp_path):
    """The port saves float8 leaves (a TypeError before) as the JAX package
    does, byte for byte, and repro.checkpoint restores them."""
    jstate, tstate = _float8_state()
    jckpt.save_checkpoint(str(tmp_path / "jax"), 2, jstate)
    tckpt.save_checkpoint(str(tmp_path / "torch"), 2, tstate)
    jfiles, tfiles = _files(tmp_path / "jax" / "step_2"), _files(
        tmp_path / "torch" / "step_2")
    assert jfiles.keys() == tfiles.keys()
    for name in jfiles:
        assert tfiles[name] == jfiles[name], name
    manifest = json.loads(tfiles["manifest.json"])
    assert {e["key"]: e["dtype"] for e in manifest["leaves"]} == {
        "float8_e4m3fn": "float8_e4m3fn", "float8_e5m2": "float8_e5m2",
        "w": "float32"}
    got = jckpt.restore_checkpoint(str(tmp_path / "torch"), 2,
                                   jax.eval_shape(lambda: jstate))
    for name in FLOAT8:
        assert got[name].dtype == jstate[name].dtype
        np.testing.assert_array_equal(np.asarray(got[name], np.float32),
                                      np.asarray(FLOAT8_VALUES, np.float32))


def test_unknown_stored_dtype_name_is_refused(tmp_path):
    """A manifest dtype the port does not know is a ValueError, not the raw
    array passed on and cast as numbers."""
    tckpt.save_checkpoint(str(tmp_path), 0, {"w": torch.ones(4,
                                                             dtype=torch.uint8)})
    mpath = tmp_path / "step_0" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["leaves"][0]["dtype"] = "float8_e4m3b11fnuz"
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="float8_e4m3b11fnuz"):
        tckpt.restore_checkpoint(str(tmp_path), 0,
                                 {"w": torch.empty(4, device="meta")})


def test_tmp_directory_is_invisible(tmp_path):
    _, tstate = _mixed_state()
    tckpt.save_checkpoint(str(tmp_path), 1, tstate)
    # a stale .tmp dir from a crashed writer must be invisible
    (tmp_path / "step_9.tmp").mkdir()
    assert tckpt.latest_step(str(tmp_path)) == 1
    assert tckpt.list_steps(str(tmp_path)) == [1]
    assert tckpt.list_steps(str(tmp_path / "absent")) == []


def test_shape_mismatch_and_missing_leaf_raise(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), 0, {"w": torch.ones(2, 2)})
    with pytest.raises(ValueError):
        tckpt.restore_checkpoint(str(tmp_path), 0, {"w": torch.empty(3, 3)})
    with pytest.raises(KeyError):
        tckpt.restore_checkpoint(str(tmp_path), 0, {"v": torch.empty(2, 2)})
    with pytest.raises(ValueError):
        tckpt.restore_checkpoint(str(tmp_path), 0, {"w": torch.empty(2, 2)},
                                 devices={"w": "cpu", "v": "cpu"})


def test_manager_rotation_and_async(tmp_path):
    """tests/test_substrate.py::test_manager_rotation_and_async: keep=2
    leaves the last two of five async saves, and restore_latest gives the
    last with the next step."""
    m = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in range(5):
        m.save(s, {"x": torch.full((3,), float(s))})
    m.wait()
    assert tckpt.list_steps(str(tmp_path)) == [3, 4]
    restored, nxt = m.restore_latest({"x": torch.empty(3, device="meta")})
    assert nxt == 5
    assert torch.equal(restored["x"], torch.full((3,), 4.0))


def test_manager_restore_empty(tmp_path):
    m = CheckpointManager(str(tmp_path))
    state, nxt = m.restore_latest({"x": torch.empty(1, device="meta")})
    assert state is None and nxt == 0


def test_in_place_update_after_an_async_save_does_not_reach_the_file(
        tmp_path, monkeypatch):
    """save() returns once the host snapshot is made; an in-place update
    of the live tensors right after it (as AdamW's) is not what the worker
    writes, even when the write starts only after the update."""
    state = {"p": torch.arange(4, dtype=torch.float32),
             "m": {"mu": torch.zeros(4, dtype=torch.bfloat16)}}
    go = threading.Event()
    real = tckpt.save_checkpoint

    def held(directory, step, st):
        assert go.wait(timeout=30)
        return real(directory, step, st)

    from repro_torch.checkpoint import manager as mmod
    monkeypatch.setattr(mmod, "save_checkpoint", held)
    m = CheckpointManager(str(tmp_path), async_save=True)
    m.save(0, state)
    state["p"].add_(100.0)
    state["m"]["mu"].add_(1.0)
    go.set()
    m.wait()
    got = tckpt.restore_checkpoint(str(tmp_path), 0, state)
    assert torch.equal(got["p"], torch.arange(4, dtype=torch.float32))
    assert torch.equal(got["m"]["mu"], torch.zeros(4, dtype=torch.bfloat16))
    snap = host_snapshot(state)
    assert snap["p"].data_ptr() != state["p"].data_ptr()


def test_manager_wait_reraises_a_worker_error(tmp_path):
    (tmp_path / "file").write_text("not a directory")
    m = CheckpointManager(str(tmp_path / "file"), async_save=True)
    m.save(0, {"x": torch.ones(2)})
    with pytest.raises(OSError):
        m.wait()
    m.wait()   # the error was raised once


def test_run_with_restarts_counts():
    calls = []

    def run_fn(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise RuntimeError("boom")
        return 10

    seen = []
    report = run_with_restarts(run_fn, max_restarts=5,
                               on_restart=lambda a, e: seen.append(a))
    assert isinstance(report, FaultToleranceReport)
    assert report.restarts == 2
    assert calls == [0, 1, 2] and seen == [1, 2]


def test_run_with_restarts_exhausts():
    def run_fn(attempt):
        raise RuntimeError("always")

    with pytest.raises(RuntimeError):
        run_with_restarts(run_fn, max_restarts=2)


def test_heartbeat():
    now = [0.0]
    hb = Heartbeat(clock=lambda: now[0])
    assert hb.age() == float("inf") and not hb.alive(1.0)
    hb.beat()
    now[0] = 0.5
    assert hb.alive(1.0) and hb.count == 1
    now[0] = 2.0
    assert not hb.alive(1.0)
