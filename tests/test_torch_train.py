"""The port's training path (repro_torch.launch.train and what it runs) on
the CPU against the JAX package on smoke_config("llama3.2-3b"), the same
weights and batches in both: the loss and its gradients, remat, three
train steps, the TALP-monitored trainer (the torch twin of
tests/test_system.py::test_train_loss_decreases_with_talp) and what the
trainer refuses."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data.pipeline import DataConfig, SyntheticTokenPipeline  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.train import UNPORTED_FLAGS, main, train  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import train_state_from_jax  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
import torch_parity as tp  # noqa: E402


def _batches(cfg, n, batch=4, seq=96, seed=3):
    """JAX pipeline batches (4 x 96 = 384 tokens: two loss chunks of the
    smoke config's 256, the second ragged), the first 3 labels of every
    row masked (-1)."""
    data = SyntheticTokenPipeline(DataConfig(batch, seq, cfg.vocab_size,
                                             seed=seed), 0, 1)
    out = []
    for step in range(n):
        b = data.batch_at(step)
        b["labels"][:, :3] = -1
        out.append(b)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_trees_close(got, want, dtype="float32", what=""):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(tp.to_np(got[path]), tp.to_np(want[path]),
                                   err_msg=f"{what}{path}", **tp.tol(dtype))


def _grads(tcfg, params, batch):
    leaves = tlm.tree_map(lambda x: x.clone().requires_grad_(), params)
    loss, metrics = tlm.train_loss(tcfg, leaves, batch)
    loss.backward()
    return loss.detach(), metrics, tlm.tree_map(lambda x: x.grad, leaves)


def test_train_loss_and_grads_match_jax_fp32():
    jcfg, tcfg = tp.configs(compute_dtype="float32")
    jp, tparams = tp.params(jcfg, tcfg)
    batch = _batches(jcfg, 1)[0]
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jlm.train_loss(jcfg, p, batch), has_aux=True)(jp)
    loss, metrics, grads = _grads(tcfg, tparams, _torch_batch(batch))
    assert float(metrics["tokens"]) == float(jmet["tokens"]) == 4 * 93
    np.testing.assert_allclose(float(loss), float(jloss), **tp.tol("float32"))
    _assert_trees_close(grads, jgrads, what="grad")


def test_remat_full_and_none_give_the_same_gradients():
    jcfg, tcfg = tp.configs(compute_dtype="float32")
    _, tparams = tp.params(jcfg, tcfg)
    batch = _torch_batch(_batches(jcfg, 1)[0])
    assert tcfg.remat == "full"
    loss_full, _, g_full = _grads(tcfg, tparams, batch)
    loss_none, _, g_none = _grads(dataclasses.replace(tcfg, remat="none"),
                                  tparams, batch)
    assert float(loss_full) == float(loss_none)
    _assert_trees_close(g_full, g_none, what="remat")


def test_three_train_steps_match_jax():
    """From the same state (carried over by train_state_from_jax), three
    steps on the same batches leave params, moments and counts within
    fp32 _tol of the JAX package's; the loss, grad norm and lr of every
    step agree too."""
    jcfg, tcfg = tp.configs(compute_dtype="float32")
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=3)
    jstate = jsteps.init_train_state(jcfg, jax.random.PRNGKey(0))
    tstate = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate))
    jstep = jax.jit(jsteps.make_train_step(jcfg, JAdamWConfig(**kw)))
    tstep = tsteps.make_train_step(tcfg, AdamWConfig(**kw))
    for i, batch in enumerate(_batches(jcfg, 3)):
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, _torch_batch(batch))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       err_msg=f"step {i} {key}",
                                       **tp.tol("float32"))
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    assert int(tstate["opt"]["count"]) == int(jstate["opt"]["count"]) == 3
    _assert_trees_close(tstate["params"], jstate["params"], what="params")
    _assert_trees_close(tstate["opt"]["mu"], jstate["opt"]["mu"], what="mu")
    _assert_trees_close(tstate["opt"]["nu"], jstate["opt"]["nu"], what="nu")


def test_train_loss_matches_jax_in_bf16_compute():
    jcfg, tcfg = tp.configs(compute_dtype="bfloat16")
    jp, tparams = tp.params(jcfg, tcfg)
    batch = _batches(jcfg, 1)[0]
    jloss, _ = jlm.train_loss(jcfg, jax.tree.map(
        lambda x: x.astype(jax.numpy.bfloat16), jp), batch)
    leaves = tlm.tree_map(lambda x: x.to(torch.bfloat16), tparams)
    loss, _ = tlm.train_loss(tcfg, leaves, _torch_batch(batch))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), **tp.tol("bfloat16"))


def test_train_loss_decreases_with_talp():
    """Torch twin of tests/test_system.py::test_train_loss_decreases_with_talp
    (llama3.2-3b's smoke config: the port's registered dense model)."""
    cfg = smoke_config("llama3.2-3b")
    state, history, talp = train(
        cfg, steps=30, global_batch=4, seq_len=64, verbose=False,
        opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=30),
        device="cpu",
    )
    losses = [h["loss"] for h in history]
    assert len(history) == 30 and int(state["step"]) == 30
    assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0]
    loop = talp.regions["train_loop"]
    assert loop.host is not None and loop.device is not None
    loop.host.validate(tol=1e-6)
    loop.device.validate(tol=1e-6)
    assert loop.host_states[0]["useful"] > 0
    assert loop.host_states[0]["offload"] > 0
    assert loop.device_states[0]["kernel"] > 0


def test_training_an_ssm_model_raises_naming_the_ssd_backward():
    with pytest.raises(NotImplementedError, match="SSD backward"):
        train(smoke_config("mamba2-130m"), steps=1, global_batch=2,
              seq_len=32, verbose=False, device="cpu")


def test_train_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    with pytest.raises(RuntimeError, match="is_available"):
        train(smoke_config("llama3.2-3b"), steps=1, verbose=False)


@pytest.mark.parametrize("argv", [
    ["--ckpt-dir", "ckpt"], ["--talp-spool", "spool"], ["--talp-watchdog"],
    ["--talp-trace-out", "t.json"], ["--rank", "1", "--world-size", "2"],
], ids=["ckpt_dir", "talp_spool", "talp_watchdog", "talp_trace_out",
        "multi_rank"])
def test_cli_refuses_unported_flags(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu", *argv])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and argv[0] in err
    assert argv[0] in UNPORTED_FLAGS


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    hist = tmp_path / "history.json"
    main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu", "--steps",
          "2", "--batch", "2", "--seq", "32", "--history-json", str(hist)])
    history = json.loads(hist.read_text())
    assert [h["step"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0
               for h in history)
    assert 'region "train_loop"' in capsys.readouterr().out
