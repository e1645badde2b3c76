"""The port's training path (repro_torch.launch.train and what it runs) on
the CPU against the JAX package on smoke_config("llama3.2-3b"), and on
the SSM configs smoke_config("mamba2-130m") and smoke_config("zamba2-
2.7b"), the same weights and batches in both: the loss and its
gradients, remat, three train steps, the TALP-monitored trainer (the
torch twin of tests/test_system.py::test_train_loss_decreases_with_talp)
and what the trainer refuses."""

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


def _loss_and_grads_match_jax(arch):
    jcfg, tcfg = tp.configs(arch, compute_dtype="float32")
    jp, tparams = tp.params(jcfg, tcfg)
    batch = _batches(jcfg, 1)[0]
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jlm.train_loss(jcfg, p, batch), has_aux=True)(jp)
    loss, metrics, grads = _grads(tcfg, tparams, _torch_batch(batch))
    assert float(metrics["tokens"]) == float(jmet["tokens"]) == 4 * 93
    np.testing.assert_allclose(float(loss), float(jloss), **tp.tol("float32"))
    _assert_trees_close(grads, jgrads, what="grad")


def test_train_loss_and_grads_match_jax_fp32():
    _loss_and_grads_match_jax("llama3.2-3b")


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_ssm_train_loss_and_grads_match_jax_fp32(arch):
    """SSM blocks (and zamba2's shared attention block) differentiate on the
    CPU through the plain SSD: the loss and every gradient leaf, the SSM
    projections, conv weights, dt_bias, a_log, d_skip and gated norm
    included, match jax.value_and_grad of the JAX package's train_loss."""
    _loss_and_grads_match_jax(arch)


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
    _three_steps_match_jax("llama3.2-3b")


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_ssm_three_train_steps_match_jax(arch):
    """test_three_train_steps_match_jax on the SSM configs, with one
    allowance for AdamW itself: a parameter whose gradient lies within
    fp32 rounding of 0 (its first moment under 1e-5 of its leaf's largest;
    zamba2's embedding has one, at about 1e-8 with opposite signs in the
    two packages) moves by about lr·sign(g) a step, so it may land up to
    2·lr a step apart. Every other parameter, and every moment, is held to
    fp32 _tol."""
    _three_steps_match_jax(arch, sign_flips=True)


def _three_steps_match_jax(arch, sign_flips=False):
    jcfg, tcfg = tp.configs(arch, compute_dtype="float32")
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
    if sign_flips:
        mu = dict(_flat(jstate["opt"]["mu"]))
        for path, want in _flat(jstate["params"]):
            got = tp.to_np(dict(_flat(tstate["params"]))[path])
            m = np.abs(tp.to_np(mu[path]))
            flip = m < 1e-5 * m.max()
            want = tp.to_np(want)
            np.testing.assert_allclose(got[~flip], want[~flip],
                                       err_msg=f"params{path}",
                                       **tp.tol("float32"))
            assert np.all(np.abs(got[flip] - want[flip])
                          <= 2 * kw["lr"] * 3 + 2e-4), f"params{path}"
    else:
        _assert_trees_close(tstate["params"], jstate["params"],
                            what="params")
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


def test_ssm_model_trains_on_the_cpu_with_talp():
    """mamba2-130m's smoke config trains through the port's trainer on the
    CPU (plain SSD, differentiated by autograd): finite losses that
    decrease, TALP's train_loop hierarchies valid."""
    state, history, talp = train(
        smoke_config("mamba2-130m"), steps=12, global_batch=2, seq_len=64,
        verbose=False,
        opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=12),
        device="cpu")
    losses = [h["loss"] for h in history]
    assert int(state["step"]) == 12 and all(map(np.isfinite, losses))
    assert losses[-1] < losses[0]
    loop = talp.regions["train_loop"]
    loop.host.validate(tol=1e-6)
    loop.device.validate(tol=1e-6)


def test_train_on_cuda_refuses_a_head_dim_the_flash_backward_lacks():
    """zamba2-2.7b's attention head dim, 80, has a flash forward but no
    flash backward: train() on the card refuses it with the backward's
    ValueError before it looks for the card or allocates, so the refusal
    shows on a machine without one too; mamba2-130m (no attention) passes
    that check and meets the no-card error; the CPU trains zamba2."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import BWD_HEAD_DIMS
    from repro_torch.launch.train import check_trainable_on_card

    cfg = get_config("zamba2-2.7b")
    assert cfg.resolved_head_dim == 80 and 80 not in BWD_HEAD_DIMS
    with pytest.raises(ValueError, match="flash backward"):
        train(cfg, steps=1, verbose=False, device="cuda")
    with pytest.raises(ValueError, match="flash backward"):
        train(cfg, steps=1, verbose=False, device=torch.device("cuda", 0))
    check_trainable_on_card(get_config("mamba2-130m"))
    check_trainable_on_card(get_config("llama3.2-3b"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            train(smoke_config("mamba2-130m"), steps=1, verbose=False)
    _, history, _ = train(smoke_config("zamba2-2.7b"), steps=1,
                          global_batch=2, seq_len=32, verbose=False,
                          device="cpu")
    assert np.isfinite(history[0]["loss"])


def test_train_on_cuda_without_a_card_raises():
    """head_dim 32: the smoke config's 16 is no head dim the flash kernels
    take, which train() now refuses on the card before it looks for one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    cfg = dataclasses.replace(smoke_config("llama3.2-3b"), head_dim=32)
    with pytest.raises(RuntimeError, match="is_available"):
        train(cfg, steps=1, verbose=False)


@pytest.mark.parametrize("argv", [
    ["--ckpt-dir", "ckpt"], ["--talp-spool", "spool"], ["--talp-watchdog"],
    ["--talp-trace-out", "t.json"], ["--rank", "1", "--world-size", "2"],
    ["--ckpt-every", "5"],
], ids=["ckpt_dir", "talp_spool", "talp_watchdog", "talp_trace_out",
        "multi_rank", "ckpt_every"])
def test_cli_refuses_unported_flags(argv, capsys, tmp_path, monkeypatch):
    """Only the checkpoint flags are refused (exit 2, "not ported yet");
    the TALP flags and --rank/--world-size of the JAX trainer train."""
    assert set(UNPORTED_FLAGS) == {"--ckpt-dir", "--ckpt-every"}
    monkeypatch.chdir(tmp_path)
    cmd = ["--arch", "llama3.2-3b", "--smoke", "--device", "cpu", "--steps",
           "1", "--batch", "2", "--seq", "16", *argv]
    if argv[0] not in UNPORTED_FLAGS:
        main(cmd)
        assert 'region "train_loop"' in capsys.readouterr().out
        return
    with pytest.raises(SystemExit) as exc:
        main(cmd)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and argv[0] in err


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    hist = tmp_path / "history.json"
    main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu", "--steps",
          "2", "--batch", "2", "--seq", "32", "--history-json", str(hist)])
    history = json.loads(hist.read_text())
    assert [h["step"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0
               for h in history)
    assert 'region "train_loop"' in capsys.readouterr().out
