"""The port's training path (repro_torch.launch.train and what it runs) on
the CPU against the JAX package on smoke_config("llama3.2-3b"), on
the SSM configs smoke_config("mamba2-130m") and smoke_config("zamba2-
2.7b"), and on the ``embed``-frontend configs smoke_config("musicgen-
large") and smoke_config("qwen2-vl-72b") (M-RoPE), the same weights and
batches in both: the loss and its
gradients, remat, three train steps, the TALP-monitored trainer (the
torch twin of tests/test_system.py::test_train_loss_decreases_with_talp),
what the trainer refuses (on the card: fp32 compute, which the server
refuses too, a head dim the flash backward lacks, a train state larger
than the card), and checkpoint and restart: a run that fails
and resumes ends bit-identical to one that did not, and a run resumes
from a checkpoint the JAX trainer wrote."""

import dataclasses
import json
import os

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
from repro_torch.launch.train import main, train  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.convert import train_state_from_jax  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
import torch_parity as tp  # noqa: E402


def _batches(cfg, n, batch=4, seq=96, seed=3):
    """JAX pipeline batches (4 x 96 = 384 tokens: two loss chunks of the
    smoke config's 256, the second ragged), the first 3 labels of every
    row masked (-1); (B, S, d_model) fp32 inputs for an ``embed``-frontend
    config, as the JAX trainer asks for."""
    embed_dim = cfg.d_model if cfg.frontend == "embed" else 0
    data = SyntheticTokenPipeline(DataConfig(batch, seq, cfg.vocab_size,
                                             seed=seed, embed_dim=embed_dim),
                                  0, 1)
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
    assert set(metrics) == set(jmet)
    for key in jmet:
        np.testing.assert_allclose(float(metrics[key]), float(jmet[key]),
                                   err_msg=key, **tp.tol("float32"))
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


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
def test_moe_train_loss_and_grads_match_jax_fp32(capacity_factor):
    """The MoE model differentiates as the JAX package's: the loss with
    MOE_AUX_WEIGHT times the aux loss added, metrics["loss"] (the
    cross-entropy) and metrics["moe_aux"], and every gradient leaf, the
    router's (through the renormalised top-k probabilities and the aux
    loss) and the dead expert slots' (zero) included; at the smoke
    config's capacity factor and at granite's own 1.25, which drops
    tokens."""
    jcfg, tcfg = tp.configs("granite-moe-3b-a800m", compute_dtype="float32")
    change = dict(capacity_factor=capacity_factor)
    jcfg = dataclasses.replace(jcfg, **change)
    tcfg = dataclasses.replace(tcfg, **change)
    jp, tparams = tp.params(jcfg, tcfg)
    batch = _batches(jcfg, 1)[0]
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jlm.train_loss(jcfg, p, batch), has_aux=True)(jp)
    loss, metrics, grads = _grads(tcfg, tparams, _torch_batch(batch))
    assert set(metrics) == set(jmet) == {"loss", "tokens", "moe_aux"}
    np.testing.assert_allclose(float(loss), float(jloss), **tp.tol("float32"))
    for key in jmet:
        np.testing.assert_allclose(float(metrics[key]), float(jmet[key]),
                                   err_msg=key, **tp.tol("float32"))
    np.testing.assert_allclose(
        float(loss), float(metrics["loss"]) + tlm.MOE_AUX_WEIGHT
        * float(metrics["moe_aux"]), rtol=1e-6)
    _assert_trees_close(grads, jgrads, what="grad")
    dead = grads["slots"]["slot0"]["moe"]["w_up"][:, tcfg.num_experts:]
    assert dead.shape[1] == 44 and torch.all(dead == 0)


def test_remat_full_and_none_give_the_same_gradients():
    _remat_matches("llama3.2-3b")


def test_moe_remat_full_and_none_give_the_same_gradients():
    """The MoE model's aux loss goes through the checkpointed repeats, and
    the recomputed forward routes as the first did."""
    _remat_matches("granite-moe-3b-a800m")


def _remat_matches(arch):
    """remat "full" (each repeat under torch.utils.checkpoint) and "none"
    give the same loss, metrics and gradients."""
    jcfg, tcfg = tp.configs(arch, compute_dtype="float32")
    _, tparams = tp.params(jcfg, tcfg)
    batch = _torch_batch(_batches(jcfg, 1)[0])
    assert tcfg.remat == "full"
    loss_full, m_full, g_full = _grads(tcfg, tparams, batch)
    loss_none, m_none, g_none = _grads(dataclasses.replace(tcfg, remat="none"),
                                       tparams, batch)
    assert float(loss_full) == float(loss_none)
    assert {k: float(v) for k, v in m_full.items()} == {
        k: float(v) for k, v in m_none.items()}
    _assert_trees_close(g_full, g_none, what="remat")


def test_three_train_steps_match_jax():
    """From the same state (carried over by train_state_from_jax), three
    steps on the same batches leave params, moments and counts within
    fp32 _tol of the JAX package's; the loss, grad norm and lr of every
    step agree too."""
    _three_steps_match_jax("llama3.2-3b")


def test_moe_three_train_steps_match_jax():
    """test_three_train_steps_match_jax on the MoE model (its train step
    minimises the loss with the aux term)."""
    _three_steps_match_jax("granite-moe-3b-a800m")


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
    """A config whose attention head dim the flash backward lacks (48:
    zamba2-2.7b's with its width cut to 1536) is refused by train() on the
    card with the backward's ValueError before it looks for the card or
    allocates, so the refusal shows on a machine without one too;
    mamba2-130m (no attention) and llama3.2-3b pass that check, and
    without a card mamba2-130m meets the no-card error; the CPU trains the
    D-48 config."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import BWD_HEAD_DIMS
    from repro_torch.launch.train import check_trainable_on_card

    cfg = dataclasses.replace(get_config("zamba2-2.7b"), d_model=1536)
    assert cfg.resolved_head_dim == 48 and 48 not in BWD_HEAD_DIMS
    with pytest.raises(ValueError, match="flash backward"):
        train(cfg, steps=1, verbose=False, device="cuda")
    with pytest.raises(ValueError, match="flash backward"):
        train(cfg, steps=1, verbose=False, device=torch.device("cuda", 0))
    check_trainable_on_card(get_config("mamba2-130m"))
    check_trainable_on_card(get_config("llama3.2-3b"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            train(smoke_config("mamba2-130m"), steps=1, verbose=False)
    small = dataclasses.replace(smoke_config("zamba2-2.7b"), head_dim=48)
    _, history, _ = train(small, steps=1, global_batch=2, seq_len=32,
                          verbose=False, device="cpu")
    assert np.isfinite(history[0]["loss"])


@pytest.mark.parametrize("entry", ["train", "serve"])
def test_train_and_serve_on_cuda_refuse_fp32_compute_before_allocating(
        entry, monkeypatch):
    """The card's kernels take bf16 activations only: train() and serve()
    on the card refuse a config computing in fp32 with ValueError before
    they look for the card (resolve_device, here a stub that records its
    call) or draw a weight, so the refusal shows on a machine without one;
    the bf16 config passes the check and reaches the device; the CPU runs
    the fp32 config through the plain versions."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod

    mod = train_mod if entry == "train" else serve_mod
    run = getattr(mod, entry)
    reached = []

    def stub(device):
        reached.append(device)
        raise RuntimeError("resolve_device reached")

    monkeypatch.setattr(mod, "resolve_device", stub)
    bf16 = smoke_config("mamba2-130m")
    fp32 = dataclasses.replace(bf16, compute_dtype="float32")
    for device in ("cuda", torch.device("cuda", 0)):
        with pytest.raises(ValueError, match="compute_dtype 'float32'"):
            run(fp32, verbose=False, device=device)
    assert not reached
    with pytest.raises(RuntimeError, match="resolve_device reached"):
        run(bf16, verbose=False, device="cuda")
    monkeypatch.undo()
    if entry == "train":
        _, history, _ = run(fp32, steps=1, global_batch=2, seq_len=32,
                            verbose=False, device="cpu")
        assert np.isfinite(history[0]["loss"])
    else:
        tokens, _ = run(fp32, requests=2, prompt_len=16, gen_len=2,
                        verbose=False, device="cpu")
        assert tokens.shape == (2, 2)


def test_zamba2_passes_the_card_checks_before_allocating():
    """zamba2-2.7b's shared block (head dim 80) has a flash backward:
    check_trainable_on_card passes its config, and its train state (16
    bytes a parameter, about 30.7 GiB) fits an 80 GB card by
    check_train_state_fits, which still refuses it on a 16 GiB one."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import BWD_HEAD_DIMS
    from repro_torch.launch.train import (
        check_train_state_fits, check_trainable_on_card)
    from repro_torch.models import lm

    cfg = get_config("zamba2-2.7b")
    assert cfg.resolved_head_dim == 80 and 80 in BWD_HEAD_DIMS
    check_trainable_on_card(cfg)
    n = lm.param_count(lm.init_params(cfg, None, device="meta"))
    assert 30.0 < 16 * n / 2 ** 30 < 31.5
    check_train_state_fits(cfg, 80 * 10 ** 9)
    with pytest.raises(ValueError, match="train state"):
        check_train_state_fits(cfg, 16 * 2 ** 30)


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
def test_cli_takes_the_jax_trainer_flags(argv, capsys, tmp_path, monkeypatch):
    """Every flag of the JAX trainer trains: the TALP flags,
    --rank/--world-size, and the checkpoint flags, which write step_N (the
    last step's checkpoint; --ckpt-every 1 with --ckpt-dir alone, so that
    the loop's own save runs too; --ckpt-every alone writes nothing)."""
    monkeypatch.chdir(tmp_path)
    cmd = ["--arch", "llama3.2-3b", "--smoke", "--device", "cpu", "--steps",
           "2", "--batch", "2", "--seq", "16", *argv]
    if argv[0] == "--ckpt-dir":
        cmd += ["--ckpt-every", "1"]
    main(cmd)
    assert 'region "train_loop"' in capsys.readouterr().out
    if argv[0] == "--ckpt-dir":
        assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_0", "step_1"]
        manifest = json.loads(
            (tmp_path / "ckpt" / "step_1" / "manifest.json").read_text())
        assert manifest["step"] == 1
        assert {e["key"] for e in manifest["leaves"]} >= {"step",
                                                          "opt__count"}
    else:
        assert not list(tmp_path.rglob("manifest.json"))


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    hist = tmp_path / "history.json"
    main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu", "--steps",
          "2", "--batch", "2", "--seq", "32", "--history-json", str(hist)])
    history = json.loads(hist.read_text())
    assert [h["step"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0
               for h in history)
    assert 'region "train_loop"' in capsys.readouterr().out


def _state_leaves(state):
    from repro_torch.checkpoint.checkpointer import flatten_with_keys

    return dict(flatten_with_keys(state))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-3b-a800m"])
def test_resume_after_a_failure_is_bit_identical(arch, tmp_path):
    """6 steps with a checkpoint every 3 (step_2, step_5) and a failure
    injected before step 4, under run_with_restarts: the second attempt
    restores step_2 and runs steps 3-5. Its history is those steps, and
    they, the final parameters, moments and counts are bit-identical to an
    uninterrupted run's; the directory then holds step_2 and step_5."""
    from repro_torch.checkpoint.checkpointer import list_steps
    from repro_torch.runtime import run_with_restarts

    cfg = smoke_config(arch)
    kw = dict(steps=6, global_batch=2, seq_len=32, verbose=False,
              opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6),
              device="cpu")
    s_full, h_full, _ = train(cfg, **kw)
    ck = str(tmp_path / "ck")
    runs = []

    def attempt(i):
        runs.append(train(cfg, ckpt_dir=ck, ckpt_every=3,
                          fail_at_step=4 if i == 0 else None, **kw))

    errors = []
    report = run_with_restarts(attempt, max_restarts=1,
                               on_restart=lambda i, e: errors.append(e))
    assert report.restarts == 1 and len(runs) == 1
    assert "injected failure at step 4" in str(errors[0])
    s_res, h_res, _ = runs[0]
    assert [h["step"] for h in h_res] == [3, 4, 5]
    drop_time = lambda h: {k: v for k, v in h.items() if k != "time_s"}  # noqa: E731
    assert [drop_time(h) for h in h_res] == [drop_time(h) for h in h_full[3:]]
    if cfg.is_moe:
        assert all(h["moe_aux"] > 0 for h in h_res)
    got, want = _state_leaves(s_res), _state_leaves(s_full)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert list_steps(ck) == [2, 5]


def test_port_resumes_a_checkpoint_the_jax_trainer_wrote(tmp_path):
    """The JAX trainer runs 6 steps with a checkpoint every 3 (step_2 and
    step_5); step_5 is removed, and the port's trainer, given the same
    directory, resumes from JAX's step_2 and runs steps 3-5. Its losses,
    grad norms and final state agree with the JAX run's at fp32 _tol
    (test_three_train_steps_match_jax's tolerance)."""
    _resumes_jax_checkpoint("llama3.2-3b", tmp_path, seq_len=32)


def _resumes_jax_checkpoint(arch, tmp_path, seq_len):
    import shutil

    from repro.launch.train import train as jax_train

    jcfg, tcfg = tp.configs(arch, compute_dtype="float32")
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=6)
    kw = dict(steps=6, global_batch=2, seq_len=seq_len, verbose=False)
    ck = tmp_path / "ck"
    jstate, jhist, _ = jax_train(jcfg, ckpt_dir=str(ck), ckpt_every=3,
                                 opt_cfg=JAdamWConfig(**opt), **kw)
    assert sorted(os.listdir(ck)) == ["step_2", "step_5"]
    shutil.rmtree(ck / "step_5")
    tstate, thist, _ = train(tcfg, ckpt_dir=str(ck), ckpt_every=3,
                             opt_cfg=AdamWConfig(**opt), device="cpu", **kw)
    assert [h["step"] for h in thist] == [3, 4, 5]
    for got, want in zip(thist, jhist[3:]):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key],
                                       err_msg=f"step {got['step']} {key}",
                                       **tp.tol("float32"))
    assert int(tstate["step"]) == int(jstate["step"]) == 6
    _assert_trees_close(tstate["params"], jstate["params"], what="params")
    _assert_trees_close(tstate["opt"]["mu"], jstate["opt"]["mu"], what="mu")
    _assert_trees_close(tstate["opt"]["nu"], jstate["opt"]["nu"], what="nu")


EMBED_ARCHS = ["musicgen-large", "qwen2-vl-72b"]


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_embed_train_loss_and_grads_match_jax_fp32(arch):
    """The ``embed`` frontend differentiates as the JAX package's on the
    pipeline's (B, S, M) embeddings: the loss, its token count and every
    gradient leaf (no input table; qwen2-vl-72b's through M-RoPE) at fp32
    _tol."""
    _loss_and_grads_match_jax(arch)


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_embed_train_loss_matches_jax_in_bf16_compute(arch):
    jcfg, tcfg = tp.configs(arch, compute_dtype="bfloat16")
    jp, tparams = tp.params(jcfg, tcfg)
    batch = _batches(jcfg, 1)[0]
    assert batch["inputs"].shape == (4, 96, jcfg.d_model)
    jloss, _ = jlm.train_loss(jcfg, jax.tree.map(
        lambda x: x.astype(jax.numpy.bfloat16), jp), batch)
    leaves = tlm.tree_map(lambda x: x.to(torch.bfloat16), tparams)
    loss, _ = tlm.train_loss(tcfg, leaves, _torch_batch(batch))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), **tp.tol("bfloat16"))


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_embed_three_train_steps_match_jax(arch):
    """test_three_train_steps_match_jax on the embed-frontend configs: the
    loss, grad norm and lr of every step, then params and moments."""
    _three_steps_match_jax(arch)


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_embed_trainer_matches_the_jax_trainer(arch, tmp_path):
    """repro.launch.train runs 2 steps with a checkpoint after each;
    step_1 is removed and the port's trainer, given the directory,
    resumes from JAX's step_0 and runs step 1 on the embeddings its own
    pipeline draws (embed_dim = d_model). Its loss and grad norm agree with
    the JAX trainer's step 1 at fp32 _tol, and so do the final params."""
    import shutil

    from repro.launch.train import train as jax_train

    jcfg, tcfg = tp.configs(arch, compute_dtype="float32")
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=2)
    kw = dict(steps=2, global_batch=2, seq_len=32, verbose=False)
    ck = tmp_path / "ck"
    jstate, jhist, _ = jax_train(jcfg, ckpt_dir=str(ck), ckpt_every=1,
                                 opt_cfg=JAdamWConfig(**opt), **kw)
    shutil.rmtree(ck / "step_1")
    tstate, thist, _ = train(tcfg, ckpt_dir=str(ck), ckpt_every=1,
                             opt_cfg=AdamWConfig(**opt), device="cpu", **kw)
    assert [h["step"] for h in thist] == [1]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(thist[0][key], jhist[1][key], err_msg=key,
                                   **tp.tol("float32"))
    assert "embed" not in tstate["params"]
    _assert_trees_close(tstate["params"], jstate["params"], what="params")


@pytest.mark.parametrize("arch,fits", [
    ("llama3.2-3b", True), ("granite-moe-3b-a800m", True),
    ("musicgen-large", True), ("starcoder2-15b", False),
    ("qwen2-vl-72b", False), ("gemma2-2b", True), ("h2o-danube-3-4b", True),
])
def test_train_state_memory_check_at_80_gib(arch, fits):
    """check_train_state_fits at a stated 80 GiB card: 16 bytes a parameter
    (fp32 masters and both moments, bf16 cast leaves and gradients) is
    53.7 GiB for llama3.2-3b, 59.3 for granite, 48.1 for musicgen-large,
    47.7 for gemma2-2b and 59.0 for h2o-danube-3-4b, which pass;
    starcoder2-15b's 327.8 GiB and qwen2-vl-72b's 1064.8 GiB are refused
    with ValueError."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import (
        TRAIN_STATE_BYTES_PER_PARAM, check_train_state_fits,
    )

    cfg = get_config(arch)
    card = 80 * 2**30
    need = TRAIN_STATE_BYTES_PER_PARAM * tlm.param_count(
        tlm.init_params(cfg, None, device="meta"))
    assert (need <= card) == fits
    if fits:
        check_train_state_fits(cfg, card)
    else:
        with pytest.raises(ValueError, match="train state"):
            check_train_state_fits(cfg, card)
    # the boundary is the stated total, byte for byte
    check_train_state_fits(cfg, need)
    with pytest.raises(ValueError):
        check_train_state_fits(cfg, need - 1)


def test_train_on_cuda_refuses_a_train_state_larger_than_the_card(
        monkeypatch):
    """train() on the card asks torch.cuda.mem_get_info for the card's total
    and refuses starcoder2-15b before it draws a weight (here a stated
    80 GiB card: the refusal comes before any CUDA allocation, so no card
    is needed to show it); the CPU trains its smoke config."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda *a: (80 * 2**30, 80 * 2**30))
    drawn = []
    monkeypatch.setattr(train_mod, "init_train_state",
                        lambda *a, **k: drawn.append(1))
    with pytest.raises(ValueError, match="327.8 GiB"):
        train(get_config("starcoder2-15b"), steps=1, verbose=False,
              device="cuda")
    assert not drawn
    monkeypatch.undo()
    _, history, _ = train(smoke_config("starcoder2-15b"), steps=1,
                          global_batch=2, seq_len=32, verbose=False,
                          device="cpu")
    assert np.isfinite(history[0]["loss"])


# Sliding-window attention at every layer (h2o-danube-3-4b, head dim 120)
# and local and global layers in turn with soft-caps (gemma2-2b, head dim
# 256); the batches' 96 tokens cross the smoke window of 64.
WINDOWED_ARCHS = ["gemma2-2b", "h2o-danube-3-4b"]


@pytest.mark.parametrize("arch", WINDOWED_ARCHS)
def test_windowed_train_loss_and_grads_match_jax_fp32(arch):
    """The loss, its token count and every gradient leaf at fp32 _tol,
    through the window and (gemma2-2b) both soft-caps."""
    _loss_and_grads_match_jax(arch)


@pytest.mark.parametrize("arch", WINDOWED_ARCHS)
def test_windowed_three_train_steps_match_jax(arch):
    """test_three_train_steps_match_jax on the windowed configs."""
    _three_steps_match_jax(arch)


@pytest.mark.parametrize("arch", WINDOWED_ARCHS)
def test_windowed_train_loss_matches_jax_in_bf16_compute(arch):
    jcfg, tcfg = tp.configs(arch, compute_dtype="bfloat16")
    jp, tparams = tp.params(jcfg, tcfg)
    batch = _batches(jcfg, 1)[0]
    jloss, _ = jlm.train_loss(jcfg, jax.tree.map(
        lambda x: x.astype(jax.numpy.bfloat16), jp), batch)
    leaves = tlm.tree_map(lambda x: x.to(torch.bfloat16), tparams)
    loss, _ = tlm.train_loss(tcfg, leaves, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), **tp.tol("bfloat16"))


@pytest.mark.parametrize("arch", WINDOWED_ARCHS)
def test_port_resumes_a_jax_checkpoint_of_a_windowed_model(arch, tmp_path):
    """test_port_resumes_a_checkpoint_the_jax_trainer_wrote on the windowed
    configs, at 80 tokens a row (past the smoke window)."""
    _resumes_jax_checkpoint(arch, tmp_path, seq_len=80)


def test_check_trainable_on_card_takes_head_dims_120_and_256():
    """h2o-danube-3-4b's head dim 120 and gemma2-2b's 256 have a flash
    backward: check_trainable_on_card passes both (before any card is
    looked for), and still refuses a head dim the backward lacks (48:
    zamba2-2.7b's width cut to 1536)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import BWD_HEAD_DIMS
    from repro_torch.launch.train import check_trainable_on_card

    for arch, d in (("h2o-danube-3-4b", 120), ("gemma2-2b", 256)):
        cfg = get_config(arch)
        assert cfg.resolved_head_dim == d and d in BWD_HEAD_DIMS
        check_trainable_on_card(cfg)
    with pytest.raises(ValueError, match="flash backward"):
        check_trainable_on_card(dataclasses.replace(
            get_config("zamba2-2.7b"), d_model=1536))


@pytest.mark.parametrize("arch", WINDOWED_ARCHS)
def test_cli_trains_windowed_archs_on_the_cpu(arch, tmp_path, capsys):
    hist = tmp_path / "history.json"
    main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
          "--batch", "2", "--seq", "80", "--history-json", str(hist)])
    history = json.loads(hist.read_text())
    assert [h["step"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0
               for h in history)
    assert 'region "train_loop"' in capsys.readouterr().out


def test_loss_chunk_is_cut_to_the_logit_budget(monkeypatch):
    """chunked_softmax_xent holds at most common.LOSS_CHUNK_ELEMENTS fp32
    logits in one chunk, whatever the config's loss_chunk (tokens) says:
    gemma2-2b trained at 1 x 8192 (256,000 words) runs chunks of 2097
    tokens, 2 GiB of logits each, where the config's 16384 would put all
    8192 in one chunk of 7.8 GiB (with the soft-cap and the gradients,
    more than an 80 GB card has beside the train state). A budget of 64
    rows at the smoke vocabulary cuts the smoke config's chunk of 256 to
    64, and the loss and every gradient stay JAX's (one chunk of 256) at
    fp32 _tol."""
    from repro_torch.configs import get_config
    from repro_torch.models import common

    cfg = get_config("gemma2-2b")
    seen = []
    real = common._xent_chunk

    def spy(h, *args):
        seen.append(h.shape[0])
        return real(h, *args)

    monkeypatch.setattr(common, "_xent_chunk", spy)
    meta = dict(device="meta")
    with torch.no_grad():
        common.chunked_softmax_xent(
            torch.empty(8192, cfg.d_model, **meta),
            torch.empty(cfg.d_model, cfg.vocab_size, **meta),
            torch.empty(8192, dtype=torch.int32, **meta),
            chunk=cfg.loss_chunk, final_softcap=cfg.final_logit_softcap)
    assert cfg.loss_chunk == 16384 and seen == [2097, 2097, 2097, 1901]
    assert 2097 * cfg.vocab_size <= common.LOSS_CHUNK_ELEMENTS
    seen.clear()
    monkeypatch.setattr(common, "LOSS_CHUNK_ELEMENTS", 64 * 512)
    _loss_and_grads_match_jax("gemma2-2b")
    assert max(seen) == 64 and smoke_config("gemma2-2b").loss_chunk == 256
