"""The port's serving entry point (repro_torch.launch.serve) on the CPU: the
torch twin of tests/test_system.py::test_serve_generates_and_reports, on
the llama3.2-3b and mamba2-130m smoke configs; both CLIs (serve and train)
on the smoke configs of musicgen-large and qwen2-vl-72b (the ``embed``
frontend) and starcoder2-15b, and of the windowed gemma2-2b and
h2o-danube-3-4b. A CUDA request without a card must fail, not run on the
CPU."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402


def test_serve_generates_and_reports(tmp_path):
    cfg = smoke_config("llama3.2-3b")
    out = tmp_path / "talp.json"
    tokens, talp = serve_mod.serve(cfg, requests=2, prompt_len=16, gen_len=6,
                                   talp_json=str(out), verbose=False,
                                   device="cpu")
    assert tokens.shape == (2, 6)
    assert np.all(tokens >= 0) and np.all(tokens < cfg.vocab_size)
    assert set(talp.regions) == {"Global", "init", "prefill", "grow_cache",
                                 "decode"}
    dec = talp.regions["decode"]
    dec.host.validate(tol=1e-6)
    assert dec.device_states[0]["kernel"] > 0
    glob = talp.regions["Global"]
    glob.host.validate(tol=1e-6)
    glob.device.validate(tol=1e-6)
    # backend.wait runs inside offload(); launch (the eager compute on the
    # CPU) is host Useful
    assert dec.host_states[0]["offload"] > 0
    assert dec.host_states[0]["useful"] > 0
    assert json.loads(out.read_text())["talp"] == "serve"


def test_serve_is_deterministic_in_seed():
    cfg = smoke_config("llama3.2-3b")
    run = lambda seed: serve_mod.serve(  # noqa: E731
        cfg, requests=2, prompt_len=8, gen_len=3, seed=seed, verbose=False,
        device="cpu")[0]
    np.testing.assert_array_equal(run(3), run(3))


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("llama3.2-3b")
    with pytest.raises(RuntimeError, match="cuda"):
        serve_mod.serve(cfg, requests=2, prompt_len=8, gen_len=2,
                        verbose=False, device="cuda")


def test_main_cli_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
        "--requests", "2", "--prompt-len", "8", "--gen-len", "2"])
    serve_mod.main()
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("generated 4 tokens in ")


def test_mamba_serve_generates_and_reports_on_cpu():
    """The mamba2-130m smoke config through the same entry point: SSM
    caches pass through grow_cache, and the decode loop advances them."""
    cfg = smoke_config("mamba2-130m")
    tokens, talp = serve_mod.serve(cfg, requests=2, prompt_len=40, gen_len=6,
                                   verbose=False, device="cpu")
    assert tokens.shape == (2, 6)
    assert np.all(tokens >= 0) and np.all(tokens < cfg.vocab_size)
    assert set(talp.regions) == {"Global", "init", "prefill", "grow_cache",
                                 "decode"}
    for name in ("Global", "decode"):
        talp.regions[name].host.validate(tol=1e-6)
        talp.regions[name].device.validate(tol=1e-6)
    assert talp.regions["prefill"].device_states[0]["kernel"] > 0


def test_main_cli_mamba_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "mamba2-130m", "--smoke", "--device", "cpu",
        "--requests", "2", "--prompt-len", "8", "--gen-len", "3"])
    serve_mod.main()
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("generated 6 tokens in ")


def test_main_cli_zamba_on_cpu(monkeypatch, capsys):
    """zamba2-2.7b comes from the registry: its smoke config serves through
    the same entry point, the shared block's KV caches grown beside the
    SSM carries."""
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
        "--requests", "2", "--prompt-len", "16", "--gen-len", "4"])
    serve_mod.main()
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("generated 8 tokens in ")


NEW_ARCHS = ["musicgen-large", "starcoder2-15b", "qwen2-vl-72b"]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_main_cli_new_archs_on_cpu(arch, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", arch, "--smoke", "--device", "cpu",
        "--requests", "2", "--prompt-len", "16", "--gen-len", "4"])
    serve_mod.main()
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("generated 8 tokens in ")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_cli_new_archs_on_cpu(arch, tmp_path, capsys):
    from repro_torch.launch.train import main as train_main

    hist = tmp_path / "history.json"
    train_main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                "--batch", "2", "--seq", "32", "--history-json", str(hist)])
    history = json.loads(hist.read_text())
    assert [h["step"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0
               for h in history)
    assert 'region "train_loop"' in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["musicgen-large", "qwen2-vl-72b"])
def test_embed_serve_feeds_embeddings_and_zero_frames(arch, monkeypatch):
    """An ``embed``-frontend model is prefilled on random bf16 (requests,
    prompt_len, d_model) embeddings from the run's generator and decoded on
    zero (requests, 1, d_model) bf16 frames, as repro.launch.serve does;
    the run is deterministic in its seed."""
    from repro_torch.models import lm

    cfg = smoke_config(arch)
    seen = []
    real_prefill, real_decode = lm.prefill, lm.decode_step

    def prefill(cfg_, params, inputs):
        seen.append(("prefill", inputs.clone()))
        return real_prefill(cfg_, params, inputs)

    def decode_step(cfg_, params, inputs, pos, caches):
        seen.append(("decode", inputs.clone()))
        return real_decode(cfg_, params, inputs, pos, caches)

    monkeypatch.setattr(lm, "prefill", prefill)
    monkeypatch.setattr(lm, "decode_step", decode_step)
    tokens, _ = serve_mod.serve(cfg, requests=2, prompt_len=8, gen_len=3,
                                seed=4, verbose=False, device="cpu")
    assert tokens.shape == (2, 3)
    (kind, prompt), *steps = seen
    assert kind == "prefill" and prompt.shape == (2, 8, cfg.d_model)
    assert prompt.dtype == torch.bfloat16 and prompt.std() > 0.5
    assert [k for k, _ in steps] == ["decode"] * 3
    for _, frame in steps:
        assert frame.shape == (2, 1, cfg.d_model)
        assert frame.dtype == torch.bfloat16 and not frame.any()
    seen.clear()
    again, _ = serve_mod.serve(cfg, requests=2, prompt_len=8, gen_len=3,
                               seed=4, verbose=False, device="cpu")
    np.testing.assert_array_equal(again, tokens)
    assert torch.equal(seen[0][1], prompt)


@pytest.mark.parametrize("arch", ["gemma2-2b", "h2o-danube-3-4b"])
def test_main_cli_windowed_archs_on_cpu(arch, monkeypatch, capsys):
    """Both windowed configs serve from the CLI with an 80-token prompt,
    past their smoke window of 64."""
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", arch, "--smoke", "--device", "cpu",
        "--requests", "2", "--prompt-len", "80", "--gen-len", "4"])
    serve_mod.main()
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("generated 8 tokens in ")
