"""The port's serving entry point (repro_torch.launch.serve) on the CPU: the
torch twin of tests/test_system.py::test_serve_generates_and_reports, on
the llama3.2-3b smoke config. A CUDA request without a card must fail,
not run on the CPU."""

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
