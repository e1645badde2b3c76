"""The harness's guards and ``BENCHMARK.json``'s schema, and a rehearsal of
each cell's driver at a smoke size on the CPU. The one test that needs a
card carries the ``gpu`` marker and decides in a fixture."""

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import harness

ROOT = harness.ROOT
REPO = harness.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMOKE = {
    "mamba2-2.7b": dict(num_layers=4, d_model=64, vocab_size=512,
                        ssm_head_dim=16, ssm_state=16, ssm_chunk=32,
                        decode_hot_len=16, loss_chunk=256),
}
SMOKE_SECONDS = {"train": 10.0, "serve": 2.0}
SMOKE_TRAFFIC = {
    "train": {"batch": 2, "seq_len": 48},
    "serve": {"requests": 4, "prompt_len": 24, "gen_len": 6,
              "compare_batches": 2},
}
# no cell of BENCHMARK.json serves yet: the serving driver is rehearsed
# on a cell built here, with the limits the last serving cell carried
SERVE_TRAFFIC = {"driver": "serve", "warmup_decode_steps": 2,
                 "profile_decode_steps": 3, "talp": {},
                 **SMOKE_TRAFFIC["serve"]}
SERVE_LIMITS = {"gap_max": 0.13, "gap_mean": 0.004, "talp_invalid": 0}


def smoke_cell(name, seed=123456789012, seconds=None, trace=False,
               limits=None):
    """A cell at a smoke size on the CPU; its window lasts long enough for
    a few training steps or batches (``SMOKE_SECONDS``)."""
    work = {w["name"]: w for w in BENCH["workloads"]}[name]
    driver = json.loads((ROOT / "traffic" / f"{work['traffic']}.json")
                        .read_text())["driver"]
    seconds = SMOKE_SECONDS[driver] if seconds is None else seconds
    return harness.load_cell(name, seed, seconds, trace, "cpu", {
        "port": SMOKE[work["config"]], "traffic": SMOKE_TRAFFIC[driver],
        "limits": limits or {}})


def serve_smoke_cell(seed=123456789012, seconds=None, trace=False,
                     limits=None):
    """A serving cell of the benchmark's configuration at a smoke size on
    the CPU."""
    config = json.loads((ROOT / "configs" / "mamba2-2.7b.json").read_text())
    config["port"].update(SMOKE["mamba2-2.7b"])
    work = {"name": "mamba2-2.7b.serve-smoke", "config": "mamba2-2.7b",
            "traffic": "serve-smoke", "chips": 1}
    seconds = SMOKE_SECONDS["serve"] if seconds is None else seconds
    return harness.Cell(work, config, dict(SERVE_TRAFFIC), seed, seconds,
                        trace, "cpu", dict(limits or {}))


def _sources():
    return sorted(p for p in ROOT.rglob("*.py") if "_cache" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__":
            yield "__import__"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    for name in _imports(path):
        assert name.split(".")[0] not in harness.FORBIDDEN_MODULES, name
        assert name != "__import__"


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        assert name.split(".")[0] != "repro_torch", name


def test_importing_everything_loads_no_jax():
    modules = ["perfbench." + ".".join(p.relative_to(ROOT).with_suffix("")
                                       .parts)
               for p in _sources() if "." not in p.stem
               and "tests" not in p.parts and p.stem != "run"]
    code = ("import sys; sys.path[:0] = [%r, %r]; import importlib; "
            "[importlib.import_module(m) for m in %r]; "
            "import repro_torch.launch.train, repro_torch.launch.serve; "
            "from perfbench.harness import forbidden_loaded; "
            "print(forbidden_loaded())"
            % (str(REPO), str(REPO / "src"), modules))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_loaded() == ["repro.core"]


def test_benchmark_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for entry in BENCH["configs"]:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / entry["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "limits" / f"{w['name']}.json").is_file()
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert (ROOT / "metrics" / f"{m['name']}.py").is_file()
    for name in metric_names + CELLS + [c["name"] for c in BENCH["configs"]]:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_per_layer_cells_report_the_metric_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if cell in m.get("workloads", CELLS)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def _well_formed(line, cell, trace):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and line["failed"] == 0
    section = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in BENCH[section]
               if cell in m.get("workloads", CELLS)}
    for name, m in line["metrics"].items():
        assert m["unit"] == allowed[name] and math_finite(m["value"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def math_finite(x):
    return isinstance(x, float) and x == x and abs(x) != float("inf")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cpu_rehearsal_prints_a_well_formed_line(name, trace, capsys):
    cell = smoke_cell(name, trace=bool(trace))
    rec = harness.run_cell(cell)
    line = harness.print_result(cell, rec, 1.5)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(
        json.dumps(line))
    assert err.strip().splitlines()[-1].startswith("check talp_invalid 0")
    _well_formed(line, name, trace)
    if not trace:
        assert set(line["metrics"]) == {
            m["name"] for m in BENCH["end_to_end"]
            if name in m.get("workloads", CELLS)}
    assert rec["checks"]["talp_invalid"]["value"] == 0


@pytest.mark.parametrize("trace", [0, 1])
def test_serving_driver_rehearsal(trace):
    cell = serve_smoke_cell(trace=bool(trace), limits=SERVE_LIMITS)
    rec = harness.run_cell(cell)
    for name in ("ttft_ms", "serve_tokens_per_s", "decode_gap_ms_p95"):
        assert math_finite(float(rec["end_to_end"][name])), name
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert all(c["ok"] for c in rec["checks"].values()), rec["checks"]
    assert set(rec["checks"]) == set(SERVE_LIMITS)
    _readers_read(rec, cell, SERVING_READERS)


# readers kept for cells that attention or serving traffic will bring;
# with no profile (the CPU) the device-trace ones find nothing to read
SERVING_READERS = ("mfu.prefill", "launch_ms.decode", "idle_share.decode",
                   "ssd_roofline.prefill", "flash_roofline.prefill")


def _readers_read(rec, cell, names):
    for name in names:
        value = harness._reader(name)(rec, cell)
        assert value is None or math_finite(float(value)), name


def test_unlisted_training_reader_reads():
    cell = smoke_cell(CELLS[0], trace=True)
    rec = harness.run_cell(cell)
    _readers_read(rec, cell, ["flash_roofline.train"])


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "{" not in out.stdout


def test_run_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "{" not in out.stdout


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_a_cell_runs_correct_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "4242424242", "--seconds", "5", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
