"""The benchmark's runner: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name: ``configs/<config>.json`` (sizes, and the
program's ``ModelConfig`` keywords under ``port``), ``traffic/<mix>.json``
(whose ``driver`` names ``drivers/<driver>.py``), ``limits/<cell>.json``
(the limit of each number the correctness check compares) and
``metrics/<metric>.py`` (a reader of one per-layer metric). A driver sets
up the program, measures the window and compares what the window produced
with the plain reference (``reference/``); it returns a record, from which
the harness prints the contract's last line."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from .sizes import Sizes, load_config
from .traffic import load_traffic

__all__ = ["Cell", "Spans", "load_cell", "make_cell", "run_cell",
           "result_line", "main", "FORBIDDEN_MODULES", "forbidden_loaded"]

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level module names that may not be loaded in a run: JAX and the JAX
# package the program was ported from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN_MODULES``, compared whole."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN_MODULES})


def benchmark() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


@dataclass
class Cell:
    """One cell's inputs: its entry in ``BENCHMARK.json``, its
    configuration and traffic files, and the run's arguments."""

    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    limits: Dict[str, float] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def sizes(self) -> Sizes:
        return Sizes.of(self.config["port"])

    def model_config(self):
        """The program's ``ModelConfig`` of this configuration."""
        from repro_torch.configs.base import ModelConfig

        port = dict(self.config["port"])
        port["pattern"] = tuple(port["pattern"])
        return ModelConfig(**port)


def load_cell(name: str, seed: int, seconds: float, trace: bool, device,
              overrides: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``. ``overrides`` (tests) may
    replace keys of the configuration's ``port`` section
    (``overrides["port"]``) and of the traffic (``overrides["traffic"]``),
    and give limits (``overrides["limits"]``)."""
    cells = {w["name"]: w for w in benchmark()["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    return make_cell(cells[name], seed, seconds, trace, device, overrides)


def make_cell(work: dict, seed: int, seconds: float, trace: bool, device,
              overrides: Optional[dict] = None) -> Cell:
    """The cell of the workload entry ``work`` (its ``name``, ``config``
    and ``traffic``), whether or not ``BENCHMARK.json`` lists it: a cell
    is calibrated before it is listed. ``overrides`` as for
    :func:`load_cell`."""
    name = work["name"]
    config = load_config(work["config"])
    traffic = load_traffic(work["traffic"])
    limits_file = ROOT / "limits" / f"{name}.json"
    limits = (json.loads(limits_file.read_text())
              if limits_file.is_file() else {})
    overrides = overrides or {}
    config = {**config, "port": {**config["port"],
                                 **overrides.get("port", {})}}
    traffic = {**traffic, **overrides.get("traffic", {})}
    limits = {**limits, **overrides.get("limits", {})}
    return Cell(work, config, traffic, seed, seconds, trace, device, limits)


def driver(cell: Cell):
    return importlib.import_module(
        f"perfbench.drivers.{cell.traffic['driver']}")


class Spans:
    """Host time by name: each ``with spans(name)`` appends its duration to
    ``spans.times[name]``; while ``spans.timeline`` is a list, each span's
    (name, start, end) in ``perf_counter_ns`` is appended to it too, so a
    profiled segment can tell its device idle gaps by what the host was
    doing."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}
        self.timeline: Optional[list] = None

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter_ns()
        yield
        t1 = time.perf_counter_ns()
        self.times.setdefault(name, []).append((t1 - t0) * 1e-9)
        if self.timeline is not None:
            self.timeline.append((name, t0, t1))


def compare(cell: Cell, numbers: Dict[str, float]) -> Dict[str, dict]:
    """Each number that ``limits/<cell>.json`` gives a limit, beside it; a
    limited number the run did not produce fails. Numbers without a limit
    are printed as readings and not compared."""
    print(f"[bench] readings: {json.dumps(numbers)}")
    out = {}
    for name, limit in cell.limits.items():
        value = numbers.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        out[name] = {"value": value, "limit": limit, "ok": ok}
    return out


def _metrics_of(section: str, cell: Cell) -> List[dict]:
    return [m for m in benchmark()[section]
            if cell.name in m.get("workloads", [cell.name])]


def _reader(name: str):
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def result_line(cell: Cell, rec: dict, setup_s: float) -> dict:
    """The result line (the run's last line on standard output) from a
    driver's record."""
    metrics = {}
    if cell.trace:
        for m in _metrics_of("per_layer", cell):
            value = _reader(m["name"])(rec, cell)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**rec["end_to_end"], "setup_s": setup_s}
        for m in _metrics_of("end_to_end", cell):
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    checks = rec["checks"]
    line = {
        "correct": bool(checks) and all(c["ok"] for c in checks.values()),
        "attempted": rec["attempted"],
        "failed": rec["failed"],
        "metrics": metrics,
        "device": dict(rec["device"]),
    }
    profile = rec.get("profile")
    if cell.trace and profile:
        line["device"]["busy_s"] = sum(p["busy_s"] for p in profile.values())
        line["device"]["window_s"] = sum(p["wall_s"] for p in profile.values())
        ops: Dict[str, float] = {}
        gaps = []
        for p in profile.values():
            for name, sec in p["ops"]:
                ops[name] = ops.get(name, 0.0) + sec
            gaps += p["gaps"]
        line["breakdown"] = {
            "device_ops": sorted(([n[:120], s] for n, s in ops.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(gaps, key=lambda x: -x[1])[:10],
        }
    line["checks"] = {name: {"value": c["value"], "limit": c["limit"]}
                      for name, c in checks.items()}
    return line


def nvidia_smi() -> str:
    """The card's name, power limit and draw, SM clock and temperature."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi unavailable ({err})"


def run_cell(cell: Cell) -> dict:
    """Run the cell's driver; its record, with ``device`` filled in."""
    import torch

    rec = driver(cell).run(cell)
    dev = torch.device(cell.device)
    if dev.type == "cuda":
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                  "count": cell.workload.get("chips", 1),
                  "memory_peak_bytes": rec["memory_peak_bytes"]}
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1,
                  "memory_peak_bytes": rec["memory_peak_bytes"]}
    rec["device"] = device
    return rec


def print_result(cell: Cell, rec: dict, setup_s: float) -> dict:
    line = result_line(cell, rec, setup_s)
    for name, c in rec["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return line


def main(argv=None, started: float = None) -> int:
    import argparse

    started = time.perf_counter() if started is None else started
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = load_cell(args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda")
    chips = cell.workload.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"[bench] {cell.name} seed {cell.seed} seconds {cell.seconds} "
          f"trace {int(cell.trace)}; card: {nvidia_smi()}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    rec = run_cell(cell)
    setup_s = rec["window_start"] - started
    print(f"[bench] card after the window: {rec.get('smi_after', '')}")
    found = forbidden_loaded()
    if found:
        print(f"perfbench: modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 3
    print_result(cell, rec, setup_s)
    return 0


def quantile(values: List[float], q: float) -> Optional[float]:
    """The ``q`` quantile (0 < q < 1) by linear interpolation, or None for
    no values."""
    if not values:
        return None
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=1000, method="inclusive")[
        round(q * 1000) - 1]
