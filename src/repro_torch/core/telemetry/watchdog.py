"""Online efficiency watchdog: rolling baselines, drift detection, and
hierarchy-aware anomaly attribution.

Job-specific monitoring systems (MPCDF's HPC monitor, arXiv:1909.11704)
turn raw telemetry into *automatic* reports because nobody stares at
dashboards for every job. This module does the same for the TALP metric
hierarchy at step resolution: an :class:`EfficiencyWatchdog` receives
the per-step metric rows produced by
:class:`~.stepseries.StepSeriesRecorder` and runs two detectors per
watched (region, metric):

  * an **EWMA baseline** (exponential mean + variance) with a z-score
    threshold — catches step-level spikes;
  * a two-sided **CUSUM** over the normalized residual — catches slow
    drifts that never individually exceed the z threshold.

Hysteresis suppresses flapping: once a detector fires, the baseline is
*frozen* and no further events are emitted for that (region, metric)
until the metric returns within ``z_clear`` for ``clear_after``
consecutive steps — a persistent regime shift therefore produces exactly
one event, not one per step.

Every event carries an **attribution path** computed from the
parent≡Π(children) structure of the hierarchy: the multiplicative
children of the degraded metric are ranked by how much they moved in log
space (``Δlog = log observed − log baseline``, the additive share of the
parent's relative change), and the path descends through the largest
mover at each level — so "parallel_efficiency dropped" arrives annotated
with "because load_balance dropped".

Events are structured dicts (see :func:`validate_anomaly_events` for the
schema) streamed to an optional JSONL sink, published by the
:class:`~.exporter.TelemetryExporter`, and rendered as instant markers
in the Chrome trace. :func:`synthetic_drift_scenario` (also the module
CLI) builds a deterministic two-device run with an injected mid-run load
imbalance — the end-to-end smoke test CI runs.
"""

from __future__ import annotations

import io
import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..hierarchy import Hierarchy, MetricSpec
from .stepseries import DEFAULT_HIERARCHIES

__all__ = [
    "AnomalyEvent",
    "EfficiencyWatchdog",
    "validate_anomaly_events",
    "load_anomaly_jsonl",
    "synthetic_drift_scenario",
    "DEFAULT_WATCHED",
]

#: Metric columns watched when none are given: the two hierarchy roots
#: and the classic drift suspects underneath them.
DEFAULT_WATCHED: Tuple[str, ...] = (
    "host_parallel_efficiency",
    "host_device_offload_efficiency",
    "host_load_balance",
    "device_parallel_efficiency",
    "device_load_balance",
    "device_orchestration_efficiency",
)

_EVENT_KIND = "anomaly"
_DETECTORS = ("ewma", "cusum")
_DIRECTIONS = ("drop", "rise")


@dataclass
class _Baseline:
    """EWMA mean/variance of one (region, metric column)."""

    alpha: float
    mean: float = 0.0
    var: float = 0.0
    n: int = 0

    def update(self, x: float) -> None:
        if self.n == 0:
            self.mean = x
            self.var = 0.0
        else:
            d = x - self.mean
            self.mean += self.alpha * d
            # EW variance of the residual around the moving mean.
            self.var = (1.0 - self.alpha) * (self.var + self.alpha * d * d)
        self.n += 1

    def std(self, floor: float) -> float:
        return max(math.sqrt(max(self.var, 0.0)), floor)


@dataclass
class _Detector:
    """Per-(region, metric) detector state: CUSUM sums + hysteresis."""

    hi: float = 0.0
    lo: float = 0.0
    firing: bool = False
    clear_count: int = 0


@dataclass(frozen=True)
class AnomalyEvent:
    """One detected anomaly (``as_dict()`` is the JSONL record)."""

    step: int
    region: str
    hierarchy: str
    metric: str
    t: float
    observed: float
    baseline_mean: float
    baseline_std: float
    z: float
    cusum: float
    detector: str       # "ewma" | "cusum"
    direction: str      # "drop" | "rise"
    attribution: Tuple[Dict[str, float], ...] = ()

    @property
    def column(self) -> str:
        return f"{self.hierarchy}_{self.metric}"

    def as_dict(self) -> Dict[str, object]:
        return {
            "kind": _EVENT_KIND,
            "step": self.step,
            "region": self.region,
            "hierarchy": self.hierarchy,
            "metric": self.metric,
            "t": self.t,
            "observed": self.observed,
            "baseline_mean": self.baseline_mean,
            "baseline_std": self.baseline_std,
            "z": self.z,
            "cusum": self.cusum,
            "detector": self.detector,
            "direction": self.direction,
            "attribution": [dict(a) for a in self.attribution],
        }


class EfficiencyWatchdog:
    """Online anomaly detector over step-resolution hierarchy metrics.

    ``metrics`` selects the watched metric columns
    (``{hierarchy}_{key}`` names as produced by the step series); every
    *observed* column still gets a baseline so attribution can compare
    children against their own history. Tuning knobs:

      * ``alpha`` — EWMA weight of the newest sample;
      * ``z_fire`` / ``z_clear`` / ``clear_after`` — fire threshold and
        hysteresis clearing band (in sigmas / steps);
      * ``cusum_k`` / ``cusum_h`` — CUSUM slack and decision threshold
        (in sigmas);
      * ``min_sigma`` — variance floor, so a near-constant metric does
        not fire on numerical dust;
      * ``min_samples`` — warmup before any detection.

    ``jsonl`` (path or file-like) streams each event as one JSON line at
    emission time — crash-safe anomaly logging for the drivers'
    ``--talp-anomaly-log``.
    """

    def __init__(
        self,
        metrics: Sequence[str] = DEFAULT_WATCHED,
        hierarchies: Sequence[Hierarchy] = DEFAULT_HIERARCHIES,
        alpha: float = 0.2,
        z_fire: float = 6.0,
        z_clear: float = 2.0,
        clear_after: int = 3,
        cusum_k: float = 0.5,
        cusum_h: float = 10.0,
        min_sigma: float = 5e-3,
        min_samples: int = 8,
        jsonl=None,
    ):
        self.watched = tuple(metrics)
        self.hierarchies = tuple(hierarchies)
        self.alpha = float(alpha)
        self.z_fire = float(z_fire)
        self.z_clear = float(z_clear)
        self.clear_after = int(clear_after)
        self.cusum_k = float(cusum_k)
        self.cusum_h = float(cusum_h)
        self.min_sigma = float(min_sigma)
        self.min_samples = int(min_samples)
        self.events: List[AnomalyEvent] = []
        self._baselines: Dict[Tuple[str, str], _Baseline] = {}
        self._detectors: Dict[Tuple[str, str], _Detector] = {}
        # column -> (hierarchy, spec) for attribution walks.
        self._specs: Dict[str, Tuple[Hierarchy, MetricSpec]] = {}
        for h in self.hierarchies:
            for spec in h.walk():
                self._specs[f"{h.name}_{spec.key}"] = (h, spec)
        self._jsonl_path: Optional[str] = None
        self._jsonl = None
        if jsonl is not None:
            if isinstance(jsonl, (str, bytes)):
                self._jsonl_path = str(jsonl)
            else:
                self._jsonl = jsonl

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        if self._jsonl is not None and self._jsonl_path is not None:
            self._jsonl.close()
            self._jsonl = None

    def _emit(self, ev: AnomalyEvent) -> None:
        self.events.append(ev)
        sink = self._jsonl
        if sink is None and self._jsonl_path is not None:
            sink = self._jsonl = io.open(self._jsonl_path, "w", encoding="utf-8")
        if sink is not None:
            sink.write(json.dumps(ev.as_dict()) + "\n")
            sink.flush()

    # -- observation -------------------------------------------------------
    def observe(
        self,
        region: str,
        step: int,
        t: float,
        values: Dict[str, float],
    ) -> List[AnomalyEvent]:
        """Feed one step row (metric column -> value); returns the events
        emitted for this row. NaN values are skipped (metric absent this
        step)."""
        out: List[AnomalyEvent] = []
        # Detection first, against baselines as of the *previous* steps;
        # then fold the row into the non-firing baselines.
        for col in self.watched:
            v = values.get(col)
            if v is None or math.isnan(v):
                continue
            ev = self._detect(region, step, t, col, float(v), values)
            if ev is not None:
                out.append(ev)
        for col, v in values.items():
            if v is None or math.isnan(v):
                continue
            key = (region, col)
            det = self._detectors.get(key)
            if det is not None and det.firing:
                continue  # baseline frozen while firing
            b = self._baselines.get(key)
            if b is None:
                b = self._baselines[key] = _Baseline(alpha=self.alpha)
            b.update(float(v))
        return out

    def _detect(
        self,
        region: str,
        step: int,
        t: float,
        col: str,
        x: float,
        row: Dict[str, float],
    ) -> Optional[AnomalyEvent]:
        key = (region, col)
        b = self._baselines.get(key)
        if b is None or b.n < self.min_samples:
            return None  # warmup
        det = self._detectors.get(key)
        if det is None:
            det = self._detectors[key] = _Detector()
        sigma = b.std(self.min_sigma)
        z = (x - b.mean) / sigma
        det.hi = max(0.0, det.hi + z - self.cusum_k)
        det.lo = max(0.0, det.lo - z - self.cusum_k)
        cusum = max(det.hi, det.lo)
        if det.firing:
            if abs(z) <= self.z_clear:
                det.clear_count += 1
                if det.clear_count >= self.clear_after:
                    det.firing = False
                    det.clear_count = 0
                    det.hi = det.lo = 0.0
            else:
                det.clear_count = 0
            return None
        ewma_fired = abs(z) >= self.z_fire
        cusum_fired = cusum >= self.cusum_h
        if not (ewma_fired or cusum_fired):
            return None
        det.firing = True
        det.clear_count = 0
        h, spec = self._specs.get(col, (None, None))
        ev = AnomalyEvent(
            step=step,
            region=region,
            hierarchy=h.name if h is not None else col.split("_", 1)[0],
            metric=spec.key if spec is not None else col.split("_", 1)[-1],
            t=t,
            observed=x,
            baseline_mean=b.mean,
            baseline_std=sigma,
            z=z,
            cusum=cusum,
            detector="ewma" if ewma_fired else "cusum",
            direction="drop" if z < 0 else "rise",
            attribution=tuple(self._attribute(region, col, row)),
        )
        self._emit(ev)
        return ev

    # -- attribution -------------------------------------------------------
    def _attribute(
        self, region: str, col: str, row: Dict[str, float]
    ) -> List[Dict[str, float]]:
        """Descend the multiplicative children of ``col``, one level per
        entry, following the largest |Δlog| mover — the additive share of
        the parent's relative change under parent = Π(children)."""
        path: List[Dict[str, float]] = []
        entry = self._specs.get(col)
        if entry is None:
            return path
        h, spec = entry
        tiny = 1e-12
        while True:
            movers: List[Tuple[float, Dict[str, float]]] = []
            for child in spec.children:
                if not child.multiplicative:
                    continue
                ccol = f"{h.name}_{child.key}"
                v = row.get(ccol)
                if v is None or math.isnan(v):
                    continue
                b = self._baselines.get((region, ccol))
                if b is None or b.n == 0:
                    continue
                dlog = math.log(max(float(v), tiny)) - math.log(
                    max(b.mean, tiny)
                )
                movers.append(
                    (
                        abs(dlog),
                        {
                            "metric": ccol,
                            "observed": float(v),
                            "baseline": b.mean,
                            "dlog": dlog,
                        },
                    )
                )
            if not movers:
                return path
            movers.sort(key=lambda m: m[0], reverse=True)
            top = movers[0]
            path.append(top[1])
            spec = next(
                c
                for c in spec.children
                if f"{h.name}_{c.key}" == top[1]["metric"]
            )

    # -- published state ---------------------------------------------------
    def firing(self) -> List[Dict[str, object]]:
        """Currently-firing (region, metric) pairs — the exporter's live
        watchdog state."""
        out: List[Dict[str, object]] = []
        for (region, col), det in sorted(self._detectors.items()):
            if det.firing:
                out.append({"region": region, "metric": col})
        return out

    def summary(self) -> Dict[str, object]:
        return {
            "watched": list(self.watched),
            "n_events": len(self.events),
            "firing": self.firing(),
        }


# ---------------------------------------------------------------------------
# the shared anomaly-event schema checker
# ---------------------------------------------------------------------------
_REQUIRED_NUMERIC = (
    "t", "observed", "baseline_mean", "baseline_std", "z", "cusum",
)


def validate_anomaly_events(events: Sequence[Dict[str, object]]) -> int:
    """Structural check of anomaly-event dicts (the JSONL schema used by
    tests, CI, and any downstream consumer). Raises ``ValueError`` on the
    first malformed event; returns the number of validated events."""

    def fail(i: int, msg: str):
        raise ValueError(f"anomaly event {i}: {msg}")

    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            fail(i, f"not a dict: {type(ev).__name__}")
        if ev.get("kind") != _EVENT_KIND:
            fail(i, f"kind must be {_EVENT_KIND!r}, got {ev.get('kind')!r}")
        if not isinstance(ev.get("step"), int) or isinstance(ev.get("step"), bool):
            fail(i, f"step must be an int, got {ev.get('step')!r}")
        for k in ("region", "hierarchy", "metric"):
            v = ev.get(k)
            if not isinstance(v, str) or not v:
                fail(i, f"{k} must be a non-empty string, got {v!r}")
        for k in _REQUIRED_NUMERIC:
            v = ev.get(k)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                fail(i, f"{k} must be a number, got {v!r}")
            if not math.isfinite(float(v)):
                fail(i, f"{k} must be finite, got {v!r}")
        if float(ev["baseline_std"]) < 0 or float(ev["cusum"]) < 0:
            fail(i, "baseline_std and cusum must be >= 0")
        if ev.get("detector") not in _DETECTORS:
            fail(i, f"detector must be one of {_DETECTORS}, got {ev.get('detector')!r}")
        if ev.get("direction") not in _DIRECTIONS:
            fail(i, f"direction must be one of {_DIRECTIONS}, got {ev.get('direction')!r}")
        attr = ev.get("attribution")
        if not isinstance(attr, list):
            fail(i, f"attribution must be a list, got {type(attr).__name__}")
        for j, a in enumerate(attr):
            if not isinstance(a, dict):
                fail(i, f"attribution[{j}] not a dict")
            if not isinstance(a.get("metric"), str) or not a.get("metric"):
                fail(i, f"attribution[{j}].metric must be a non-empty string")
            for k in ("observed", "baseline", "dlog"):
                v = a.get(k)
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    fail(i, f"attribution[{j}].{k} must be a number, got {v!r}")
    return len(events)


def load_anomaly_jsonl(path: str) -> List[Dict[str, object]]:
    """Read an anomaly JSONL file back into event dicts."""
    out: List[Dict[str, object]] = []
    with io.open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# ---------------------------------------------------------------------------
# deterministic end-to-end scenario (tests + CI smoke)
# ---------------------------------------------------------------------------
class _DemoClock:
    """Deterministic monotonically advancing clock for the scenario."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def synthetic_drift_scenario(
    steps: int = 60,
    inject: bool = True,
    seed: int = 0,
    capacity: Optional[int] = None,
    anomaly_log=None,
    region: str = "step",
):
    """Two-device synthetic run with an optional load-imbalance injection
    at the midpoint: device 1's kernels shrink to ~40% of device 0's, so
    the device ``load_balance`` (and with it ``parallel_efficiency``)
    drops sharply while ``orchestration_efficiency`` stays put — the
    watchdog should fire on the device metrics with an attribution path
    ending at ``device_load_balance``, and stay silent when
    ``inject=False``.

    Returns a dict with ``monitor``, ``recorder`` (its ``.series`` is the
    step series), ``watchdog``, ``result`` (finalized TalpResult) and
    ``inject_step`` (the first degraded step index, or None).
    """
    from ..states import DeviceActivity
    from ..talp import TalpMonitor
    from .stepseries import StepSeriesRecorder

    rng = np.random.default_rng(seed)
    clk = _DemoClock()
    mon = TalpMonitor(
        "drift-demo", clock=clk.now, auto_start=True, overhead_report=True
    )
    wd = EfficiencyWatchdog(
        metrics=(
            "device_parallel_efficiency",
            "device_load_balance",
            "device_orchestration_efficiency",
            "host_parallel_efficiency",
            "host_device_offload_efficiency",
        ),
        jsonl=anomaly_log,
    )
    rec = StepSeriesRecorder(
        mon, capacity=capacity or max(steps + 8, 16), watchdog=wd
    )
    inject_step = steps // 2 if inject else None
    base = 0.008  # nominal per-step kernel busy seconds
    for i in range(steps):
        with mon.region(region):
            t0 = clk.now()
            k0 = base * (1.0 + 0.005 * float(rng.standard_normal()))
            k1 = base * (1.0 + 0.005 * float(rng.standard_normal()))
            if inject_step is not None and i >= inject_step:
                k1 *= 0.4  # device 1 starves: load imbalance appears
            mon.add_device_record(0, DeviceActivity.KERNEL, t0, t0 + k0)
            mon.add_device_record(1, DeviceActivity.KERNEL, t0, t0 + k1)
            with mon.offload():
                clk.advance(max(k0, k1))  # host blocked on the sync
            clk.advance(0.001)  # useful host tail
    result = mon.finalize()
    return {
        "monitor": mon,
        "recorder": rec,
        "watchdog": wd,
        "result": result,
        "inject_step": inject_step,
    }


# ---------------------------------------------------------------------------
# CLI: run the scenario / validate an anomaly log
# ---------------------------------------------------------------------------
def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.core.telemetry.watchdog",
        description=(
            "Run the synthetic drift scenario through the step-series "
            "recorder + efficiency watchdog, or validate an anomaly JSONL."
        ),
    )
    p.add_argument("--steps", type=int, default=60, help="scenario steps")
    p.add_argument(
        "--steady", action="store_true",
        help="no injection (expect zero anomalies)",
    )
    p.add_argument("--seed", type=int, default=0, help="noise seed")
    p.add_argument(
        "--anomaly-log", default=None, metavar="PATH",
        help="stream anomaly events to this JSONL file",
    )
    p.add_argument(
        "--trace-out", default=None, metavar="PATH",
        help="write a per-step Chrome trace (with anomaly markers)",
    )
    p.add_argument(
        "--step-table", action="store_true",
        help="print the per-step metric table",
    )
    p.add_argument(
        "--expect-anomaly", action="store_true",
        help="exit 1 unless >= 1 anomaly was detected",
    )
    p.add_argument(
        "--expect-clean", action="store_true",
        help="exit 1 if any anomaly was detected",
    )
    p.add_argument(
        "--validate", default=None, metavar="PATH",
        help="validate an anomaly JSONL file and exit",
    )
    args = p.parse_args(argv)

    if args.validate is not None:
        try:
            n = validate_anomaly_events(load_anomaly_jsonl(args.validate))
        except (ValueError, OSError, json.JSONDecodeError) as e:
            print(f"INVALID: {e}")
            return 1
        print(f"OK: {n} anomaly events valid")
        return 0

    sc = synthetic_drift_scenario(
        steps=args.steps,
        inject=not args.steady,
        seed=args.seed,
        anomaly_log=args.anomaly_log,
    )
    wd: EfficiencyWatchdog = sc["watchdog"]
    wd.close()
    validate_anomaly_events([e.as_dict() for e in wd.events])
    if args.step_table:
        print(sc["recorder"].series.as_table())
    for ev in wd.events:
        attr = " -> ".join(a["metric"] for a in ev.attribution)
        print(
            f"anomaly step={ev.step} region={ev.region} "
            f"metric={ev.hierarchy}:{ev.metric} {ev.direction} "
            f"z={ev.z:+.1f} observed={ev.observed:.4f} "
            f"baseline={ev.baseline_mean:.4f}"
            + (f" attribution: {attr}" if attr else "")
        )
    print(
        f"{len(wd.events)} anomaly events over {args.steps} steps "
        f"(inject={'no' if args.steady else 'yes'})"
    )
    if args.trace_out:
        from .traceexport import export_monitor

        trace = export_monitor(
            sc["monitor"],
            result=sc["result"],
            step_series=sc["recorder"].series,
            anomalies=wd.events,
        )
        with io.open(args.trace_out, "w", encoding="utf-8") as fh:
            fh.write(trace)
        print(f"trace written to {args.trace_out}")
    if args.expect_anomaly and not wd.events:
        print("FAIL: expected >= 1 anomaly, got none")
        return 1
    if args.expect_clean and wd.events:
        print(f"FAIL: expected zero anomalies, got {len(wd.events)}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
