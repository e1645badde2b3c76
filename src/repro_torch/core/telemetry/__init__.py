"""Observability subsystem: trace export, runtime metric stream, and
TALP self-overhead accounting. Copied from ``repro.core.telemetry``;
:mod:`.stepseries` defers a step's device columns where a flush of the
backend closes a device activity collection (see its docstring).

Three pillars (see the module docstrings):

  * :mod:`.traceexport` — Chrome trace-event JSON (Perfetto /
    ``chrome://tracing``) rendered vectorized from the columnar buffers.
  * :mod:`.exporter` — :class:`TelemetryExporter`: ring-buffered
    ``sample_result()`` snapshots published as JSONL + Prometheus text.
  * :mod:`.overhead` — monotonic-clock accounting of the monitor's own
    hot paths, surfaced as the optional ``talp_overhead`` report branch.

Plus the step-resolution pair built on all three:

  * :mod:`.stepseries` — per-region-close metric capture into a bounded
    columnar ring (:class:`StepSeries` / :class:`StepSeriesRecorder`).
  * :mod:`.watchdog` — online :class:`EfficiencyWatchdog` with rolling
    EWMA/CUSUM baselines, hysteresis, and hierarchy-aware attribution.

Only :mod:`.overhead` is imported eagerly: it is dependency-free and the
core measurement modules (``states``/``talp``/``merge``) time their hot
paths against it, so it must never pull the exporters (which import
those same core modules) back in. Everything else loads lazily on first
attribute access.
"""

from __future__ import annotations

import importlib

from .overhead import OverheadAccumulator, current, install, section  # noqa: F401
from . import overhead  # noqa: F401

__all__ = [
    "OverheadAccumulator",
    "current",
    "install",
    "section",
    "overhead",
    "traceexport",
    "exporter",
    "stepseries",
    "watchdog",
    "TelemetryExporter",
    "TelemetrySnapshot",
    "StepSeries",
    "StepSeriesRecorder",
    "EfficiencyWatchdog",
    "AnomalyEvent",
    "validate_anomaly_events",
    "synthetic_drift_scenario",
    "export_trace",
    "export_trace_reference",
    "export_result",
    "export_monitor",
    "export_job",
    "validate_chrome_trace",
]

_LAZY = {
    "traceexport": (".traceexport", None),
    "exporter": (".exporter", None),
    "stepseries": (".stepseries", None),
    "watchdog": (".watchdog", None),
    "TelemetryExporter": (".exporter", "TelemetryExporter"),
    "TelemetrySnapshot": (".exporter", "TelemetrySnapshot"),
    "StepSeries": (".stepseries", "StepSeries"),
    "StepSeriesRecorder": (".stepseries", "StepSeriesRecorder"),
    "EfficiencyWatchdog": (".watchdog", "EfficiencyWatchdog"),
    "AnomalyEvent": (".watchdog", "AnomalyEvent"),
    "validate_anomaly_events": (".watchdog", "validate_anomaly_events"),
    "synthetic_drift_scenario": (".watchdog", "synthetic_drift_scenario"),
    "export_trace": (".traceexport", "export_trace"),
    "export_trace_reference": (".traceexport", "export_trace_reference"),
    "export_result": (".traceexport", "export_result"),
    "export_monitor": (".traceexport", "export_monitor"),
    "export_job": (".traceexport", "export_job"),
    "validate_chrome_trace": (".traceexport", "validate_chrome_trace"),
}


def __getattr__(name: str):
    try:
        modname, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    mod = importlib.import_module(modname, __name__)
    return mod if attr is None else getattr(mod, attr)
