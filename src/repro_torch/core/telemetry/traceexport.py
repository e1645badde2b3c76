"""Chrome trace-event export — the machine-readable execution trace.

The paper leans on execution traces as "a visual confirmation that the
reported metrics are consistent with the observed behavior"; the ASCII
:mod:`repro.core.traceview` gives the in-terminal check, this module
emits the same timeline in the `Chrome trace event format
<https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU>`_
so any run opens directly in Perfetto (`ui.perfetto.dev`) or
``chrome://tracing``:

  * one lane per host **rank** (pid 1): Useful / Offload / MPI slices
    (synthesized proportionally from the state durations, in recorded
    order — the same convention as ``traceview``),
  * one lane per **device** (pid 2): flattened Kernel / Memory slices —
    exact, straight from the columnar interval arrays,
  * one **regions** lane (pid 3): ``B``/``E`` begin/end markers per
    monitored region,
  * **counter tracks** (pid 4): the hierarchy metrics (PE, LB, CE,
    OE, …) over time, names derived generically from the
    :class:`~repro.core.hierarchy.Hierarchy` specs. When a
    step-resolution :class:`~.stepseries.StepSeries` is attached the
    counters are *per region close* (one point per step, at the window's
    close timestamp) instead of the exporter's polling cadence — a
    one-step spike stays visible,
  * **anomaly markers** (pid 5): instant events (``"ph":"i"``) from the
    :class:`~.watchdog.EfficiencyWatchdog`, one per emitted anomaly,
    carrying the observed/baseline/z payload and the attribution path in
    ``args``.

The slice generator is **vectorized**: interval arrays (the
``ColumnStore``/``flatten()`` output) become JSON event lines through
whole-array NumPy string formatting — no per-record Python loop, no
per-event dict. Two number policies, chosen per field:

  * ``ts`` is quantized to integer **nanoseconds** and emitted as
    ``<ns>e-3`` µs (the resolution Perfetto itself stores); integer
    formatting is a cheap C loop, and ``rint`` is monotone so lane
    ordering survives quantization.
  * ``dur`` is **exact**: NumPy's shortest round-trip float repr
    (C-level dragon4, ``astype("U32")``) survives a JSON round trip
    bit-for-bit, so the exported durations *are* the flattened interval
    durations the metrics were computed from (export is a view, not a
    recomputation — per-lane duration sums match ``StateDurations``).

:func:`export_trace_reference` retains the naive one-dict-per-event
exporter as the correctness oracle and benchmark baseline
(``benchmarks/merge_bench.py`` gates the vectorized path ≥5× against
it); :func:`validate_chrome_trace` is the structural validator the test
suite and CI share. CLI: ``python -m repro_torch.core.telemetry.traceexport
--validate trace.json``.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .. import intervals as ivx
from ..hierarchy import MetricFrame
from ..states import DeviceActivity, DeviceTimeline, Trace
from ..talp import RegionResult, TalpMonitor, TalpResult
from . import overhead as _ovh

__all__ = [
    "PID_HOST",
    "PID_DEVICE",
    "PID_REGIONS",
    "PID_COUNTERS",
    "PID_ANOMALIES",
    "slice_lines",
    "slice_events_loop",
    "quantize_ts_us",
    "export_trace",
    "export_trace_reference",
    "export_result",
    "export_monitor",
    "export_job",
    "validate_chrome_trace",
    "main",
]

#: Lane group ids (Chrome "processes"); one tid per rank/device inside.
PID_HOST = 1
PID_DEVICE = 2
PID_REGIONS = 3
PID_COUNTERS = 4
PID_ANOMALIES = 5

_US = 1e6  # trace-event timestamps are microseconds

#: host-state slice order + names (recorded order, like traceview)
_HOST_SLICES = (("useful", "Useful"), ("offload", "Offload"), ("mpi", "MPI"))


def _fmt_f64(a: np.ndarray) -> np.ndarray:
    """Whole-array exact float formatting: NumPy's C-level dragon4 emits
    the shortest repr that round-trips float64 exactly through JSON, so
    parsed values equal the source values bit-for-bit."""
    return np.asarray(a, dtype=np.float64).astype("U32")


def _fmt_ts_ns(ts_us: np.ndarray) -> np.ndarray:
    """Whole-array timestamp formatting: integer-nanosecond mantissas
    (``"ts":<ns>`` + the constant ``e-3`` suffix appended by the caller
    = µs). Integer→string is ~3× cheaper than exact float formatting,
    and ``rint`` is monotone, so quantization never reorders a lane."""
    ns = np.rint(np.asarray(ts_us, dtype=np.float64) * 1e3)
    return ns.astype(np.int64).astype("U20")


def quantize_ts_us(ts_us):
    """The parsed value of an emitted timestamp: ``<ns>e-3`` parses to
    exactly ``rint(ts*1e3)/1e3`` (both are the correctly rounded double
    of the same exact decimal). Exposed so the reference exporter and
    the tests model emission with the same arithmetic."""
    return np.rint(np.asarray(ts_us, dtype=np.float64) * 1e3) / 1e3


def _slice_line_array(
    name: str, cat: str, pid: int, tid: int, iv, t0: float = 0.0
) -> np.ndarray:
    """One complete-event (``"ph":"X"``) JSON line per interval as a
    fixed-width string array, generated vectorized from the (N, 2)
    interval array — no per-event Python work at all."""
    iv = np.asarray(iv, dtype=np.float64).reshape(-1, 2)
    if len(iv) == 0:
        return np.empty(0, dtype="U1")
    ts = (iv[:, 0] - t0) * _US
    dur = (iv[:, 1] - iv[:, 0]) * _US
    head = (
        f'{{"name":{json.dumps(name)},"cat":{json.dumps(cat)},"ph":"X",'
        f'"pid":{int(pid)},"tid":{int(tid)},"ts":'
    )
    lines = np.char.add(head, _fmt_ts_ns(ts))
    lines = np.char.add(lines, 'e-3,"dur":')
    lines = np.char.add(lines, _fmt_f64(dur))
    lines = np.char.add(lines, "}")
    return lines


def slice_lines(
    name: str, cat: str, pid: int, tid: int, iv, t0: float = 0.0
) -> List[str]:
    """List-of-lines view of :func:`_slice_line_array` (the only
    per-event Python object creation is the final ``tolist()``)."""
    return _slice_line_array(name, cat, pid, tid, iv, t0).tolist()


def _device_lane_order(kern, mem) -> np.ndarray:
    """Stable time order over the concatenated kernel+memory slices of
    one device lane (kernel wins start-time ties) — Chrome lanes expect
    monotonically ordered events."""
    starts = np.concatenate([
        np.asarray(kern, dtype=np.float64).reshape(-1, 2)[:, 0],
        np.asarray(mem, dtype=np.float64).reshape(-1, 2)[:, 0],
    ])
    return np.argsort(starts, kind="stable")


def _device_lane_lines(
    dev: int, kern, mem, t0: float
) -> List[str]:
    """Kernel + Memory slices of one device lane, time-ordered. The
    merge happens on the raw (N, 2) float intervals *before* formatting
    (an 8-byte gather, not a full-line string gather), then a single
    format pass emits both kinds — the kind-dependent name/cat moves to
    a per-element tail selected with ``np.where``."""
    kern = np.asarray(kern, dtype=np.float64).reshape(-1, 2)
    mem = np.asarray(mem, dtype=np.float64).reshape(-1, 2)
    n_k, n_m = len(kern), len(mem)
    if n_k + n_m == 0:
        return []
    order = _device_lane_order(kern, mem)
    iv = np.concatenate([kern, mem])[order]
    is_kern = (np.arange(n_k + n_m) < n_k)[order]
    ts = (iv[:, 0] - t0) * _US
    dur = (iv[:, 1] - iv[:, 0]) * _US
    head = f'{{"ph":"X","pid":{PID_DEVICE},"tid":{int(dev)},"ts":'
    tails = np.where(
        is_kern,
        ',"name":"Kernel","cat":"device"}',
        ',"name":"Memory","cat":"device"}',
    )
    lines = np.char.add(head, _fmt_ts_ns(ts))
    lines = np.char.add(lines, 'e-3,"dur":')
    lines = np.char.add(lines, _fmt_f64(dur))
    lines = np.char.add(lines, tails)
    return lines.tolist()


def slice_events_loop(
    name: str, cat: str, pid: int, tid: int, iv, t0: float = 0.0
) -> List[Dict]:
    """Retained per-event reference: one Python dict per slice (the shape
    every naive exporter has). Kept as the oracle + benchmark baseline
    for :func:`slice_lines`; not used on any production path."""
    out = []
    for s, e in np.asarray(iv, dtype=np.float64).reshape(-1, 2):
        ts = (float(s) - t0) * _US
        out.append(
            {
                "name": name, "cat": cat, "ph": "X",
                "pid": int(pid), "tid": int(tid),
                "ts": float(quantize_ts_us(ts)),
                "dur": (float(e) - float(s)) * _US,
            }
        )
    return out


# ---------------------------------------------------------------------------
# lane construction helpers
# ---------------------------------------------------------------------------
def _host_state_intervals(
    states: Dict[str, float], t0: float
) -> List[Tuple[str, np.ndarray]]:
    """Proportional (name, 1-interval array) slices for one rank, in
    recorded order starting at ``t0`` — durations only, like traceview."""
    out = []
    cursor = t0
    for key, display in _HOST_SLICES:
        dur = float(states.get(key, 0.0))
        if dur > 0:
            out.append((display, np.array([[cursor, cursor + dur]])))
            cursor += dur
    return out


def _device_lane_intervals(
    tl: DeviceTimeline, window: Optional[Tuple[float, float]] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """(kernel, memory-minus-kernel) flattened arrays for one device —
    exactly the arrays the metrics pipeline computes from."""
    kern = tl.kind_intervals(DeviceActivity.KERNEL)
    mem = ivx.subtract(tl.kind_intervals(DeviceActivity.MEMORY), kern)
    if window is not None:
        kern = ivx.clip(kern, *window)
        mem = ivx.clip(mem, *window)
    return kern, mem


def _synthetic_device_intervals(
    states: Dict[str, float], t0: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Proportional device slices from reduced state durations (fallback
    when no raw timeline is attached): kernel first, then memory."""
    k = float(states.get("kernel", 0.0))
    m = float(states.get("memory", 0.0))
    kern = np.array([[t0, t0 + k]]) if k > 0 else ivx.EMPTY
    mem = np.array([[t0 + k, t0 + k + m]]) if m > 0 else ivx.EMPTY
    return kern, mem


def _meta_line(name: str, pid: int, value: str, tid: int = 0) -> str:
    ev = {"name": name, "ph": "M", "pid": pid, "tid": tid,
          "args": {"name": value}}
    return json.dumps(ev, separators=(",", ":"))


def _region_marker_lines(
    region_windows: Dict[str, np.ndarray], t0: float,
    pid: int = PID_REGIONS, tid: int = 0,
) -> List[str]:
    """Paired ``B``/``E`` begin/end markers, ordered so nesting is valid:
    at equal timestamps ends precede begins, longer regions open first
    and inner regions close first."""
    evs: List[Tuple[float, int, float, str, str]] = []
    for name, iv in region_windows.items():
        for s, e in np.asarray(iv, dtype=np.float64).reshape(-1, 2):
            dur = float(e - s)
            evs.append((float(quantize_ts_us((s - t0) * _US)), 1, -dur, name, "B"))
            evs.append((float(quantize_ts_us((e - t0) * _US)), 0, dur, name, "E"))
    evs.sort(key=lambda t: (t[0], t[1], t[2]))
    return [
        json.dumps(
            {"name": name, "cat": "region", "ph": ph, "pid": pid,
             "tid": tid, "ts": ts},
            separators=(",", ":"),
        )
        for ts, _, _, name, ph in evs
    ]


def _result_frames(rr: RegionResult) -> List[MetricFrame]:
    """Metric frames of one region result, façade or raw frame alike —
    every downstream naming walks ``frame.hierarchy``, so metrics
    registered with ``with_child`` flow through automatically."""
    frames = []
    for obj in (rr.host, rr.device):
        if obj is None:
            continue
        frames.append(obj if isinstance(obj, MetricFrame) else obj.frame())
    return frames


def _counter_lines(
    samples: Sequence[Tuple[float, TalpResult]], t0: float,
    pid: int = PID_COUNTERS,
) -> List[str]:
    """One multi-series counter event per (sample, region, hierarchy) —
    series names are the hierarchy spec keys."""
    lines = []
    for t, res in samples:
        ts = float(quantize_ts_us((float(t) - t0) * _US))
        for rname in sorted(res.regions):
            rr = res.regions[rname]
            for frame in _result_frames(rr):
                args = {
                    spec.key: frame.values[spec.key]
                    for spec in frame.hierarchy.walk()
                    if spec.key in frame.values
                }
                if not args:
                    continue
                lines.append(
                    json.dumps(
                        {
                            "name": f"talp:{frame.hierarchy.name}:{rname}",
                            "ph": "C", "pid": pid, "tid": 0, "ts": ts,
                            "args": args,
                        },
                        separators=(",", ":"),
                    )
                )
    return lines


def _step_counter_lines(
    step_series, t0: float, pid: int = PID_COUNTERS
) -> List[str]:
    """One multi-series counter event per (step row, hierarchy), at the
    window's *close* timestamp — step-resolution counter tracks. Series
    are grouped by the column's hierarchy prefix so the counter names
    match the cadence-sampled ones (``talp:{hierarchy}:{region}``)."""
    lines: List[str] = []
    # hierarchy name -> its metric columns, preserving column order.
    groups: Dict[str, List[Tuple[str, str]]] = {}
    for col in step_series.metric_columns:
        hname, _, key = col.partition("_")
        groups.setdefault(hname, []).append((col, key))
    for row in step_series.rows():
        ts = float(quantize_ts_us((float(row["t_close"]) - t0) * _US))
        rname = step_series.region_name(row["region"])
        for hname, cols in groups.items():
            args = {
                key: float(row[col])
                for col, key in cols
                if not np.isnan(row[col])
            }
            if not args:
                continue
            lines.append(
                json.dumps(
                    {
                        "name": f"talp:{hname}:{rname}",
                        "ph": "C", "pid": pid, "tid": 0, "ts": ts,
                        "args": args,
                    },
                    separators=(",", ":"),
                )
            )
    return lines


def _anomaly_lines(
    anomalies, t0: float, pid: int = PID_ANOMALIES
) -> List[str]:
    """Instant events (``"ph":"i"``, process-scoped) — one marker per
    watchdog anomaly, so degradations are visually pinned on the trace
    timeline. Accepts :class:`~.watchdog.AnomalyEvent` objects or their
    ``as_dict()`` payloads."""
    lines: List[str] = []
    for ev in anomalies:
        d = ev.as_dict() if hasattr(ev, "as_dict") else dict(ev)
        ts = float(quantize_ts_us((float(d["t"]) - t0) * _US))
        lines.append(
            json.dumps(
                {
                    "name": f"talp:anomaly:{d['hierarchy']}:{d['metric']}",
                    "cat": "anomaly", "ph": "i", "s": "p",
                    "pid": pid, "tid": 0, "ts": ts,
                    "args": {
                        "region": d["region"],
                        "step": d["step"],
                        "observed": d["observed"],
                        "baseline_mean": d["baseline_mean"],
                        "z": d["z"],
                        "direction": d["direction"],
                        "attribution": " -> ".join(
                            a["metric"] for a in d.get("attribution", ())
                        ),
                    },
                },
                separators=(",", ":"),
            )
        )
    return lines


def _assemble(
    lines: List[str], name: str, other: Optional[Dict] = None
) -> str:
    meta: Dict[str, object] = {"generator": "repro-talp", "trace": name}
    if other:
        meta.update(other)
    return (
        '{"traceEvents":[' + ",".join(lines) + '],"displayTimeUnit":"ms",'
        '"otherData":' + json.dumps(meta, separators=(",", ":")) + "}"
    )


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------
def _build(
    name: str,
    t0: float,
    host_states: Dict[int, Dict[str, float]],
    device_lanes: Dict[int, Tuple[np.ndarray, np.ndarray]],
    region_windows: Dict[str, np.ndarray],
    samples: Optional[Sequence[Tuple[float, TalpResult]]] = None,
    step_series=None,
    anomalies=None,
    other: Optional[Dict] = None,
) -> str:
    lines: List[str] = [
        _meta_line("process_name", PID_HOST, "host ranks"),
        _meta_line("process_name", PID_DEVICE, "devices"),
    ]
    if region_windows:
        lines.append(_meta_line("process_name", PID_REGIONS, "talp regions"))
    if samples or (step_series is not None and len(step_series)):
        lines.append(_meta_line("process_name", PID_COUNTERS, "talp metrics"))
    if anomalies:
        lines.append(_meta_line("process_name", PID_ANOMALIES, "talp anomalies"))
    for rank in sorted(host_states):
        lines.append(_meta_line("thread_name", PID_HOST, f"rank {rank}", rank))
        for display, iv in _host_state_intervals(host_states[rank], t0):
            lines.extend(slice_lines(display, "host", PID_HOST, rank, iv, t0))
    for dev in sorted(device_lanes):
        kern, mem = device_lanes[dev]
        lines.append(_meta_line("thread_name", PID_DEVICE, f"dev {dev}", dev))
        lines.extend(_device_lane_lines(dev, kern, mem, t0))
    if region_windows:
        lines.extend(_region_marker_lines(region_windows, t0))
    if step_series is not None and len(step_series):
        # Step-resolution counters supersede the polling-cadence ones:
        # one point per region close, nothing averaged away.
        lines.extend(_step_counter_lines(step_series, t0))
    elif samples:
        lines.extend(_counter_lines(samples, t0))
    if anomalies:
        lines.extend(_anomaly_lines(anomalies, t0))
    return _assemble(lines, name, other=other)


def export_trace(
    trace: Trace,
    samples: Optional[Sequence[Tuple[float, TalpResult]]] = None,
) -> str:
    """Render a :class:`~repro.core.states.Trace` (host timelines +
    device record timelines) as Chrome trace JSON."""
    with _ovh.section("export"):
        if trace.window is not None:
            t0, t1 = trace.window
        else:
            t0, t1 = 0.0, trace.elapsed
        host_states = {r: h.as_dict() for r, h in trace.hosts.items()}
        device_lanes = {
            d: _device_lane_intervals(tl, (t0, t1))
            for d, tl in trace.devices.items()
        }
        return _build(trace.name, t0, host_states, device_lanes, {}, samples)


def export_trace_reference(trace: Trace) -> str:
    """Retained per-event reference exporter: identical event stream to
    :func:`export_trace`, built one dict at a time and serialized one
    event at a time — the shape every naive/streaming exporter has.
    Oracle + benchmark baseline; not on any production path."""
    if trace.window is not None:
        t0, t1 = trace.window
    else:
        t0, t1 = 0.0, trace.elapsed
    events: List[Dict] = [
        json.loads(_meta_line("process_name", PID_HOST, "host ranks")),
        json.loads(_meta_line("process_name", PID_DEVICE, "devices")),
    ]
    for rank in sorted(trace.hosts):
        events.append(
            json.loads(_meta_line("thread_name", PID_HOST, f"rank {rank}", rank))
        )
        for display, iv in _host_state_intervals(
            trace.hosts[rank].as_dict(), t0
        ):
            events.extend(slice_events_loop(display, "host", PID_HOST, rank, iv, t0))
    for dev in sorted(trace.devices):
        kern, mem = _device_lane_intervals(trace.devices[dev], (t0, t1))
        events.append(
            json.loads(_meta_line("thread_name", PID_DEVICE, f"dev {dev}", dev))
        )
        lane = (slice_events_loop("Kernel", "device", PID_DEVICE, dev, kern, t0)
                + slice_events_loop("Memory", "device", PID_DEVICE, dev, mem, t0))
        events.extend(lane[i] for i in _device_lane_order(kern, mem))
    parts = [json.dumps(ev, separators=(",", ":")) for ev in events]
    return _assemble(parts, trace.name)


def _pick_window_region(result: TalpResult) -> Optional[RegionResult]:
    g = result.regions.get(TalpMonitor.GLOBAL)
    if g is not None:
        return g
    if not result.regions:
        return None
    return max(result.regions.values(), key=lambda r: r.elapsed)


def export_result(
    result: TalpResult,
    timelines: Optional[Dict[int, DeviceTimeline]] = None,
    samples: Optional[Sequence[Tuple[float, TalpResult]]] = None,
) -> str:
    """Render a (single-rank or post-merge job-level)
    :class:`~repro.core.talp.TalpResult` as Chrome trace JSON.

    Host lanes are proportional slices from the per-rank state durations;
    device lanes are exact when raw ``timelines`` are attached (spool
    payloads carry them), proportional from the reduced device states
    otherwise. Regions become ``B``/``E`` markers anchored at the window
    start (a reduced result carries region durations, not timestamps —
    use :func:`export_monitor` for exact region windows).
    """
    with _ovh.section("export"):
        cov = getattr(result, "rank_coverage", None)
        other = (
            {"rank_coverage": cov.as_dict() if hasattr(cov, "as_dict")
             else cov}
            if cov is not None else None
        )
        g = _pick_window_region(result)
        if g is None:
            return _build(result.name, 0.0, {}, {}, {}, samples, other=other)
        device_lanes: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        if timelines:
            # Raw timelines live in the producing rank's clock domain;
            # re-anchor to the earliest record so lanes start at zero.
            starts = [tl.span()[0] for tl in timelines.values()
                      if tl.n_records]
            shift = min(starts) if starts else 0.0
            for dev, tl in timelines.items():
                kern, mem = _device_lane_intervals(tl)
                device_lanes[dev] = (kern - shift, mem - shift)
        else:
            for dev, st in g.device_states.items():
                device_lanes[dev] = _synthetic_device_intervals(st, 0.0)
        region_windows = {
            rname: np.array([[0.0, rr.elapsed]])
            for rname, rr in result.regions.items()
            if rr.elapsed > 0
        }
        return _build(
            result.name, 0.0, g.host_states, device_lanes,
            region_windows, samples, other=other,
        )


def export_monitor(
    mon: TalpMonitor,
    result: Optional[TalpResult] = None,
    samples: Optional[Sequence[Tuple[float, TalpResult]]] = None,
    step_series=None,
    anomalies=None,
) -> str:
    """Render a live (or finalized) monitor with *exact* region windows
    and device records — everything shares the monitor's clock domain, so
    region markers align with device slices. A ``step_series`` switches
    the counter tracks to step resolution (superseding ``samples``);
    ``anomalies`` adds watchdog instant markers."""
    with _ovh.section("export"):
        if result is None:
            result = mon.sample_result()
        g = _pick_window_region(result)
        region_windows = mon.region_windows()
        device_lanes = {
            dev: _device_lane_intervals(tl) for dev, tl in mon.devices.items()
        }
        anchors = [iv[0, 0] for iv in region_windows.values() if len(iv)]
        anchors += [tl.span()[0] for tl in mon.devices.values() if tl.n_records]
        t0 = min(anchors) if anchors else 0.0
        host_states = g.host_states if g is not None else {}
        return _build(
            result.name, t0, host_states, device_lanes,
            region_windows, samples,
            step_series=step_series, anomalies=anomalies,
        )


def export_job(
    job: TalpResult,
    rank_timelines: Dict[int, Dict[int, DeviceTimeline]],
) -> str:
    """Job-level trace from a merged result + the per-rank raw timeline
    attachments (``FileSpoolTransport.collect_timelines``). Local device
    ids are remapped to the same dense job-global ids the merge assigns
    ((rank-order, local-id) order), and each rank's records are
    re-anchored to its own first record — per-rank clocks do not share an
    epoch across nodes."""
    remapped: Dict[int, DeviceTimeline] = {}
    gid = 0
    for rank in sorted(rank_timelines):
        tls = rank_timelines[rank]
        starts = [tl.span()[0] for tl in tls.values() if tl.n_records]
        shift = min(starts) if starts else 0.0
        for dev in sorted(tls):
            tl = tls[dev]
            kern, mem = _device_lane_intervals(tl)
            shifted = DeviceTimeline(device=gid)
            if len(kern):
                shifted.ingest_arrays(DeviceActivity.KERNEL,
                                      kern[:, 0] - shift, kern[:, 1] - shift)
            if len(mem):
                shifted.ingest_arrays(DeviceActivity.MEMORY,
                                      mem[:, 0] - shift, mem[:, 1] - shift)
            remapped[gid] = shifted
            gid += 1
    return export_result(job, timelines=remapped or None)


# ---------------------------------------------------------------------------
# structural validator (tests + CI share it)
# ---------------------------------------------------------------------------
def validate_chrome_trace(
    text: str, overlap_tol_us: float = 2e-3
) -> Dict[str, object]:
    """Validate trace-event JSON structurally; raises ``ValueError`` on
    the first violation, returns a summary dict on success.

    Checks: valid JSON with a ``traceEvents`` list; every event has a
    known ``ph``; complete events carry numeric ``ts``/``dur``/``pid``/
    ``tid`` with ``dur >= 0``; per (pid, tid) lane the X events are
    monotonically ordered and non-overlapping (touching allowed; the
    default tolerance covers the exporter's ±0.5 ns ``ts`` quantization
    on both neighbors); ``B``/``E`` markers are balanced per lane and
    name with depth never going negative; counters carry numeric series
    args; instant events (``"i"``) carry a name, a numeric ``ts`` and a
    valid scope.
    """
    try:
        payload = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"trace is not valid JSON: {e}") from e
    events = payload.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("missing traceEvents list")
    lanes: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
    marker_depth: Dict[Tuple[int, int], int] = {}
    marker_last_ts: Dict[Tuple[int, int], float] = {}
    marker_open: Dict[Tuple[int, int, str], int] = {}
    counts = {"X": 0, "B": 0, "E": 0, "C": 0, "M": 0, "i": 0}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev:
            raise ValueError(f"event {i}: missing required field 'ph'")
        ph = ev["ph"]
        if ph not in counts:
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        counts[ph] += 1
        if ph == "X":
            for f in ("ts", "dur", "pid", "tid"):
                if not isinstance(ev.get(f), (int, float)):
                    raise ValueError(
                        f"event {i}: complete event missing numeric {f!r}"
                    )
            if ev["dur"] < 0:
                raise ValueError(f"event {i}: negative dur {ev['dur']}")
            lanes.setdefault((ev["pid"], ev["tid"]), []).append(
                (float(ev["ts"]), float(ev["dur"]))
            )
        elif ph in ("B", "E"):
            for f in ("ts", "pid", "tid"):
                if not isinstance(ev.get(f), (int, float)):
                    raise ValueError(f"event {i}: marker missing numeric {f!r}")
            if "name" not in ev:
                raise ValueError(f"event {i}: marker missing 'name'")
            key = (ev["pid"], ev["tid"])
            ts = float(ev["ts"])
            if ts < marker_last_ts.get(key, -np.inf) - overlap_tol_us:
                raise ValueError(
                    f"event {i}: marker ts {ts} out of order on lane {key}"
                )
            marker_last_ts[key] = max(marker_last_ts.get(key, -np.inf), ts)
            d = marker_depth.get(key, 0) + (1 if ph == "B" else -1)
            if d < 0:
                raise ValueError(
                    f"event {i}: 'E' without matching 'B' on lane {key}"
                )
            marker_depth[key] = d
            nkey = (ev["pid"], ev["tid"], ev["name"])
            marker_open[nkey] = marker_open.get(nkey, 0) + (
                1 if ph == "B" else -1
            )
        elif ph == "i":
            if not isinstance(ev.get("ts"), (int, float)):
                raise ValueError(
                    f"event {i}: instant event missing numeric 'ts'"
                )
            if "name" not in ev:
                raise ValueError(f"event {i}: instant event missing 'name'")
            if ev.get("s", "t") not in ("t", "p", "g"):
                raise ValueError(
                    f"event {i}: instant event scope {ev.get('s')!r} invalid"
                )
        elif ph == "C":
            if not isinstance(ev.get("ts"), (int, float)):
                raise ValueError(f"event {i}: counter missing numeric 'ts'")
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                raise ValueError(f"event {i}: counter missing series args")
            for k, v in args.items():
                if not isinstance(v, (int, float)):
                    raise ValueError(
                        f"event {i}: counter series {k!r} non-numeric"
                    )
    for key, depth in marker_depth.items():
        if depth != 0:
            raise ValueError(f"unbalanced B/E markers on lane {key}")
    for (pid, tid, name), n in marker_open.items():
        if n != 0:
            raise ValueError(
                f"unbalanced B/E markers for region {name!r} on lane "
                f"({pid}, {tid})"
            )
    for key, slices in lanes.items():
        prev_end = -np.inf
        prev_ts = -np.inf
        for ts, dur in slices:
            if ts < prev_ts:
                raise ValueError(f"lane {key}: ts not monotonically ordered")
            if ts < prev_end - overlap_tol_us:
                raise ValueError(
                    f"lane {key}: overlapping slices (ts {ts} < previous "
                    f"end {prev_end})"
                )
            prev_ts = ts
            prev_end = max(prev_end, ts + dur)
    return {
        "n_events": len(events),
        "counts": counts,
        "lanes": {f"{pid}:{tid}": len(s) for (pid, tid), s in sorted(lanes.items())},
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        description="Validate (or summarize) a Chrome trace-event JSON "
                    "file produced by the TALP trace exporter."
    )
    ap.add_argument("trace", help="trace JSON file to validate")
    ap.add_argument("--validate", action="store_true",
                    help="structural validation only (default behavior; "
                         "flag kept for explicit CI invocations)")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        text = f.read()
    try:
        summary = validate_chrome_trace(text)
    except ValueError as e:
        print(f"INVALID: {e}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"valid": True, **summary}, indent=2))


if __name__ == "__main__":
    main()
