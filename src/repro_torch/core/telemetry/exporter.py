"""Runtime metric stream — TALP's "available at runtime" promise, wired.

:class:`TelemetryExporter` wraps :meth:`TalpMonitor.sample_result` into a
bounded ring buffer of timestamped snapshots and publishes each one as

  * a **JSONL stream** (one self-contained JSON object per sample, to a
    path or any writable file object — a dashboard tails it), and
  * **Prometheus text-format exposition** (opt-in stdlib HTTP server,
    ``GET /metrics``), the format MPCDF-style production monitoring
    scrapes.

Metric names are derived *generically* from the
:class:`~repro.core.hierarchy.Hierarchy` specs: a JSONL record carries
each region's ``frame.scalar_fields()`` keyed by hierarchy name, and a
Prometheus family is ``talp_{hierarchy}_{spec key}`` with a ``region``
label. Nothing here enumerates metrics — a metric registered with
``Hierarchy.with_child()`` appears in both outputs with no exporter
changes, exactly like it appears in the text/JSON reports.

An attached :class:`~.watchdog.EfficiencyWatchdog` is published too:
each JSONL record carries its ``summary()`` (watched metrics, event
count, currently-firing detectors) and the exposition gains a
``talp_watchdog_events_total`` counter plus one ``talp_watchdog_firing``
gauge per firing (region, metric).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple, Union

from ..hierarchy import MetricFrame
from ..talp import RegionResult, TalpMonitor, TalpResult
from . import overhead as _ovh

__all__ = ["TelemetrySnapshot", "TelemetryExporter", "result_frames"]

_PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def result_frames(rr: RegionResult) -> List[MetricFrame]:
    """Metric frames of one region result — façade dataclass or raw
    :class:`MetricFrame` alike (``with_child`` flows pass frames)."""
    frames = []
    for obj in (rr.host, rr.device):
        if obj is None:
            continue
        frames.append(obj if isinstance(obj, MetricFrame) else obj.frame())
    return frames


@dataclass
class TelemetrySnapshot:
    """One ring-buffer entry: a non-destructive all-regions result plus
    the monitor-clock and wall-clock instants it was taken at."""

    seq: int
    t: float       # monitor clock (same domain as region windows/devices)
    wall: float    # unix epoch, for cross-host correlation
    result: TalpResult


class TelemetryExporter:
    """Bounded ring buffer of monitor snapshots with JSONL + Prometheus
    publication.

    ``jsonl`` may be a path (opened append, line-buffered intent — each
    record is flushed) or any object with ``write``; pass
    ``prometheus=True``-style opt-in by calling :meth:`serve` (port 0
    binds an ephemeral port and returns it). ``close()`` is idempotent
    and leaves the ring readable.
    """

    def __init__(
        self,
        monitor: TalpMonitor,
        capacity: int = 256,
        jsonl: Optional[Union[str, "object"]] = None,
        watchdog=None,
    ):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.monitor = monitor
        self.capacity = capacity
        self.watchdog = watchdog
        self._ring: List[TelemetrySnapshot] = []
        self._seq = 0
        self._lock = threading.Lock()
        self._jsonl_owned = False
        self._jsonl = None
        if jsonl is not None:
            if hasattr(jsonl, "write"):
                self._jsonl = jsonl
            else:
                self._jsonl = open(jsonl, "a")
                self._jsonl_owned = True
        self._http = None
        self._http_thread = None

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def sample(self) -> TelemetrySnapshot:
        """Take one snapshot: ring-buffer it and publish to the JSONL
        stream (the Prometheus endpoint always serves the latest)."""
        with _ovh.section("sample"):
            t = self.monitor.clock()
            result = self.monitor.sample_result()
            with self._lock:
                snap = TelemetrySnapshot(
                    seq=self._seq, t=t, wall=time.time(), result=result
                )
                self._seq += 1
                self._ring.append(snap)
                if len(self._ring) > self.capacity:
                    del self._ring[: len(self._ring) - self.capacity]
            if self._jsonl is not None:
                with _ovh.section("export"):
                    self._jsonl.write(
                        json.dumps(self.jsonl_record(snap),
                                   separators=(",", ":")) + "\n"
                    )
                    if hasattr(self._jsonl, "flush"):
                        self._jsonl.flush()
            return snap

    @property
    def last(self) -> Optional[TelemetrySnapshot]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def snapshots(self) -> List[TelemetrySnapshot]:
        with self._lock:
            return list(self._ring)

    def trace_samples(self) -> List[Tuple[float, TalpResult]]:
        """(monitor-clock t, result) pairs — the ``samples`` input of the
        Chrome-trace counter tracks."""
        return [(s.t, s.result) for s in self.snapshots()]

    # ------------------------------------------------------------------
    # JSONL
    # ------------------------------------------------------------------
    def jsonl_record(self, snap: TelemetrySnapshot) -> Dict:
        """One self-contained JSON object per sample. Region metrics are
        each frame's ``scalar_fields()`` keyed by hierarchy name — spec
        keys verbatim, so stream consumers and report JSON agree."""
        regions: Dict[str, Dict] = {}
        for rname in sorted(snap.result.regions):
            rr = snap.result.regions[rname]
            entry: Dict[str, object] = {"elapsed": rr.elapsed}
            for frame in result_frames(rr):
                entry[frame.hierarchy.name] = frame.scalar_fields()
            regions[rname] = entry
        record = {
            "seq": snap.seq,
            "t": snap.t,
            "wall": snap.wall,
            "name": snap.result.name,
            "regions": regions,
        }
        cov = getattr(snap.result, "rank_coverage", None)
        if cov is not None:
            # job-level snapshots from a tolerant merge carry their
            # partial-rank annotation into the stream
            record["rank_coverage"] = (
                cov.as_dict() if hasattr(cov, "as_dict") else cov
            )
        if self.watchdog is not None:
            record["watchdog"] = self.watchdog.summary()
        return record

    # ------------------------------------------------------------------
    # Prometheus text exposition
    # ------------------------------------------------------------------
    def _families(
        self, snap: TelemetrySnapshot
    ) -> Iterator[Tuple[str, str, List[Tuple[str, float]]]]:
        """(family name, help text, [(label string, value)]) groups, one
        family per (hierarchy, scalar field) across regions."""
        fams: Dict[str, Tuple[str, List[Tuple[str, float]]]] = {}
        for rname in sorted(snap.result.regions):
            rr = snap.result.regions[rname]
            labels = f'{{region="{rname}",trace="{snap.result.name}"}}'
            for frame in result_frames(rr):
                h = frame.hierarchy
                displays = {s.key: s.display for s in h.walk()}
                for key, value in frame.scalar_fields().items():
                    fam = f"talp_{h.name}_{key}"
                    help_text = displays.get(
                        key,
                        "elapsed seconds" if key == "elapsed" else key,
                    )
                    fams.setdefault(fam, (help_text, []))[1].append(
                        (labels, float(value))
                    )
        for fam in sorted(fams):
            help_text, rows = fams[fam]
            yield fam, help_text, rows

    def prometheus_text(
        self, snap: Optional[TelemetrySnapshot] = None
    ) -> str:
        """Prometheus text-format exposition of one snapshot (latest by
        default; empty exposition before the first sample)."""
        snap = snap if snap is not None else self.last
        if snap is None:
            return "# no samples yet\n"
        out: List[str] = []
        for fam, help_text, rows in self._families(snap):
            out.append(f"# HELP {fam} {help_text}")
            out.append(f"# TYPE {fam} gauge")
            for labels, value in rows:
                out.append(f"{fam}{labels} {value:.17g}")
        out.append(f"# HELP talp_sample_seq sample sequence number")
        out.append(f"# TYPE talp_sample_seq counter")
        out.append(
            f'talp_sample_seq{{trace="{snap.result.name}"}} {snap.seq}'
        )
        if self.watchdog is not None:
            s = self.watchdog.summary()
            out.append(
                "# HELP talp_watchdog_events_total anomaly events emitted"
            )
            out.append("# TYPE talp_watchdog_events_total counter")
            out.append(
                f'talp_watchdog_events_total'
                f'{{trace="{snap.result.name}"}} {s["n_events"]}'
            )
            out.append(
                "# HELP talp_watchdog_firing detector currently firing "
                "(1 per firing region/metric)"
            )
            out.append("# TYPE talp_watchdog_firing gauge")
            for f in s["firing"]:
                out.append(
                    f'talp_watchdog_firing{{region="{f["region"]}",'
                    f'metric="{f["metric"]}",'
                    f'trace="{snap.result.name}"}} 1'
                )
        return "\n".join(out) + "\n"

    @property
    def port(self) -> Optional[int]:
        """Bound HTTP port (``None`` until :meth:`serve` has been
        called) — with ``serve(port=0)`` this is how tests discover the
        ephemeral port."""
        return self._http.server_address[1] if self._http is not None else None

    def serve(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Start the opt-in stdlib HTTP endpoint (``GET /metrics``) in a
        daemon thread; returns the bound port (pass 0 for ephemeral)."""
        if self._http is not None:
            return self._http.server_address[1]
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib handler API)
                if self.path not in ("/", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = exporter.prometheus_text().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", _PROM_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr
                pass

        self._http = ThreadingHTTPServer((host, port), _Handler)
        self._http_thread = threading.Thread(
            target=self._http.serve_forever, name="talp-prometheus",
            daemon=True,
        )
        self._http_thread.start()
        return self._http.server_address[1]

    def close(self) -> None:
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None
            self._http_thread = None
        if self._jsonl is not None and self._jsonl_owned:
            self._jsonl.close()
        self._jsonl = None
        self._jsonl_owned = False

    def __enter__(self) -> "TelemetryExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
