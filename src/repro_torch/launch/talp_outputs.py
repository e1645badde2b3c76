"""TALP's runtime outputs for the drivers: the ``--talp-*`` flags of
``repro.launch.serve`` and ``repro.launch.train``, with their names,
defaults and behaviour, in one place for both of the port's drivers.

  * ``--talp-step-series N`` / ``--talp-watchdog`` / ``--talp-anomaly-log``:
    a nested per-step region (``step`` in training, ``decode_step`` in
    serving) whose closes feed a :class:`StepSeriesRecorder` and the
    :class:`EfficiencyWatchdog`; with them a :class:`StepModel` flop model
    (the driver's ``model_flops`` over ``world_size``) feeds the measured
    Computational Efficiency;
  * ``--talp-sample-every N``: a mid-run snapshot every N steps, through
    the exporter when one is attached, merged across the ranks of a
    ``--talp-spool``;
  * ``--talp-trace-out`` / ``--talp-metrics-jsonl`` /
    ``--talp-prometheus-port``: Chrome trace at exit, one JSON line per
    snapshot, the latest snapshot as Prometheus text on 127.0.0.1;
  * ``--talp-spool`` / ``--talp-spool-format``: this rank's report (with
    its device timelines) and step series spooled, and the job report
    ``talp_job.json`` merged by the rank that completes the spool;
  * ``--talp-fault-plan``: deterministic collection faults for this rank;
    its ``clock_skew`` skews the monitor's clock only, the backend keeps
    ``time.perf_counter``;
  * ``--rank`` / ``--world-size``: this process's place in a job of
    independent processes (no collective).
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Callable, Optional

from ..core.backends.analytical import StepModel
from ..core.collect import FaultPlan
from ..core.merge import FileSpoolTransport, emit_job_report
from ..core.report import render_tables, to_json
from ..core.talp import TalpMonitor

__all__ = ["TALP_FLAGS", "add_talp_arguments", "talp_kwargs", "TalpOutputs"]

# the keyword arguments of serve() and train() the flags below set
TALP_FLAGS = ("rank", "world_size", "talp_spool", "talp_sample_every",
              "talp_spool_format", "talp_trace_out", "talp_metrics_jsonl",
              "talp_prometheus_port", "talp_step_series", "talp_watchdog",
              "talp_anomaly_log", "talp_fault_plan")


def add_talp_arguments(ap, unit: str) -> None:
    """The JAX drivers' ``--talp-*``, ``--rank`` and ``--world-size`` flags;
    ``unit`` names what a sample and a step-series row are per."""
    ap.add_argument("--talp-sample-every", type=int, default=0,
                    help=f"every N {unit}s publish a mid-run snapshot and "
                         "(with --talp-spool) merge a job-level report")
    ap.add_argument("--talp-spool", default=None,
                    help="shared dir for per-rank reports + job-level merge")
    ap.add_argument("--talp-spool-format", choices=("binary", "json"),
                    default="binary",
                    help="spool payload: versioned binary .npz (default) "
                         "or legacy JSON")
    ap.add_argument("--talp-trace-out", default=None,
                    help="write a Chrome/Perfetto trace JSON of this rank "
                         "at exit")
    ap.add_argument("--talp-metrics-jsonl", default=None,
                    help="stream every TALP snapshot as one JSON line to "
                         "this file")
    ap.add_argument("--talp-prometheus-port", type=int, default=None,
                    help="serve the latest snapshot as Prometheus text on "
                         "127.0.0.1 at this port (0 = ephemeral)")
    ap.add_argument("--talp-step-series", type=int, default=0,
                    help=f"keep the last N per-{unit} metric rows (columnar "
                         "ring; spooled + rank-aligned with --talp-spool)")
    ap.add_argument("--talp-watchdog", action="store_true",
                    help="run the online efficiency anomaly watchdog over "
                         f"the per-{unit} rows (implies a step series)")
    ap.add_argument("--talp-anomaly-log", default=None,
                    help="stream watchdog anomaly events as JSONL to this "
                         "file (implies --talp-watchdog)")
    ap.add_argument("--talp-fault-plan", default=None, metavar="SPEC",
                    help="deterministic collection-fault injection for "
                         "this rank (debug): inline JSON or a JSON file "
                         "with drop/truncate/corrupt/delay/clock_skew "
                         "sections keyed by rank id")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world-size", type=int, default=1)


def talp_kwargs(args) -> dict:
    """The parsed flags as keyword arguments of ``serve``/``train``."""
    return {k: getattr(args, k) for k in TALP_FLAGS}


class TalpOutputs:
    """One driver run's monitor and its runtime outputs, as the JAX drivers
    build them: construct before the run, wrap each step in :meth:`step`,
    call :meth:`sample` after each step and :meth:`finish` at the end.

    ``model_flops`` gives the useful FLOPs of one launch for the whole job;
    it is called only when a step series is on.
    """

    def __init__(
        self,
        name: str,
        backend,
        step_region: str,
        model_flops: Callable[[], float],
        verbose: bool = True,
        rank: int = 0,
        world_size: int = 1,
        talp_spool: Optional[str] = None,
        talp_sample_every: int = 0,
        talp_spool_format: str = "binary",
        talp_trace_out: Optional[str] = None,
        talp_metrics_jsonl: Optional[str] = None,
        talp_prometheus_port: Optional[int] = None,
        talp_step_series: int = 0,
        talp_watchdog: bool = False,
        talp_anomaly_log: Optional[str] = None,
        talp_fault_plan=None,
    ):
        self.rank, self.world_size = rank, world_size
        self.verbose = verbose
        self.spool, self.spool_format = talp_spool, talp_spool_format
        self.sample_every = talp_sample_every
        self.trace_out = talp_trace_out
        self.fault_plan = (FaultPlan.from_spec(talp_fault_plan)
                           if talp_fault_plan is not None else None)
        clock = time.perf_counter
        if self.fault_plan is not None:
            skew = self.fault_plan.skew_s(rank)
            if skew:
                clock = lambda: time.perf_counter() + skew  # noqa: E731
            if verbose and self.fault_plan.touches(rank):
                print(f"[talp fault] rank {rank} plan: "
                      f"{self.fault_plan.describe(rank)}")
        want_steps = bool(talp_step_series or talp_watchdog
                          or talp_anomaly_log)
        flop_model = None
        if want_steps:
            flop_model = StepModel(
                flops=0.0, hbm_bytes=0.0, collective_bytes=0.0,
                model_flops=model_flops() / max(world_size, 1),
            )
        self.mon = TalpMonitor(name, rank=rank, clock=clock, backend=backend,
                               overhead_report=True, flop_model=flop_model)
        self.recorder = self.watchdog = None
        if want_steps:
            from ..core.telemetry.stepseries import StepSeriesRecorder

            if talp_watchdog or talp_anomaly_log:
                from ..core.telemetry.watchdog import EfficiencyWatchdog

                self.watchdog = EfficiencyWatchdog(jsonl=talp_anomaly_log)
            self.recorder = StepSeriesRecorder(
                self.mon, capacity=talp_step_series or 4096,
                regions=(step_region,), watchdog=self.watchdog,
            )
        self.step_region = step_region
        self.sample_transport = (
            FileSpoolTransport(talp_spool, world_size=world_size,
                               payload=talp_spool_format)
            if talp_spool and talp_sample_every else None
        )
        self.telemetry = None
        if (talp_metrics_jsonl or talp_prometheus_port is not None
                or talp_trace_out):
            from ..core.telemetry.exporter import TelemetryExporter

            self.telemetry = TelemetryExporter(
                self.mon, jsonl=talp_metrics_jsonl, watchdog=self.watchdog)
            if talp_prometheus_port is not None:
                port = self.telemetry.serve(port=talp_prometheus_port)
                if verbose:
                    print(f"[talp] prometheus exposition on :{port}/metrics")

    def step(self):
        """The nested per-step region, only when the step series is on: its
        close is what the recorder and watchdog capture."""
        if self.recorder is None:
            return nullcontext()
        return self.mon.region(self.step_region)

    def sample(self, index: int, tag: str) -> None:
        """After step ``index`` (0-based): every ``talp_sample_every`` steps
        a snapshot, through the exporter when one is attached (so it also
        lands in the ring buffer and the JSONL/Prometheus stream), merged
        across the spooled ranks."""
        if not self.sample_every or (index + 1) % self.sample_every:
            return
        snapshot = (self.telemetry.sample().result
                    if self.telemetry is not None
                    else self.mon.sample_result())
        if self.sample_transport is not None:
            self.sample_transport.submit_sample(snapshot, rank=self.rank)
            job_snap = self.sample_transport.merge_samples(name=self.mon.name)
        else:
            job_snap = snapshot
        if self.verbose:
            g = job_snap.regions.get(TalpMonitor.GLOBAL)
            if g is not None and g.host is not None:
                print(f"[talp sample] {tag} "
                      f"ranks={g.n_ranks} devices={g.n_devices} "
                      f"PE_host={g.host.parallel_efficiency:.3f}")

    def finish(self, talp_json: Optional[str] = None,
               notes: Callable[[], None] = None):
        """Finalize the monitor and write every output; ``notes`` prints the
        driver's own lines after the report tables. Returns the result."""
        mon, telemetry = self.mon, self.telemetry
        if telemetry is not None:
            # Final snapshot while the monitor still runs: the stream's last
            # record and the post-mortem report describe the same window.
            telemetry.sample()
        if self.recorder is not None:
            self.recorder.close()   # detach before finalize's Global close
        result = mon.finalize()
        if self.trace_out:
            from ..core.telemetry.traceexport import export_monitor

            with open(self.trace_out, "w") as f:
                f.write(export_monitor(
                    mon, result=result,
                    samples=telemetry.trace_samples() if telemetry else None,
                    step_series=(self.recorder.series
                                 if self.recorder is not None else None),
                    anomalies=(self.watchdog.events
                               if self.watchdog is not None else None),
                ))
            if self.verbose:
                print(f"[talp] wrote Chrome trace: {self.trace_out}")
        if telemetry is not None:
            telemetry.close()
        if self.verbose:
            print(render_tables(result))
            if notes is not None:
                notes()
            if self.watchdog is not None and self.watchdog.events:
                print(f"[talp watchdog] {len(self.watchdog.events)} anomaly "
                      f"event(s); first: {self.watchdog.events[0].as_dict()}")
        if talp_json:
            with open(talp_json, "w") as f:
                f.write(to_json(result))
        if self.spool and self.recorder is not None:
            steps_transport = self.sample_transport or FileSpoolTransport(
                self.spool, world_size=self.world_size,
                payload=self.spool_format)
            steps_transport.submit_steps(self.recorder.series, rank=self.rank)
        if self.spool:
            emit_job_report(result, self.spool, self.rank, self.world_size,
                            verbose=self.verbose, payload=self.spool_format,
                            timelines=mon.devices, fault_plan=self.fault_plan)
        if self.watchdog is not None:
            self.watchdog.close()
        return result
