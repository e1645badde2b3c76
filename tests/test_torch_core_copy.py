"""The port's copy of the TALP engine (repro_torch.core) must stay
identical to repro.core: the same synthetic host regions and device
record columns, fed into both monitors, give the same JSON and the same
text report. Without this the copy would fork the single-source metric
specs of core/hierarchy.py unnoticed."""

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.core.report as jreport  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.report as treport  # noqa: E402


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _device_columns(rng, n, t_end):
    starts = np.sort(rng.uniform(0.0, t_end, n))
    ends = starts + rng.uniform(0.0, 0.4, n)
    kinds = np.where(rng.random(n) < 0.7, 0, 1).astype(np.uint8)
    streams = rng.integers(0, 3, n).astype(np.uint32)
    return kinds, starts, ends, streams


def _drive(core, seed):
    """One scripted run: regions (nested, re-opened), host states, device
    records from two devices in column batches and single records. Returns
    a mid-run sample and the final result."""
    rng = np.random.default_rng(seed)
    clk = FakeClock()
    mon = core.TalpMonitor("copy", clock=clk, overhead_report=False)
    codes = {0: core.DeviceActivity.KERNEL.code,
             1: core.DeviceActivity.MEMORY.code}
    with mon.region("init"):
        clk.advance(rng.uniform(0.5, 1.5))
    for step in range(4):
        with mon.region("step"):
            clk.advance(rng.uniform(0.1, 0.5))
            with mon.offload():
                clk.advance(rng.uniform(0.2, 1.0))
            with mon.region("inner"):
                clk.advance(rng.uniform(0.0, 0.3))
                with mon.mpi():
                    clk.advance(rng.uniform(0.0, 0.2))
    t_end = clk()
    for dev, n in ((0, 200), (1, 50)):
        kinds, starts, ends, streams = _device_columns(rng, n, t_end)
        kinds = np.array([codes[int(k)] for k in kinds], np.uint8)
        mon.ingest_device_arrays(dev, kinds, starts, ends, streams)
    mon.add_device_record(2, core.DeviceActivity.KERNEL, 0.25, 0.75)
    sample = mon.sample_result()
    with mon.region("tail"):
        clk.advance(0.3)
        with mon.offload():
            clk.advance(0.2)
    return sample, mon.finalize()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_copied_engine_reports_identically(seed):
    jsample, jres = _drive(jcore, seed)
    tsample, tres = _drive(tcore, seed)
    assert treport.to_json(tres) == jreport.to_json(jres)
    assert treport.render_tables(tres) == jreport.render_tables(jres)
    assert treport.to_json(tsample) == jreport.to_json(jsample)


def test_copied_metric_specs_identical():
    """Same tree of metric keys, labels and flags in each hierarchy."""
    for name in ("HOST", "DEVICE"):
        j, t = getattr(jcore, name), getattr(tcore, name)
        fields = lambda h: [(s.key, s.display, s.multiplicative, s.optional,  # noqa: E731
                             tuple(c.key for c in s.children))
                            for s in h.walk()]
        assert (t.name, t.side, t.count_key) == (j.name, j.side, j.count_key)
        assert fields(t) == fields(j)


# ---------------------------------------------------------------------------
# The validation layer: PILS, the application emulators, POP, scalability
# and the trace renderer give identical results in both packages.
# ---------------------------------------------------------------------------
import dataclasses  # noqa: E402

import repro.appsim as jappsim  # noqa: E402
import repro.core.scalability as jscal  # noqa: E402
import repro.core.traceview as jview  # noqa: E402
import repro.pils as jpils  # noqa: E402
import repro_torch.appsim as tappsim  # noqa: E402
import repro_torch.core.scalability as tscal  # noqa: E402
import repro_torch.core.traceview as tview  # noqa: E402
import repro_torch.pils as tpils  # noqa: E402


def _analysis(a):
    """Every number of a TraceAnalysis, as plain Python values."""
    return {"host": dataclasses.asdict(a.host) if a.host else None,
            "device": dataclasses.asdict(a.device) if a.device else None,
            "elapsed": a.elapsed, "host_states": a.host_states,
            "device_states": a.device_states, "name": a.name}


@pytest.mark.parametrize("name", sorted(jpils.USE_CASES))
def test_pils_use_case_identical(name):
    j, t = jpils.run_use_case(name), tpils.run_use_case(name)
    assert (t.name, t.description) == (j.name, j.description)
    assert set(t.analyses) == set(j.analyses)
    for key in j.analyses:
        assert _analysis(t.analyses[key]) == _analysis(j.analyses[key])
        for width in (40, 72):
            assert (tview.render_trace(t.traces[key], width=width)
                    == jview.render_trace(j.traces[key], width=width))


@pytest.mark.parametrize("app", ["sod2d", "fall3d", "xshells"])
def test_appsim_node_scan_identical(app):
    j, t = jappsim.node_scan(app), tappsim.node_scan(app)
    assert sorted(t) == sorted(j) == [1, 2, 4, 8]
    for n in j:
        assert _analysis(t[n]) == _analysis(j[n])
    jpts = jscal.scalability_scan([j[n] for n in sorted(j)],
                                  labels=[str(n) for n in sorted(j)],
                                  resources=[4 * n for n in sorted(j)])
    tpts = tscal.scalability_scan([t[n] for n in sorted(t)],
                                  labels=[str(n) for n in sorted(t)],
                                  resources=[4 * n for n in sorted(t)])
    assert [dataclasses.asdict(p) for p in tpts] == [
        dataclasses.asdict(p) for p in jpts]
    assert tscal.render_scalability(tpts) == jscal.render_scalability(jpts)
    trace = {"sod2d": "sod2d_trace", "fall3d": "fall3d_trace",
             "xshells": "xshells_trace"}[app]
    assert (tview.render_trace(getattr(tappsim, trace)(2), legend=False)
            == jview.render_trace(getattr(jappsim, trace)(2), legend=False))


@pytest.mark.parametrize("seed", [0, 1])
def test_pop_metrics_identical(seed):
    rng = np.random.default_rng(seed)
    useful = rng.uniform(0.1, 2.0, 6)
    not_useful = rng.uniform(0.0, 0.5, 6)
    for kw in ({"not_useful": not_useful},
               {"elapsed": float((useful + not_useful).max()) * 1.1}):
        j, t = jcore.pop_metrics(useful, **kw), tcore.pop_metrics(useful, **kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        t.validate()
    assert (tcore.elapsed_time(useful, not_useful)
            == jcore.elapsed_time(useful, not_useful))


def test_synthetic_backend_replays_identically():
    """The copied SyntheticBackend drains the same records, column batches
    and legacy objects, as the original; both are registered."""
    from repro.core import backends as jb
    from repro_torch.core import backends as tb

    assert "synthetic" in tb.available_backends()
    rng = np.random.default_rng(3)
    kinds, starts, ends, streams = _device_columns(rng, 20, 5.0)
    out = []
    for core, mod in ((jcore, jb), (tcore, tb)):
        be = mod.SyntheticBackend()
        be.start()
        be.push_arrays(1, kinds, starts, ends, streams)
        be.push(0, core.DeviceRecord(core.DeviceActivity.KERNEL, 0.5, 0.75,
                                     2))
        cols = [(d, k.tolist(), s.tolist(), e.tolist(), st.tolist())
                for d, k, s, e, st in be.flush_arrays()]
        be.push_arrays(0, kinds[:3], starts[:3], ends[:3], streams[:3])
        objs = [(d, r.kind.code, r.start, r.end, r.stream)
                for d, r in be.flush()]
        out.append((cols, objs))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# TALP's runtime outputs: the collection layer (merge, collect), the step
# series and watchdog, the metric stream and the trace exporter give
# identical outputs in both packages on the same inputs.
# ---------------------------------------------------------------------------
import importlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import time  # noqa: E402
from types import SimpleNamespace  # noqa: E402


def _pkg(root):
    mod = lambda name: importlib.import_module(f"{root}.core.{name}")  # noqa: E731
    return SimpleNamespace(
        core=importlib.import_module(f"{root}.core"), merge=mod("merge"),
        collect=mod("collect"), report=mod("report"),
        stepseries=mod("telemetry.stepseries"),
        watchdog=mod("telemetry.watchdog"),
        exporter=mod("telemetry.exporter"),
        traceexport=mod("telemetry.traceexport"))


JAX_PKG, TORCH_PKG = _pkg("repro"), _pkg("repro_torch")


def _telemetry_run(p, rank, seed):
    """One rank's scripted run with every runtime output attached: a step
    series (a ring smaller than the run) and watchdog over the ``step``
    region, an exporter sampled every 4 steps, device records from two
    devices whose second starves from step 9 on (the watchdog fires), and
    a flop model. Returns the monitor, its result and the outputs."""
    rng = np.random.default_rng(seed)
    clk = FakeClock()
    flop = SimpleNamespace(model_flops=2e9,
                           hw=SimpleNamespace(peak_flops=1e12))
    mon = p.core.TalpMonitor("job", rank=rank, clock=clk,
                             overhead_report=False, flop_model=flop)
    wd_sink, stream = io.StringIO(), io.StringIO()
    wd = p.watchdog.EfficiencyWatchdog(jsonl=wd_sink)
    rec = p.stepseries.StepSeriesRecorder(mon, capacity=10,
                                          regions=("step",), watchdog=wd)
    exp = p.exporter.TelemetryExporter(mon, capacity=3, jsonl=stream,
                                       watchdog=wd)
    prom = []
    K, M = p.core.DeviceActivity.KERNEL, p.core.DeviceActivity.MEMORY
    with mon.region("init"):
        clk.advance(0.3 + 0.1 * rank)
    with mon.region("train_loop"):
        for step in range(14):
            with mon.region("step"):
                t0 = clk()
                k = 0.05 * (1.0 + 0.01 * rng.standard_normal(2))
                if step >= 9:
                    k[1] *= 0.3
                for dev in (0, 1):
                    mon.add_device_record(dev, K, t0, t0 + k[dev])
                mon.add_device_record(0, M, t0 + k[0], t0 + k[0] + 0.004)
                clk.advance(0.01 + 0.002 * rank)
                with mon.offload():
                    clk.advance(float(k.max()))
                if step % 5 == 4:
                    with mon.mpi():
                        clk.advance(0.003)
            if step % 4 == 3:
                exp.sample()
                prom.append(exp.prometheus_text())
    exp.sample()
    rec.close()
    result = mon.finalize()
    trace = p.traceexport.export_monitor(
        mon, result=result, samples=exp.trace_samples(),
        step_series=rec.series, anomalies=wd.events)
    exp.close()
    wd.close()
    return SimpleNamespace(mon=mon, result=result, series=rec.series,
                           events=[e.as_dict() for e in wd.events],
                           anomaly_jsonl=wd_sink.getvalue(),
                           stream=stream.getvalue(), prom=prom, trace=trace)


def _rows_equal(a, b):
    assert a.dtype == b.dtype
    for f in a.dtype.names:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.fixture
def fixed_wall(monkeypatch):
    """The exporter stamps snapshots with time.time(): one value for both."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)


@pytest.mark.parametrize("rank", [0, 1])
def test_runtime_outputs_identical(rank, fixed_wall):
    """Step-series rows, watchdog events and anomaly JSONL, the exporter's
    JSONL and Prometheus text, and the Chrome trace of one rank."""
    j = _telemetry_run(JAX_PKG, rank, seed=rank)
    t = _telemetry_run(TORCH_PKG, rank, seed=rank)
    assert t.series.n_dropped == 4
    _rows_equal(t.series.rows(), j.series.rows())
    assert t.series.region_names == j.series.region_names
    assert t.series.as_table() == j.series.as_table()
    assert j.events and t.events == j.events
    assert t.anomaly_jsonl == j.anomaly_jsonl
    assert len(t.stream.splitlines()) == 4 and t.stream == j.stream
    assert t.prom == j.prom
    assert t.trace == j.trace
    TORCH_PKG.traceexport.validate_chrome_trace(t.trace)
    assert TORCH_PKG.report.to_json(t.result) == JAX_PKG.report.to_json(
        j.result)


def _spool_job(p, root, fmt, world=3):
    """Three ranks spooled (with their timelines and step series) through
    emit_job_report: the published job JSON, the merge of the spool, the
    job trace, the merged step table and the payload text of rank 0."""
    runs = [_telemetry_run(p, r, seed=10 + r) for r in range(world)]
    transport = p.merge.FileSpoolTransport(str(root), world_size=world,
                                           payload=fmt)
    for r, run in enumerate(runs):
        transport.submit_steps(run.series, rank=r)
        p.merge.emit_job_report(run.result, str(root), r, world,
                                verbose=False, payload=fmt,
                                timelines=run.mon.devices)
    job = (root / "talp_job.json").read_text()
    merged = p.report.to_json(p.merge.merge_spool(str(root), name="job"))
    trace = p.traceexport.export_job(
        p.merge.talp_result_from_json(job), transport.collect_timelines())
    steps = transport.merge_steps(name="job").as_table()
    direct = p.report.to_json(p.merge.merge_results(
        [run.result for run in runs], name="job"))
    return SimpleNamespace(job=job, merged=merged, trace=trace, steps=steps,
                           direct=direct, runs=runs)


@pytest.mark.parametrize("fmt", ["binary", "json"])
def test_job_merge_identical(fmt, tmp_path, fixed_wall):
    """merge_results, the spool's job report (binary and JSON payloads),
    the job trace and the rank-aligned step table: byte-identical."""
    j = _spool_job(JAX_PKG, tmp_path / "jax", fmt)
    t = _spool_job(TORCH_PKG, tmp_path / "torch", fmt)
    for field in ("job", "merged", "trace", "steps", "direct"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.job == t.direct
    assert len(json.loads(t.job)["regions"]["Global"]["host_states"]) == 3


@pytest.mark.parametrize("fmt", ["binary", "json"])
def test_spool_payload_round_trip_identical(fmt, tmp_path, fixed_wall):
    """One rank's payload with its timelines: each package reads the
    other's, and both give the same result and timeline columns."""
    runs = {name: _telemetry_run(p, 0, seed=4)
            for name, p in (("jax", JAX_PKG), ("torch", TORCH_PKG))}
    decoded = {}
    for writer, p in (("jax", JAX_PKG), ("torch", TORCH_PKG)):
        run = runs[writer]
        if fmt == "binary":
            data = p.merge.result_to_spool_bytes(run.result, run.mon.devices)
            path = tmp_path / f"{writer}.npz"
            path.write_bytes(data)
        else:
            data = p.merge.result_to_spool_json(run.result, run.mon.devices)
            path = tmp_path / f"{writer}.json"
            path.write_text(data)
        for reader, q in (("jax", JAX_PKG), ("torch", TORCH_PKG)):
            result, tls = q.merge.load_spool_payload(str(path))
            decoded[writer, reader] = (
                q.report.to_json(result),
                {d: {k: (v.tolist() if hasattr(v, "tolist") else v)
                     for k, v in tl.to_columns().items()}
                 for d, tl in tls.items()})
    if fmt == "json":
        assert (TORCH_PKG.merge.result_to_spool_json(
            runs["torch"].result, runs["torch"].mon.devices)
            == JAX_PKG.merge.result_to_spool_json(
                runs["jax"].result, runs["jax"].mon.devices))
    values = list(decoded.values())
    assert len(values) == 4 and all(v == values[0] for v in values)
    assert set(values[0][1]) == {0, 1}


def test_fault_plan_and_coverage_identical(tmp_path):
    """FaultPlan parsing in every form, its byte mutations, and the
    tolerant merge's rank_coverage on the same injected losses."""
    spec = {"drop": [2], "truncate": {"1": 96},
            "corrupt": {"0": {"offset": 4, "length": 2, "xor": 255}},
            "delay": {"1": 0.25}, "clock_skew": {"0": 1.5}}
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(spec))
    seen = []
    for p in (JAX_PKG, TORCH_PKG):
        FaultPlan = p.collect.FaultPlan
        plans = [FaultPlan.from_spec(s) for s in
                 (spec, json.dumps(spec), str(path), "@" + str(path))]
        seen.append([
            (fp.drop, fp.truncate, fp.corrupt, fp.delay, fp.clock_skew,
             [fp.describe(r) for r in range(4)],
             [fp.mutate_bytes(bytes(range(40)), r) for r in range(4)],
             [(fp.drops(r), fp.delay_s(r), fp.skew_s(r), fp.touches(r))
              for r in range(4)])
            for fp in plans])
        with pytest.raises(ValueError, match="unknown fault plan"):
            FaultPlan.from_spec({"explode": True})
    assert seen[0] == seen[1]

    jobs = []
    for name, p in (("jax", JAX_PKG), ("torch", TORCH_PKG)):
        root = tmp_path / "spool"          # the same path: the same reasons
        plan = p.collect.FaultPlan.from_spec({"truncate": {"1": 64}})
        for r in range(3):
            run = _telemetry_run(p, r, seed=20 + r)
            p.merge.emit_job_report(run.result, str(root), r, 3,
                                    verbose=False, fault_plan=plan)
        job = (root / "talp_job.json").read_text()
        assert json.loads(job)["rank_coverage"]["merged"] == [0, 2]
        jobs.append(job)
        shutil.rmtree(root)
    assert jobs[0] == jobs[1]


# ---------------------------------------------------------------------------
# The analytical backend: the same StepModels give the same trace and the
# same analysis in both packages. Each side gets an equal HardwareSpec, as
# their defaults differ on purpose (one H100 against one TPU v5e).
# ---------------------------------------------------------------------------
_STEP_MODEL_CASES = {
    "balanced": ([dict(flops=3e14, hbm_bytes=4e11, collective_bytes=1e10,
                       model_flops=2e14)] * 2, 3, 0.0),
    "imbalanced": ([dict(flops=1e14, hbm_bytes=0.0, collective_bytes=0.0),
                    dict(flops=4e14, hbm_bytes=1e12, collective_bytes=5e9,
                         model_flops=1e14)], 2, 0.25),
    "host_gap_and_overlap": ([dict(flops=2e14, hbm_bytes=3e12,
                                   collective_bytes=2e11, host_gap_s=0.5,
                                   collective_overlap=0.4,
                                   model_flops=1.5e14)] * 3, 5, 0.1),
}


@pytest.mark.parametrize("case", sorted(_STEP_MODEL_CASES))
def test_analytical_backend_identical(case):
    """trace_from_step_model gives the same host states, device columns
    and window, and AnalyticalBackend the same analysis and trees, in both
    packages."""
    from repro.core.backends import analytical as jan
    from repro_torch.core.backends import analytical as tan

    models, steps, host_useful = _STEP_MODEL_CASES[case]
    out = []
    for core, mod in ((jcore, jan), (tcore, tan)):
        hw = mod.HardwareSpec(name="h", peak_flops=5e14, hbm_bw=2e12,
                              ici_bw=1e11)
        sms = [mod.StepModel(hw=hw, **m) for m in models]
        trace = mod.trace_from_step_model(sms, steps=steps,
                                          host_useful_s=host_useful)
        dev = {d: [(r.kind.code, r.start, r.end) for r in
                   trace.devices[d].records]
               for d in sorted(trace.devices)}
        hosts = {r: trace.hosts[r].as_dict() for r in sorted(trace.hosts)}
        a = mod.AnalyticalBackend(sms, steps=steps,
                                  host_useful_s=host_useful).analyze()
        a.validate()
        trees = {k: v.as_dict() for k, v in a.trees().items()}
        out.append((trace.window, dev, hosts, a.elapsed,
                    a.host.as_dict(), a.device.as_dict(), a.host_states,
                    a.device_states, trees))
    assert out[0] == out[1]
