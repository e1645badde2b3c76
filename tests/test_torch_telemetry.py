"""TALP's runtime outputs in the port, on the CPU: the two changes for the
card's per-kernel records (Computational Efficiency per launch, a step
series that defers its device columns where a flush closes the CUPTI
collection), the torch.distributed AllGatherTransport's quarantine, and
both drivers' ``--talp-*`` flags end to end. The copies themselves are
held identical to ``repro``'s in tests/test_torch_core_copy.py."""

import io
import json
import re
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.core.telemetry.stepseries import (  # noqa: E402
    StepSeriesRecorder as JaxRecorder,
)
from repro_torch.core import DeviceActivity, TalpMonitor  # noqa: E402
from repro_torch.core.backends import CudaRuntimeBackend, StepModel  # noqa: E402
from repro_torch.core.report import to_json  # noqa: E402
from repro_torch.core.telemetry.exporter import TelemetryExporter  # noqa: E402
from repro_torch.core.telemetry.stepseries import StepSeriesRecorder  # noqa: E402
from repro_torch.core.telemetry.watchdog import EfficiencyWatchdog  # noqa: E402
from test_torch_runtime_backend import FakeActivity, FakeClock  # noqa: E402

K = DeviceActivity.KERNEL


class CountingActivity(FakeActivity):
    """FakeActivity that counts its closes: each is one drain of the CUPTI
    collection on the card (synchronises, two 20 ms waits, a profiler
    stop and start, the parsing of every row)."""

    def __init__(self, clock):
        super().__init__(clock)
        self.closes = 0

    def close(self):
        self.closes += 1
        return super().close()


def _split(start, end, n):
    """[start, end) as n contiguous kernel rows."""
    edges = np.linspace(start, end, n + 1)
    return list(zip(edges[:-1], edges[1:]))


def _steps(mon, backend, clk, inject, n_steps, rows_per_launch=1,
           region="step", after=None, second=True):
    """``n_steps`` launches, each inside ``region``: a kernel span of 0.3 s
    delivered as ``rows_per_launch`` rows and, with ``second``, a host gap
    and a second span."""
    for i in range(n_steps):
        with mon.region(region):
            def fn(t0=clk()):
                for s, e in _split(t0 + 0.05, t0 + 0.35, rows_per_launch):
                    inject(K, s, e)
                if second:
                    inject(K, t0 + 0.5, t0 + 0.5 + 0.02 * (i % 3 + 1))
                clk.advance(0.6)
            h = backend.launch(fn, name=f"step{i}")
            with mon.offload():
                clk.advance(0.1)
                backend.wait(h)
        if after is not None:
            after(i)


def _card_like(**kw):
    """A CPU backend fed by a fake activity source: the card's device path
    (one row per kernel, a flush that closes the collection)."""
    clk = FakeClock()
    src = CountingActivity(clk)
    be = CudaRuntimeBackend("cpu", clock=clk, activity=src)
    flop = StepModel(flops=0.0, hbm_bytes=0.0, collective_bytes=0.0,
                     model_flops=3e9)
    mon = TalpMonitor("t", clock=clk, backend=be, flop_model=flop,
                      overhead_report=False, **kw)
    return clk, src, be, mon


@pytest.mark.parametrize("rows_per_launch", [1, 4, 50])
def test_computational_efficiency_counts_launches_not_kernel_rows(
        rows_per_launch):
    """The flop model's FLOPs are per launch: the same busy intervals
    delivered as 1, 4 or 50 kernel rows per launch give one CE, the one
    repro.core gives with one record per launch."""
    clk, src, be, mon = _card_like()
    _steps(mon, be, clk, src.inject, 5, rows_per_launch, second=False)
    got = mon.finalize()["Global"].device.computational_efficiency
    assert be.launch_counts == {0: 5}

    jclk = FakeClock()
    jflop = SimpleNamespace(model_flops=3e9,
                            hw=SimpleNamespace(peak_flops=989e12))
    jmon = jcore.TalpMonitor("t", clock=jclk, flop_model=jflop)

    class OneRecordPerLaunch:
        def launch(self, fn, name=""):
            t0 = jclk()
            fn()
            return t0

        def wait(self, t0):
            pass

    spans = []
    _steps(jmon, OneRecordPerLaunch(), jclk,
           lambda kind, s, e: spans.append((s, e)), 5, second=False)
    for s, e in spans:
        jmon.add_device_record(0, jcore.DeviceActivity.KERNEL, s, e)
    want = jmon.finalize()["Global"].device.computational_efficiency
    # 5 launches of 3 GFLOP over 5 x 0.3 s of busy time
    assert want == pytest.approx(5 * 3e9 / (989e12 * 1.5))
    assert got == pytest.approx(want, rel=1e-9)


def test_one_record_per_launch_keeps_the_copys_count():
    """Without an activity source (one KERNEL record per launch) the
    backend offers no launch count and the engine counts records, as the
    copy does."""
    be = CudaRuntimeBackend("cpu")
    assert be.launch_counts is None and not be.flush_closes_collection


def _jax_rows(n_steps):
    """The copy's recorder over the same intervals (records added as the
    launches run, so every step close sees its own)."""
    jclk = FakeClock()
    jmon = jcore.TalpMonitor("t", clock=jclk, overhead_report=False)
    rec = JaxRecorder(jmon, capacity=64, regions=("step",))

    class Direct:
        def launch(self, fn, name=""):
            fn()

        def wait(self, h):
            pass

    def add(kind, s, e):
        jmon.add_device_record(0, jcore.DeviceActivity.KERNEL, s, e)

    _steps(jmon, Direct(), jclk, add, n_steps)
    rec.close()
    jmon.finalize()
    return rec.series.rows()


def _assert_rows_match(got, want):
    assert got.dtype.names == want.dtype.names and len(got) == len(want)
    for name in want.dtype.names:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-9,
                                   atol=1e-8, err_msg=name)


@pytest.mark.parametrize("capacity,closes", [(64, 1), (4, 3)])
def test_step_series_defers_device_columns_to_the_next_drain(capacity,
                                                             closes):
    """On the card's device path a step close does not drain the
    collection: 10 steps drain once (at the recorder's close) or, with a
    ring of 4 rows, every 4 closes, before a row is overwritten, where the
    copy drains 10 times; the rows equal the copy's, and the watchdog sees
    them all in step order."""
    clk, src, be, mon = _card_like()
    mon.flop_model = None
    seen = []
    wd = EfficiencyWatchdog()
    wd.observe = lambda region, step, t, values: seen.append(
        (step, values["device_parallel_efficiency"]))
    rec = StepSeriesRecorder(mon, capacity=capacity, regions=("step",),
                             watchdog=wd)
    assert rec.deferred
    pending = []
    _steps(mon, be, clk, src.inject, 10,
           after=lambda i: pending.append(np.isnan(
               rec.series.rows()["device_parallel_efficiency"][-1])))
    rec.close()
    mon.finalize()
    assert src.closes == closes
    # the first row's device columns waited for a drain
    assert pending[0]
    rows = rec.series.rows()
    _assert_rows_match(rows, _jax_rows(10)[-capacity:])
    assert [s for s, _ in seen] == list(range(10))
    np.testing.assert_allclose([v for _, v in seen][-len(rows):],
                               rows["device_parallel_efficiency"])


def test_a_sample_fills_the_deferred_rows_before_it_publishes():
    """An exporter sample drains the collection: the rows closed before it
    are filled and the watchdog fed before the snapshot's JSONL record
    (which carries the watchdog's summary) is written."""
    clk, src, be, mon = _card_like()
    stream = io.StringIO()
    wd = EfficiencyWatchdog()
    rec = StepSeriesRecorder(mon, regions=("step",), watchdog=wd)
    exp = TelemetryExporter(mon, jsonl=stream, watchdog=wd)
    n_baselines = []
    _steps(mon, be, clk, src.inject, 6, after=lambda i: (
        exp.sample(), n_baselines.append(len(wd._baselines)))
        if i == 2 else None)
    assert src.closes == 1
    rows = rec.series.rows()
    assert not np.isnan(rows["device_parallel_efficiency"][:3]).any()
    assert np.isnan(rows["device_parallel_efficiency"][3:]).all()
    assert n_baselines[0] > 0
    assert json.loads(stream.getvalue())["watchdog"]["n_events"] == 0
    rec.close()
    exp.close()
    assert src.closes == 2
    assert not np.isnan(rec.series.rows()["device_parallel_efficiency"]).any()
    mon.finalize()


def test_without_activity_source_each_close_drains_as_the_copy_does():
    clk = FakeClock()
    be = CudaRuntimeBackend("cpu", clock=clk)
    mon = TalpMonitor("t", clock=clk, backend=be, overhead_report=False)
    rec = StepSeriesRecorder(mon, capacity=64, regions=("step",))
    assert not rec.deferred

    def fn():
        clk.advance(0.3)

    for _ in range(4):
        with mon.region("step"):
            h = be.launch(fn)
            clk.advance(0.1)
            with mon.offload():
                clk.advance(0.05)
                be.wait(h)
            n_before = len(rec.series)
        assert len(rec.series) == n_before + 1
        assert not np.isnan(rec.series.rows()["device_parallel_efficiency"]
                            [-1])
    rec.close()
    mon.finalize()


# ---------------------------------------------------------------------------
# AllGatherTransport on torch.distributed, in one process
# ---------------------------------------------------------------------------
def _rank_result(rank):
    clk = FakeClock()
    mon = TalpMonitor(f"rank{rank}", rank=rank, clock=clk)
    with mon.region("step"):
        clk.advance(1.0 + rank)
        with mon.offload():
            clk.advance(0.5)
    mon.add_device_record(0, K, 0.0, 0.25 * (rank + 1))
    return mon.finalize()


def test_allgather_single_process_merges_locally():
    from repro_torch.core.merge import AllGatherTransport, merge_results

    r = _rank_result(0)
    assert to_json(AllGatherTransport().gather(r, name="job")) == to_json(
        merge_results([r], name="job"))
    assert to_json(AllGatherTransport().gather_sample(r)) == to_json(
        merge_results([r]))


def test_allgather_quarantines_empty_and_mangled_payloads(monkeypatch):
    """A collective of four ranks: one sends nothing, one a truncated
    JSON, one a non-bytes object. The survivors merge with a rank_coverage
    naming the three."""
    import torch.distributed as dist
    from repro_torch.core.merge import AllGatherTransport, merge_results

    mine, other = _rank_result(0), _rank_result(3)
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)

    def all_gather_object(out, obj, group=None):
        out[:] = [obj, b"", to_json(other).encode()[:50], 17]

    monkeypatch.setattr(dist, "all_gather_object", all_gather_object)
    job = AllGatherTransport().gather(mine, name="job")
    cov = job.rank_coverage
    assert cov.merged == [0] and cov.expected == 4
    reasons = {q.rank: q.reason for q in cov.quarantined}
    assert sorted(reasons) == [1, 2, 3]
    assert "empty" in reasons[1] and "mangled" in reasons[2]
    assert "mangled" in reasons[3]
    want = json.loads(to_json(merge_results([mine], name="job")))
    assert json.loads(to_json(job))["regions"] == want["regions"]

    def all_bad(out, obj, group=None):
        out[:] = [b""] * 4

    monkeypatch.setattr(dist, "all_gather_object", all_bad)
    with pytest.raises(ValueError, match="no decodable payloads"):
        AllGatherTransport().gather(mine)
    with pytest.raises(ValueError, match="exceeds allgather buffer"):
        AllGatherTransport(max_bytes=64).gather(mine)


# ---------------------------------------------------------------------------
# the drivers' flags, end to end on the CPU
# ---------------------------------------------------------------------------
def _scrape_on_each_sample(monkeypatch):
    """Scrape /metrics over 127.0.0.1 right after each exporter sample:
    (the snapshot's Global host PE, the scraped text)."""
    scrapes = []
    orig = TelemetryExporter.sample

    def sample(self):
        snap = orig(self)
        if self.port is not None:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{self.port}/metrics", timeout=5) as r:
                body = r.read().decode()
            g = snap.result.regions["Global"].host.parallel_efficiency
            scrapes.append((g, body))
        return snap

    monkeypatch.setattr(TelemetryExporter, "sample", sample)
    return scrapes


def _check_outputs(tmp_path, scrapes, n_lines, region, n_rows):
    from repro_torch.core.merge import FileSpoolTransport
    from repro_torch.core.merge import main as merge_main
    from repro_torch.core.telemetry.traceexport import main as trace_main
    from repro_torch.core.telemetry.watchdog import main as wd_main

    trace_main([str(tmp_path / "trace.json"), "--validate"])
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == n_lines
    assert len(scrapes) == n_lines
    for pe, body in scrapes:
        m = re.search(r'^talp_host_parallel_efficiency\{region="Global",'
                      r'[^}]*\} (\S+)$', body, re.M)
        assert m and float(m.group(1)) == pe
    assert wd_main(["--validate", str(tmp_path / "anomalies.jsonl")]) == 0
    spool = tmp_path / "spool"
    job = json.loads((spool / "talp_job.json").read_text())
    assert len(job["regions"]["Global"]["host_states"]) == 1
    series = FileSpoolTransport(str(spool)).collect_steps()[0]
    assert len(series) == n_rows and series.region_names == (region,)
    merge_main([str(spool), "--json-out", str(tmp_path / "job.json"),
                "--step-series", "--trace-out", str(tmp_path / "job.trace")])
    assert json.loads((tmp_path / "job.json").read_text())[
        "regions"].keys() == job["regions"].keys()
    trace_main([str(tmp_path / "job.trace")])


def _flags(tmp_path, n):
    return ["--talp-step-series", str(n), "--talp-watchdog",
            "--talp-anomaly-log", str(tmp_path / "anomalies.jsonl"),
            "--talp-trace-out", str(tmp_path / "trace.json"),
            "--talp-metrics-jsonl", str(tmp_path / "metrics.jsonl"),
            "--talp-prometheus-port", "0",
            "--talp-spool", str(tmp_path / "spool"),
            "--talp-spool-format", "json", "--talp-sample-every", "4",
            "--talp-fault-plan", '{"delay": {"0": 0.01}}',
            "--rank", "0", "--world-size", "1"]


def _stall_after(monkeypatch, module, first, seconds=0.03):
    """From launch number ``first`` on, the host stalls before each launch
    (device idle inside the step): the watchdog fires, so the anomaly log
    exists."""
    import time

    class Stalling(CudaRuntimeBackend):
        n = 0

        def launch(self, fn, *args, **kwargs):
            Stalling.n += 1
            if Stalling.n > first:
                time.sleep(seconds)
            return super().launch(fn, *args, **kwargs)

    monkeypatch.setattr(module, "CudaRuntimeBackend", Stalling)


def test_serve_cli_every_flag_on_cpu(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import serve as serve_mod

    scrapes = _scrape_on_each_sample(monkeypatch)
    _stall_after(monkeypatch, serve_mod, 13)
    serve_mod.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
                    "--requests", "2", "--prompt-len", "8", "--gen-len",
                    "16", *_flags(tmp_path, 16)])
    out = capsys.readouterr().out
    assert "[talp] prometheus exposition on :" in out
    assert "[talp fault] rank 0 plan:" in out
    assert "[talp watchdog]" in out
    # four samples (every 4 of 16 tokens) and the final one
    _check_outputs(tmp_path, scrapes, 5, "decode_step", 16)


def test_train_cli_every_flag_on_cpu(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import train as train_mod

    scrapes = _scrape_on_each_sample(monkeypatch)
    _stall_after(monkeypatch, train_mod, 9, seconds=0.2)
    train_mod.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
                    "--steps", "12", "--batch", "2", "--seq", "16",
                    *_flags(tmp_path, 12)])
    out = capsys.readouterr().out
    assert "[talp sample] step 3 ranks=1" in out
    _check_outputs(tmp_path, scrapes, 4, "step", 12)
