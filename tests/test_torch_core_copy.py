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
