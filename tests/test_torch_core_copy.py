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
