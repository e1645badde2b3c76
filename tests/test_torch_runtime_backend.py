"""The port's runtime backend (repro_torch.core.backends.cuda_runtime)
under the copied TalpMonitor: the semantics of
tests/test_talp_monitor.py::test_runtime_backend_async_overlap and
::test_instrument_prefers_backend_records on the CPU path, and the
per-kernel device path driven by a fake activity source (rows on a clock
of integer nanoseconds, as Kineto's): its report equals the one
repro.core's engine gives for the same intervals. The CUPTI collection
itself is tested on the card: tests/test_torch_gpu.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro_torch.core import DeviceActivity, TalpMonitor  # noqa: E402
from repro_torch.core.backends import CudaRuntimeBackend  # noqa: E402


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def test_cpu_launch_wait_records_the_host_window():
    clk = FakeClock()
    be = CudaRuntimeBackend("cpu", clock=clk)
    mon = TalpMonitor("t", clock=clk, backend=be)

    def work(x):
        clk.advance(2.0)      # eager compute inside launch
        return x + 1

    with mon.region("step"):
        h = be.launch(work, torch.ones(3), name="k")
        clk.advance(1.0)      # host useful work before waiting
        with mon.offload():
            clk.advance(0.5)
            out = be.wait(h)
    assert torch.equal(out, torch.full((3,), 2.0))
    r = mon.finalize()["step"]
    assert r.device_states[0]["kernel"] == pytest.approx(3.5)
    assert r.host_states[0]["offload"] == pytest.approx(0.5)
    assert r.host_states[0]["useful"] == pytest.approx(3.0)
    r.host.validate()
    r.device.validate()


def test_cpu_async_overlap_real_clock():
    be = CudaRuntimeBackend("cpu")
    mon = TalpMonitor("async", backend=be)
    x = torch.ones(256, 256)
    with mon.region("step"):
        h = be.launch(lambda a: torch.tanh(a @ a).sum(), x, name="k")
        acc = sum(i * i for i in range(10000))
        with mon.offload():
            be.wait(h)
    assert acc > 0
    r = mon.finalize()["step"]
    assert r.device_states[0]["kernel"] > 0
    assert r.host_states[0]["useful"] > 0


def test_instrument_prefers_backend_records():
    clk = FakeClock()
    be = CudaRuntimeBackend("cpu", clock=clk)
    mon = TalpMonitor(clock=clk, backend=be)

    def fake_kernel(x):
        clk.advance(3.0)
        return x

    f = mon.instrument(fake_kernel, name="k")
    with mon.region("r"):
        clk.advance(1.0)
        f(0)
    r = mon.finalize()["r"]
    assert mon.devices[0].n_records == 1
    assert r.device_states[0]["kernel"] == pytest.approx(3.0)
    assert r.host_states[0]["offload"] == pytest.approx(3.0)
    assert r.host_states[0]["useful"] == pytest.approx(1.0)
    r.host.validate()
    r.device.validate()


def test_record_transfer_and_stop_drains_pending():
    clk = FakeClock()
    be = CudaRuntimeBackend("cpu", clock=clk)
    mon = TalpMonitor(clock=clk, backend=be)

    def copy(x):
        clk.advance(1.0)
        return x.clone()

    with mon.region("r"):
        be.record_transfer(copy, torch.ones(2))
        be.launch(lambda: clk.advance(2.0))   # never waited: stop() drains
    mon.finalize()
    assert len(mon.devices[0].kind_intervals(DeviceActivity.MEMORY)) == 1
    # as in the JAX backend, finalize() flushes before stop() drains, so
    # the drained launch stays in the backend's buffer
    assert not be._pending
    [(dev, kinds, starts, ends, _)] = be.flush_arrays()
    assert dev == 0 and list(kinds) == [DeviceActivity.KERNEL.code]
    assert ends[0] - starts[0] == pytest.approx(2.0)


# An epoch far from the monitor clock's origin, as Kineto's Unix-time
# nanoseconds are from time.perf_counter's.
EPOCH_NS = 1_792_223_531_083_133_785


class FakeActivity:
    """Stands in for KinetoActivity: rows injected on the monitor clock
    are handed out at close() in integer nanoseconds since EPOCH_NS, with
    correlation ids in the order of injection."""

    def __init__(self, clock):
        self.clock = clock
        self.rows = []
        self.opens = 0
        self.is_open = False

    def now_ns(self):
        return EPOCH_NS + round(self.clock() * 1e9)

    def open(self):
        self.opens += 1
        self.is_open = True

    def inject(self, kind, start, end, stream=7, dev=0):
        self.rows.append((dev, kind.code, EPOCH_NS + round(start * 1e9),
                          EPOCH_NS + round(end * 1e9), stream,
                          len(self.rows) + 1))

    def close(self):
        self.is_open = False
        rows, self.rows = self.rows, []
        out = []
        for dev in sorted({r[0] for r in rows}):
            mine = [r for r in rows if r[0] == dev]
            out.append((dev, np.array([r[1] for r in mine], np.uint8),
                        np.array([r[2] for r in mine], np.int64),
                        np.array([r[3] for r in mine], np.int64),
                        np.array([r[4] for r in mine], np.uint32),
                        np.array([r[5] for r in mine], np.int64)))
        return out


K, M = DeviceActivity.KERNEL, DeviceActivity.MEMORY


def _step_rows(t0):
    """The rows of one eager step starting at t0: three kernels with host
    gaps between them, a memcpy, and a kernel on a second stream that
    overlaps the first."""
    return [(K, t0 + 0.10, t0 + 0.30, 7), (K, t0 + 0.20, t0 + 0.25, 9),
            (K, t0 + 0.90, t0 + 1.00, 7), (M, t0 + 1.05, t0 + 1.10, 7),
            (K, t0 + 1.60, t0 + 1.80, 7)]


def _serve_like(backend, mon, clk, inject):
    """prefill, then three decode steps, as repro_torch.launch.serve drives
    the backend; ``inject`` delivers each step's device rows."""

    def step(t0):
        def fn():
            for kind, s, e, stream in _step_rows(t0):
                inject(kind, s, e, stream)
            clk.advance(1.2)        # the host enqueues the step's kernels
            return t0
        return fn

    with mon.region("prefill"):
        h = backend.launch(step(clk()), name="prefill")
        with mon.offload():
            clk.advance(0.7)
            backend.wait(h)
    with mon.region("decode"):
        for _ in range(3):
            clk.advance(0.05)       # tok.cpu(), argmax
            h = backend.launch(step(clk()), name="decode")
            with mon.offload():
                clk.advance(0.65)
                backend.wait(h)
    return mon.finalize()


def test_activity_rows_give_the_reference_engine_report():
    """The same device intervals: injected as activity rows into the
    port's backend, and added as records to repro.core's monitor. Device
    Kernel, Memory, Idle and every device metric agree in every region."""
    clk = FakeClock()
    src = FakeActivity(clk)
    be = CudaRuntimeBackend("cpu", clock=clk, activity=src)
    got = _serve_like(be, TalpMonitor("t", clock=clk, backend=be), clk,
                      src.inject)

    jclk = FakeClock()
    jmon = jcore.TalpMonitor("t", clock=jclk)

    def add(kind, s, e, stream):
        jmon.add_device_record(0, jcore.DeviceActivity.from_code(kind.code),
                               s, e, stream=stream)

    want = _serve_like(_NoBackend(jclk), jmon, jclk, add)
    assert src.opens == 1 and not src.is_open
    for name in ("Global", "prefill", "decode"):
        g, w = got[name], want[name]
        for state in ("kernel", "memory", "idle"):
            assert g.device_states[0][state] == pytest.approx(
                w.device_states[0][state], abs=1e-9), (name, state)
        for field, val in w.device.as_dict().items():
            assert g.device.as_dict()[field] == pytest.approx(
                val, abs=1e-9), (name, field)
        g.device.validate()
    # 4 kernel-busy spans of 0.2 + 0.1 + 0.2 = 0.5 s per step, 4 steps
    assert got["Global"].device_states[0]["kernel"] == pytest.approx(2.0)
    assert got["Global"].device_states[0]["memory"] == pytest.approx(0.2)


class _NoBackend:
    """launch/wait for the reference side, which gets its device records
    directly: runs the step and records nothing."""

    def __init__(self, clock):
        self.clock = clock

    def launch(self, fn, name=""):
        return fn()

    def wait(self, handle):
        return handle


def test_host_gap_inside_one_launch_is_device_idle():
    """Two kernels in one launch/wait window with a host gap between them:
    the gap is device Idle, not Kernel (a record spanning the launch would
    count all 3 s as Kernel)."""
    clk = FakeClock()
    src = FakeActivity(clk)
    be = CudaRuntimeBackend("cpu", clock=clk, activity=src)
    mon = TalpMonitor("gap", clock=clk, backend=be)

    def step():
        src.inject(K, clk(), clk() + 0.5)
        clk.advance(2.0)                      # host sleeps between kernels
        src.inject(K, clk(), clk() + 0.5)
        clk.advance(0.5)

    with mon.region("step"):
        h = be.launch(step, name="step")
        with mon.offload():
            clk.advance(0.5)
            be.wait(h)
    r = mon.finalize()["step"]
    assert r.elapsed == pytest.approx(3.0)
    assert r.device_states[0]["kernel"] == pytest.approx(1.0)
    assert r.device_states[0]["idle"] == pytest.approx(2.0)
    assert r.device.parallel_efficiency == pytest.approx(1.0 / 3.0)
    assert r.host_states[0]["offload"] == pytest.approx(0.5)


def test_rows_carry_their_stream_and_device():
    clk = FakeClock()
    src = FakeActivity(clk)
    be = CudaRuntimeBackend("cpu", clock=clk, activity=src)
    be.start()
    h = be.launch(lambda: (src.inject(K, 1.0, 2.0, stream=13),
                           src.inject(M, 2.5, 3.0, stream=7, dev=1)))
    be.wait(h)
    (d0, k0, s0, e0, st0), (d1, k1, s1, e1, st1) = be.flush_arrays()
    assert (d0, list(k0), list(st0)) == (0, [K.code], [13])
    assert (d1, list(k1), list(st1)) == (1, [M.code], [7])
    np.testing.assert_allclose([s0[0], e0[0], s1[0], e1[0]],
                               [1.0, 2.0, 2.5, 3.0], atol=1e-9)
    assert not src.is_open


def test_no_device_rows_after_a_launch_raises():
    """No fallback to a record spanning the launch: a collection that saw
    nothing while work was launched is an error."""
    clk = FakeClock()
    src = FakeActivity(clk)
    be = CudaRuntimeBackend("cpu", clock=clk, activity=src)
    mon = TalpMonitor("empty", clock=clk, backend=be)
    with mon.region("step"):
        be.wait(be.launch(lambda: clk.advance(1.0)))
    with pytest.raises(RuntimeError, match="no device rows"):
        mon.finalize()
    assert not src.is_open


def test_stop_closes_the_collection_and_a_launch_after_a_flush_reopens():
    clk = FakeClock()
    src = FakeActivity(clk)
    be = CudaRuntimeBackend("cpu", clock=clk, activity=src)
    mon = TalpMonitor("t", clock=clk, backend=be)
    with mon.region("a"):
        be.wait(be.launch(lambda: src.inject(K, clk(), clk() + 1.0)))
        clk.advance(1.0)
    mon.sample("a")                 # a flush closes the collection
    assert not src.is_open and src.opens == 1
    with mon.region("b"):
        be.wait(be.launch(lambda: src.inject(K, clk(), clk() + 0.5)))
        assert src.is_open and src.opens == 2
        clk.advance(1.0)
    result = mon.finalize()
    assert result["b"].device_states[0]["kernel"] == pytest.approx(0.5)
    assert not src.is_open
    # stop() alone (no flush) closes it too and keeps its rows
    be2 = CudaRuntimeBackend("cpu", clock=clk, activity=FakeActivity(clk))
    be2.start()
    be2.launch(lambda: be2.activity.inject(K, 0.0, 1.0))
    be2.stop()
    assert not be2.activity.is_open
    [(_, kinds, _, _, _)] = be2.flush_arrays()
    assert list(kinds) == [K.code]


def _marked_batch(true_marks, work, kineto_ns, lose_first_blocker=False,
                  lose_marker=None):
    """One activity batch as the card gives it: on side stream 3, a
    blocker (400,000 cycles: 0.2 ms at 2 GHz) and a marker kernel of 1 +
    10,000 (k mod 8) cycles for marker k, on stream 7 the work rows
    launched between the markers, correlation ids in launch order, times
    through ``kineto_ns``; ``lose_marker`` drops that marker's row."""
    side, main = 3, 7
    rows = []

    def add(s, e, stream):
        rows.append((K.code, kineto_ns(s), kineto_ns(e), stream,
                     len(rows) + 1))

    for m, t_mark in enumerate(true_marks):
        if not (lose_first_blocker and m == 0):
            add(t_mark - 2e-4, t_mark, side)
        if m != lose_marker:
            add(t_mark, t_mark + 1e-6 + (m % 8) * 5e-6, side)
        nxt = true_marks[m + 1] if m + 1 < len(true_marks) else 99.0
        for s, e in work:
            if t_mark < s < nxt:
                add(s, e, main)
    cols = [np.array([r[i] for r in rows]) for i in range(5)]
    return (0, cols[0].astype(np.uint8), cols[1].astype(np.int64),
            cols[2].astype(np.int64), cols[3].astype(np.uint32),
            cols[4].astype(np.int64))


def test_markers_place_rows_through_a_drifting_and_jumping_clock():
    """The card's placement (_place): rows whose source clock runs 2.6%
    slow are put back on the monitor clock by the markers around them
    (their true times are CUDA events, faked here), launch order taken
    from correlation ids; a jump of 0.3 s inside one launch's window
    moves rows only within that window. The markers' rows, on the side
    stream, are dropped; a missing first blocker (CUPTI may miss a
    collection's first kernel) does not matter, and a lost marker row is
    told by the codes of the others and skipped."""
    be = CudaRuntimeBackend("cpu")
    true_marks = [10.0, 10.5, 11.0, 12.0, 12.5]
    be._marks = list(range(len(true_marks)))
    be._event_time = lambda m: true_marks[m]
    work = [(10.1, 10.3), (10.35, 10.4), (10.6, 10.9), (11.2, 11.4),
            (11.6, 11.9), (12.1, 12.4)]

    def kineto_ns(t):                       # slow, and back 0.3 s after 11.5
        return round((t * 0.974 - (0.3 if t > 11.5 else 0.0)) * 1e9) + EPOCH_NS

    for lose, lost in ((False, None), (True, None), (False, 1), (True, 0)):
        [(dev, kinds, starts, ends, streams)] = be._place(
            [_marked_batch(true_marks, work, kineto_ns, lose, lost)])
        assert dev == 0 and set(streams) == {7} and len(kinds) == len(work)
        got = np.c_[starts, ends][np.argsort(starts)]
        clean = [0, 1, 2, 5]                # windows with no jump inside
        np.testing.assert_allclose(got[clean], np.array(work)[clean],
                                   atol=2e-6)
        jumped = got[[3, 4]]                # the window [11.0, 12.0]
        assert (jumped >= 11.0 - 5e-4).all() and (jumped <= 12.0).all()
    # the lost rows of markers 1 and 0: their events skipped, counted
    assert be.lost_markers == 2
    # one marker left (the other lost): Kineto's own rate from it
    be.lost_markers, be._marks = 0, [0, 1]
    [(_, _, starts, ends, _)] = be._place([_marked_batch(
        true_marks[:2], work[:2], lambda t: round(t * 1e9) + EPOCH_NS,
        lose_marker=0)])
    np.testing.assert_allclose(np.c_[starts, ends], work[:2], atol=2e-6)
    assert be.lost_markers == 1
    be._marks = list(range(len(true_marks)))
    # a misread code (a marker kernel run at another clock) is outvoted
    be._marks = list(range(len(true_marks)))
    be.lost_markers = 0
    batch = _marked_batch(true_marks, work, kineto_ns, lose_marker=1)
    side = np.flatnonzero(batch[4] == 3)
    batch[3][side[-1]] += 5_000           # the last marker 5 us longer
    [(_, _, starts, _, _)] = be._place([batch])
    assert len(starts) == len(work) and be.lost_markers == 1
    # a missing marker is an error, not a guess
    # every code unreadable (the markers all waited for an SM): the gaps
    # between the markers still place the rows, a lost one included
    be.lost_markers = 0
    steady = lambda t: round(t * 1e9) + EPOCH_NS       # noqa: E731
    batch = _marked_batch(true_marks, work, steady, lose_marker=2)
    side = np.flatnonzero((batch[4] == 3) & (batch[3] - batch[2] < 100_000))
    batch[3][side] = batch[2][side] + 60_000
    [(_, _, starts, ends, _)] = be._place([batch])
    np.testing.assert_allclose(np.c_[starts, ends][np.argsort(starts)], work,
                               atol=2e-6)
    assert be.lost_markers == 1
    be._marks = be._marks[:-1]
    with pytest.raises(RuntimeError, match="marker"):
        be._place([_marked_batch(true_marks, work, kineto_ns)])


def test_markers_place_rows_when_the_collection_lost_its_last_rows():
    """CUPTI may lose a collection's last rows, the closing marker's
    among them: the side stream is then the latest stream with no more
    short kernel rows than markers launched, not the stream of the work
    launched last, and the rows are placed as before."""
    be = CudaRuntimeBackend("cpu")
    true_marks = [10.0, 10.5, 11.0, 11.5]
    be._marks = list(range(len(true_marks)))
    be._event_time = lambda m: true_marks[m]
    # short work rows, more of them than markers, some launched after the
    # last marker whose rows survive
    work = [(t0 + 0.01 * k, t0 + 0.01 * k + 2e-6)
            for t0 in (10.1, 11.1) for k in range(30)]
    steady = lambda t: round(t * 1e9) + EPOCH_NS       # noqa: E731
    batch = _marked_batch(true_marks, work, steady)
    keep = np.ones(len(batch[1]), dtype=bool)
    keep[np.flatnonzero(batch[4] == 3)[-2:]] = False   # the closing marker
    batch = (batch[0],) + tuple(col[keep] for col in batch[1:])
    assert batch[4][np.argmax(batch[5])] == 7           # work launched last
    [(_, _, starts, ends, streams)] = be._place([batch])
    assert set(streams) == {7} and len(starts) == len(work)
    np.testing.assert_allclose(np.c_[starts, ends][np.argsort(starts)],
                               work, atol=2e-6)
    assert be.lost_markers == 1


@pytest.mark.parametrize("per_ns", [1.0, 2.1, 3.0])
def test_cupti_stamps_convert_to_nanoseconds(per_ns):
    """CUPTI counts wall-clock ns, or a registered callback's units (the
    CPU's time-stamp counter once a profiler has run): the stamps come out
    as ns since the open, at the rate of CUPTI's clock against the host's
    over the collection."""
    from repro_torch.core.backends.cuda_runtime import cupti_ns

    origin = 1_792_244_520_031_955_589
    opened = (origin, 17.25)
    closed = (origin + round(0.5e9 * per_ns), 17.75)
    raw = origin + np.rint(np.array([0, 1_000, 250_000_000]) * per_ns
                           ).astype(np.int64)
    np.testing.assert_array_equal(
        cupti_ns(raw, opened, closed),
        [0, 1_000, 250_000_000])
