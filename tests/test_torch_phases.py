"""Phase spans inside the port's train step (repro_torch.core.telemetry.
phases) on the CPU: the recorder's contract (nothing recorded without
one, parents, the bounded ring), the three spans of one step of a small
mamba2 through a started CPU backend (numerics unchanged), the join of
spans with device intervals (launch/talp_outputs.py::join_phases) on
hand-made intervals, the ``--talp-json`` file with and without spans, and
the benchmark's phase readers. The device windows on the card are tested
in tests/test_torch_gpu.py."""

import json
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.checkpointer import flatten_with_keys  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import TalpMonitor  # noqa: E402
from repro_torch.core.backends import CudaRuntimeBackend  # noqa: E402
from repro_torch.core.report import to_json  # noqa: E402
from repro_torch.core.telemetry import overhead, phases  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline  # noqa: E402
from repro_torch.launch.steps import init_train_state, make_train_step  # noqa: E402
from repro_torch.launch.talp_outputs import (  # noqa: E402
    TalpOutputs, join_phases, phase_table)
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(autouse=True)
def _restore_globals():
    """Each test leaves the process's recorder and accumulator as it found
    them."""
    rec, acc = phases.current(), overhead.current()
    yield
    phases.install(rec)
    overhead.install(acc)


def test_section_without_a_recorder_records_nothing():
    acc = overhead.OverheadAccumulator()
    overhead.install(acc)
    phases.install(None)
    with phases.section("forward") as span:
        assert span is None
    assert phases.current() is None
    assert acc.counts == {} and acc.total == 0.0


def test_section_records_name_parent_and_host_window():
    clk = FakeClock()
    rec = phases.PhaseRecorder(clock=clk)
    phases.install(rec)
    acc = overhead.OverheadAccumulator()
    overhead.install(acc)
    with phases.section("outer") as outer:
        clk.advance(1.0)
        with phases.section("inner") as inner:
            clk.advance(2.0)
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            phases.current().begin("other")))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert [s.name for s in rec.spans()] == ["outer", "inner", "other"]
    assert inner.parent == outer.seq and outer.parent is None
    assert seen[0].parent is None          # another thread: no parent
    assert (outer.t0, outer.t1) == (0.0, 3.0)
    assert (inner.t0, inner.t1) == (1.0, 3.0)
    # the CPU: the device window is the host window
    assert (inner.d0, inner.d1) == (inner.t0, inner.t1)
    assert rec.counts == {"outer": 1, "inner": 1, "other": 1}
    # two bookkeeping sections per ended span, one per begun one
    assert acc.counts["phases"] == 5


def test_ring_overflow_counts_the_spans_dropped():
    rec = phases.PhaseRecorder(capacity=4, clock=FakeClock())
    phases.install(rec)
    for i in range(10):
        with phases.section("even" if i % 2 == 0 else "odd"):
            pass
    assert rec.dropped == 6
    assert [s.seq for s in rec.spans()] == [6, 7, 8, 9]
    assert rec.counts == {"even": 5, "odd": 5}
    with pytest.raises(ValueError):
        phases.PhaseRecorder(capacity=0)


def test_threads_sharing_a_recorder_lose_no_span():
    """8 threads of 500 nested span pairs each on one recorder (ring of
    256), the interpreter switching threads every microsecond: every span
    is counted, each seq is given once, the ring holds the latest 256 and
    each inner span's parent is its own thread's outer span."""
    rec = phases.PhaseRecorder(capacity=256)
    phases.install(rec)
    n_threads, pairs = 8, 500
    wrong = []

    def work():
        for _ in range(pairs):
            with phases.section("outer") as outer:
                with phases.section("inner") as inner:
                    if inner.parent != outer.seq:
                        wrong.append((inner, outer))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not wrong
    total = 2 * n_threads * pairs
    assert rec.counts == {"outer": total // 2, "inner": total // 2}
    assert rec.dropped == total - 256
    assert [s.seq for s in rec.spans()] == list(range(total - 256, total))


def _leaves(state):
    return dict(flatten_with_keys(state))


def _mamba_step_inputs():
    cfg = smoke_config("mamba2-130m")
    state = init_train_state(cfg, torch.Generator().manual_seed(5), "cpu")
    batch = SyntheticTokenPipeline(
        DataConfig(2, 48, cfg.vocab_size, seed=6)).batch_at(0)
    return cfg, state, {k: torch.from_numpy(v) for k, v in batch.items()}


def test_cpu_train_step_records_forward_backward_adamw_in_the_launch():
    """One step of smoke mamba2 launched through a started CPU backend
    records forward, backward and adamw, top level, in order, without
    overlap and inside the launch's host window; its new state and metrics
    are bit-identical to the same step with no recorder installed."""
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    cfg, state, batch = _mamba_step_inputs()
    step = make_train_step(cfg, opt)
    phases.install(None)
    plain_state, plain_metrics = step(state, batch)

    cfg, state, batch = _mamba_step_inputs()
    be = CudaRuntimeBackend("cpu")
    mon = TalpMonitor("phases", backend=be)
    assert phases.current() is be.phases
    h = be.launch(step, state, batch, name="train_step")
    after = be.clock()
    with mon.offload():
        new_state, metrics = be.wait(h)
    mon.finalize()
    spans = be.phases.spans()
    assert [s.name for s in spans] == ["forward", "backward", "adamw"]
    assert all(s.parent is None for s in spans)
    assert h.launch_t <= spans[0].t0
    for a, b in zip(spans, spans[1:]):
        assert a.t0 < a.t1 <= b.t0 < b.t1
    assert spans[-1].t1 <= after
    # stays readable after stop()
    assert phases.current() is be.phases and not be.enabled
    for key, want in _leaves(plain_state).items():
        assert torch.equal(_leaves(new_state)[key], want), key
    for key, want in plain_metrics.items():
        assert torch.equal(metrics[key], want), key


def _placed(rec, name, host, device):
    span = rec.begin(name)
    rec.end(span)
    span.t0, span.t1 = host
    span.d0, span.d1 = device
    return span


# Two steps on hand-made device windows (seconds), and rows that straddle
# span edges: busy is the union of Kernel and Memory inside each window.
KERNEL = [(0.5, 1.5), (2.0, 2.5), (2.9, 3.2), (4.0, 4.5), (5.8, 6.4),
          (7.0, 7.5), (9.5, 10.5)]
MEMORY = [(1.2, 1.8), (6.2, 6.6), (8.0, 8.2), (10.4, 10.6)]
STEPS = [
    # (name, host window, device window)
    ("forward", (0.0, 1.0), (1.0, 3.0)),
    ("backward", (1.0, 2.0), (3.0, 5.0)),
    ("adamw", (2.0, 2.5), (5.0, 6.0)),
    ("forward", (2.7, 3.0), (6.5, 7.2)),
    ("backward", (3.0, 3.5), (7.2, 9.0)),
    ("adamw", (3.5, 3.6), (9.0, 10.0)),
]
# busy by hand: [1, 3]: (1, 1.8) 0.8 + (2, 2.5) 0.5 + (2.9, 3) 0.1
WANT_BUSY = [1.4, 0.7, 0.2, 0.3, 0.5, 0.5]
# outside [6.0, 6.5]: inside the union's (5.8, 6.6), all busy
WANT_OUTSIDE = (0.5, 0.0)


@pytest.mark.parametrize("memory_first", [False, True])
def test_join_gives_exact_busy_idle_and_outside(memory_first):
    rec = phases.PhaseRecorder(clock=FakeClock())
    spans = [_placed(rec, *step) for step in STEPS]
    kernel, memory = np.array(KERNEL), np.array(MEMORY)
    if memory_first:   # the arrays' roles swapped: a union either way
        kernel, memory = memory, kernel
    join_phases(rec, kernel, memory)
    for span, busy in zip(spans, WANT_BUSY):
        assert span.busy == pytest.approx(busy, abs=1e-12), span
        assert span.idle == pytest.approx((span.d1 - span.d0) - busy,
                                          abs=1e-12)
        assert span.busy + span.idle == pytest.approx(span.d1 - span.d0)
    [gap] = rec.outside
    assert (gap.d0, gap.d1) == (6.0, 6.5) and (gap.t0, gap.t1) == (2.5, 2.7)
    assert (gap.busy, gap.idle) == pytest.approx(WANT_OUTSIDE, abs=1e-12)
    table = phase_table(rec)
    assert list(table["rows"]) == ["forward", "backward", "adamw", "outside"]
    fwd = table["rows"]["forward"]
    assert fwd["spans"] == 2
    assert fwd["busy_ms"] == pytest.approx(1e3 * (1.4 + 0.3) / 2)
    assert fwd["window_ms"] == pytest.approx(1e3 * (2.0 + 0.7) / 2)
    assert fwd["host_ms"] == pytest.approx(1e3 * (1.0 + 0.3) / 2)
    assert fwd["busy_share"] == pytest.approx(1.7 / 2.7)
    assert table["spans_dropped"] == 0 and table["lost_markers"] is None


def test_join_skips_unplaced_spans_and_nested_ones_make_no_outside():
    rec = phases.PhaseRecorder(clock=FakeClock())
    a = _placed(rec, "adamw", (0.0, 1.0), (0.0, 1.0))
    inner = _placed(rec, "forward", (1.5, 1.6), (1.5, 1.6))
    inner.parent = a.seq            # nested: not a step's start
    open_span = rec.begin("forward")
    join_phases(rec, np.array([(0.0, 2.0)]), np.empty((0, 2)))
    assert rec.outside == []
    assert inner.busy == pytest.approx(0.1)
    assert open_span.busy is None


def _talp_run(tmp_path, with_step, verbose=False):
    """A CPU monitor through TalpOutputs: two launches, of the smoke
    mamba2 train step or of a plain function; the written JSON and the
    result."""
    be = CudaRuntimeBackend("cpu")
    talp = TalpOutputs("t", be, "step", lambda: 0.0, verbose=verbose)
    cfg, state, batch = _mamba_step_inputs()
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=2))
    with talp.mon.region("loop"):
        for _ in range(2):
            if with_step:
                h = be.launch(step, state, batch, name="train_step")
            else:
                h = be.launch(lambda: torch.ones(64).sum(), name="plain")
            with talp.mon.offload():
                out = be.wait(h)
            if with_step:
                state = out[0]
    path = tmp_path / "talp.json"
    result = talp.finish(str(path))
    return path.read_text(), result, be


def test_a_run_with_no_span_writes_the_same_talp_json(tmp_path):
    text, result, be = _talp_run(tmp_path, with_step=False)
    assert be.phases.counts == {}
    assert text == to_json(result)


def test_a_run_with_spans_adds_the_phase_table(tmp_path, capsys):
    text, result, be = _talp_run(tmp_path, with_step=True, verbose=True)
    payload = json.loads(text)
    table = payload.pop("phases")
    assert json.dumps(payload, indent=2) == to_json(result)
    assert list(table["rows"]) == ["forward", "backward", "adamw", "outside"]
    assert [r["spans"] for r in table["rows"].values()] == [2, 2, 2, 1]
    for name, row in table["rows"].items():
        assert row["busy_ms"] + row["idle_ms"] == pytest.approx(
            row["window_ms"]), name
    assert table["lost_markers"] == 0 and table["dropped"] is None
    out = capsys.readouterr().out
    assert "[talp phases]" in out and "lost markers 0" in out


PHASE_READERS = [f"{p}_{q}_ms.train" for q in ("host", "busy", "idle")
                 for p in ("forward", "backward", "adamw")] + [
    "step_gap_idle_ms.train", "talp_ms.train"]


def _reader(name):
    from perfbench import harness

    return harness._reader(name)


def _record_for(rec_spans, window_start, seconds):
    return {"window_start": window_start, "attempted": 3,
            "window": {"seconds": seconds, "talp_overhead_s": 0.0015}}


@pytest.mark.parametrize("name", PHASE_READERS)
def test_phase_readers_read_the_window_as_floats_or_none(name, monkeypatch):
    rec = phases.PhaseRecorder(clock=FakeClock())
    for step in STEPS:
        _placed(rec, *step)
    join_phases(rec, np.array(KERNEL), np.array(MEMORY))
    phases.install(rec)
    read = _reader(name)
    # a window holding the second step only (host starts 2.7 .. 3.6) and
    # the gap before it (host start 2.5)
    value = read(_record_for(rec, 2.5, 1.2), None)
    assert isinstance(value, float)
    want = {
        "forward_host_ms.train": 300.0, "backward_host_ms.train": 500.0,
        "adamw_host_ms.train": 100.0, "forward_busy_ms.train": 300.0,
        "backward_busy_ms.train": 500.0, "adamw_busy_ms.train": 500.0,
        "forward_idle_ms.train": 400.0, "backward_idle_ms.train": 1300.0,
        "adamw_idle_ms.train": 500.0, "step_gap_idle_ms.train": 0.0,
        "talp_ms.train": 0.5}[name]
    assert value == pytest.approx(want)
    # a window with no span
    empty = read(_record_for(rec, 100.0, 1.0), None)
    assert empty is None or name == "talp_ms.train"
    # no recorder, and a program without the module (the parent commit)
    phases.install(None)
    assert read(_record_for(rec, 2.5, 1.2), None) in (None, 0.5)
    monkeypatch.setitem(__import__("sys").modules,
                        "repro_torch.core.telemetry.phases", None)
    assert read(_record_for(rec, 2.5, 1.2), None) in (None, 0.5)
