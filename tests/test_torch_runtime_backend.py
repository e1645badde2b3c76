"""The port's runtime backend (repro_torch.core.backends.cuda_runtime)
under the copied TalpMonitor: the semantics of
tests/test_talp_monitor.py::test_runtime_backend_async_overlap and
::test_instrument_prefers_backend_records on the CPU path. The CUDA
event path is tested on the card: tests/test_torch_gpu.py."""

import pytest

torch = pytest.importorskip("torch")

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
