"""Live CUDA runtime backend — the port of ``repro.core.backends.runtime``.

Same two paths as the JAX backend:

  * host path: the monitor's ``offload()`` scopes around ``wait()`` (the
    host blocked on the device);
  * device path: ``launch()`` records a ``torch.cuda.Event`` before and
    after the work it enqueues on the current stream; ``wait()``
    synchronises on the end event and emits a KERNEL record spanning the
    two events. ``record_transfer()`` does the same for a MEMORY record.

CUDA event times are GPU timestamps, valid only once the end event has
completed, and measured relative to another event. They are mapped onto
the monitor's clock through one anchor event recorded at ``start()``,
right after a ``torch.cuda.synchronize()``, when GPU and host clocks are
read together. Without the mapping the KERNEL records would fall outside
the host's region windows and the device hierarchy would be wrong.

For CPU tensors (``device="cpu"``) ``launch``/``wait`` use host timing,
exactly as the JAX backend did on its CPU "device".
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Union

import numpy as np
import torch

from ..states import DeviceActivity, DeviceRecord
from ..telemetry import overhead as _ovh
from .base import register_backend

__all__ = ["CudaRuntimeBackend", "AsyncHandle"]


class _DeviceColumns:
    """Per-device scalar-append column buffer (kind/start/end/stream)."""

    __slots__ = ("kinds", "starts", "ends", "streams")

    def __init__(self):
        self.kinds: List[int] = []
        self.starts: List[float] = []
        self.ends: List[float] = []
        self.streams: List[int] = []

    def append(self, kind: int, start: float, end: float, stream: int) -> None:
        self.kinds.append(kind)
        self.starts.append(start)
        self.ends.append(end)
        self.streams.append(stream)

    def drain(self):
        cols = (
            np.asarray(self.kinds, dtype=np.uint8),
            np.asarray(self.starts, dtype=np.float64),
            np.asarray(self.ends, dtype=np.float64),
            np.asarray(self.streams, dtype=np.uint32),
        )
        self.kinds, self.starts, self.ends, self.streams = [], [], [], []
        return cols


@dataclass
class AsyncHandle:
    """Tracks one launch: the work enqueued between two CUDA events (or,
    on the CPU, the host window of an eager call)."""

    out: Any
    launch_t: float
    device: int
    name: str
    stream: int = 0
    start_event: Optional[torch.cuda.Event] = None
    end_event: Optional[torch.cuda.Event] = None


@register_backend("cuda_runtime")
class CudaRuntimeBackend:
    """Collects device activity records from live PyTorch execution."""

    def __init__(self, device: Union[str, torch.device] = "cuda",
                 clock: Callable[[], float] = time.perf_counter):
        self.torch_device = torch.device(device)
        self.cuda = self.torch_device.type == "cuda"
        self.clock = clock
        self._columns: dict = {}  # dev -> _DeviceColumns
        self._pending: List[AsyncHandle] = []
        self._anchor: Optional[torch.cuda.Event] = None
        self._anchor_t = 0.0
        self.enabled = False

    # -- plugin lifecycle ------------------------------------------------
    def start(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.torch_device)
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record(torch.cuda.current_stream(self.torch_device))
            self._anchor_t = self.clock()
            anchor.synchronize()
            self._anchor = anchor
        self.enabled = True

    def stop(self) -> None:
        # Drain pending asynchronous work before disabling.
        for h in list(self._pending):
            self.wait(h)
        self.enabled = False

    def _event_time(self, event: torch.cuda.Event) -> float:
        """A completed event's GPU timestamp on the monitor's clock."""
        return self._anchor_t + self._anchor.elapsed_time(event) * 1e-3

    def _record(self, dev: int, kind: DeviceActivity, start: float,
                end: float, stream: int = 0) -> None:
        cols = self._columns.get(dev)
        if cols is None:
            cols = self._columns[dev] = _DeviceColumns()
        cols.append(kind.code, start, end, stream)

    def flush_arrays(self):
        """Drain buffered activity as per-device column batches."""
        with _ovh.section("flush"):
            return [
                (dev, *self._columns[dev].drain())
                for dev in sorted(self._columns)
            ]

    def flush(self):
        """Legacy object path: materialize ``DeviceRecord`` per event."""
        out = []
        for dev, kinds, starts, ends, streams in self.flush_arrays():
            out.extend(
                (dev, DeviceRecord(DeviceActivity.from_code(k), float(s),
                                   float(e), int(st)))
                for k, s, e, st in zip(kinds, starts, ends, streams)
            )
        return out

    # -- device activity (async path) ------------------------------------
    def _events(self):
        if self._anchor is None:
            raise RuntimeError("CudaRuntimeBackend.start() was not called")
        stream = torch.cuda.current_stream(self.torch_device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        return stream, start, end

    def launch(self, fn: Callable, *args, device: int = 0, name: str = "",
               stream: int = 0, **kwargs) -> AsyncHandle:
        """Enqueue ``fn``'s work without waiting for it; the device record
        is completed at ``wait()``. The host time of the call itself (in
        eager PyTorch: enqueueing every kernel) is charged by the caller's
        scope."""
        label = name or getattr(fn, "__name__", "fn")
        t0 = self.clock()
        start = end = None
        if self.cuda:
            cuda_stream, start, end = self._events()
            start.record(cuda_stream)
        out = fn(*args, **kwargs)
        if end is not None:
            end.record(cuda_stream)
        h = AsyncHandle(out, t0, device, label, stream, start, end)
        self._pending.append(h)
        return h

    def wait(self, handle: AsyncHandle) -> Any:
        """Block until the work is done; emit the kernel activity record."""
        if handle.end_event is not None:
            handle.end_event.synchronize()
            start = self._event_time(handle.start_event)
            end = self._event_time(handle.end_event)
        else:
            start, end = handle.launch_t, self.clock()
        if self.enabled:
            self._record(handle.device, DeviceActivity.KERNEL, start, end,
                         handle.stream)
        if handle in self._pending:
            self._pending.remove(handle)
        return handle.out

    def record_transfer(self, fn: Callable, *args, device: int = 0,
                        name: str = "transfer", **kwargs) -> Any:
        """Time a host↔device data movement as a MEMORY record."""
        if not self.cuda:
            t0 = self.clock()
            out = fn(*args, **kwargs)
            t1 = self.clock()
        else:
            cuda_stream, start, end = self._events()
            start.record(cuda_stream)
            out = fn(*args, **kwargs)
            end.record(cuda_stream)
            end.synchronize()
            t0, t1 = self._event_time(start), self._event_time(end)
        if self.enabled:
            self._record(device, DeviceActivity.MEMORY, t0, t1)
        return out
