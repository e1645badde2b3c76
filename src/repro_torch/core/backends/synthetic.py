"""Synthetic trace construction — the PILS substrate.

PILS (paper §5.1) is a microbenchmark that *constructs controlled
execution patterns* (imbalance, offload, transfers, overlap) to validate
the metrics. This builder is the pattern-construction engine: cursors
advance per rank and per device, states are appended sequentially, and
``barrier()`` models an MPI blocking synchronization (laggard ranks wait
in MPI until the slowest arrives) — exactly how the paper's traces are
shaped (red MPI regions while waiting for rank 0, etc.).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..recordio import as_record_columns
from ..states import DeviceActivity, DeviceRecord, HostState, Trace
from .base import register_backend

__all__ = ["SyntheticTraceBuilder", "SyntheticBackend"]


@dataclass
class _RankCursor:
    builder: "SyntheticTraceBuilder"
    rank: int
    t: float = 0.0

    def _host(self, state: HostState, dur: float) -> "_RankCursor":
        if dur < 0:
            raise ValueError("negative duration")
        self.builder.trace.host(self.rank).add(state, dur)
        self.t += dur
        return self

    def useful(self, dur: float) -> "_RankCursor":
        return self._host(HostState.USEFUL, dur)

    def mpi(self, dur: float) -> "_RankCursor":
        return self._host(HostState.MPI, dur)

    def offload(self, dur: float) -> "_RankCursor":
        """Host blocked in device runtime calls for `dur` seconds."""
        return self._host(HostState.OFFLOAD, dur)

    # -- combined host+device idioms used by PILS patterns -------------
    def offload_kernel(self, dur: float, device: Optional[int] = None,
                       stream: int = 0) -> "_RankCursor":
        """Synchronous offload: host blocked while its GPU runs a kernel."""
        dev = self.rank if device is None else device
        self.builder.trace.device(dev).add(
            DeviceActivity.KERNEL, self.t, self.t + dur, stream=stream
        )
        return self._host(HostState.OFFLOAD, dur)

    def offload_memory(self, dur: float, device: Optional[int] = None,
                       stream: int = 0) -> "_RankCursor":
        """Synchronous transfer: host blocked while data moves."""
        dev = self.rank if device is None else device
        self.builder.trace.device(dev).add(
            DeviceActivity.MEMORY, self.t, self.t + dur, stream=stream
        )
        return self._host(HostState.OFFLOAD, dur)

    def async_kernel(self, dur: float, device: Optional[int] = None,
                     launch: float = 0.0, stream: int = 0) -> "_RankCursor":
        """Asynchronous launch: kernel starts now; host continues (use
        case 7's overlapped execution). ``launch`` charges a small host
        offload cost for the launch call itself."""
        dev = self.rank if device is None else device
        self.builder.trace.device(dev).add(
            DeviceActivity.KERNEL, self.t + launch, self.t + launch + dur,
            stream=stream,
        )
        if launch > 0:
            self._host(HostState.OFFLOAD, launch)
        return self


@dataclass
class SyntheticTraceBuilder:
    nranks: int = 2
    ndevices: Optional[int] = None
    name: str = "synthetic"
    trace: Trace = field(init=False)
    _cursors: Dict[int, _RankCursor] = field(init=False, default_factory=dict)

    def __post_init__(self):
        self.trace = Trace(name=self.name)
        if self.ndevices is None:
            self.ndevices = self.nranks
        for r in range(self.nranks):
            self.trace.host(r)
        for d in range(self.ndevices):
            self.trace.device(d)

    def rank(self, r: int) -> _RankCursor:
        if r not in self._cursors:
            self._cursors[r] = _RankCursor(self, r)
        return self._cursors[r]

    def barrier(self) -> "SyntheticTraceBuilder":
        """MPI blocking synchronization: every rank waits (MPI state)
        until the slowest cursor arrives."""
        tmax = max((c.t for c in self._cursors.values()), default=0.0)
        for r in range(self.nranks):
            c = self.rank(r)
            if c.t < tmax:
                c.mpi(tmax - c.t)
        return self

    def device_kernel(self, dev: int, start: float, dur: float,
                      stream: int = 0) -> "SyntheticTraceBuilder":
        self.trace.device(dev).add(DeviceActivity.KERNEL, start, start + dur,
                                   stream=stream)
        return self

    def device_memory(self, dev: int, start: float, dur: float,
                      stream: int = 0) -> "SyntheticTraceBuilder":
        self.trace.device(dev).add(DeviceActivity.MEMORY, start, start + dur,
                                   stream=stream)
        return self

    def build(self, window: Optional[Tuple[float, float]] = None) -> Trace:
        if window is None:
            t_host = max((c.t for c in self._cursors.values()), default=0.0)
            t_dev = max(
                (tl.span()[1] for tl in self.trace.devices.values()),
                default=0.0,
            )
            window = (0.0, max(t_host, t_dev))
        self.trace.window = window
        return self.trace


@register_backend("synthetic")
class SyntheticBackend:
    """ActivityBackend that replays pre-built activity (testing).

    Columnar inside: events are kept as per-device ``(kind_code, start,
    end, stream)`` column lists — no ``DeviceRecord`` objects are
    materialized unless a consumer insists on the legacy ``flush()``
    path. ``push_arrays`` accepts whole column batches;
    ``flush_arrays`` drains them batch-for-batch.
    """

    def __init__(self, records: Optional[Iterable[Tuple[int, DeviceRecord]]] = None):
        # dev -> list of (kinds, starts, ends, streams) column batches
        self._batches: Dict[int, List[Tuple[np.ndarray, np.ndarray,
                                            np.ndarray, np.ndarray]]] = {}
        self.started = False
        for dev, rec in records or []:
            self.push(dev, rec)

    def start(self) -> None:
        self.started = True

    def stop(self) -> None:
        self.started = False

    def push(self, dev: int, record: DeviceRecord) -> None:
        """Legacy single-record entry point (wraps a one-row batch)."""
        self.push_arrays(
            dev,
            np.array([record.kind.code], dtype=np.uint8),
            np.array([record.start]),
            np.array([record.end]),
            np.array([record.stream], dtype=np.uint32),
        )

    def push_arrays(self, dev: int, kinds, starts, ends, streams=None) -> None:
        """Queue one whole activity buffer for a device, as columns."""
        cols = as_record_columns(kinds, starts, ends, streams)
        self._batches.setdefault(dev, []).append(cols)

    def flush_arrays(self):
        """Drain queued per-device column batches (the zero-object path)."""
        out = []
        for dev in sorted(self._batches):
            out.extend((dev, *cols) for cols in self._batches[dev])
        self._batches = {}
        return out

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
