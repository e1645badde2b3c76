"""Live CUDA runtime backend — the port of ``repro.core.backends.runtime``.

The two paths of the paper's CUPTI plugin:

  * host path: the monitor's ``offload()`` scopes around ``wait()`` (the
    host blocked on the device);
  * device path: CUPTI activity records, one per kernel, memcpy and
    memset the card ran, read straight from CUPTI's activity API by a
    small host library (``csrc/cupti_activity.cpp``, built with ``nvcc``
    at first use and bound with ``ctypes``; :class:`CuptiActivity`).
    ``start()`` opens a collection (enables the records); the first
    ``flush_arrays()``/``flush()`` closes it (a forced flush of CUPTI's
    buffers, records disabled) and converts its rows into KERNEL and
    MEMORY records on their streams; ``stop()`` closes it too (in a
    ``finally``). A ``launch()`` after a flush opens a new collection. No
    profiler session is involved: a drain costs a fraction of a µs per
    row, where reading the rows through ``torch.profiler`` (Kineto), its
    stop and its event parsing, took about 27 µs per row on the H100
    (``PERF.md``): seconds for every sample of a decode run.
    CUPTI serves one client at a time, and Kineto registers its own
    buffer callbacks when it starts, so a ``torch.profiler`` session may
    open after a monitored run, never during one.

``launch()``/``wait()`` keep their host role only: ``wait()`` synchronises
on an event recorded after the launched work, inside the caller's
``offload()``. On CUDA neither emits a record, and neither does
``record_transfer()``: the eager step of the port enqueues thousands of
kernels while the card waits between them, and a record spanning the
whole step would count those waits as Kernel time. The JAX backend's one
record per launch spans one compiled executable, which has no host gaps
inside it.

Clocks. CUPTI stamps each record in its own time base: wall-clock
nanoseconds, or the units of a timestamp callback another client has
registered (Kineto registers the CPU's time-stamp counter, so after a
``torch.profiler`` session a process's rows count TSC ticks, 2.1 GHz on
the H100's host). :class:`CuptiActivity` reads CUPTI's clock beside the
host's at each open and close and converts its rows to nanoseconds at
the rate between them. Kineto's
own conversion of those stamps was not to be trusted on an H100 either:
its rows sat 30 to 85 µs early against the CUDA events around the same
kernels, and in some processes drifted by 2.6% and jumped by hundreds
of ms, while the events agreed with the host clock within 30 µs over
9 s. So the rows are placed on the monitor's clock through markers whose
true times are CUDA events, whatever their units:
  * ``start()`` records an anchor event on the idle card between two
    reads of the monitor's clock (the tightest of five tries, at its
    midpoint: one read after a slow ``record()`` put every event up to
    65 µs late); ``_event_time`` maps any later event through it;
  * a marker is three things on a private side stream, after the main
    stream's work so far: a sleep kernel that holds the side stream, an
    event, and a one-cycle sleep kernel queued behind the event, which so
    starts when the event completes, with no launch between them. One
    marker opens and one closes each collection, and one more sits before
    and after the work of every ``launch()``;
  * at the drain, each row is placed by linear interpolation between the
    two markers launched just before and just after it (CUPTI's
    correlation ids give the launch order, which a jump of the clock
    cannot reorder), and kept inside their window: stream order runs
    work launched between two markers between them (from a blocker's
    length before the first). The markers' rows, the only ones on the
    side stream, are dropped. A jump of the clock inside one window so
    moves rows within that launch only: a dump of 132 markers over one
    llama3.2-3b serve run showed the clock constant to 0.2 ms but for
    one jump of 1.16 ms.
  * Each collection first runs a kernel of its own on the side stream,
    finds the side stream from the closing marker, launched last (or,
    when rows were lost at the end, as the latest stream with no more
    short kernels than markers launched), and tells the markers from the
    blockers by length, not by position. Through Kineto a serve run lost
    a marker row or two of 132, so each marker's kernel carries its index
    mod 8 in its length, the marker rows are matched to their events in
    order, a lost one skipped, and ``lost_markers`` counts them. The
    match is the alignment whose gaps between successive marker rows best
    fit the gaps between their events, a disagreeing code counted as
    1 ms of misfit: under a training step that fills every SM a marker's
    measured length also held its wait for an SM, and 4 of 13 codes read
    wrong, while the gaps, tens of ms apart, still fit to a ms. Records
    CUPTI itself drops (buffers full) are counted in
    ``CuptiActivity.dropped``.
On the card a ``torch.cuda._sleep`` kernel's activity record is held
against the CUDA events around it and against the host's window around
its launch (tests/test_torch_gpu.py, chip_smoke.py). An activity source
without a card (tests) is placed by one host anchor: its ``now_ns()``
read beside the monitor's clock.

There is no fallback: a collection that cannot open raises, and so does
one that returns no device row after work was launched through this
backend, or whose markers are not all there.

For CPU tensors (``device="cpu"``) ``launch``/``wait`` record the host
window of each eager call as a KERNEL record, as the JAX backend does on
its CPU "device". Tests give a CPU backend an ``activity`` source of
their own to drive the device path without a card.

Two things the monitor reads, where the card differs from the JAX
backend's one record per compiled launch:
  * ``launch_counts`` (device -> ``launch`` calls while enabled, under
    the card's ordinal on CUDA): the unit a flop model's FLOPs are per,
    for Computational Efficiency. None without an activity source, whose
    one KERNEL record per launch the monitor counts itself.
  * ``flush_closes_collection``: true with an activity source, whose
    drain closes the collection (a synchronise, the closing marker,
    CUPTI's forced flush, the rows' placement), which the next launch
    reopens. A step-series recorder then defers a step's device columns
    to the next drain instead of draining at every step close. The
    reopening is charged to the monitor's ``flush`` overhead section
    with the drain, the reading of the rows to ``drain``.
"""

from __future__ import annotations

import ctypes
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..states import DeviceActivity, DeviceRecord
from ..telemetry import overhead as _ovh
from .base import register_backend

__all__ = ["CudaRuntimeBackend", "AsyncHandle", "CuptiActivity"]

# One drained activity batch: (device, kinds u1, starts i8 ns, ends i8 ns,
# streams u4, correlation ids i8), times on the source's clock.
ActivityRows = Tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                     np.ndarray]

# A marker's blocker: about 0.2 ms of a sleep kernel at the H100's clock,
# long past the host's enqueueing of the event and the kernel behind it.
_BLOCKER_CYCLES = 400_000
# A marker's kernel sleeps 1 + code * _CODE_CYCLES cycles, code its index
# in the collection mod _CODES: 1 to 36 µs at the H100's 1.98 GHz, under
# 60 µs down to 1.2 GHz, so that a lost marker row can be told.
_CODE_CYCLES = 10_000
_CODES = 8
# Side-stream rows shorter than this are the markers' kernels; the
# blockers run 0.2 ms or more (at any clock up to 2 GHz).
_MARKER_NS = 100_000
# Work launched after a marker's blocker began cannot start earlier than
# the blocker's length before the marker (stream order): 0.4 ms at 1 GHz.
_SLACK_S = 5e-4
CUPTI_SOURCE = Path(__file__).resolve().parent / "csrc" / "cupti_activity.cpp"


class _DeviceColumns:
    """Per-device column buffer (kind/start/end/stream): scalar appends and
    whole activity batches."""

    __slots__ = ("kinds", "starts", "ends", "streams", "batches")

    def __init__(self):
        self.kinds: List[int] = []
        self.starts: List[float] = []
        self.ends: List[float] = []
        self.streams: List[int] = []
        self.batches: List[Tuple[np.ndarray, ...]] = []

    def append(self, kind: int, start: float, end: float, stream: int) -> None:
        self.kinds.append(kind)
        self.starts.append(start)
        self.ends.append(end)
        self.streams.append(stream)

    def extend(self, kinds, starts, ends, streams) -> None:
        self.batches.append((kinds, starts, ends, streams))

    def drain(self):
        parts = [(
            np.asarray(self.kinds, dtype=np.uint8),
            np.asarray(self.starts, dtype=np.float64),
            np.asarray(self.ends, dtype=np.float64),
            np.asarray(self.streams, dtype=np.uint32),
        )] + self.batches
        cols = tuple(np.concatenate([p[i] for p in parts]) for i in range(4))
        self.kinds, self.starts, self.ends, self.streams = [], [], [], []
        self.batches = []
        return cols


def _cupti_library() -> Path:
    """The libcupti this process has loaded (PyTorch's, for Kineto); one
    CUPTI instance then serves both."""
    maps = Path("/proc/self/maps").read_text()
    found = sorted({line.split()[-1] for line in maps.splitlines()
                    if "/libcupti" in line})
    if not found:
        raise RuntimeError(
            "no libcupti is loaded in this process: TALP's device records "
            "read CUPTI through the copy PyTorch's CUDA build loads")
    return Path(found[0])


def _cupti_include() -> Path:
    """The CUDA toolkit's directory holding ``cupti.h``."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    for d in (home / "extras" / "CUPTI" / "include", home / "include"):
        if (d / "cupti.h").is_file():
            return d
    raise RuntimeError(f"cupti.h not found under {home}: the CUDA toolkit's "
                       "CUPTI headers build TALP's activity reader")


def cupti_ns(stamps: np.ndarray, opened: Tuple[int, float],
             closed: Tuple[int, float]) -> np.ndarray:
    """CUPTI stamps as int64 nanoseconds since ``opened``: each of
    ``opened`` and ``closed`` is (CUPTI's clock, the host's seconds), read
    together; CUPTI's units per ns are their ratio."""
    (s0, h0), (s1, h1) = opened, closed
    per_ns = (s1 - s0) / max((h1 - h0) * 1e9, 1.0)
    return np.rint((stamps - s0) / per_ns).astype(np.int64)


class CuptiActivity:
    """The card's CUPTI activity records, read straight from CUPTI:
    kernels as KERNEL rows, memcpy and memset as MEMORY rows, one batch
    per device at each close."""

    _lib = None

    def __init__(self):
        self._open = False

    @classmethod
    def library(cls):
        """Build (at first use) and load ``csrc/cupti_activity.cpp``, bound
        to the process's libcupti."""
        if cls._lib is None:
            from ...kernels import cuda_build

            flags = ("-std=c++17", "-O2", "-shared", "-Xcompiler", "-fPIC",
                     "-I", str(_cupti_include()))
            lib = cuda_build.load(CUPTI_SOURCE, flags)
            for name, restype, argtypes in (
                    ("init", ctypes.c_int, [ctypes.c_char_p]),
                    ("enable", ctypes.c_int, []),
                    ("flush", ctypes.c_int, [ctypes.c_int, ctypes.c_int]),
                    ("count", ctypes.c_int64, []),
                    ("take", ctypes.c_int64,
                     [ctypes.c_void_p] * 6 + [ctypes.c_int64]),
                    ("dropped", ctypes.c_uint64, []),
                    ("timestamp", ctypes.c_uint64, []),
                    ("error", ctypes.c_char_p, [ctypes.c_int])):
                fn = getattr(lib, f"talp_cupti_{name}")
                fn.restype, fn.argtypes = restype, argtypes
            err = lib.talp_cupti_init(str(_cupti_library()).encode())
            if err:
                raise RuntimeError(
                    f"CUPTI's entry points not found in {_cupti_library()} "
                    f"(code {err})")
            cls._lib = lib
        return cls._lib

    def _check(self, err: int, what: str) -> None:
        if err:
            raise RuntimeError(
                f"CUPTI {what} failed: "
                f"{self.library().talp_cupti_error(err).decode()}")

    @property
    def is_open(self) -> bool:
        return self._open

    @property
    def dropped(self) -> int:
        """Records CUPTI dropped in this process (its buffers were full)."""
        return int(self.library().talp_cupti_dropped())

    def _clocks(self) -> Tuple[int, float]:
        """CUPTI's clock, in its records' units, beside the host's."""
        t0 = time.perf_counter()
        stamp = self.library().talp_cupti_timestamp()
        return stamp, 0.5 * (t0 + time.perf_counter())

    def open(self) -> None:
        self._check(self.library().talp_cupti_enable(), "enable")
        self._open = True
        self._opened = self._clocks()

    def close(self) -> List[ActivityRows]:
        """Stop collecting; the device rows, one batch per device, in
        nanoseconds since the open: CUPTI's units (wall-clock nanoseconds,
        or a registered timestamp callback's) are converted at the rate its
        clock ran against the host's over the collection."""
        lib = self.library()
        self._open = False
        torch.cuda.synchronize()
        self._check(lib.talp_cupti_flush(1, 1), "flush")
        closed = self._clocks()
        n = lib.talp_cupti_count()
        cols = (np.empty(n, np.uint8), np.empty(n, np.int64),
                np.empty(n, np.int64), np.empty(n, np.uint32),
                np.empty(n, np.int64), np.empty(n, np.uint32))
        n = lib.talp_cupti_take(*[c.ctypes.data for c in cols], n)
        kinds, starts, ends, streams, corrs, devs = (c[:n] for c in cols)
        starts, ends = (cupti_ns(x, self._opened, closed)
                        for x in (starts, ends))
        out = []
        for dev in np.unique(devs):
            on = devs == dev
            out.append((int(dev), kinds[on], starts[on], ends[on],
                        streams[on], corrs[on]))
        return out


@dataclass
class AsyncHandle:
    """Tracks one launch: on the card, the event recorded after the work
    it enqueued; on the CPU, the host window of an eager call."""

    out: Any
    launch_t: float
    device: int
    name: str
    stream: int = 0
    end_event: Optional[torch.cuda.Event] = None


@register_backend("cuda_runtime")
class CudaRuntimeBackend:
    """Collects device activity records from live PyTorch execution."""

    def __init__(self, device: Union[str, torch.device] = "cuda",
                 clock: Callable[[], float] = time.perf_counter,
                 activity: Optional[Any] = None):
        self.torch_device = torch.device(device)
        self.cuda = self.torch_device.type == "cuda"
        self.clock = clock
        if activity is None and self.cuda:
            activity = CuptiActivity()
        # source of per-kernel device rows (None: host windows, CPU only)
        self.activity = activity
        self._columns: dict = {}  # dev -> _DeviceColumns
        self._pending: List[AsyncHandle] = []
        self._anchor: Optional[torch.cuda.Event] = None
        self._anchor_t = 0.0
        self._ns_anchor: Tuple[int, float] = (0, 0.0)   # host anchor (no card)
        self._side: Optional[torch.cuda.Stream] = None  # the markers' stream
        self._marks: List[torch.cuda.Event] = []        # this collection's
        self.lost_markers = 0    # marker rows CUPTI lost, over the drains
        self._launched = 0       # launches and transfers since the open
        self._launch_counts: dict = {}  # device -> launch() calls, enabled
        self._ordinal = 0        # the card's device index (CUDA)
        self.enabled = False

    @property
    def launch_counts(self) -> Optional[dict]:
        """``launch`` calls made while enabled, by device, where device rows
        come from an activity source (one per kernel); None where each
        launch is one KERNEL record."""
        return self._launch_counts if self.activity is not None else None

    @property
    def flush_closes_collection(self) -> bool:
        """Whether a flush closes a device activity collection (which the
        next launch reopens), rather than copying out buffered rows."""
        return self.activity is not None

    # -- plugin lifecycle ------------------------------------------------
    def start(self) -> None:
        if self.cuda:
            # the anchor event of the idle card, between two reads of the
            # monitor's clock: the tightest of five pairs, at its midpoint
            best = None
            stream = torch.cuda.current_stream(self.torch_device)
            for _ in range(5):
                torch.cuda.synchronize(self.torch_device)
                anchor = torch.cuda.Event(enable_timing=True)
                t0 = self.clock()
                anchor.record(stream)
                t1 = self.clock()
                if best is None or t1 - t0 < best[2] - best[1]:
                    best = (anchor, t0, t1)
            torch.cuda.synchronize(self.torch_device)
            self._anchor, t0, t1 = best
            self._anchor_t = 0.5 * (t0 + t1)
            self._side = torch.cuda.Stream(self.torch_device)
            self._ordinal = (self.torch_device.index
                             if self.torch_device.index is not None
                             else torch.cuda.current_device())
        if self.activity is not None:
            self._open()
        self.enabled = True

    def stop(self) -> None:
        try:
            # Drain pending asynchronous work before disabling.
            for h in list(self._pending):
                self.wait(h)
        finally:
            self.enabled = False
            if self.activity is not None and self.activity.is_open:
                self._drain_activity()

    def _open(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.torch_device)
        self.activity.open()
        self._launched = 0
        if self.cuda:
            # the first rows of the collection: a kernel that may be missed,
            # then the opening marker
            self._marks = []
            with torch.cuda.stream(self._side):
                torch.cuda._sleep(_BLOCKER_CYCLES)
            self._mark()
        else:
            t0 = self.clock()
            ns = self.activity.now_ns()
            self._ns_anchor = (ns, 0.5 * (t0 + self.clock()))

    def _mark(self) -> None:
        """Enqueue a marker on the side stream, after the current stream's
        work so far."""
        main = torch.cuda.current_stream(self.torch_device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            torch.cuda._sleep(_BLOCKER_CYCLES)
            mark = torch.cuda.Event(enable_timing=True)
            mark.record(self._side)
            torch.cuda._sleep(1 + _CODE_CYCLES * (len(self._marks) % _CODES))
        self._marks.append(mark)

    def _align(self, codes: np.ndarray, ns: np.ndarray,
               t: np.ndarray) -> List[int]:
        """The marker index of each marker row (codes ``codes``, starts
        ``ns`` in seconds): the increasing assignment, skipping at
        most _CODES - 1 lost rows in a row, whose gaps between successive
        rows best match the gaps between their events' times ``t``, a
        disagreeing code counted as 1 ms of mismatch."""
        n, m = len(codes), len(t)
        if n == 0 or n > m:
            raise RuntimeError(
                f"the CUDA activity collection's {n} marker kernels do not "
                f"match the {m} markers launched")
        idx = np.arange(m)
        miss = (codes[:, None] != (idx % _CODES)[None, :]) * 1e-3
        cost, backs = miss[0].copy(), []
        for j in range(1, n):
            new, back = np.full(m, np.inf), np.zeros(m, dtype=int)
            for d in range(1, _CODES + 1):
                prev = np.maximum(idx - d, 0)
                c = np.where(idx >= d, cost[prev] + miss[j] + np.abs(
                    (ns[j] - ns[j - 1]) - (t - t[prev])), np.inf)
                better = c < new
                new[better], back[better] = c[better], prev[better]
            cost = new
            backs.append(back)
        k = int(np.argmin(cost))
        if not np.isfinite(cost[k]):
            raise RuntimeError(
                f"the CUDA activity collection's {n} marker kernels do not "
                f"match the {m} markers launched")
        ks = [k]
        for back in reversed(backs):
            k = int(back[k])
            ks.append(k)
        return ks[::-1]

    def _place(self, batches: List[ActivityRows]):
        """Rows on the monitor's clock: each placed by linear interpolation
        between the markers launched just before and just after it; the
        markers' rows (the side stream's) dropped."""
        last = max((b for b in batches if len(b[5])),
                   key=lambda b: b[5].max(), default=None)
        if last is None:
            raise RuntimeError(
                "the CUDA activity collection returned no device rows: "
                "CUPTI recorded nothing (is another profiler open?)")
        dev_m, m_kinds, m_starts, m_ends, m_streams, m_corrs = last
        # the side stream: the closing marker's, launched last; when CUPTI
        # lost the collection's last rows, the latest stream whose short
        # kernel rows are no more than the markers launched (a stream with
        # more is doing the work)
        short = (m_kinds == DeviceActivity.KERNEL.code) & (
            m_ends - m_starts < _MARKER_NS)
        sides = [st for st in np.unique(m_streams)
                 if 0 < short[m_streams == st].sum() <= len(self._marks)]
        if not sides:
            raise RuntimeError(
                "the CUDA activity collection holds no stream of marker "
                f"kernels for the {len(self._marks)} markers launched")
        side = max(sides, key=lambda st: m_corrs[m_streams == st].max())
        on_side = np.flatnonzero(m_streams == side)
        on_side = on_side[np.argsort(m_corrs[on_side])]
        dur = (m_ends - m_starts)[on_side]
        is_mark = dur < _MARKER_NS
        # a marker's code, from its length over its own blocker's (the side
        # row just before it, run at the same clock)
        blocker = np.where(np.r_[False, ~is_mark[:-1]], np.r_[0, dur[:-1]], 0)
        blocker = np.where(blocker > 0, blocker, np.median(dur[~is_mark])
                           if (~is_mark).any() else 2e5)
        rows = on_side[is_mark]
        codes = np.rint((dur[is_mark] - 1000.0) * _BLOCKER_CYCLES
                        / (_CODE_CYCLES * blocker[is_mark])).astype(np.int64)
        base = int(m_starts[rows[0]])
        m_ns = (m_starts[rows] - base).astype(np.float64)
        t_all = np.array([self._event_time(e) for e in self._marks])
        ks = np.array(self._align(codes % _CODES, m_ns * 1e-9, t_all))
        self.lost_markers += len(self._marks) - len(rows)
        m_corr = m_corrs[rows]
        m_t = t_all[ks]
        if len(m_t) == 1:
            # one marker left: the source's own rate from it, and no window
            # after it (a marker far past every row)
            m_corr = np.append(m_corr, np.iinfo(np.int64).max)
            m_ns, m_t = np.append(m_ns, 1e18), np.append(m_t, m_t[0] + 1e9)
        span = np.diff(m_ns)
        rates = np.where(span > 0, np.diff(m_t) / np.maximum(span, 1.0), 1e-9)
        out = []
        for dev, kinds, starts, ends, streams, corrs in batches:
            if dev == dev_m:
                keep = streams != side
                kinds, starts, ends, streams, corrs = (
                    kinds[keep], starts[keep], ends[keep], streams[keep],
                    corrs[keep])
            # the markers before and after each row in launch order (-1 and
            # len(m_t): none); interpolation takes the nearest window
            before = np.searchsorted(m_corr, corrs, side="right") - 1
            k = np.clip(before, 0, len(rates) - 1)
            t0, ns0, rate = m_t[k], m_ns[k], rates[k]
            lo = np.where(before >= 0, m_t[np.maximum(before, 0)] - _SLACK_S,
                          -np.inf)
            hi = np.where(before + 1 < len(m_t),
                          m_t[np.minimum(before + 1, len(m_t) - 1)], np.inf)
            t_start = np.clip(
                t0 + ((starts - base).astype(np.float64) - ns0) * rate, lo, hi)
            t_end = np.clip(
                t0 + ((ends - base).astype(np.float64) - ns0) * rate,
                t_start, hi)
            out.append((dev, kinds, t_start, t_end, streams))
        return out

    def _drain_activity(self) -> None:
        """Close the collection and buffer its rows on the monitor clock."""
        if self.cuda:
            self._mark()            # the closing marker
            torch.cuda.synchronize(self.torch_device)
        with _ovh.section("drain"):
            batches = self.activity.close()
        n_rows = sum(len(b[1]) for b in batches)
        if self.cuda:
            placed = self._place(batches)
        else:
            ns0, t0 = self._ns_anchor
            placed = [(dev, kinds, t0 + (starts - ns0) * 1e-9,
                       t0 + (ends - ns0) * 1e-9, streams)
                      for dev, kinds, starts, ends, streams, _ in batches]
        if self._launched and not any(len(b[1]) for b in placed):
            raise RuntimeError(
                "the CUDA activity collection returned no device rows for "
                f"{self._launched} launches ({n_rows} rows in all): CUPTI "
                "recorded nothing (is another profiler open?)")
        for dev, kinds, starts, ends, streams in placed:
            cols = self._columns.get(dev)
            if cols is None:
                cols = self._columns[dev] = _DeviceColumns()
            cols.extend(kinds, starts, ends, streams)

    def _event_time(self, event: torch.cuda.Event) -> float:
        """A completed event's GPU timestamp on the monitor's clock, through
        the anchor event of ``start()``: it places the markers, and it is
        the yardstick the activity records are checked against. On the idle
        card the anchor completes while ``record()`` returns; the monitor's
        clock is read on both sides of the call."""
        return self._anchor_t + self._anchor.elapsed_time(event) * 1e-3

    def _record(self, dev: int, kind: DeviceActivity, start: float,
                end: float, stream: int = 0) -> None:
        cols = self._columns.get(dev)
        if cols is None:
            cols = self._columns[dev] = _DeviceColumns()
        cols.append(kind.code, start, end, stream)

    def flush_arrays(self):
        """Drain buffered activity as per-device column batches; the first
        flush closes the activity collection."""
        with _ovh.section("flush"):
            if self.activity is not None and self.activity.is_open:
                self._drain_activity()
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
    def _collecting(self) -> bool:
        """Whether device rows come from the activity source; opens a new
        collection after a flush closed the last one."""
        if self.activity is None:
            return False
        if self.enabled and not self.activity.is_open:
            with _ovh.section("flush"):
                self._open()
        self._launched += 1
        return self.activity.is_open

    def _end_event(self) -> torch.cuda.Event:
        end = torch.cuda.Event()
        end.record(torch.cuda.current_stream(self.torch_device))
        return end

    def launch(self, fn: Callable, *args, device: int = 0, name: str = "",
               stream: int = 0, **kwargs) -> AsyncHandle:
        """Enqueue ``fn``'s work without waiting for it, between two markers
        on the card. The host time of the call itself (in eager PyTorch:
        enqueueing every kernel) is charged by the caller's scope."""
        label = name or getattr(fn, "__name__", "fn")
        if self.enabled:
            dev = self._ordinal if self.cuda else device
            self._launch_counts[dev] = self._launch_counts.get(dev, 0) + 1
        marked = self._collecting() and self.cuda
        t0 = self.clock()
        if marked:
            self._mark()
        out = fn(*args, **kwargs)
        end = None
        if self.cuda:
            if marked:
                self._mark()
            end = self._end_event()
        h = AsyncHandle(out, t0, device, label, stream, end)
        self._pending.append(h)
        return h

    def wait(self, handle: AsyncHandle) -> Any:
        """Block until the work is done. Without an activity source (CPU
        tensors), emit the host window of the call as a kernel record."""
        if handle.end_event is not None:
            handle.end_event.synchronize()
        elif self.enabled and self.activity is None:
            self._record(handle.device, DeviceActivity.KERNEL,
                         handle.launch_t, self.clock(), handle.stream)
        if handle in self._pending:
            self._pending.remove(handle)
        return handle.out

    def record_transfer(self, fn: Callable, *args, device: int = 0,
                        name: str = "transfer", **kwargs) -> Any:
        """Run a host↔device data movement and wait for it; without an
        activity source, its host window is a MEMORY record."""
        collecting = self._collecting()
        t0 = self.clock()
        out = fn(*args, **kwargs)
        if self.cuda:
            self._end_event().synchronize()
        if self.enabled and not collecting:
            self._record(device, DeviceActivity.MEMORY, t0, self.clock())
        return out
