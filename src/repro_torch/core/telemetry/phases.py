"""Phase spans inside a launched step, on TALP's clock.

A TALP region's device metrics are taken over the device rows inside the
region's host window. Inside one eager step the card runs behind the
host, so a phase of the step (the forward, the backward, the optimizer)
needs a device window of its own: two timing events recorded on the
current stream at its ends. :meth:`PhaseRecorder.place` reads them
through the runtime backend's anchor (``CudaRuntimeBackend._event_time``),
the clock that places CUPTI's rows, so a phase's window and the device
rows line up as closely as the backend's markers do. With CPU tensors a
span's host window is its device window.

The contract is :mod:`.overhead`'s: :func:`install` returns the previous
recorder, :func:`current` gives the installed one, and :func:`section`
times a span against it; with none installed a section costs one global
load and a ``None`` check. ``CudaRuntimeBackend.start()`` installs a
recorder, which stays readable after ``stop()`` until the next
``start()``.

Each span keeps its name, its parent (the ``seq`` of the span open on the
same thread, or None), its host start and end on the recorder's clock and,
once placed, its device window. Spans live in a bounded ring; those it
overwrites are counted in ``dropped``. The recorder never synchronises:
events are read, and returned to a pool, only when TALP drains or
finishes. Its own bookkeeping is timed as the ``phases`` section of the
installed overhead accumulator.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

from . import overhead as _ovh

__all__ = ["Span", "PhaseRecorder", "install", "current", "section"]


class Span:
    """One phase: host window ``t0``..``t1``; device window ``d0``..``d1``
    once placed; ``busy`` and ``idle`` seconds once joined with the device
    rows (``repro_torch.launch.talp_outputs.join_phases``)."""

    __slots__ = ("seq", "name", "parent", "t0", "t1", "ev0", "ev1", "d0",
                 "d1", "busy", "idle")

    def __init__(self, seq: int, name: str, parent: Optional[int]):
        self.seq, self.name, self.parent = seq, name, parent
        self.t0 = self.t1 = self.d0 = self.d1 = None
        self.ev0 = self.ev1 = None
        self.busy = self.idle = None

    def __repr__(self) -> str:
        return (f"Span({self.seq}, {self.name!r}, parent={self.parent}, "
                f"host={self.t0}..{self.t1}, device={self.d0}..{self.d1}, "
                f"busy={self.busy}, idle={self.idle})")


class PhaseRecorder:
    """Spans of named phases in a ring of ``capacity``. ``device`` a CUDA
    device: each span records two timing events on the current stream;
    otherwise (CPU tensors) its device window is its host window."""

    def __init__(self, capacity: int = 4096,
                 clock: Callable[[], float] = time.perf_counter,
                 device=None):
        if capacity < 1:
            raise ValueError("capacity must be at least 1")
        self.capacity = capacity
        self.clock = clock
        self.device = device
        self.cuda = device is not None and device.type == "cuda"
        self.counts: Dict[str, int] = {}
        self.dropped = 0
        self.outside: List[Span] = []   # filled by the join
        self._ring: List[Span] = []
        self._seq = 0
        self._open: Dict[int, List[Span]] = {}   # thread -> open spans
        self._pool: list = []
        self._unplaced: List[Span] = []    # ended, events not yet read
        self._lock = threading.Lock()      # spans may come from any thread
        if self.cuda:
            import torch

            self._cuda_api = torch.cuda
            # an int index: current_stream() resolves a bare "cuda" device
            # through current_device(), 5 us more a call on the H100's host
            self._index = (device.index if device.index is not None
                           else torch.cuda.current_device())

    def _record(self):
        with self._lock:
            ev = self._pool.pop() if self._pool else None
        if ev is None:
            ev = self._cuda_api.Event(enable_timing=True)
        ev.record(self._cuda_api.current_stream(self._index))
        return ev

    def begin(self, name: str) -> Span:
        acc = _ovh.current()
        t = acc.begin() if acc is not None else 0.0
        stack = self._open.setdefault(threading.get_ident(), [])
        with self._lock:
            span = Span(self._seq, name, stack[-1].seq if stack else None)
            self._seq += 1
            self.counts[name] = self.counts.get(name, 0) + 1
            if len(self._ring) < self.capacity:
                self._ring.append(span)
            else:
                slot = span.seq % self.capacity
                old = self._ring[slot]
                if old.t1 is not None:
                    self._release(old)
                self._ring[slot] = span
                self.dropped += 1
        stack.append(span)
        span.t0 = self.clock()
        if self.cuda:
            span.ev0 = self._record()
        if acc is not None:
            acc.end("phases", t)
        return span

    def end(self, span: Span) -> None:
        acc = _ovh.current()
        t = acc.begin() if acc is not None else 0.0
        if self.cuda:
            span.ev1 = self._record()
            with self._lock:
                self._unplaced.append(span)
                if len(self._unplaced) > self.capacity:
                    # those the ring overwrote (no drain since) hold no
                    # events
                    self._unplaced = [s for s in self._unplaced
                                      if s.ev1 is not None]
        span.t1 = self.clock()
        if not self.cuda:
            span.d0, span.d1 = span.t0, span.t1
        self._open[threading.get_ident()].remove(span)
        if acc is not None:
            acc.end("phases", t)

    def _release(self, span: Span) -> None:
        """Return the span's events to the pool (under the lock)."""
        for ev in (span.ev0, span.ev1):
            if ev is not None:
                self._pool.append(ev)
        span.ev0 = span.ev1 = None

    def spans(self) -> List[Span]:
        """The ring's spans, oldest first."""
        with self._lock:
            if len(self._ring) < self.capacity:
                return list(self._ring)
            k = self._seq % self.capacity
            return self._ring[k:] + self._ring[:k]

    def place(self, event_time: Callable[[object], float]) -> None:
        """Read the device window of every ended span whose events have
        completed, through ``event_time`` (an event's time on the monitor's
        clock), and return the events to the pool."""
        with self._lock:
            left = []
            for span in self._unplaced:
                if span.ev1 is None:        # overwritten in the ring
                    continue
                if not (span.ev0.query() and span.ev1.query()):
                    left.append(span)
                    continue
                span.d0, span.d1 = event_time(span.ev0), event_time(span.ev1)
                self._release(span)
            self._unplaced = left


# ---------------------------------------------------------------------------
# process-global installation
# ---------------------------------------------------------------------------
_current: Optional[PhaseRecorder] = None


def install(rec: Optional[PhaseRecorder]) -> Optional[PhaseRecorder]:
    """Install ``rec`` as the process-global recorder; returns the
    previously installed one."""
    global _current
    prev = _current
    _current = rec
    return prev


def current() -> Optional[PhaseRecorder]:
    return _current


@contextmanager
def section(name: str):
    """Record a span ``name`` against the installed recorder; a no-op
    (beyond one global load) when none is installed."""
    rec = _current
    if rec is None:
        yield None
        return
    span = rec.begin(name)
    try:
        yield span
    finally:
        rec.end(span)
