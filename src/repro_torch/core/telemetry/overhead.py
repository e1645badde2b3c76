"""TALP self-overhead accounting — the "lightweight" claim, measured.

The paper sells TALP as *lightweight monitoring*; production monitoring
systems (MPCDF's HPC monitor, arXiv:1909.11704) treat the monitor's own
cost as a first-class metric, because an observability layer whose price
is unknown cannot be left on in production. This module instruments the
monitor's hot paths with monotonic-clock accumulators:

  * ``ingest``  — backend flush + columnar record ingestion,
  * ``flush``   — a backend draining its own activity buffers,
  * ``compact`` — pending-row folds into the flattened interval arrays,
  * ``flatten`` — per-device flattened-pair construction at sample time,
  * ``sample``  — online snapshot construction (includes nested work),
  * ``step``    — per-region-close step-series capture (+ watchdog),
  * ``spool``   — spool-payload serialization + atomic publish,
  * ``export``  — Chrome-trace / metric-stream rendering.

Sections may nest (a ``sample`` triggers ``flatten`` which may trigger
``compact``); per-section totals are *inclusive* while
:attr:`OverheadAccumulator.total` counts only outermost sections, so the
wall-clock fraction never double-counts nested work.

One accumulator is installed process-globally (every
:class:`~repro.core.talp.TalpMonitor` installs its own at construction;
the most recently installed wins — the one-monitor-per-process reality
of a rank). Timing a section when no accumulator is installed costs a
global load and a ``None`` check, nothing else. The measured fraction
surfaces as the optional ``talp_overhead`` annotation node of the HOST
hierarchy (see :data:`repro.core.hierarchy.HOST`).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional

__all__ = [
    "SECTIONS",
    "OverheadAccumulator",
    "install",
    "current",
    "section",
]

#: Known hot-path section names (free-form names are accepted too).
SECTIONS = (
    "ingest", "flush", "compact", "flatten", "sample", "step", "spool", "export",
)


class OverheadAccumulator:
    """Per-section monotonic-clock time accumulator with nesting-aware
    wall-clock total.

    ``totals[section]`` is inclusive (nested sections count toward their
    parents as well as themselves); :attr:`total` sums only sections
    entered at depth 0, so ``total / elapsed`` is a true wall-clock
    fraction. The clock is always a *real* monotonic clock — monitors
    driven by synthetic test clocks still measure their real cost.
    """

    __slots__ = ("totals", "counts", "clock", "_depth", "_outer_total")

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.clock = clock
        self._depth = 0
        self._outer_total = 0.0

    # -- explicit begin/end (hot-path inline form) -----------------------
    def begin(self) -> float:
        self._depth += 1
        return self.clock()

    def end(self, name: str, t0: float) -> float:
        dt = self.clock() - t0
        self._depth -= 1
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        if self._depth == 0:
            self._outer_total += dt
        return dt

    @contextmanager
    def section(self, name: str):
        t0 = self.begin()
        try:
            yield self
        finally:
            self.end(name, t0)

    # -- results ----------------------------------------------------------
    @property
    def total(self) -> float:
        """Outermost-section wall-clock seconds (nesting not double
        counted)."""
        return self._outer_total

    def fraction(self, elapsed: float) -> Optional[float]:
        """Monitor cost as a fraction of ``elapsed`` wall-clock seconds
        (``None`` when the window is empty — the annotation node then
        vanishes from every report)."""
        if elapsed <= 0:
            return None
        return self._outer_total / elapsed

    def as_dict(self) -> Dict[str, object]:
        return {
            "total_s": self._outer_total,
            "sections": dict(self.totals),
            "counts": dict(self.counts),
        }

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self._depth = 0
        self._outer_total = 0.0


# ---------------------------------------------------------------------------
# process-global installation
# ---------------------------------------------------------------------------
_current: Optional[OverheadAccumulator] = None


def install(acc: Optional[OverheadAccumulator]) -> Optional[OverheadAccumulator]:
    """Install ``acc`` as the process-global accumulator; returns the
    previously installed one (restore it to scope a measurement)."""
    global _current
    prev = _current
    _current = acc
    return prev


def current() -> Optional[OverheadAccumulator]:
    return _current


@contextmanager
def section(name: str):
    """Time a section against the installed accumulator; a no-op (beyond
    one global load) when none is installed."""
    acc = _current
    if acc is None:
        yield None
        return
    t0 = acc.begin()
    try:
        yield acc
    finally:
        acc.end(name, t0)
