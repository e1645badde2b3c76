"""Shared arithmetic of the phase readers (``*_host_ms.train``,
``*_busy_ms.train``, ``*_idle_ms.train``, ``step_gap_idle_ms.train``): the
program's phase spans (``repro_torch.core.telemetry.phases``), recorded
inside its training step while TALP's monitor runs and joined with TALP's
device rows when the monitor finishes. A reader keeps the spans of one
name whose host start lies in the measured window and returns the mean of
one quantity over them, in ms. A program without the recorder, or a run
that recorded no such span, gives None."""

from __future__ import annotations

from typing import List, Optional


def spans(rec: dict, name: str) -> List[object]:
    """The spans named ``name`` (``outside``: the joined gaps between two
    steps) whose host start lies in the window."""
    try:
        from repro_torch.core.telemetry import phases
    except ImportError:
        return []
    recorder = phases.current()
    if recorder is None:
        return []
    lo = rec["window_start"]
    hi = lo + rec["window"]["seconds"]
    pool = recorder.outside if name == "outside" else recorder.spans()
    return [s for s in pool if s.name == name and lo <= s.t0 <= hi]


def mean_ms(rec: dict, name: str, quantity: str) -> Optional[float]:
    """The mean over the window's spans ``name`` of ``quantity``: ``host``
    (the span's host time), ``busy`` or ``idle`` (device seconds inside
    its window), in ms."""
    values = []
    for s in spans(rec, name):
        if quantity == "host":
            value = s.t1 - s.t0 if s.t1 is not None else None
        else:
            value = getattr(s, quantity, None)
        if value is not None:
            values.append(value)
    if not values:
        return None
    return float(1e3 * sum(values) / len(values))
