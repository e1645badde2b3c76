"""Straggler detection. Copy of ``StragglerDetector`` from
``repro.runtime.fault_tolerance`` (which holds no JAX); its heartbeat and
restart loop come with checkpointing."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

__all__ = ["StragglerDetector"]


@dataclass
class StragglerDetector:
    """Flags step-time outliers vs a trailing median (soft-failure signal).

    ``factor=2.0`` → a step slower than 2× the trailing median is a
    straggler event. Mitigation at scale: the caller re-slices or drops
    the slow host; here we record and expose the events."""

    window: int = 20
    factor: float = 2.0
    times: List[float] = field(default_factory=list)
    events: List[int] = field(default_factory=list)

    def observe(self, step: int, duration: float) -> bool:
        hist = self.times[-self.window:]
        self.times.append(duration)
        if len(hist) < 5:
            return False
        median = sorted(hist)[len(hist) // 2]
        if duration > self.factor * median:
            self.events.append(step)
            return True
        return False
