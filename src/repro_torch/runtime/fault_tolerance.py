"""Fault-tolerance runtime: step heartbeats, straggler detection, and a
checkpointed restart loop. Copy of ``repro.runtime.fault_tolerance``
(which holds no JAX).

The failure model: (a) hard loss → process exit → restart from the last
checkpoint (``repro_torch.checkpoint``; ``launch.train.train`` restores
before it initialises), (b) soft stragglers → step-time outliers →
flagged by the ``StragglerDetector`` so the deployment layer can
re-slice. The TALP host timeline accounts the recovery time as
non-useful, which is how the paper's metrics make failure overheads
visible.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

__all__ = ["Heartbeat", "StragglerDetector", "run_with_restarts",
           "FaultToleranceReport"]


class Heartbeat:
    """Tracks liveness: the deployment layer polls ``age()`` and declares
    the worker dead past a deadline."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.last_beat: Optional[float] = None
        self.count = 0

    def beat(self) -> None:
        self.last_beat = self.clock()
        self.count += 1

    def age(self) -> float:
        if self.last_beat is None:
            return float("inf")
        return self.clock() - self.last_beat

    def alive(self, deadline: float) -> bool:
        return self.age() <= deadline


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


@dataclass
class FaultToleranceReport:
    restarts: int = 0
    resumed_steps: List[int] = field(default_factory=list)
    straggler_events: List[int] = field(default_factory=list)


def run_with_restarts(
    run_fn: Callable[[int], int],
    max_restarts: int = 3,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
) -> FaultToleranceReport:
    """Restart loop: ``run_fn(attempt)`` trains from its checkpointed
    state and returns the final step; exceptions trigger restore+retry
    (the single-controller analogue of a cluster-manager restart)."""
    report = FaultToleranceReport()
    attempt = 0
    while True:
        try:
            run_fn(attempt)
            return report
        except KeyboardInterrupt:
            raise
        except BaseException as e:
            attempt += 1
            report.restarts += 1
            if on_restart is not None:
                on_restart(attempt, e)
            if attempt > max_restarts:
                raise
