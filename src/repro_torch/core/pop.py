"""Original POP MPI efficiency metrics (paper §3.3, eqs. 1–5).

Two-state model per MPI process: *Useful* computation vs *Not useful*
(stalled, e.g. in MPI). The metrics form a multiplicative hierarchy:

    Parallel Efficiency = Load Balance × Communication Efficiency

The formulas themselves live in :data:`repro.core.hierarchy.POP` — this
module is a thin façade that validates inputs and exposes the classic
``PopMetrics`` dataclass.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .hierarchy import POP, MetricFrame, StateDurations, elapsed_time

__all__ = ["PopMetrics", "pop_metrics", "elapsed_time"]


@dataclass(frozen=True)
class PopMetrics:
    parallel_efficiency: float
    load_balance: float
    communication_efficiency: float
    elapsed: float
    n_processes: int

    @classmethod
    def from_frame(cls, frame: MetricFrame) -> "PopMetrics":
        return cls(**frame.scalar_fields())

    def frame(self) -> MetricFrame:
        return POP.frame_of(self)

    def validate(self, tol: float = 1e-9) -> None:
        """Parent = product of children (multiplicative hierarchy)."""
        self.frame().validate(tol)


def pop_metrics(
    useful: Sequence[float],
    not_useful: Optional[Sequence[float]] = None,
    elapsed: Optional[float] = None,
) -> PopMetrics:
    """Compute eqs. (3)–(5). Provide either per-process not_useful or E."""
    u = np.asarray(useful, dtype=np.float64)
    if u.ndim != 1 or len(u) == 0:
        raise ValueError("useful must be 1-D, non-empty")
    if np.any(u < 0):
        raise ValueError("negative useful time")
    if elapsed is None:
        if not_useful is None:
            raise ValueError("need not_useful or elapsed")
        elapsed = elapsed_time(u, not_useful)
    if elapsed <= 0:
        raise ValueError("elapsed must be positive")
    sd = StateDurations(elapsed=float(elapsed), useful=u)
    return PopMetrics.from_frame(POP.compute(sd))
