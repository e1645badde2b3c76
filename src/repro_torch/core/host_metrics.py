"""Host-side efficiency hierarchy for accelerated platforms (paper §4.1).

Extends the POP host hierarchy (Fig. 2). Three host states per rank:
Useful (U), Device Offloading (W), MPI. New metrics (orange boxes):

  Host Hybrid Parallel Efficiency  PE_host = ΣU / (E·n)              (eq. 6)
  MPI Parallel Efficiency          MPI_PE = Σ(U+W) / (E·n)           (eq. 7)
  Device Offload Efficiency        OE_host = ΣU / Σ(U+W)             (eq. 8)

with PE_host = MPI_PE × OE_host. MPI_PE's children apply "the same
treatment of states" (offload counts as useful):

  Load Balance           LB = Σ(U+W) / (n · max(U+W))
  Communication Eff.     CE = max(U+W) / E

so MPI_PE = LB × CE, mirroring the original POP formulas. The formulas
live in :data:`repro.core.hierarchy.HOST`; this module is the input-
validating façade around them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from .hierarchy import HOST, MetricFrame, StateDurations, elapsed_time

__all__ = ["HostMetrics", "host_metrics"]


@dataclass(frozen=True)
class HostMetrics:
    parallel_efficiency: float        # PE_host, eq. (6)
    mpi_parallel_efficiency: float    # eq. (7)
    communication_efficiency: float   # child of MPI PE
    load_balance: float               # child of MPI PE
    device_offload_efficiency: float  # eq. (8)
    elapsed: float
    n_processes: int
    # optional annotation: monitor self-cost fraction (absent → None)
    talp_overhead: Optional[float] = None

    @classmethod
    def from_frame(cls, frame: MetricFrame) -> "HostMetrics":
        return cls(**frame.scalar_fields())

    def frame(self) -> MetricFrame:
        return HOST.frame_of(self)

    def validate(self, tol: float = 1e-9) -> None:
        self.frame().validate(tol)

    def as_dict(self) -> Dict[str, float]:
        return self.frame().as_dict()


def host_metrics(
    useful: Sequence[float],
    offload: Sequence[float],
    mpi: Optional[Sequence[float]] = None,
    elapsed: Optional[float] = None,
    talp_overhead: Optional[float] = None,
) -> HostMetrics:
    """Compute eqs. (6)–(8) plus the MPI-PE children.

    ``elapsed`` defaults to paper eq. (1) over the three-state totals.
    ``talp_overhead`` (monitor self-cost fraction of wall-clock) feeds
    the optional annotation node of the same name.
    """
    u = np.asarray(useful, dtype=np.float64)
    w = np.asarray(offload, dtype=np.float64)
    if u.shape != w.shape or u.ndim != 1 or len(u) == 0:
        raise ValueError("useful/offload must be equal-length 1-D, non-empty")
    if np.any(u < 0) or np.any(w < 0):
        raise ValueError("negative state duration")
    if elapsed is None:
        if mpi is None:
            raise ValueError("need mpi durations or explicit elapsed")
        m = np.asarray(mpi, dtype=np.float64)
        elapsed = elapsed_time(u, w + m)
    if elapsed <= 0:
        raise ValueError("elapsed must be positive")
    extras = {} if talp_overhead is None else {"talp_overhead": float(talp_overhead)}
    sd = StateDurations(
        elapsed=float(elapsed), useful=u, offload=w, mpi=mpi, extras=extras
    )
    return HostMetrics.from_frame(HOST.compute(sd))
