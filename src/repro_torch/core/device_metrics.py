"""Device-side efficiency hierarchy (paper §4.1, Fig. 3, eqs. 9–12).

Three device states per accelerator (streams flattened): Kernel (K),
Memory operations (M), Idle. The Parallel Efficiency branch:

  Device Parallel Efficiency  PE = ΣK / (E·m)                      (eq. 9)
  Load Balance                LB = ΣK / (m · max K)                (eq. 10)
  Communication Efficiency    CE = max K / max(K+M)                (eq. 11)
  Orchestration Efficiency    OE = max(K+M) / E                    (eq. 12)

with PE = LB × CE × OE (multiplicative). The second branch, Device
Computational Efficiency, is the paper's *future work*; we implement it
as a beyond-paper extension in :mod:`repro.core.backends.analytical`
(useful-model-FLOPs vs peak over kernel time) and feed it into the
hierarchy as an optional annotation node. The formulas live in
:data:`repro.core.hierarchy.DEVICE`; this module is the input-validating
façade around them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from .hierarchy import DEVICE, MetricFrame, StateDurations

__all__ = ["DeviceMetrics", "device_metrics"]


@dataclass(frozen=True)
class DeviceMetrics:
    parallel_efficiency: float        # eq. (9)
    load_balance: float               # eq. (10)
    communication_efficiency: float   # eq. (11)
    orchestration_efficiency: float   # eq. (12)
    elapsed: float
    n_devices: int
    # beyond-paper (paper's future-work branch), optional:
    computational_efficiency: Optional[float] = None

    @classmethod
    def from_frame(cls, frame: MetricFrame) -> "DeviceMetrics":
        return cls(**frame.scalar_fields())

    def frame(self) -> MetricFrame:
        return DEVICE.frame_of(self)

    def validate(self, tol: float = 1e-9) -> None:
        self.frame().validate(tol)

    def as_dict(self) -> Dict[str, float]:
        return self.frame().as_dict()


def device_metrics(
    kernel: Sequence[float],
    memory: Sequence[float],
    elapsed: float,
    computational_efficiency: Optional[float] = None,
) -> DeviceMetrics:
    """Compute eqs. (9)–(12) from per-device flattened state durations."""
    k = np.asarray(kernel, dtype=np.float64)
    mem = np.asarray(memory, dtype=np.float64)
    if k.shape != mem.shape or k.ndim != 1 or len(k) == 0:
        raise ValueError("kernel/memory must be equal-length 1-D, non-empty")
    if np.any(k < 0) or np.any(mem < 0):
        raise ValueError("negative state duration")
    if elapsed <= 0:
        raise ValueError("elapsed must be positive")
    extras = (
        {"computational_efficiency": computational_efficiency}
        if computational_efficiency is not None
        else {}
    )
    sd = StateDurations(elapsed=float(elapsed), kernel=k, memory=mem, extras=extras)
    return DeviceMetrics.from_frame(DEVICE.compute(sd))
