"""The drivers' flop model: ``HardwareSpec`` and ``StepModel``, copied from
``repro.core.backends.analytical``.

``StepModel`` is the roofline-derived per-step, per-device execution
model. The drivers give one to :class:`~repro_torch.core.talp.TalpMonitor`
as its ``flop_model``: ``model_flops`` useful FLOPs per device per launch
over ``hw.peak_flops`` is the measured Device Computational Efficiency.

One change from the copy: the default ``hw`` is one NVIDIA H100 SXM
(:data:`H100_SXM`), the card the port runs on; the JAX package's default
is a TPU spec, whose peak would read the port's efficiency high. The
analytical backend itself (``AnalyticalBackend``,
``trace_from_step_model``) is not copied yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["HardwareSpec", "H100_SXM", "StepModel"]


@dataclass(frozen=True)
class HardwareSpec:
    """Per-card hardware constants (defaults: one H100 SXM, dense)."""

    name: str = "h100_sxm"
    peak_flops: float = 989e12      # bf16 dense tensor-core FLOP/s
    hbm_bw: float = 3.35e12         # HBM3 bytes/s
    ici_bw: float = 450e9           # NVLink 4 bytes/s per direction


H100_SXM = HardwareSpec()


@dataclass(frozen=True)
class StepModel:
    """Roofline-derived per-step, per-device execution model.

    All byte/FLOP counts are **per device** (the compiled SPMD program is
    the per-device program).
    """

    flops: float                    # HLO FLOPs per device per step
    hbm_bytes: float                # HLO bytes accessed per device per step
    collective_bytes: float         # collective operand bytes per device per step
    model_flops: float = 0.0        # useful model FLOPs per device per step
    hw: HardwareSpec = H100_SXM
    collective_overlap: float = 0.0  # fraction of collective time hidden
    host_gap_s: float = 0.0         # per-step orchestration gap (host-induced)

    @property
    def compute_s(self) -> float:
        return self.flops / self.hw.peak_flops

    @property
    def hbm_s(self) -> float:
        return self.hbm_bytes / self.hw.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / self.hw.ici_bw

    @property
    def kernel_s(self) -> float:
        return max(self.compute_s, self.hbm_s)

    @property
    def memory_s(self) -> float:
        return (1.0 - self.collective_overlap) * self.collective_s

    @property
    def step_s(self) -> float:
        return self.kernel_s + self.memory_s + self.host_gap_s

    @property
    def computational_efficiency(self) -> Optional[float]:
        """Beyond-paper Device Computational Efficiency branch."""
        if self.model_flops <= 0 or self.kernel_s <= 0:
            return None
        return (self.model_flops / self.hw.peak_flops) / self.kernel_s
