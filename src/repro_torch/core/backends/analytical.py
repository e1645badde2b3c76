"""Analytical backend: device activity *predicted* from a per-step cost
model, copied from ``repro.core.backends.analytical``.

``StepModel`` is the roofline-derived per-step, per-device execution
model, from three terms:

    kernel time   = max(compute term, HBM term)
    memory time   = (1 - overlap) × collective term
    idle time     = host-side orchestration gap per step

The drivers give one to :class:`~repro_torch.core.talp.TalpMonitor` as its
``flop_model``: ``model_flops`` useful FLOPs per device per launch over
``hw.peak_flops`` is the measured Device Computational Efficiency.
:func:`trace_from_step_model` synthesizes a ``Trace`` from StepModels on
which the same eqs. (9)–(12) pipeline runs, and :class:`AnalyticalBackend`
wraps that into the analysis; the dry run (``repro_torch.launch.dryrun``)
feeds it the counts of a step run on fake tensors.

One change from the copy: the default ``hw`` is one NVIDIA H100 SXM
(:data:`H100_SXM`), the card the port runs on; the JAX package's default
is a TPU spec, whose peak would read the port's efficiency high.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..analysis import TraceAnalysis, analyze_trace
from ..states import DeviceActivity, Trace

__all__ = ["HardwareSpec", "H100_SXM", "StepModel", "AnalyticalBackend",
           "trace_from_step_model"]


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


def trace_from_step_model(
    models: Sequence[StepModel],
    steps: int = 1,
    host_useful_s: float = 0.0,
) -> Trace:
    """Synthesize a job trace: one StepModel per device, repeated ``steps``
    times. Device imbalance is expressed by passing per-device models with
    different FLOP counts.

    Device activity is generated **columnar**: per device, the kernel and
    memory records of all steps are computed as whole start/end columns
    (one ``arange`` per device) and delivered through
    :meth:`~repro_torch.core.states.DeviceTimeline.ingest_arrays` — no
    per-step Python loop, no ``DeviceRecord`` objects."""
    trace = Trace(name="analytical")
    step_busy = max(m.kernel_s + m.memory_s for m in models)
    step_gap = max(m.host_gap_s for m in models)
    period = host_useful_s + step_busy + step_gap
    # step s starts its device work at host_useful_s + s*period
    t0s = host_useful_s + period * np.arange(steps, dtype=np.float64)
    for d, m in enumerate(models):
        tl = trace.device(d)
        if m.kernel_s > 0:
            tl.ingest_arrays(DeviceActivity.KERNEL, t0s, t0s + m.kernel_s)
        if m.memory_s > 0:
            tl.ingest_arrays(
                DeviceActivity.MEMORY,
                t0s + m.kernel_s,
                t0s + m.kernel_s + m.memory_s,
            )
    t = steps * period
    # Host: one rank per device group; host is Useful for host_useful_s,
    # Offload while blocked on its own device pipeline (+ gap), and in
    # MPI while waiting for slower peers.
    for d, m in enumerate(models):
        busy_d = m.kernel_s + m.memory_s
        h = trace.host(d)
        h.useful = steps * host_useful_s
        h.offload = steps * (busy_d + step_gap)
        h.mpi = steps * max(0.0, step_busy - busy_d)
    trace.window = (0.0, t)
    return trace


class AnalyticalBackend:
    """Wraps StepModels into the standard analysis pipeline."""

    def __init__(self, models: Sequence[StepModel], steps: int = 1,
                 host_useful_s: float = 0.0):
        self.models = list(models)
        self.steps = steps
        self.host_useful_s = host_useful_s

    def analyze(self) -> TraceAnalysis:
        trace = trace_from_step_model(self.models, self.steps, self.host_useful_s)
        ce = self.models[0].computational_efficiency if self.models else None
        return analyze_trace(trace, computational_efficiency=ce)
