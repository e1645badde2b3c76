"""Trace → metrics analysis for multi-rank / multi-device traces.

``TalpMonitor`` measures one process; ``Trace`` (built synthetically, by
the analytical backend, or merged from per-process JSON) carries the
whole job. This module computes the paper's host and device hierarchies
from a ``Trace`` — the aggregation step TALP performs at report time.
All metric arithmetic is routed through the façades into the declarative
engine (:data:`repro.core.hierarchy.HOST` / :data:`~.DEVICE`); no
formula is restated here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from .device_metrics import DeviceMetrics, device_metrics
from .host_metrics import HostMetrics, host_metrics
from .states import Trace
from .tree import MetricNode, device_tree, host_tree

__all__ = ["TraceAnalysis", "analyze_trace"]


@dataclass
class TraceAnalysis:
    host: Optional[HostMetrics]
    device: Optional[DeviceMetrics]
    elapsed: float
    host_states: Dict[int, Dict[str, float]]
    device_states: Dict[int, Dict[str, float]]
    name: str = "Global"

    def trees(self) -> Dict[str, MetricNode]:
        out: Dict[str, MetricNode] = {}
        if self.host is not None:
            out["host"] = host_tree(self.host)
        if self.device is not None:
            out["device"] = device_tree(self.device)
        return out

    def validate(self, tol: float = 1e-6) -> None:
        if self.host is not None:
            self.host.validate(tol)
        if self.device is not None:
            self.device.validate(tol)


def analyze_trace(
    trace: Trace,
    computational_efficiency: Optional[float] = None,
) -> TraceAnalysis:
    """Compute eqs. (6)–(12) for a complete job trace."""
    elapsed = trace.elapsed
    hm = None
    host_states: Dict[int, Dict[str, float]] = {}
    if trace.hosts:
        ranks = sorted(trace.hosts)
        useful = [trace.hosts[r].useful for r in ranks]
        offload = [trace.hosts[r].offload for r in ranks]
        mpi = [trace.hosts[r].mpi for r in ranks]
        hm = host_metrics(useful, offload, mpi, elapsed=elapsed)
        host_states = {r: trace.hosts[r].as_dict() for r in ranks}

    dm = None
    device_states: Dict[int, Dict[str, float]] = {}
    if trace.devices:
        occ = trace.device_occupancies()
        devs = sorted(occ)
        kernel = [occ[d].kernel for d in devs]
        memory = [occ[d].memory for d in devs]
        # Re-anchor idle to the job window: occupancy() computed idle
        # within the record span; the device-level idle in the paper is
        # relative to the elapsed time E.
        device_states = {
            d: {
                "kernel": occ[d].kernel,
                "memory": occ[d].memory,
                "idle": max(0.0, elapsed - occ[d].kernel - occ[d].memory),
            }
            for d in devs
        }
        if elapsed > 0:
            dm = device_metrics(
                kernel, memory, elapsed,
                computational_efficiency=computational_efficiency,
            )
    return TraceAnalysis(
        host=hm,
        device=dm,
        elapsed=elapsed,
        host_states=host_states,
        device_states=device_states,
        name=trace.name,
    )
