"""POP Scalability metrics across multiple TALP runs (beyond-paper).

The paper computes only the *efficiency* branch ("Because TALP reports
the metrics for a single run, only the efficiency metrics can be
obtained. However, with the hardware counters collected by TALP, a user
can compute the scalability metrics of several TALP runs."). This module
is that computation: given per-run TALP results (or their JSON), it
derives the POP scaling branch relative to a baseline run:

    Speedup(n)                   = T_base / T_n
    Global Efficiency(n)         = Speedup / (resources_n / resources_base)
    Parallel Efficiency(n)       = from the run itself (eqs. 3/6)
    Computational Scalability(n) = Global Eff. / Parallel Eff.
                                   (= useful-computation growth: how much
                                   total useful work inflated with scale)

so Global = Computational Scalability × Parallel Efficiency, preserving
POP's multiplicative structure across the scan. The formulas live in
:data:`repro.core.hierarchy.SCALABILITY`; this module feeds it one
:class:`StateDurations` per run (baseline quantities via ``extras``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

from .analysis import TraceAnalysis
from .hierarchy import SCALABILITY, StateDurations
from .talp import RegionResult

Result = Union[RegionResult, TraceAnalysis]

__all__ = ["ScalabilityPoint", "scalability_scan", "render_scalability"]


@dataclass(frozen=True)
class ScalabilityPoint:
    label: str
    resources: int            # ranks (or ranks × devices) in the run
    elapsed: float
    parallel_efficiency: float
    speedup: float
    global_efficiency: float
    computational_scalability: float

    def validate(self, tol: float = 1e-6) -> None:
        try:
            SCALABILITY.frame_of(self).validate(tol)
        except AssertionError:
            prod = self.computational_scalability * self.parallel_efficiency
            raise AssertionError(
                f"{self.label}: GE {self.global_efficiency} != "
                f"CS*PE {prod}"
            )


def _resources(r: Result) -> int:
    return max(1, len(r.host_states) or getattr(r, "n_ranks", 1))


def _pe(r: Result) -> float:
    if r.host is not None:
        return r.host.parallel_efficiency
    if r.device is not None:
        return r.device.parallel_efficiency
    raise ValueError("result carries no metrics")


def scalability_scan(
    results: Sequence[Result],
    labels: Optional[Sequence[str]] = None,
    resources: Optional[Sequence[int]] = None,
) -> List[ScalabilityPoint]:
    """First entry is the baseline. ``resources`` overrides rank counts
    (e.g. ranks × GPUs)."""
    if not results:
        return []
    labels = list(labels or [str(i) for i in range(len(results))])
    res = list(resources or [_resources(r) for r in results])
    base_t = results[0].elapsed
    base_r = res[0]
    points = []
    for r, lab, n in zip(results, labels, res):
        frame = SCALABILITY.compute(
            StateDurations(
                elapsed=r.elapsed,
                extras={
                    "base_elapsed": base_t,
                    "resources": float(n),
                    "base_resources": float(base_r),
                    "parallel_efficiency": _pe(r),
                },
            )
        )
        points.append(
            ScalabilityPoint(
                label=lab, resources=n, elapsed=r.elapsed,
                parallel_efficiency=frame["parallel_efficiency"],
                speedup=frame["speedup"],
                global_efficiency=frame["global_efficiency"],
                computational_scalability=frame["computational_scalability"],
            )
        )
    return points


def render_scalability(points: Sequence[ScalabilityPoint],
                       title: str = "POP scalability scan") -> str:
    lines = [title, f"{'run':>10s} {'res':>5s} {'elapsed':>10s} {'speedup':>8s} "
             f"{'GlobalEff':>10s} {'ParEff':>8s} {'CompScal':>9s}"]
    for p in points:
        lines.append(
            f"{p.label:>10s} {p.resources:5d} {p.elapsed:10.4f} "
            f"{p.speedup:8.3f} {p.global_efficiency:10.3f} "
            f"{p.parallel_efficiency:8.3f} {p.computational_scalability:9.3f}"
        )
    return "\n".join(lines)
