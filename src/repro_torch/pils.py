"""PILS — Parallel Imbalance Load Simulator, extended for accelerators.

Re-implementation of the paper's synthetic microbenchmark (§5.1): PILS
"constructs simple execution patterns" with controlled load imbalance,
offloading, data movement and CPU/GPU overlap, used to validate that the
TALP metrics report what the trace shows. All seven paper use cases are
provided as parameterized pattern generators over
:class:`~repro.core.backends.SyntheticTraceBuilder`; each mirrors the
paper's Fig. 4–10 trace shape with 2 MPI ranks × 2 GPUs.

Where the paper states explicit metric values they are engineered to
match exactly (UC1 Orchestration 82 %, UC2 Offload 94 % / Device PE 5 %,
UC3/UC4 Load Balance 55 %, UC5 host LB 70 % / Orchestration 33 %, UC7
Offload +33 % / Orchestration ≈50 %). UC6 fixes the three device-side
constraints the paper reports (host LB 72 %, device Comm. Eff. 36 %,
Orchestration 86 %); the paper's Device Offload Efficiency of 9 % is not
reachable simultaneously with those three under the published pattern
description, so we match "very low" qualitatively and note it in
EXPERIMENTS.md.

Copied from ``repro.pils`` for the port. The reference's docstring
promises a live mode (``run_live``) that neither package defines; the
port's live check of the same measurement path is on the card:
``chip_smoke.py::talp_backend_check`` and
``tests/test_torch_gpu.py::test_cuda_host_gap_inside_one_launch_is_device_idle``
drive real kernels and host gaps through the CUDA runtime backend and
hold TALP's device states to what was launched.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

from .core.analysis import TraceAnalysis, analyze_trace
from .core.backends import SyntheticTraceBuilder
from .core.states import Trace

__all__ = ["USE_CASES", "use_case", "PilsResult", "run_use_case"]


@dataclass
class PilsResult:
    name: str
    description: str
    traces: Dict[str, Trace]
    analyses: Dict[str, TraceAnalysis]


def _uc1(iters: int = 5) -> Dict[str, Trace]:
    """Loaded GPUs, underutilized CPUs, well balanced.

    Host useful : GPU kernel = 0.18 : 0.82 per iteration →
    Orchestration Eff. 82 %, everything else (but Offload Eff.) 100 %.
    """
    b = SyntheticTraceBuilder(nranks=2, ndevices=2, name="uc1")
    for _ in range(iters):
        for r in range(2):
            b.rank(r).useful(0.18).offload_kernel(0.82)
    return {"trace": b.build()}


def _uc2(iters: int = 5) -> Dict[str, Trace]:
    """Loaded CPUs, underutilized GPUs, well balanced.

    Per iter: useful 9.4, offload window 0.6 of which kernel 0.5 (0.1 is
    launch/sync overhead) → Device Offload Eff. 94 %, Device PE 5 %.
    """
    b = SyntheticTraceBuilder(nranks=2, ndevices=2, name="uc2")
    for _ in range(iters):
        for r in range(2):
            c = b.rank(r)
            c.useful(9.4)
            # offload window with embedded (shorter) kernel
            t0 = c.t
            b.device_kernel(r, t0 + 0.05, 0.5)
            c.offload(0.6)
    return {"trace": b.build()}


def _uc3(iters: int = 1) -> Dict[str, Trace]:
    """Loaded GPUs, imbalanced GPU computation (GPU0 ≈ 10× GPU1).

    Device Load Balance 55 %, Device Offload Eff. 26 %; rank 1 waits in
    MPI for rank 0 (red in the paper's trace).
    """
    u, g0, g1 = 0.19324324, 1.0, 0.1
    b = SyntheticTraceBuilder(nranks=2, ndevices=2, name="uc3")
    for _ in range(iters):
        b.rank(0).useful(u).offload_kernel(g0)
        b.rank(1).useful(u).offload_kernel(g1)
        b.barrier()
    return {"trace": b.build()}


def _uc4(iters: int = 1) -> Dict[str, Trace]:
    """Imbalanced GPUs and CPUs, CPUs more loaded than GPUs.

    rank0: long offload (g=1.0) then long compute (u=4.0);
    rank1: short offload (0.1), short burst (0.4), then MPI wait.
    Host LB 55 %, device LB 55 %, Orchestration 20 %.
    """
    b = SyntheticTraceBuilder(nranks=2, ndevices=2, name="uc4")
    for _ in range(iters):
        b.rank(0).offload_kernel(1.0).useful(4.0)
        b.rank(1).offload_kernel(0.1).useful(0.4)
        b.barrier()
    return {"trace": b.build()}


def _uc5(iters: int = 1) -> Dict[str, Trace]:
    """Imbalanced CPU load, same global load CPU and GPU.

    Equal offload (g=1.0) on both ranks, then imbalanced CPU chunk
    (u0=2.0303, u1=0.2121) with rank 1 waiting in MPI.
    Host LB 70 %, Orchestration Eff. 33 %.
    """
    g, u0, u1 = 1.0, 2.030303, 0.212121
    b = SyntheticTraceBuilder(nranks=2, ndevices=2, name="uc5")
    for _ in range(iters):
        b.rank(0).offload_kernel(g).useful(u0)
        b.rank(1).offload_kernel(g).useful(u1)
        b.barrier()
    return {"trace": b.build()}


def _uc6(iters: int = 1) -> Dict[str, Trace]:
    """Even distribution of work, large host↔device data movement.

    Both ranks: useful u then kernel g; then rank 0 moves a large chunk
    D from the device (green) while rank 1 blocks in MPI (red).
    Engineered: host LB 72 %, device Comm. Eff. 36 %, Orchestration 86 %.
    """
    # E := 1.0; g+D = 0.86 (OE 86%), g = 0.36·(g+D) (CE 36%); rank 0 is the
    # slowest rank so u = E - (g+D), which lands host LB at 0.7248 ≈ 72%.
    E = 1.0
    g = 0.86 * E * 9.0 / 25.0        # 0.3096
    D = 0.86 * E - g                 # 0.5504
    u = E - (g + D)                  # 0.14
    b = SyntheticTraceBuilder(nranks=2, ndevices=2, name="uc6")
    for _ in range(iters):
        b.rank(0).useful(u).offload_kernel(g).offload_memory(D)
        b.rank(1).useful(u).offload_kernel(g)
        b.barrier()
    return {"trace": b.build()}


def _uc7(iters: int = 4) -> Dict[str, Trace]:
    """Comparison of CPU–GPU computation overlap (two runs).

    CPU workload is 2× the GPU workload (u = 2g). Without overlap the
    host blocks in the offload (Offload Eff. 67 %, Orchestration 33 %);
    with asynchronous launches the kernel hides under host compute
    (Offload Eff. ≈100 %, Orchestration ≈50 %).
    """
    g, u = 1.0, 2.0
    b1 = SyntheticTraceBuilder(nranks=2, ndevices=2, name="uc7_no_overlap")
    for _ in range(iters):
        for r in range(2):
            b1.rank(r).useful(u).offload_kernel(g)
    b2 = SyntheticTraceBuilder(nranks=2, ndevices=2, name="uc7_overlap")
    for _ in range(iters):
        for r in range(2):
            b2.rank(r).async_kernel(g).useful(u)
    return {"no_overlap": b1.build(), "overlap": b2.build()}


USE_CASES: Dict[str, Tuple[Callable[..., Dict[str, Trace]], str]] = {
    "uc1": (_uc1, "Loaded GPUs, underutilized CPUs, well balanced"),
    "uc2": (_uc2, "Loaded CPUs, underutilized GPUs, well balanced"),
    "uc3": (_uc3, "Loaded GPUs, imbalanced GPU computation"),
    "uc4": (_uc4, "Imbalanced GPUs and CPUs, CPUs more loaded"),
    "uc5": (_uc5, "Imbalanced CPU load, same global CPU/GPU load"),
    "uc6": (_uc6, "Even distribution, large host-device data movement"),
    "uc7": (_uc7, "CPU-GPU computation overlap comparison"),
}


def use_case(name: str, **kwargs) -> Dict[str, Trace]:
    fn, _ = USE_CASES[name]
    return fn(**kwargs)


def run_use_case(name: str, **kwargs) -> PilsResult:
    fn, desc = USE_CASES[name]
    traces = fn(**kwargs)
    analyses = {k: analyze_trace(t) for k, t in traces.items()}
    return PilsResult(name=name, description=desc, traces=traces,
                      analyses=analyses)
