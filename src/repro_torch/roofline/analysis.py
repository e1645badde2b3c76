"""Roofline analysis of one step per device. Port of
``repro.roofline.analysis`` (``CollectiveStats``, ``RooflineReport``,
``build_report``).

Per (arch × shape × mesh) the dry run (``repro_torch.launch.dryrun``)
supplies each device's FLOPs, HBM bytes, collective bytes by kind and
memory footprint, counted from the step's local ops on fake tensors.
Three roofline terms (seconds, per step, per device):

    compute    = FLOPs / peak_FLOPs            (989 TFLOP/s bf16, H100 SXM)
    memory     = bytes / HBM_bw                (3.35 TB/s)
    collective = collective_bytes / link_bw    (450 GB/s NVLink 4, a direction)

Deliberate differences from the JAX namesake:

* ``collective_bytes_from_hlo`` is not ported: there is no compiled module
  to read. The dry run's collective record fills the same
  :class:`CollectiveStats` through :meth:`CollectiveStats.add` as the
  collectives run, one per op, with the result's bytes, under the JAX
  kinds (:data:`COLLECTIVES`): :func:`collective_kind` maps both of
  torch's namespaces onto them, the functional ``_c10d_functional.*`` ops
  (DTensor's redistributions) and the eager ``c10d.*_`` ops
  (``torch.distributed.all_reduce``). ``wait_tensor`` moves nothing and
  is not counted, as an async pair's ``-done`` half is not in JAX.
  ``build_report`` takes those stats in place of the HLO text.
* ``hw`` defaults to :data:`~repro_torch.core.backends.analytical.H100_SXM`.
* ``memory_analysis`` is any object with the attributes of XLA's
  ``CompiledMemoryStats`` that are read (``peak_memory_in_bytes``,
  ``argument_size_in_bytes``, ``output_size_in_bytes``,
  ``temp_size_in_bytes``), as the dry run's ``MemoryAnalysis``.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional

from ..core.backends.analytical import H100_SXM, HardwareSpec

__all__ = [
    "COLLECTIVES",
    "CollectiveStats",
    "RooflineReport",
    "build_report",
    "collective_kind",
]

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# torch's collective ops (the name of the op packet, namespace included),
# each under its JAX kind
_KIND = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_out": "reduce-scatter",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "collective-permute",
    "_c10d_functional.broadcast_": "collective-permute",
    "_c10d_functional.isend": "collective-permute",
    "_c10d_functional.irecv": "collective-permute",
    "_c10d_functional.batch_p2p_ops": "collective-permute",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_coalesced_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.gather_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.reduce_": "all-reduce",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "collective-permute",
    "c10d.scatter_": "collective-permute",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
    "c10d.recv_any_source_": "collective-permute",
}

# ops of those namespaces that move no data
_NOT_COUNTED = {
    "_c10d_functional.wait_tensor",
    "c10d.barrier",
    "c10d.monitored_barrier_",
    "c10d.check_for_nan",
}


def collective_kind(op_name: str) -> Optional[str]:
    """The JAX kind of the torch op named ``op_name`` (``namespace.name``,
    as ``OpOverloadPacket`` names it), or None for an op of another
    namespace or one that moves no data (``wait_tensor``, barriers).
    Raises ``KeyError`` for a collective of either namespace that has no
    kind here, so none goes uncounted."""
    namespace = op_name.split(".")[0]
    if namespace not in ("_c10d_functional", "c10d") or (
            op_name in _NOT_COUNTED):
        return None
    return _KIND[op_name]


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    def add(self, kind: str, nbytes: int) -> None:
        """Count one collective of ``kind`` whose results are ``nbytes``."""
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device, per-step
    flops: float
    hbm_bytes: float
    collective_bytes: float
    collective_detail: Dict[str, int]
    collective_count: int
    model_flops: float          # useful model FLOPs per device per step
    # memory analysis (bytes per device)
    peak_memory: Optional[float] = None
    argument_size: Optional[float] = None
    output_size: Optional[float] = None
    temp_size: Optional[float] = None
    hw: HardwareSpec = H100_SXM

    # ---- derived terms (seconds) ----
    @property
    def compute_s(self) -> float:
        return self.flops / self.hw.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.hw.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / self.hw.ici_bw

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Bound model: overlapped compute/HBM, exposed collectives."""
        return max(self.compute_s, self.memory_s) + self.collective_s

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — catches remat/redundancy waste."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable fraction of peak on the bound model: useful FLOPs
        over peak·step-time. Meaningful for train/prefill; decode steps
        are bandwidth-bound by definition — see ``bound_fraction``."""
        if self.step_s <= 0:
            return 0.0
        return (self.model_flops / self.hw.peak_flops) / self.step_s

    @property
    def bound_fraction(self) -> float:
        """Dominant-term share of the modeled step: 1.0 = the step is
        purely its own roofline bound with everything else hidden. The
        per-cell optimization target for bandwidth-bound (decode) cells."""
        if self.step_s <= 0:
            return 0.0
        return max(self.compute_s, self.memory_s, self.collective_s) / self.step_s

    def step_model(self):
        """Bridge to the analytical execution model: a per-device
        :class:`~repro_torch.core.backends.analytical.StepModel` carrying
        this report's roofline estimates."""
        from ..core.backends.analytical import StepModel

        return StepModel(
            flops=self.flops,
            hbm_bytes=self.hbm_bytes,
            collective_bytes=self.collective_bytes,
            model_flops=self.model_flops,
            hw=self.hw,
        )

    def to_dict(self) -> Dict:
        d = {
            k: v for k, v in asdict(self).items() if k != "hw"
        }
        d.update(
            compute_s=self.compute_s,
            memory_s=self.memory_s,
            collective_s=self.collective_s,
            dominant=self.dominant,
            step_s=self.step_s,
            useful_flop_ratio=self.useful_flop_ratio,
            roofline_fraction=self.roofline_fraction,
            bound_fraction=self.bound_fraction,
        )
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)


def build_report(
    arch: str,
    shape: str,
    mesh_desc: str,
    chips: int,
    cost: Dict[str, float],
    collectives: Optional[CollectiveStats],
    model_flops_global: float,
    memory_analysis=None,
    hw: HardwareSpec = H100_SXM,
) -> RooflineReport:
    stats = collectives if collectives is not None else CollectiveStats()
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    rep = RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_desc,
        chips=chips,
        flops=flops,
        hbm_bytes=hbm,
        collective_bytes=float(stats.total_bytes),
        collective_detail=dict(stats.bytes_by_kind),
        collective_count=stats.total_count,
        model_flops=model_flops_global / chips,
        hw=hw,
    )
    if memory_analysis is not None:
        for attr, key in (
            ("peak_memory", "peak_memory_in_bytes"),
            ("argument_size", "argument_size_in_bytes"),
            ("output_size", "output_size_in_bytes"),
            ("temp_size", "temp_size_in_bytes"),
        ):
            val = getattr(memory_analysis, key, None)
            if val is not None:
                setattr(rep, attr, float(val))
    return rep
