"""Declarative metric-hierarchy engine: one spec drives everything.

The paper's core contribution is a *multiplicative hierarchy* of host and
device efficiency metrics (eqs. 1–12, Figs. 1–3, Tables 1–3): each parent
metric is the product of its children. This module encodes that hierarchy
exactly once, as data:

  * :class:`StateDurations` — the common input record: per-rank host state
    durations (Useful, Offload, MPI), per-device state durations (Kernel,
    Memory), the elapsed time E (paper eq. 1) and free-form ``extras``.
  * :class:`MetricSpec` — one metric node: a stable ``key``, a report
    ``display`` name, a ``formula`` over :class:`StateDurations`, and its
    children. ``multiplicative=False`` marks annotation/extension nodes
    that are reported but excluded from the parent≡Π(children) invariant;
    ``optional=True`` marks nodes whose formula may return ``None`` (the
    node is then simply absent from the computed frame).
  * :class:`Hierarchy` — a named tree of specs with ``compute()`` →
    :class:`MetricFrame`, generic validation, and ``with_child()`` for
    registering new metrics without touching any other layer.
  * :class:`MetricFrame` — the computed values, in hierarchy order, with
    generic ``validate()`` (parent = product of multiplicative children),
    ``as_dict()`` (report JSON layout) and ``tree()`` (MetricNode view).

Every other layer derives from these specs: ``pop.py`` /
``host_metrics.py`` / ``device_metrics.py`` are thin dataclass façades
over :data:`POP` / :data:`HOST` / :data:`DEVICE`, ``tree.py`` builds its
``MetricNode`` trees from frames, ``report.py`` renders text / JSON /
node-scan tables generically from the specs (a registered metric appears
in every output format automatically), and ``merge.py`` /
``scalability.py`` recompute job-level metrics through the engine from
merged :class:`StateDurations`. Each paper formula is therefore stated
exactly once, in the instances at the bottom of this file.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "StateDurations",
    "MetricSpec",
    "MetricFrame",
    "Hierarchy",
    "elapsed_time",
    "POP",
    "HOST",
    "DEVICE",
    "SCALABILITY",
]


def elapsed_time(useful: Sequence[float], not_useful: Sequence[float]) -> float:
    """Eq. (1): E = max_i (D_U_i + D_notU_i)."""
    u = np.asarray(useful, dtype=np.float64)
    nu = np.asarray(not_useful, dtype=np.float64)
    if u.shape != nu.shape or u.ndim != 1 or len(u) == 0:
        raise ValueError("useful/not_useful must be equal-length 1-D, non-empty")
    return float(np.max(u + nu))


# ---------------------------------------------------------------------------
# the common input record
# ---------------------------------------------------------------------------
@dataclass
class StateDurations:
    """Per-rank / per-device state durations — the one record every
    hierarchy formula is written against.

    Host arrays are indexed by rank position, device arrays by device
    position; ``offload``/``mpi`` (resp. ``memory``) default to zeros of
    the matching shape. ``extras`` carries scalar side-channel inputs
    (e.g. an externally measured ``computational_efficiency``, or the
    baseline quantities of a scalability scan).
    """

    elapsed: float = 0.0
    useful: Optional[np.ndarray] = None
    offload: Optional[np.ndarray] = None
    mpi: Optional[np.ndarray] = None
    kernel: Optional[np.ndarray] = None
    memory: Optional[np.ndarray] = None
    extras: Dict[str, float] = field(default_factory=dict)
    _host_work: Optional[np.ndarray] = field(
        default=None, init=False, repr=False, compare=False
    )
    _device_work: Optional[np.ndarray] = field(
        default=None, init=False, repr=False, compare=False
    )

    def __post_init__(self) -> None:
        def arr(x, like):
            if x is None:
                return np.zeros(0 if like is None else len(like), dtype=np.float64)
            return np.asarray(x, dtype=np.float64)

        self.useful = arr(self.useful, None)
        self.offload = arr(self.offload, self.useful)
        self.mpi = arr(self.mpi, self.useful)
        self.kernel = arr(self.kernel, None)
        self.memory = arr(self.memory, self.kernel)

    # -- derived vectors (cached; shared by several formulas) ---------------
    @property
    def host_work(self) -> np.ndarray:
        """Useful + Offload: the "offload counts as useful" MPI-level view."""
        if self._host_work is None:
            self._host_work = self.useful + self.offload
        return self._host_work

    @property
    def device_work(self) -> np.ndarray:
        """Kernel + Memory: the non-idle device occupancy."""
        if self._device_work is None:
            self._device_work = self.kernel + self.memory
        return self._device_work

    @property
    def n_ranks(self) -> int:
        return len(self.useful)

    @property
    def n_devices(self) -> int:
        return len(self.kernel)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_host(
        cls,
        useful: Sequence[float],
        offload: Sequence[float],
        mpi: Optional[Sequence[float]] = None,
        elapsed: Optional[float] = None,
    ) -> "StateDurations":
        u = np.asarray(useful, dtype=np.float64)
        w = np.asarray(offload, dtype=np.float64)
        m = None if mpi is None else np.asarray(mpi, dtype=np.float64)
        if elapsed is None:
            if m is None:
                raise ValueError("need mpi durations or explicit elapsed")
            elapsed = elapsed_time(u, w + m)
        return cls(elapsed=float(elapsed), useful=u, offload=w, mpi=m)

    @classmethod
    def from_device(
        cls,
        kernel: Sequence[float],
        memory: Sequence[float],
        elapsed: float,
        extras: Optional[Dict[str, float]] = None,
    ) -> "StateDurations":
        return cls(
            elapsed=float(elapsed),
            kernel=np.asarray(kernel, dtype=np.float64),
            memory=np.asarray(memory, dtype=np.float64),
            extras=dict(extras or {}),
        )

    @classmethod
    def from_states(
        cls,
        host_states: Optional[Dict[int, Dict[str, float]]] = None,
        device_states: Optional[Dict[int, Dict[str, float]]] = None,
        elapsed: float = 0.0,
        extras: Optional[Dict[str, float]] = None,
    ) -> "StateDurations":
        """Build from the per-rank / per-device state dicts that
        :class:`~repro.core.talp.RegionResult` and the merge layer carry
        (keys sorted, so the construction is deterministic)."""
        ranks = sorted(host_states or {})
        devs = sorted(device_states or {})
        return cls(
            elapsed=float(elapsed),
            useful=[host_states[r]["useful"] for r in ranks] if ranks else None,
            offload=[host_states[r]["offload"] for r in ranks] if ranks else None,
            mpi=[host_states[r]["mpi"] for r in ranks] if ranks else None,
            kernel=[device_states[d]["kernel"] for d in devs] if devs else None,
            memory=[device_states[d]["memory"] for d in devs] if devs else None,
            extras=dict(extras or {}),
        )


# ---------------------------------------------------------------------------
# spec + frame + hierarchy
# ---------------------------------------------------------------------------
# A formula sees the input record and a ``dep(key)`` resolver for other
# metrics of the same hierarchy (memoized, cycle-checked).
Formula = Callable[[StateDurations, Callable[[str], Optional[float]]], Optional[float]]


@dataclass(frozen=True)
class MetricSpec:
    key: str
    display: str
    formula: Formula
    children: Tuple["MetricSpec", ...] = ()
    multiplicative: bool = True
    optional: bool = False


@dataclass
class MetricFrame:
    """Computed metric values of one hierarchy, in hierarchy order."""

    hierarchy: "Hierarchy"
    values: Dict[str, float]
    elapsed: float
    count: int

    def __getitem__(self, key: str) -> float:
        return self.values[key]

    def __contains__(self, key: str) -> bool:
        return key in self.values

    def get(self, key: str, default: Optional[float] = None) -> Optional[float]:
        return self.values.get(key, default)

    def validate(self, tol: float = 1e-9) -> None:
        """Generic multiplicative invariant: every node with multiplicative
        children equals their product (within ``tol``)."""
        for spec in self.hierarchy.walk():
            if spec.key not in self.values:
                continue
            mult = [
                c for c in spec.children
                if c.multiplicative and c.key in self.values
            ]
            if not mult:
                continue
            prod = 1.0
            for c in mult:
                prod *= self.values[c.key]
            if abs(prod - self.values[spec.key]) > tol:
                raise AssertionError(
                    f"{self.hierarchy.name}:{spec.key} "
                    f"{self.values[spec.key]} != product of children {prod}"
                )

    def scalar_fields(self) -> Dict[str, float]:
        """Core metrics (hierarchy order), then ``elapsed`` and the count,
        then optional/extension metrics — the façade-dataclass field layout
        and the report-JSON key order."""
        h = self.hierarchy
        out: Dict[str, float] = {}
        for spec in h.walk():
            if not spec.optional and spec.key in self.values:
                out[spec.key] = self.values[spec.key]
        out["elapsed"] = self.elapsed
        out[h.count_key] = self.count
        for spec in h.walk():
            if spec.optional and spec.key in self.values:
                out[spec.key] = self.values[spec.key]
        return out

    def as_dict(self) -> Dict[str, float]:
        return self.scalar_fields()

    def tree(self):
        """MetricNode view of this frame (paper Figs. 1–3)."""
        from .tree import tree_from_frame

        return tree_from_frame(self)


@dataclass
class Hierarchy:
    """A named multiplicative metric hierarchy (one paper figure)."""

    name: str          # engine id: "pop" / "host" / "device" / ...
    side: str          # report side column: "Host" / "Device"
    count_key: str     # scalar count field: "n_processes" / "n_devices"
    count: Callable[[StateDurations], int]
    root: MetricSpec
    _index: Dict[str, MetricSpec] = field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    def __post_init__(self) -> None:
        for spec in self.walk():
            if spec.key in self._index:
                raise ValueError(f"duplicate metric key {spec.key!r} in {self.name}")
            self._index[spec.key] = spec

    def walk(self) -> Iterator[MetricSpec]:
        """Pre-order walk (parent before children, siblings in order)."""

        def rec(spec: MetricSpec) -> Iterator[MetricSpec]:
            yield spec
            for c in spec.children:
                yield from rec(c)

        yield from rec(self.root)

    def spec(self, key: str) -> MetricSpec:
        return self._index[key]

    def keys(self) -> Tuple[str, ...]:
        return tuple(s.key for s in self.walk())

    def compute(self, sd: StateDurations) -> MetricFrame:
        """Evaluate every formula against one :class:`StateDurations`."""
        values: Dict[str, float] = {}
        resolving: set = set()

        def dep(key: str) -> Optional[float]:
            if key in values:
                return values[key]
            if key in resolving:
                raise RuntimeError(
                    f"metric dependency cycle at {key!r} in hierarchy {self.name}"
                )
            spec = self._index[key]
            resolving.add(key)
            try:
                v = spec.formula(sd, dep)
            finally:
                resolving.discard(key)
            if v is not None:
                values[key] = float(v)
                return values[key]
            if not spec.optional:
                raise ValueError(
                    f"formula for non-optional metric {key!r} returned None"
                )
            return None

        for spec in self.walk():
            dep(spec.key)
        return MetricFrame(
            hierarchy=self, values=values,
            elapsed=sd.elapsed, count=self.count(sd),
        )

    def frame_of(self, obj) -> MetricFrame:
        """Rebuild a frame from any object exposing the metric keys as
        attributes (the façade dataclasses, or a reconstructed payload)."""
        values: Dict[str, float] = {}
        for spec in self.walk():
            v = getattr(obj, spec.key, None)
            if v is not None:
                values[spec.key] = v
        return MetricFrame(
            hierarchy=self,
            values=values,
            elapsed=getattr(obj, "elapsed", 0.0),
            count=getattr(obj, self.count_key, 0),
        )

    def with_child(self, parent_key: str, child: MetricSpec) -> "Hierarchy":
        """Register a new metric under ``parent_key`` — returns a NEW
        hierarchy; compute/validate/tree/report all pick the node up
        automatically. Multiplicative children must complete the parent's
        product; annotation metrics should pass ``multiplicative=False``.
        """
        if parent_key not in self._index:
            raise KeyError(f"no metric {parent_key!r} in hierarchy {self.name}")
        if child.key in self._index:
            raise ValueError(f"metric {child.key!r} already exists in {self.name}")

        def rebuild(spec: MetricSpec) -> MetricSpec:
            children = tuple(rebuild(c) for c in spec.children)
            if spec.key == parent_key:
                children = children + (child,)
            return replace(spec, children=children)

        return Hierarchy(
            name=self.name, side=self.side, count_key=self.count_key,
            count=self.count, root=rebuild(self.root),
        )


# ---------------------------------------------------------------------------
# shared arithmetic — each efficiency form is written once
# ---------------------------------------------------------------------------
def _parallel_efficiency(work: np.ndarray, elapsed: float, n: int) -> float:
    """Σ work / (E · n) — eqs. (3), (6), (7), (9)."""
    return float(np.sum(work)) / (elapsed * n)


def _load_balance(work: np.ndarray) -> float:
    """Σ work / (n · max work) — eqs. (4), (10) and the MPI-level LB."""
    m = float(np.max(work))
    return float(np.sum(work)) / (len(work) * m) if m > 0 else 0.0


def _ratio(num: float, den: float) -> float:
    """num / den, 0 when the denominator vanishes — eqs. (5), (8), (11), (12)."""
    return num / den if den > 0 else 0.0


# ---------------------------------------------------------------------------
# the paper's hierarchies, stated once
# ---------------------------------------------------------------------------
#: Original POP MPI hierarchy (paper §3.3, Fig. 1): PE = LB × CE.
POP = Hierarchy(
    name="pop",
    side="MPI",
    count_key="n_processes",
    count=lambda sd: sd.n_ranks,
    root=MetricSpec(
        "parallel_efficiency", "Parallel Efficiency",
        lambda sd, dep: _parallel_efficiency(sd.useful, sd.elapsed, sd.n_ranks),  # eq. (3)
        children=(
            MetricSpec(
                "load_balance", "Load Balance",
                lambda sd, dep: _load_balance(sd.useful),                         # eq. (4)
            ),
            MetricSpec(
                "communication_efficiency", "Communication Eff.",
                lambda sd, dep: _ratio(float(np.max(sd.useful)), sd.elapsed),     # eq. (5)
            ),
        ),
    ),
)

#: Host hierarchy for accelerated platforms (paper §4.1, Fig. 2):
#: PE_host = MPI_PE × OE_host, with MPI_PE = LB × CE over Useful+Offload.
HOST = Hierarchy(
    name="host",
    side="Host",
    count_key="n_processes",
    count=lambda sd: sd.n_ranks,
    root=MetricSpec(
        "parallel_efficiency", "Parallel Efficiency",
        lambda sd, dep: _parallel_efficiency(sd.useful, sd.elapsed, sd.n_ranks),  # eq. (6)
        children=(
            MetricSpec(
                "mpi_parallel_efficiency", "MPI Parallel Eff.",
                lambda sd, dep: _parallel_efficiency(                             # eq. (7)
                    sd.host_work, sd.elapsed, sd.n_ranks
                ),
                children=(
                    MetricSpec(
                        "communication_efficiency", "Comm. Eff.",
                        lambda sd, dep: _ratio(
                            float(np.max(sd.host_work)), sd.elapsed
                        ),
                    ),
                    MetricSpec(
                        "load_balance", "Load Balance",
                        lambda sd, dep: _load_balance(sd.host_work),
                    ),
                ),
            ),
            MetricSpec(
                "device_offload_efficiency", "Device Offload Eff.",
                lambda sd, dep: _ratio(                                           # eq. (8)
                    float(np.sum(sd.useful)), float(np.sum(sd.host_work))
                ),
            ),
            # TALP self-cost as a fraction of wall-clock — the paper's
            # "lightweight monitoring" claim, measured (fed through
            # ``extras`` by the monitor's overhead accumulator; absent
            # unless self-accounting is enabled).
            MetricSpec(
                "talp_overhead", "TALP Overhead",
                lambda sd, dep: sd.extras.get("talp_overhead"),
                multiplicative=False,
                optional=True,
            ),
        ),
    ),
)

#: Device hierarchy (paper §4.1, Fig. 3): PE = LB × CE × OE, plus the
#: paper's future-work Computational Efficiency branch as an optional
#: annotation node fed through ``extras`` (beyond-paper extension).
DEVICE = Hierarchy(
    name="device",
    side="Device",
    count_key="n_devices",
    count=lambda sd: sd.n_devices,
    root=MetricSpec(
        "parallel_efficiency", "Parallel Efficiency",
        lambda sd, dep: _parallel_efficiency(sd.kernel, sd.elapsed, sd.n_devices),  # eq. (9)
        children=(
            MetricSpec(
                "load_balance", "Load Balance",
                lambda sd, dep: _load_balance(sd.kernel),                           # eq. (10)
            ),
            MetricSpec(
                "communication_efficiency", "Communication Eff.",
                lambda sd, dep: _ratio(                                             # eq. (11)
                    float(np.max(sd.kernel)), float(np.max(sd.device_work))
                ),
            ),
            MetricSpec(
                "orchestration_efficiency", "Orchestration Eff.",
                lambda sd, dep: _ratio(float(np.max(sd.device_work)), sd.elapsed),  # eq. (12)
            ),
            MetricSpec(
                "computational_efficiency", "Computational Eff.",
                lambda sd, dep: sd.extras.get("computational_efficiency"),
                multiplicative=False,
                optional=True,
            ),
        ),
    ),
)

#: POP scalability branch across runs (beyond-paper, §"scalability
#: metrics of several TALP runs"): Global Eff. = Comp. Scalability × PE,
#: with Speedup as a non-multiplicative annotation. Inputs arrive via
#: ``extras``: base_elapsed, resources, base_resources, parallel_efficiency.
SCALABILITY = Hierarchy(
    name="scalability",
    side="Scal",
    count_key="resources",
    count=lambda sd: int(sd.extras.get("resources", 0)),
    root=MetricSpec(
        "global_efficiency", "Global Efficiency",
        lambda sd, dep: _ratio(
            dep("speedup"),
            sd.extras["resources"] / sd.extras["base_resources"],
        ),
        children=(
            MetricSpec(
                "computational_scalability", "Computational Scalability",
                lambda sd, dep: _ratio(
                    dep("global_efficiency"), dep("parallel_efficiency")
                ),
            ),
            MetricSpec(
                "parallel_efficiency", "Parallel Efficiency",
                lambda sd, dep: float(sd.extras["parallel_efficiency"]),
            ),
            MetricSpec(
                "speedup", "Speedup",
                lambda sd, dep: _ratio(sd.extras["base_elapsed"], sd.elapsed),
                multiplicative=False,
            ),
        ),
    ),
)
