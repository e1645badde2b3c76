"""Step-resolution metric series: one hierarchy frame per region close.

The exporter's polling cadence (:mod:`.exporter`) averages a one-step
load-imbalance spike or a slow offload-efficiency drift into the
cumulative history. This module captures metrics at *step* resolution
instead: a :class:`StepSeriesRecorder` attaches to
:meth:`TalpMonitor.on_region_close <repro.core.talp.TalpMonitor.on_region_close>`
and, for every closed window, computes the per-window host frame from
the close event's state deltas and the device frame by intersecting the
incremental flattened-timeline cache with exactly that window — then
appends one row to a bounded columnar :class:`StepSeries`.

Columns are derived **generically** from the hierarchy specs
(``{hierarchy.name}_{spec.key}`` for every node of every configured
hierarchy), so a metric registered with
:meth:`Hierarchy.with_child <repro.core.hierarchy.Hierarchy.with_child>`
flows into the step series, the per-step trace counters, the merged
job-level table, and the watchdog without touching this module. Rows
additionally carry the raw per-window host state durations
(useful/offload/mpi), which is what lets the merge layer *recompute*
exact job-level host metrics per step instead of averaging per-rank
efficiencies.

The ring is a structured NumPy array: appending a row is a handful of
scalar stores, and the whole series spools as one NPZ entry. The
recorder's hot-path cost is charged to the ``step`` section of the
monitor's :class:`~.overhead.OverheadAccumulator`, so it shows up under
the ``talp_overhead`` report annotation like every other monitor cost.

Copied from ``repro.core.telemetry.stepseries``, with one change for the
card. The copy drains the backend at every step close. The CUDA
backend's drain closes its CUPTI collection and the next launch opens a
new one: two synchronises, two 20 ms waits at the collection's edges, a
profiler stop and start and the parsing of the step's thousands of
kernel rows, at every step, with the reopening inside the next step.
Where the backend says so (``flush_closes_collection``) the recorder
therefore takes a step's host columns at its close and *defers* its
device columns: they are filled, and the watchdog fed in step order, at
the monitor's next drain (:meth:`TalpMonitor.on_flush`: a sample,
``finalize``, :meth:`StepSeriesRecorder.close`) or after
:data:`DEFER_STEPS` closes (fewer when the ring is smaller), whichever
comes first. A step's kernels have all finished by
its close, so the filled values are those a drain at the close would
have given, but for the monitor-wide Computational Efficiency, which is
the running value at the fill. Elsewhere (the CPU, a backend whose flush
is a copy of buffered rows) the recorder drains at every close, as the
copy does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..hierarchy import DEVICE, HOST, Hierarchy, StateDurations
from .. import intervals as ivx

__all__ = [
    "BASE_FIELDS",
    "DEFAULT_HIERARCHIES",
    "StepSeries",
    "StepSeriesRecorder",
    "metric_columns_of",
]

#: Step closes whose device columns may wait for a drain of a backend
#: whose flush closes its collection (see the module docstring).
DEFER_STEPS = 32

#: Hierarchies recorded by default (matches what the monitor reports).
DEFAULT_HIERARCHIES: Tuple[Hierarchy, ...] = (HOST, DEVICE)

#: Non-metric row fields, in dtype order. ``region`` indexes the interned
#: region-name table; ``useful``/``offload``/``mpi`` are the *per-window*
#: host state deltas (the merge layer rebuilds exact multi-rank host
#: metrics from them).
BASE_FIELDS: Tuple[Tuple[str, str], ...] = (
    ("step", "i8"),
    ("region", "u4"),
    ("t_open", "f8"),
    ("t_close", "f8"),
    ("elapsed", "f8"),
    ("useful", "f8"),
    ("offload", "f8"),
    ("mpi", "f8"),
)


def metric_columns_of(hierarchies: Sequence[Hierarchy]) -> Tuple[str, ...]:
    """Column name per metric node: ``{hierarchy.name}_{spec.key}`` for
    every spec in walk order — ``with_child()`` metrics appear
    automatically."""
    cols: List[str] = []
    for h in hierarchies:
        for spec in h.walk():
            cols.append(f"{h.name}_{spec.key}")
    return tuple(cols)


class StepSeries:
    """Bounded columnar ring of per-step metric rows.

    ``capacity`` bounds memory: once full, the oldest rows are
    overwritten and :attr:`n_dropped` counts what fell off. Metric
    columns hold NaN where a hierarchy produced no value for that step
    (e.g. no device activity yet, or an optional annotation node that
    returned ``None``).
    """

    def __init__(
        self,
        capacity: int = 4096,
        hierarchies: Sequence[Hierarchy] = DEFAULT_HIERARCHIES,
    ):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.hierarchies: Tuple[Hierarchy, ...] = tuple(hierarchies)
        self.metric_columns: Tuple[str, ...] = metric_columns_of(self.hierarchies)
        self.dtype = np.dtype(
            list(BASE_FIELDS) + [(c, "f8") for c in self.metric_columns]
        )
        self._buf = np.zeros(self.capacity, dtype=self.dtype)
        self._n = 0
        # rows that were already dropped before this object existed (set
        # by from_arrays when a spooled ring had wrapped) — pure
        # accounting, the buffer itself is never rotated by it
        self._pre_dropped = 0
        self._region_ids: Dict[str, int] = {}
        self._region_names: List[str] = []

    # -- write ------------------------------------------------------------
    def _intern(self, region: str) -> int:
        rid = self._region_ids.get(region)
        if rid is None:
            rid = len(self._region_names)
            self._region_ids[region] = rid
            self._region_names.append(region)
        return rid

    def append(
        self,
        region: str,
        step: int,
        t_open: float,
        t_close: float,
        useful: float = 0.0,
        offload: float = 0.0,
        mpi: float = 0.0,
        values: Optional[Dict[str, float]] = None,
    ) -> None:
        """Append one row; ``values`` maps metric column names to floats
        (missing columns become NaN, unknown keys are ignored)."""
        row = self._buf[self._n % self.capacity]
        row["step"] = step
        row["region"] = self._intern(region)
        row["t_open"] = t_open
        row["t_close"] = t_close
        row["elapsed"] = t_close - t_open
        row["useful"] = useful
        row["offload"] = offload
        row["mpi"] = mpi
        vals = values or {}
        for c in self.metric_columns:
            v = vals.get(c)
            row[c] = math.nan if v is None else v
        self._n += 1

    def fill(self, index: int, values: Dict[str, float]) -> bool:
        """Set the metric columns of the row appended as number ``index``
        (0-based, over every append) from ``values``, as :meth:`append`
        does; False, and nothing written, if the ring has overwritten it."""
        if not 0 <= self._n - 1 - index < self.capacity:
            return False
        row = self._buf[index % self.capacity]
        for c in self.metric_columns:
            v = values.get(c)
            row[c] = math.nan if v is None else v
        return True

    # -- read -------------------------------------------------------------
    @property
    def n_total(self) -> int:
        """Rows ever appended (including overwritten ones)."""
        return self._n + self._pre_dropped

    @property
    def n_dropped(self) -> int:
        return self._pre_dropped + max(0, self._n - self.capacity)

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    @property
    def region_names(self) -> Tuple[str, ...]:
        return tuple(self._region_names)

    def region_name(self, rid: int) -> str:
        return self._region_names[int(rid)]

    def rows(self) -> np.ndarray:
        """Retained rows in chronological order (a copy)."""
        if self._n <= self.capacity:
            return self._buf[: self._n].copy()
        i = self._n % self.capacity
        return np.concatenate([self._buf[i:], self._buf[:i]])

    def column(self, name: str, region: Optional[str] = None) -> np.ndarray:
        """One column, optionally restricted to a region's rows."""
        r = self.rows()
        if region is not None:
            r = r[r["region"] == self._region_ids[region]]
        return r[name].copy()

    # -- spool round trip --------------------------------------------------
    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Arrays for an NPZ spool entry: the structured ``rows`` (dtype
        carries the schema) plus the interned ``regions`` name table and
        the total-appended count (for ``n_dropped`` reconstruction)."""
        return {
            "rows": self.rows(),
            "regions": np.asarray(self._region_names, dtype=np.str_),
            "n_total": np.asarray(self._n, dtype=np.int64),
        }

    @classmethod
    def from_arrays(
        cls,
        rows: np.ndarray,
        regions: np.ndarray,
        n_total: Optional[int] = None,
    ) -> "StepSeries":
        """Rebuild from :meth:`to_arrays` output. The metric schema is
        recovered from the structured dtype itself, so a reader does not
        need the writer's (possibly ``with_child``-extended) hierarchy
        objects."""
        rows = np.asarray(rows)
        base = {name for name, _ in BASE_FIELDS}
        self = cls.__new__(cls)
        self.capacity = max(1, len(rows))
        self.hierarchies = ()
        self.metric_columns = tuple(
            n for n in (rows.dtype.names or ()) if n not in base
        )
        self.dtype = rows.dtype
        self._buf = np.array(rows, dtype=rows.dtype)
        # to_arrays() already emitted retained rows chronologically, so
        # the buffer starts unwrapped; any excess of n_total over what is
        # here was dropped by the writer's ring and is pure accounting.
        self._n = len(rows)
        total = int(n_total) if n_total is not None else len(rows)
        self._pre_dropped = max(0, total - len(rows))
        self._region_names = [str(r) for r in np.asarray(regions).tolist()]
        self._region_ids = {r: i for i, r in enumerate(self._region_names)}
        return self

    # -- text view ---------------------------------------------------------
    def as_table(
        self,
        columns: Optional[Sequence[str]] = None,
        max_rows: int = 50,
    ) -> str:
        """Plain-text per-step table (the merge CLI ``--step-series``
        view). ``columns`` defaults to every metric column."""
        cols = list(columns) if columns is not None else list(self.metric_columns)
        header = ["region", "step", "elapsed"] + cols
        lines = ["  ".join(f"{h:>24}" if i > 1 else f"{h:<12}"
                           for i, h in enumerate(header))]
        r = self.rows()
        shown = r if len(r) <= max_rows else r[-max_rows:]
        for row in shown:
            cells = [
                f"{self.region_name(row['region']):<12}",
                f"{int(row['step']):>24d}",
                f"{float(row['elapsed']):>24.6f}",
            ]
            for c in cols:
                v = float(row[c])
                cells.append(f"{'-':>24}" if math.isnan(v) else f"{v:>24.4f}")
            lines.append("  ".join(cells))
        if len(r) > max_rows:
            lines.append(f"... ({len(r) - max_rows} earlier rows not shown)")
        if self.n_dropped:
            lines.append(f"... ({self.n_dropped} rows dropped by ring capacity)")
        return "\n".join(lines)


class StepSeriesRecorder:
    """Attaches a :class:`StepSeries` (and optionally a watchdog) to a
    monitor's region-close hook.

    Per closed window the recorder computes:

      * the **host** frame from the event's per-window state deltas
        (single-rank ``StateDurations`` — exact, no history involved);
      * the **device** frame by intersecting the monitor's incremental
        per-device flattened cache with ``[t_open, t_close]`` — the same
        arrays ``sample()`` uses, so an unchanged timeline is a pure
        cache hit and the per-close cost stays bounded.

    ``regions`` restricts recording to a subset of region names (default:
    every region). The whole callback is charged to the monitor
    overhead accumulator's ``step`` section.

    Where the monitor's backend has ``flush_closes_collection`` set, the
    device columns are deferred to the next drain, at most
    :data:`DEFER_STEPS` closes (or ``capacity``, if smaller) later;
    ``deferred`` says whether they are.
    """

    def __init__(
        self,
        monitor,
        capacity: int = 4096,
        hierarchies: Sequence[Hierarchy] = DEFAULT_HIERARCHIES,
        regions: Optional[Sequence[str]] = None,
        watchdog=None,
    ):
        self.monitor = monitor
        self.series = StepSeries(capacity=capacity, hierarchies=hierarchies)
        self.regions = None if regions is None else frozenset(regions)
        self.watchdog = watchdog
        self.deferred = bool(getattr(getattr(monitor, "backend", None),
                                     "flush_closes_collection", False))
        self.defer_steps = min(DEFER_STEPS, self.series.capacity)
        # (row number, close event) of the rows whose device columns wait
        # for the next drain
        self._pending: List[Tuple[int, object]] = []
        self._unregister = monitor.on_region_close(self._on_close)
        self._unregister_flush = (monitor.on_flush(self._on_flush)
                                  if self.deferred else None)

    def close(self) -> None:
        """Fill the deferred rows (one drain of the backend) and detach from
        the monitor (idempotent)."""
        if self._pending:
            self.monitor._flush_backend()
        if self._unregister is not None:
            self._unregister()
            self._unregister = None
        if self._unregister_flush is not None:
            self._unregister_flush()
            self._unregister_flush = None

    # -- the hot path -----------------------------------------------------
    def _on_close(self, mon, ev) -> None:
        if self.regions is not None and ev.region not in self.regions:
            return
        t0 = mon.overhead.begin()
        try:
            self._record(mon, ev)
        finally:
            mon.overhead.end("step", t0)

    def _record(self, mon, ev) -> None:
        elapsed = ev.elapsed
        if elapsed <= 0:
            return
        if self.deferred:
            # host columns now, device columns at the next drain
            self.series.append(
                region=ev.region,
                step=ev.index,
                t_open=ev.t_open,
                t_close=ev.t_close,
                useful=ev.useful,
                offload=ev.offload,
                mpi=ev.mpi,
                values=self._values(mon, ev, device=False),
            )
            self._pending.append((self.series._n - 1, ev))
            if len(self._pending) >= self.defer_steps:
                mon._flush_backend()    # fills them through _on_flush
            return
        # Drain the backend's activity buffers so the just-closed window's
        # kernel/memory records are in the timelines (region close does not
        # flush by itself; sample()/finalize() do).
        mon._flush_backend()
        values = self._values(mon, ev)
        self.series.append(
            region=ev.region,
            step=ev.index,
            t_open=ev.t_open,
            t_close=ev.t_close,
            useful=ev.useful,
            offload=ev.offload,
            mpi=ev.mpi,
            values=values,
        )
        if self.watchdog is not None:
            self.watchdog.observe(
                region=ev.region, step=ev.index, t=ev.t_close, values=values
            )

    def _on_flush(self, mon) -> None:
        """After a drain: the deferred rows' device columns, and the
        watchdog fed with each whole row in step order."""
        if not self._pending:
            return
        t0 = mon.overhead.begin()
        try:
            pending, self._pending = self._pending, []
            for index, ev in pending:
                values = self._values(mon, ev)
                self.series.fill(index, values)
                if self.watchdog is not None:
                    self.watchdog.observe(
                        region=ev.region, step=ev.index, t=ev.t_close,
                        values=values,
                    )
        finally:
            mon.overhead.end("step", t0)

    def _values(self, mon, ev, device: bool = True) -> Dict[str, float]:
        """The metric columns of one closed window: the host frame from the
        event's state deltas and, with ``device``, the device frame from
        the monitor's timelines as they stand."""
        elapsed = ev.elapsed
        values: Dict[str, float] = {}
        for h in self.series.hierarchies:
            if h.name == "host":
                sd = StateDurations(
                    elapsed=elapsed,
                    useful=[ev.useful],
                    offload=[ev.offload],
                    mpi=[ev.mpi],
                )
            elif h.name == "device":
                if not device or not mon.devices:
                    continue
                flats = mon._device_flats()
                kernels: List[float] = []
                memories: List[float] = []
                for _dev, (kern, mem) in sorted(flats.items()):
                    kernels.append(
                        ivx.window_total(kern, ev.t_open, ev.t_close))
                    memories.append(
                        ivx.window_total(mem, ev.t_open, ev.t_close))
                if not kernels:
                    continue
                extras: Dict[str, float] = {}
                ce = mon.computational_efficiency(flats)
                if ce is not None:
                    extras["computational_efficiency"] = ce
                sd = StateDurations(
                    elapsed=elapsed,
                    kernel=kernels,
                    memory=memories,
                    extras=extras,
                )
            else:
                # Unknown hierarchy family: nothing to feed it per step.
                continue
            frame = h.compute(sd)
            for key, val in frame.values.items():
                values[f"{h.name}_{key}"] = val
        return values
