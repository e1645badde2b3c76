"""Execution-state model for TALP on accelerated platforms.

The paper's simplified execution model (§4.1):

  * Host (per MPI process/rank): three mutually exclusive states —
    (i) ``USEFUL`` computation, (ii) ``OFFLOAD`` (blocked in
    device-related operations: transfers, launches, synchronization),
    (iii) ``MPI`` (blocked in cross-process communication).
  * Device (per accelerator, streams not distinguished): three states —
    (i) ``KERNEL`` computation (useful work), (ii) ``MEMORY`` operations,
    (iii) ``IDLE``. Overlap between computation and communication
    streams counts as computation.

``HostTimeline`` holds per-state accumulated durations for one rank.
``DeviceTimeline`` holds raw activity records for one device and applies
the paper's flattening pipeline to produce the state occupancy breakdown.
``Trace`` aggregates both sides for one monitored region/run.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from . import intervals as iv
from .recordio import KIND_KERNEL, KIND_MEMORY, ColumnStore, as_record_columns
from .telemetry import overhead as _ovh


class HostState(enum.Enum):
    USEFUL = "useful"
    OFFLOAD = "offload"  # "Device Offloading" in the paper
    MPI = "mpi"


class DeviceActivity(enum.Enum):
    KERNEL = "kernel"
    MEMORY = "memory"

    @property
    def code(self) -> int:
        """Integer kind code used by the columnar record engine."""
        return KIND_KERNEL if self is DeviceActivity.KERNEL else KIND_MEMORY

    @classmethod
    def from_code(cls, code: int) -> "DeviceActivity":
        return _KIND_BY_CODE[int(code)]


_KIND_BY_CODE = (DeviceActivity.KERNEL, DeviceActivity.MEMORY)


class DeviceState(enum.Enum):
    KERNEL = "kernel"
    MEMORY = "memory"
    IDLE = "idle"


@dataclass
class DeviceRecord:
    """One raw activity record, as delivered by a backend (≙ CUPTI activity)."""

    kind: DeviceActivity
    start: float
    end: float
    stream: int = 0
    name: str = ""

    def __post_init__(self):
        if self.end < self.start:
            raise ValueError(f"record end < start: {self}")


@dataclass
class HostTimeline:
    """Accumulated host-state durations for one rank.

    ``useful`` may either be accumulated explicitly or derived as
    ``elapsed - offload - mpi`` (the TALP measurement model: PMPI
    intercepts MPI time, the CUPTI-analogue intercepts offload time,
    everything else is useful).
    """

    rank: int = 0
    useful: float = 0.0
    offload: float = 0.0
    mpi: float = 0.0

    def add(self, state: HostState, duration: float) -> None:
        if duration < 0:
            raise ValueError("negative duration")
        if state is HostState.USEFUL:
            self.useful += duration
        elif state is HostState.OFFLOAD:
            self.offload += duration
        else:
            self.mpi += duration

    @property
    def elapsed(self) -> float:
        return self.useful + self.offload + self.mpi

    def as_dict(self) -> Dict[str, float]:
        return {"useful": self.useful, "offload": self.offload, "mpi": self.mpi}


@dataclass
class DeviceOccupancy:
    """Flattened per-device state breakdown over a window."""

    kernel: float
    memory: float
    idle: float

    @property
    def elapsed(self) -> float:
        return self.kernel + self.memory + self.idle

    def as_dict(self) -> Dict[str, float]:
        return {"kernel": self.kernel, "memory": self.memory, "idle": self.idle}


@dataclass
class DeviceTimeline:
    """Activity records for one device + the paper's post-processing.

    The pipeline (§4.2, backend-independent):
      1. kernel records are flattened across streams,
      2. memory records are flattened, then kernel-overlapping segments
         are removed (overlap counts as computation),
      3. remaining uncovered window time is idle.

    Storage is **columnar and zero-object**: pending records live in a
    preallocated NumPy structured buffer (``kind:u1, start:f8, end:f8,
    stream:u4``, amortized-doubling growth — see
    :class:`repro.core.recordio.ColumnStore`); no ``DeviceRecord``
    instance is ever allocated on the ingestion path. Backends deliver
    whole activity buffers through :meth:`ingest_arrays`; the per-record
    ``add()``/``ingest()`` methods are a thin compatibility façade over
    the same store, and :attr:`records` materializes the pending rows as
    ``DeviceRecord`` objects only on demand (tests, debugging).

    Ingestion is *streaming*: pending rows accumulate until
    ``compact_threshold`` is reached, then they are folded into per-kind
    flattened interval arrays (``compact()`` — a vectorized
    boolean-mask-per-kind fold, no Python loop over records). A timeline
    therefore holds at most ``compact_threshold`` pending rows plus the
    (disjoint, hence bounded by trace structure, not record count)
    compacted arrays — a million activity records flatten in bounded
    memory. Compaction is lossy w.r.t. per-record identity (stream ids,
    kernel names) but exact w.r.t. the state occupancy the metrics are
    computed from.
    """

    device: int = 0
    compact_threshold: int = 65536
    _store: ColumnStore = field(init=False, repr=False)
    _compact: Dict[DeviceActivity, np.ndarray] = field(
        default_factory=dict, init=False, repr=False
    )
    _span: Optional[Tuple[float, float]] = field(default=None, init=False, repr=False)
    _n_compacted: int = field(default=0, init=False, repr=False)
    # Kernel-record launch count, maintained at ingest time (compaction
    # folds records into flattened occupancy, losing per-record identity,
    # so the count cannot be recovered later). Feeds the monitor's
    # measured Computational Efficiency (launches × model FLOPs).
    _n_kernel: int = field(default=0, init=False, repr=False)
    # kind -> (pending-count watermark, flattened intervals); pending count
    # only moves monotonically between compactions (which clear the cache),
    # so it is a sound cache key.
    _kind_cache: Dict[DeviceActivity, Tuple[int, np.ndarray]] = field(
        default_factory=dict, init=False, repr=False
    )
    # kind -> capacity slab backing the streaming-append fast path of
    # compact(); the logical array in ``_compact`` is a prefix view of
    # it. Writes only ever touch rows past every outstanding view's
    # length, so shared views stay valid.
    _compact_buf: Dict[DeviceActivity, np.ndarray] = field(
        default_factory=dict, init=False, repr=False
    )

    def __post_init__(self):
        if self.compact_threshold <= 0:
            raise ValueError(
                f"compact_threshold must be positive, got {self.compact_threshold}"
            )
        self._store = ColumnStore(capacity=min(self.compact_threshold, 4096))

    @property
    def n_records(self) -> int:
        """Total records ever ingested (pending + already compacted)."""
        return self._n_compacted + len(self._store)

    @property
    def n_pending(self) -> int:
        """Pending (not yet compacted) records currently buffered."""
        return len(self._store)

    @property
    def n_kernel_records(self) -> int:
        """Kernel records ever ingested (a launch count — counted at
        ingest time, since compaction erases per-record identity)."""
        return self._n_kernel

    @property
    def records(self) -> List[DeviceRecord]:
        """Pending rows materialized as ``DeviceRecord`` objects.

        Compatibility façade over the columnar store — a fresh list is
        built per access (names are not retained by the columnar core),
        so mutating it does not affect the timeline.
        """
        v = self._store.view()
        return [
            DeviceRecord(_KIND_BY_CODE[k], float(s), float(e), int(st))
            for k, s, e, st in zip(v["kind"], v["start"], v["end"], v["stream"])
        ]

    def add(self, kind: DeviceActivity, start: float, end: float,
            stream: int = 0, name: str = "") -> None:
        if end < start:
            raise ValueError(
                f"record end < start: ({kind}, {start}, {end})"
            )
        self._store.append(kind.code, start, end, stream)
        if kind is DeviceActivity.KERNEL:
            self._n_kernel += 1
        if len(self._store) >= self.compact_threshold:
            self.compact()

    def extend(self, records: Iterable[DeviceRecord]) -> None:
        self.ingest(records)

    def ingest(self, records: Iterable, chunk_size: Optional[int] = None) -> int:
        """Stream records (``DeviceRecord`` or ``(kind, start, end[, stream,
        name])`` tuples) from any iterable, compacting every ``chunk_size``
        records so arbitrarily long streams are ingested in bounded memory.
        Returns the number of records ingested."""
        if chunk_size is not None and chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        chunk = self.compact_threshold if chunk_size is None else chunk_size
        store = self._store
        n = 0
        for rec in records:
            if isinstance(rec, DeviceRecord):
                kind, start, end, stream = rec.kind, rec.start, rec.end, rec.stream
            else:
                kind, start, end = rec[0], rec[1], rec[2]
                stream = rec[3] if len(rec) > 3 else 0
            if end < start:
                raise ValueError(f"record end < start: ({kind}, {start}, {end})")
            code = kind.code if isinstance(kind, DeviceActivity) else int(kind)
            store.append(code, start, end, stream)
            if code == KIND_KERNEL:
                self._n_kernel += 1
            n += 1
            if len(store) >= chunk:
                self.compact()
        return n

    def ingest_arrays(
        self,
        kinds,
        starts,
        ends,
        streams=None,
    ) -> int:
        """Batch API: ingest one whole activity buffer as columns.

        ``kinds`` is an integer kind-code array, a sequence of
        :class:`DeviceActivity`, or a single kind applied to the whole
        batch; ``starts``/``ends`` are float arrays; ``streams`` defaults
        to stream 0. The batch is appended in ``compact_threshold``-sized
        slices with compaction in between, so arbitrarily large buffers
        ingest in bounded memory. Returns the number of records ingested.
        """
        kind_col, starts, ends, stream_col = as_record_columns(
            kinds, starts, ends, streams
        )
        self._n_kernel += int(np.count_nonzero(kind_col == KIND_KERNEL))
        m = len(starts)
        pos = 0
        while pos < m:
            room = self.compact_threshold - len(self._store)
            if room <= 0:
                self.compact()
                continue
            end_pos = min(m, pos + room)
            self._store.extend_columns(
                kind_col[pos:end_pos], starts[pos:end_pos],
                ends[pos:end_pos], stream_col[pos:end_pos],
            )
            pos = end_pos
            if len(self._store) >= self.compact_threshold:
                self.compact()
        return m

    def compact(self) -> None:
        """Fold pending rows into the per-kind flattened arrays.

        Fully vectorized: per-kind selection is a boolean mask over the
        columnar buffer; the flatten itself is the vectorized merge in
        :func:`repro.core.intervals.flatten`.
        """
        v = self._store.view()
        if len(v) == 0:
            return
        with _ovh.section("compact"):
            starts, ends, kinds = v["start"], v["end"], v["kind"]
            lo, hi = float(starts.min()), float(ends.max())
            self._span = (
                (lo, hi) if self._span is None
                else (min(self._span[0], lo), max(self._span[1], hi))
            )
            for kind in DeviceActivity:
                mask = kinds == kind.code
                if not mask.any():
                    continue
                pairs = iv.flatten(np.stack([starts[mask], ends[mask]], axis=1))
                base = self._compact.get(kind)
                if base is None or len(base) == 0:
                    self._compact[kind] = pairs
                    self._compact_buf.pop(kind, None)
                elif len(pairs) and pairs[0, 0] > base[-1, 1]:
                    # Streaming fast path: the new chunk lies strictly
                    # after the compacted history (records arrive in time
                    # order), so the fold appends into a capacity-doubling
                    # slab — amortized O(chunk) per compact, not
                    # O(history). Appends land past the end of every
                    # outstanding prefix view, so sharing stays safe.
                    n, k = len(base), len(pairs)
                    buf = self._compact_buf.get(kind)
                    if buf is None or base.base is not buf or n + k > len(buf):
                        buf = np.empty((max(2 * (n + k), 1024), 2),
                                       dtype=np.float64)
                        buf[:n] = base
                        self._compact_buf[kind] = buf
                    buf[n:n + k] = pairs
                    self._compact[kind] = buf[: n + k]
                else:
                    self._compact[kind] = iv.flatten(
                        np.concatenate([base, pairs], axis=0)
                    )
                    self._compact_buf.pop(kind, None)
            self._n_compacted += len(v)
            self._store.clear()
            self._kind_cache.clear()

    def kind_intervals(self, kind: DeviceActivity) -> np.ndarray:
        """Flattened intervals of one activity kind (compacted + pending).

        Cached on the pending-row watermark, so repeated calls between
        ingests (the online ``sample()`` pattern) are O(1) instead of
        O(pending). Treat the returned array as read-only.
        """
        n_pending = len(self._store)
        cached = self._kind_cache.get(kind)
        if cached is not None and cached[0] == n_pending:
            return cached[1]
        v = self._store.view()
        mask = v["kind"] == kind.code
        base = self._compact.get(kind)
        if not mask.any():
            # No pending rows of this kind: hand out the compacted array
            # itself (read-only contract above). Compaction never mutates
            # it in place — folds reassign a fresh array — so sharing is
            # safe and the post-compact path stays O(1) per call.
            out = base if base is not None else iv.EMPTY.copy()
        else:
            pairs = np.stack([v["start"][mask], v["end"][mask]], axis=1)
            if base is not None:
                pairs = np.concatenate([base, pairs], axis=0)
            out = iv.flatten(pairs)
        self._kind_cache[kind] = (n_pending, out)
        return out

    def span(self) -> Tuple[float, float]:
        """(min start, max end) over every record ever ingested."""
        lo, hi = self._span if self._span is not None else (np.inf, -np.inf)
        v = self._store.view()
        if len(v):
            lo = min(lo, float(v["start"].min()))
            hi = max(hi, float(v["end"].max()))
        if lo > hi:
            return (0.0, 0.0)
        return (lo, hi)

    # -- columnar serialization (binary spool payloads) -----------------
    def to_columns(self) -> Dict[str, object]:
        """Columnar snapshot: pending structured rows + compacted per-kind
        interval arrays + metadata — the payload the binary spool format
        writes (NPZ columns, no per-record encoding)."""
        return {
            "pending": self._store.view().copy(),
            "kernel": self._compact.get(DeviceActivity.KERNEL, iv.EMPTY).copy(),
            "memory": self._compact.get(DeviceActivity.MEMORY, iv.EMPTY).copy(),
            "meta": {
                "device": self.device,
                "compact_threshold": self.compact_threshold,
                "n_compacted": self._n_compacted,
                "n_kernel": self._n_kernel,
                "span": list(self._span) if self._span is not None else None,
            },
        }

    @classmethod
    def from_columns(
        cls,
        pending: np.ndarray,
        kernel: np.ndarray,
        memory: np.ndarray,
        device: int = 0,
        compact_threshold: int = 65536,
        n_compacted: int = 0,
        span: Optional[Tuple[float, float]] = None,
        n_kernel: Optional[int] = None,
    ) -> "DeviceTimeline":
        """Inverse of :meth:`to_columns` (exact state reconstruction).

        ``n_kernel`` restores the launch count; payloads from producers
        that did not record it fall back to counting the pending rows
        (the compacted portion's launches are unrecoverable)."""
        tl = cls(device=device, compact_threshold=compact_threshold)
        if len(kernel):
            tl._compact[DeviceActivity.KERNEL] = iv.as_intervals(kernel)
        if len(memory):
            tl._compact[DeviceActivity.MEMORY] = iv.as_intervals(memory)
        tl._n_compacted = int(n_compacted)
        tl._span = (float(span[0]), float(span[1])) if span is not None else None
        if len(pending):
            tl._store.extend_columns(
                pending["kind"], pending["start"],
                pending["end"], pending["stream"],
            )
        tl._n_kernel = (
            int(n_kernel) if n_kernel is not None
            else int(np.count_nonzero(pending["kind"] == KIND_KERNEL))
            if len(pending) else 0
        )
        return tl

    def occupancy(self, window: Optional[Tuple[float, float]] = None) -> DeviceOccupancy:
        kern = self.kind_intervals(DeviceActivity.KERNEL)
        mem = iv.subtract(self.kind_intervals(DeviceActivity.MEMORY), kern)
        if window is None:
            window = self.span()
        kern_c = iv.clip(kern, *window)
        mem_c = iv.clip(mem, *window)
        idle = iv.gaps(iv.union(kern_c, mem_c), *window)
        return DeviceOccupancy(
            kernel=iv.total(kern_c), memory=iv.total(mem_c), idle=iv.total(idle)
        )

    def state_intervals(self, window: Tuple[float, float]) -> Dict[DeviceState, np.ndarray]:
        """Disjoint per-state intervals over a window (for trace rendering)."""
        kern = iv.clip(self.kind_intervals(DeviceActivity.KERNEL), *window)
        mem = iv.clip(
            iv.subtract(self.kind_intervals(DeviceActivity.MEMORY), kern), *window
        )
        idle = iv.gaps(iv.union(kern, mem), *window)
        return {DeviceState.KERNEL: kern, DeviceState.MEMORY: mem, DeviceState.IDLE: idle}


@dataclass
class ObjectPathTimeline:
    """Retained object-per-event reference implementation of
    :class:`DeviceTimeline` (one Python ``DeviceRecord`` per activity
    event, per-record list-comprehension compaction).

    Kept verbatim as the correctness oracle for the columnar engine: the
    hypothesis property tests and ``benchmarks/merge_bench.py`` assert
    bit-identical compacted intervals, spans and metric frames between
    this path and the columnar one — and the benchmark gates the
    columnar path's ≥10× ingestion+compaction speedup against it. Not
    used on any production path.
    """

    device: int = 0
    records: List[DeviceRecord] = field(default_factory=list)
    compact_threshold: int = 65536
    _compact: Dict[DeviceActivity, np.ndarray] = field(
        default_factory=dict, init=False, repr=False
    )
    _span: Optional[Tuple[float, float]] = field(default=None, init=False, repr=False)
    _n_compacted: int = field(default=0, init=False, repr=False)

    @property
    def n_records(self) -> int:
        return self._n_compacted + len(self.records)

    def add(self, kind: DeviceActivity, start: float, end: float,
            stream: int = 0, name: str = "") -> None:
        self.records.append(DeviceRecord(kind, start, end, stream, name))
        if len(self.records) >= self.compact_threshold:
            self.compact()

    def extend(self, records: Iterable[DeviceRecord]) -> None:
        self.ingest(records)

    def ingest(self, records: Iterable, chunk_size: Optional[int] = None) -> int:
        if chunk_size is not None and chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        chunk = self.compact_threshold if chunk_size is None else chunk_size
        n = 0
        for rec in records:
            if not isinstance(rec, DeviceRecord):
                rec = DeviceRecord(*rec)
            self.records.append(rec)
            n += 1
            if len(self.records) >= chunk:
                self.compact()
        return n

    def compact(self) -> None:
        if not self.records:
            return
        lo = min(r.start for r in self.records)
        hi = max(r.end for r in self.records)
        self._span = (
            (lo, hi) if self._span is None
            else (min(self._span[0], lo), max(self._span[1], hi))
        )
        for kind in DeviceActivity:
            pairs = [(r.start, r.end) for r in self.records if r.kind is kind]
            if not pairs:
                continue
            parts = [iv.as_intervals(pairs)]
            if kind in self._compact:
                parts.append(self._compact[kind])
            self._compact[kind] = iv.flatten(np.concatenate(parts, axis=0))
        self._n_compacted += len(self.records)
        self.records.clear()

    def kind_intervals(self, kind: DeviceActivity) -> np.ndarray:
        pairs = [(r.start, r.end) for r in self.records if r.kind is kind]
        base = self._compact.get(kind)
        if base is None:
            return iv.flatten(iv.as_intervals(pairs)) if pairs else iv.EMPTY.copy()
        if not pairs:
            return base.copy()
        return iv.flatten(np.concatenate([base, iv.as_intervals(pairs)], axis=0))

    def span(self) -> Tuple[float, float]:
        lo, hi = self._span if self._span is not None else (np.inf, -np.inf)
        for r in self.records:
            lo = min(lo, r.start)
            hi = max(hi, r.end)
        if lo > hi:
            return (0.0, 0.0)
        return (lo, hi)

    def occupancy(self, window: Optional[Tuple[float, float]] = None) -> DeviceOccupancy:
        kern = self.kind_intervals(DeviceActivity.KERNEL)
        mem = iv.subtract(self.kind_intervals(DeviceActivity.MEMORY), kern)
        if window is None:
            window = self.span()
        kern_c = iv.clip(kern, *window)
        mem_c = iv.clip(mem, *window)
        idle = iv.gaps(iv.union(kern_c, mem_c), *window)
        return DeviceOccupancy(
            kernel=iv.total(kern_c), memory=iv.total(mem_c), idle=iv.total(idle)
        )


@dataclass
class Trace:
    """One monitored region: host timelines per rank + device timelines.

    ``elapsed`` follows paper eq. (1): E = max_i (D_useful_i + D_not_useful_i)
    unless an explicit window is provided (then E = window span, which is
    what the online runtime backend uses).
    """

    hosts: Dict[int, HostTimeline] = field(default_factory=dict)
    devices: Dict[int, DeviceTimeline] = field(default_factory=dict)
    window: Optional[Tuple[float, float]] = None
    name: str = "Global"

    def host(self, rank: int) -> HostTimeline:
        if rank not in self.hosts:
            self.hosts[rank] = HostTimeline(rank=rank)
        return self.hosts[rank]

    def device(self, dev: int) -> DeviceTimeline:
        if dev not in self.devices:
            self.devices[dev] = DeviceTimeline(device=dev)
        return self.devices[dev]

    @property
    def elapsed(self) -> float:
        if self.window is not None:
            return self.window[1] - self.window[0]
        if not self.hosts:
            # device-only trace: use the union span of device activity
            spans = [
                d.occupancy().elapsed for d in self.devices.values()
            ]
            return max(spans, default=0.0)
        return max(h.elapsed for h in self.hosts.values())

    def device_occupancies(self) -> Dict[int, DeviceOccupancy]:
        win = self.window
        if win is None and self.hosts:
            win = (0.0, self.elapsed)
        return {d: tl.occupancy(win) for d, tl in self.devices.items()}
