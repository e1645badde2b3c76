"""TalpMonitor — the TALP measurement engine (paper §3.2, §4.2). Copied
from ``repro.core.talp``; the changes for the card (the instrument
fallback's synchronise, the launch count of Computational Efficiency,
``on_flush``) are listed in :mod:`repro_torch.core`.

Mirrors TALP's design:

  * **Region API** (≙ TALP user-level API): ``with monitor.region("solver")``
    — regions may nest and re-open; a ``Global`` region always exists.
  * **Host state accounting**: explicit ``offload()`` / ``mpi()`` scopes
    (≙ CUPTI runtime callbacks / PMPI interception); everything else in
    an open region is *Useful* — exactly TALP's measurement model.
  * **Device activity records** arrive asynchronously from a pluggable
    backend (≙ CUPTI/rocprofiler activity buffers) and are
    post-processed with the paper's flattening pipeline at ``finalize``
    (or at an online ``sample()``).
  * **Online + post-mortem**: ``sample()`` returns live metrics;
    ``finalize()`` produces the full per-region report (text/JSON via
    :mod:`repro.core.report`).

Transparency: ``monitor.instrument(fn)`` wraps a jitted callable so the
application code needs no changes (≙ LD_PRELOAD).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import intervals as ivx
from .device_metrics import DeviceMetrics, device_metrics
from .host_metrics import HostMetrics, host_metrics
from .states import DeviceActivity, DeviceTimeline, HostState
from .telemetry import overhead as _ovh
from .tree import MetricNode, device_tree, host_tree

__all__ = ["TalpMonitor", "RegionResult", "TalpResult", "StepCloseEvent"]


def _synchronize() -> None:
    """Wait for the device work queued so far: a CUDA synchronise when
    this process has initialised CUDA, else nothing (CPU tensors are
    computed eagerly). Stands in for ``jax.block_until_ready``."""
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass(frozen=True)
class StepCloseEvent:
    """One region close, seen by ``on_region_close`` callbacks.

    ``index`` counts closes of *this* region (0-based) — the step index
    of the step-series row. The state durations are **per-window
    deltas**: exactly the offload/MPI charged between this open and this
    close (not the region's cumulative totals), so a one-step anomaly is
    visible at full amplitude instead of being averaged into history.
    """

    region: str
    index: int
    t_open: float
    t_close: float
    useful: float
    offload: float
    mpi: float

    @property
    def elapsed(self) -> float:
        return self.t_close - self.t_open


@dataclass
class _RegionAcc:
    """Accumulator for one (region, rank).

    ``closed_total`` is the running sum of closed-window durations,
    maintained at ``close_region`` time so ``elapsed()`` is O(1) instead
    of O(#windows). ``window_intervals`` likewise keeps a flattened-array
    cache of the closed windows and folds in only the ones appended since
    the last call — an open region samples in O(1) per new window.
    ``open_offload``/``open_mpi`` snapshot the cumulative state totals at
    ``open_region`` time so ``close_region`` can hand per-window deltas
    to the region-close callbacks.
    """

    windows: List[Tuple[float, float]] = field(default_factory=list)
    open_since: Optional[float] = None
    offload: float = 0.0
    mpi: float = 0.0
    closed_total: float = 0.0
    open_offload: float = 0.0
    open_mpi: float = 0.0
    _flat: Optional[np.ndarray] = field(
        default=None, init=False, repr=False, compare=False
    )
    _flat_n: int = field(default=0, init=False, repr=False, compare=False)

    def elapsed(self, now: Optional[float] = None) -> float:
        tot = self.closed_total
        if self.open_since is not None and now is not None:
            tot += max(0.0, now - self.open_since)
        return tot

    def window_intervals(self, now: Optional[float] = None) -> np.ndarray:
        if self._flat_n < len(self.windows):
            new = ivx.as_intervals(self.windows[self._flat_n:])
            if self._flat is not None and len(self._flat):
                new = np.concatenate([self._flat, new], axis=0)
            self._flat = ivx.flatten(new)
            self._flat_n = len(self.windows)
        flat = self._flat if self._flat is not None else ivx.EMPTY
        if self.open_since is not None and now is not None:
            open_iv = ivx.as_intervals([(self.open_since, now)])
            if not len(flat):
                return open_iv
            return ivx.flatten(np.concatenate([flat, open_iv], axis=0))
        return flat.copy()


@dataclass
class RegionResult:
    name: str
    elapsed: float
    n_ranks: int
    n_devices: int
    host: Optional[HostMetrics]
    device: Optional[DeviceMetrics]
    host_states: Dict[int, Dict[str, float]]
    device_states: Dict[int, Dict[str, float]]

    def trees(self) -> Dict[str, MetricNode]:
        out: Dict[str, MetricNode] = {}
        if self.host is not None:
            out["host"] = host_tree(self.host)
        if self.device is not None:
            out["device"] = device_tree(self.device)
        return out


@dataclass
class TalpResult:
    name: str
    regions: Dict[str, RegionResult]
    #: Partial-merge annotation (a :class:`repro.core.collect.RankCoverage`):
    #: set by tolerant job-level merges to record which ranks were
    #: expected/merged/missing/quarantined. ``None`` on per-rank results
    #: and on strict (all-ranks) merges.
    rank_coverage: Optional[object] = None

    def __getitem__(self, region: str) -> RegionResult:
        return self.regions[region]


class TalpMonitor:
    """Lightweight region/state monitor for one process ("rank")."""

    GLOBAL = "Global"

    def __init__(
        self,
        name: str = "talp",
        rank: int = 0,
        clock: Callable[[], float] = time.perf_counter,
        backend: Optional[object] = None,
        auto_start: bool = True,
        incremental: bool = True,
        overhead_report: bool = False,
        flop_model: Optional[object] = None,
    ):
        self.name = name
        self.rank = rank
        self.clock = clock
        self.backend = backend
        # Optional occupancy/FLOP source for the device hierarchy's
        # Computational Efficiency annotation: any object exposing
        # ``model_flops`` (useful FLOPs per device per kernel launch) and
        # ``hw.peak_flops`` — an analytical ``StepModel`` or a compiled
        # ``repro.roofline.RooflineReport`` both qualify, so the runtime
        # and synthetic backends get a real CE feed, not just the
        # analytical backend's synthesized traces.
        self.flop_model = flop_model
        # Self-overhead accounting: every monitor owns an accumulator and
        # installs it process-globally (last monitor wins — the
        # one-monitor-per-rank reality), so the hot paths it does not own
        # directly (DeviceTimeline.compact, backend flush, spool publish)
        # charge the same ledger. The accumulator always uses a *real*
        # monotonic clock, independent of ``clock`` (tests drive monitors
        # with synthetic clocks; the monitor's own cost is still real).
        # ``overhead_report=True`` additionally surfaces the measured
        # wall-clock fraction as the optional ``talp_overhead`` node of
        # the Global region's host hierarchy.
        self.overhead = _ovh.OverheadAccumulator()
        self.overhead_report = overhead_report
        _ovh.install(self.overhead)
        # ``incremental`` keeps the per-device flattened-interval arrays
        # cached between sample() calls, folding in only records that
        # arrived since the previous sample (via DeviceTimeline.compact).
        # Disable to force a full re-flatten per sample (the baseline the
        # merge benchmark measures against).
        self.incremental = incremental
        # region name -> rank -> accumulator  (single-process monitor has
        # one rank; merged results may carry many).
        self._acc: Dict[str, _RegionAcc] = {}
        self._region_stack: List[str] = []
        self._close_callbacks: List[Callable[["TalpMonitor", StepCloseEvent], None]] = []
        self._flush_callbacks: List[Callable[["TalpMonitor"], None]] = []
        self._state: Optional[HostState] = None
        self._state_since: Optional[float] = None
        self.devices: Dict[int, DeviceTimeline] = {}
        # dev -> (n_records watermark, (kernel, memory) flattened arrays)
        self._flat_cache: Dict[int, Tuple[int, Tuple[np.ndarray, np.ndarray]]] = {}
        if backend is not None and hasattr(backend, "start"):
            backend.start()
        if auto_start:
            self.open_region(self.GLOBAL)

    # ------------------------------------------------------------------
    # Region API (TALP user-level API analogue)
    # ------------------------------------------------------------------
    def open_region(self, name: str) -> None:
        if self._state is not None:
            # A state scope's duration is charged at scope exit to the
            # regions on the stack at that moment; letting the stack
            # change mid-scope would charge the region for time before it
            # opened (or silently drop time for one closed mid-scope).
            raise RuntimeError(
                f"cannot open region {name!r} inside host state {self._state}"
            )
        acc = self._acc.setdefault(name, _RegionAcc())
        if acc.open_since is not None:
            raise RuntimeError(f"region {name!r} already open")
        acc.open_since = self.clock()
        acc.open_offload = acc.offload
        acc.open_mpi = acc.mpi
        self._region_stack.append(name)

    def on_region_close(
        self, callback: Callable[["TalpMonitor", StepCloseEvent], None]
    ) -> Callable[[], None]:
        """Register a callback fired at every ``close_region`` with a
        :class:`StepCloseEvent` (per-window state deltas) — the per-step
        sampling hook (``StepSeriesRecorder`` attaches here). Returns an
        unregister function. Callbacks run after the window is recorded,
        outside any host-state scope, and must not open/close regions."""
        self._close_callbacks.append(callback)

        def unregister() -> None:
            try:
                self._close_callbacks.remove(callback)
            except ValueError:
                pass

        return unregister

    def on_flush(
        self, callback: Callable[["TalpMonitor"], None]
    ) -> Callable[[], None]:
        """Register a callback fired after every drain of the backend into
        the device timelines (``sample()``, ``sample_result()``,
        ``finalize()`` and direct ``_flush_backend()`` calls): the moment
        the records launched so far are in. A step-series recorder that
        defers its device columns fills them here. Returns an unregister
        function."""
        self._flush_callbacks.append(callback)

        def unregister() -> None:
            try:
                self._flush_callbacks.remove(callback)
            except ValueError:
                pass

        return unregister

    def close_region(self, name: str) -> None:
        if self._state is not None:
            raise RuntimeError(
                f"cannot close region {name!r} inside host state {self._state}"
            )
        if not self._region_stack or self._region_stack[-1] != name:
            raise RuntimeError(
                f"region close mismatch: {name!r} vs stack {self._region_stack}"
            )
        acc = self._acc[name]
        now = self.clock()
        t_open = acc.open_since
        acc.windows.append((t_open, now))
        acc.closed_total += now - t_open
        acc.open_since = None
        self._region_stack.pop()
        if self._close_callbacks:
            d_off = acc.offload - acc.open_offload
            d_mpi = acc.mpi - acc.open_mpi
            ev = StepCloseEvent(
                region=name,
                index=len(acc.windows) - 1,
                t_open=t_open,
                t_close=now,
                useful=max(0.0, (now - t_open) - d_off - d_mpi),
                offload=d_off,
                mpi=d_mpi,
            )
            for cb in tuple(self._close_callbacks):
                cb(self, ev)

    @contextmanager
    def region(self, name: str):
        self.open_region(name)
        try:
            yield self
        finally:
            self.close_region(name)

    # ------------------------------------------------------------------
    # Host state scopes (CUPTI-runtime-callback / PMPI analogue)
    # ------------------------------------------------------------------
    @contextmanager
    def _state_scope(self, state: HostState):
        if self._state is not None:
            raise RuntimeError(f"nested host state {state} inside {self._state}")
        self._state = state
        t0 = self.clock()
        try:
            yield
        finally:
            dt = self.clock() - t0
            self._state = None
            self._charge(state, dt)

    def _charge(self, state: HostState, dt: float) -> None:
        """Charge a non-useful duration to every open region."""
        for name in self._region_stack:
            acc = self._acc[name]
            if state is HostState.OFFLOAD:
                acc.offload += dt
            elif state is HostState.MPI:
                acc.mpi += dt

    def offload(self):
        """Host blocked in device dispatch/transfer/sync."""
        return self._state_scope(HostState.OFFLOAD)

    def mpi(self):
        """Host blocked waiting on other ranks (control-plane sync)."""
        return self._state_scope(HostState.MPI)

    # ------------------------------------------------------------------
    # Device records
    # ------------------------------------------------------------------
    def device(self, dev: int) -> DeviceTimeline:
        if dev not in self.devices:
            self.devices[dev] = DeviceTimeline(device=dev)
        return self.devices[dev]

    def add_device_record(
        self, dev: int, kind: DeviceActivity, start: float, end: float,
        stream: int = 0, name: str = "",
    ) -> None:
        self.device(dev).add(kind, start, end, stream, name)

    def ingest_device_arrays(
        self, dev: int, kinds, starts, ends, streams=None
    ) -> int:
        """Batch entry point: deliver one whole activity buffer for a
        device as columns (see :meth:`DeviceTimeline.ingest_arrays`)."""
        t0 = self.overhead.begin()
        try:
            return self.device(dev).ingest_arrays(kinds, starts, ends, streams)
        finally:
            self.overhead.end("ingest", t0)

    def _flush_backend(self) -> None:
        be = self.backend
        if be is None:
            return
        t0 = self.overhead.begin()
        try:
            if hasattr(be, "flush_arrays"):
                # Columnar path: whole activity buffers, zero per-event objects.
                for dev, kinds, starts, ends, streams in be.flush_arrays():
                    self.device(dev).ingest_arrays(kinds, starts, ends, streams)
            elif hasattr(be, "flush"):
                # Legacy object path: batch per device before ingesting.
                by_dev: Dict[int, List] = {}
                for dev, rec in be.flush():
                    by_dev.setdefault(dev, []).append(rec)
                for dev, recs in by_dev.items():
                    self.device(dev).ingest(recs)
        finally:
            self.overhead.end("ingest", t0)
        for cb in tuple(self._flush_callbacks):
            cb(self)

    # ------------------------------------------------------------------
    # Transparent instrumentation
    # ------------------------------------------------------------------
    def instrument(self, fn: Callable, device: int = 0, name: str = "") -> Callable:
        """Wrap a (jitted) callable: host time blocked on it = Offload,
        the execution window = a device Kernel record.

        When a backend with ``launch``/``wait`` is attached, dispatch is
        routed through it so the device record comes from the backend's
        activity buffer (launch→ready), decoupled from the host-blocked
        window. Without a backend the kernel record is *synthesized* to
        span exactly the host-blocked window — an approximation that by
        construction pins Orchestration Efficiency (max(K+M)/E) to 1 over
        that window, so device metrics from backend-less instrumentation
        only carry information about idle gaps *between* calls.
        """
        label = name or getattr(fn, "__name__", "fn")
        backend = self.backend
        if (backend is not None and hasattr(backend, "launch")
                and hasattr(backend, "wait")):

            def wrapped(*args, **kwargs):
                # The host is blocked for the whole wrapped call (dispatch,
                # possible first-call compilation, and the wait), so all of
                # it is Offload; the backend owns the device record timing.
                # The closure keeps the caller's kwargs for fn separate
                # from launch()'s own device/name/stream parameters.
                with self.offload():
                    handle = backend.launch(
                        lambda: fn(*args, **kwargs), device=device, name=label
                    )
                    return backend.wait(handle)

        else:

            def wrapped(*args, **kwargs):
                t0 = self.clock()
                with self.offload():
                    out = fn(*args, **kwargs)
                    _synchronize()
                t1 = self.clock()
                self.add_device_record(
                    device, DeviceActivity.KERNEL, t0, t1, name=label
                )
                return out

        wrapped.__name__ = f"talp_{label}"
        return wrapped

    # ------------------------------------------------------------------
    # Results
    # ------------------------------------------------------------------
    def _device_flats(self) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        """Per-device flattened (kernel, memory-minus-kernel) intervals —
        the region-independent part of the post-processing, computed once
        per sample()/finalize() and shared across regions.

        In incremental mode a per-device cache keyed on the timeline's
        ``n_records`` watermark makes repeated sampling cheap: new raw
        records are first folded into the timeline's compacted arrays
        (reusing the ``compact_threshold`` streaming machinery), the
        flattened pair is rebuilt from those, and an unchanged timeline
        is a pure cache hit — no re-flattening of the whole history.
        """
        t0 = self.overhead.begin()
        try:
            flats: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
            for dev, tl in sorted(self.devices.items()):
                if self.incremental:
                    cached = self._flat_cache.get(dev)
                    if cached is not None and cached[0] == tl.n_records:
                        flats[dev] = cached[1]
                        continue
                    tl.compact()  # fold pending records once, incrementally
                kern = tl.kind_intervals(DeviceActivity.KERNEL)
                mem = ivx.subtract(tl.kind_intervals(DeviceActivity.MEMORY), kern)
                flats[dev] = (kern, mem)
                if self.incremental:
                    self._flat_cache[dev] = (tl.n_records, flats[dev])
            return flats
        finally:
            self.overhead.end("flatten", t0)

    def computational_efficiency(
        self,
        device_flats: Optional[Dict[int, Tuple[np.ndarray, np.ndarray]]] = None,
    ) -> Optional[float]:
        """Measured Device Computational Efficiency from the attached
        ``flop_model``: useful FLOPs executed (kernel launches ×
        ``model_flops``) over peak throughput during the measured kernel
        busy time — ``None`` without a model or kernel activity. CE is a
        property of the kernels themselves, so the single monitor-wide
        value annotates every region's device frame.

        A launch is what ``model_flops`` is per: one ``launch`` of the
        backend. A backend that counts them (``launch_counts``, device ->
        launches) is read; otherwise each kernel record is one launch, as
        with the JAX runtime backend's one record per compiled executable.
        On the card the CUDA backend records every kernel of an eager
        step, thousands per launch."""
        fm = self.flop_model
        if fm is None:
            return None
        peak = float(getattr(getattr(fm, "hw", None), "peak_flops", 0.0) or 0.0)
        model_flops = float(getattr(fm, "model_flops", 0.0) or 0.0)
        if peak <= 0 or model_flops <= 0:
            return None
        if device_flats is None:
            device_flats = self._device_flats()
        # flats are already flattened — direct sum, no revalidation
        busy = sum(
            float(np.sum(kern[:, 1] - kern[:, 0]))
            for kern, _ in device_flats.values()
        )
        counts = getattr(self.backend, "launch_counts", None)
        launches = sum(
            (counts.get(d, 0) if counts is not None
             else self.devices[d].n_kernel_records)
            for d in device_flats if d in self.devices
        )
        if busy <= 0 or launches == 0:
            return None
        return (launches * model_flops) / (peak * busy)

    def _region_result(
        self,
        name: str,
        now: Optional[float],
        device_flats: Optional[Dict[int, Tuple[np.ndarray, np.ndarray]]] = None,
    ) -> RegionResult:
        acc = self._acc[name]
        elapsed = acc.elapsed(now)
        windows = acc.window_intervals(now)
        useful = max(0.0, elapsed - acc.offload - acc.mpi)
        hm = (
            host_metrics(
                [useful], [acc.offload], [acc.mpi], elapsed=elapsed,
                # Self-cost is a wall-clock fraction, so it only makes
                # sense against the whole-run window: annotate Global.
                talp_overhead=(
                    self.overhead.fraction(elapsed)
                    if self.overhead_report and name == self.GLOBAL
                    else None
                ),
            )
            if elapsed > 0
            else None
        )
        dev_states: Dict[int, Dict[str, float]] = {}
        kernels: List[float] = []
        memories: List[float] = []
        if device_flats is None:
            device_flats = self._device_flats()
        for dev, (kern, mem) in sorted(device_flats.items()):
            k_in = ivx.total(ivx.intersect(kern, windows)) if len(windows) else 0.0
            m_in = ivx.total(ivx.intersect(mem, windows)) if len(windows) else 0.0
            idle = max(0.0, elapsed - k_in - m_in)
            dev_states[dev] = {"kernel": k_in, "memory": m_in, "idle": idle}
            kernels.append(k_in)
            memories.append(m_in)
        dm = (
            device_metrics(
                kernels, memories, elapsed,
                computational_efficiency=self.computational_efficiency(
                    device_flats
                ),
            )
            if kernels and elapsed > 0
            else None
        )
        return RegionResult(
            name=name,
            elapsed=elapsed,
            n_ranks=1,
            n_devices=len(kernels),
            host=hm,
            device=dm,
            host_states={self.rank: {"useful": useful, "offload": acc.offload, "mpi": acc.mpi}},
            device_states=dev_states,
        )

    def region_windows(
        self, now: Optional[float] = None
    ) -> Dict[str, np.ndarray]:
        """Absolute (monitor-clock) flattened window arrays per region —
        open regions extend to ``now``. The exact timestamps the trace
        exporter turns into region begin/end markers."""
        if now is None:
            now = self.clock()
        return {
            name: acc.window_intervals(now) for name, acc in self._acc.items()
        }

    def sample(self, region: Optional[str] = None) -> RegionResult:
        """Online metrics for an open (or closed) region — TALP's runtime mode."""
        t0 = self.overhead.begin()
        try:
            self._flush_backend()
            return self._region_result(
                region or self.GLOBAL, now=self.clock(),
                device_flats=self._device_flats(),
            )
        finally:
            self.overhead.end("sample", t0)

    def sample_result(self) -> TalpResult:
        """Non-destructive all-regions snapshot at the current clock — the
        per-rank payload for :func:`repro.core.merge.merge_samples`.

        Open regions are measured up to *now*; nothing is closed and the
        monitor keeps running, so snapshots can be taken repeatedly during
        the run (e.g. on a ``--talp-sample-every`` cadence) and merged
        across ranks into a job-level mid-run report.
        """
        t0 = self.overhead.begin()
        try:
            self._flush_backend()
            now = self.clock()
            flats = self._device_flats()
            regions = {
                name: self._region_result(name, now=now, device_flats=flats)
                for name in self._acc
            }
            return TalpResult(name=self.name, regions=regions)
        finally:
            self.overhead.end("sample", t0)

    def finalize(self) -> TalpResult:
        """Close remaining regions and produce the post-mortem result."""
        now = self.clock()
        while self._region_stack:
            self.close_region(self._region_stack[-1])
        t0 = self.overhead.begin()
        try:
            self._flush_backend()
            if self.backend is not None and hasattr(self.backend, "stop"):
                self.backend.stop()
            flats = self._device_flats()
            regions = {
                name: self._region_result(name, now=None, device_flats=flats)
                for name in self._acc
            }
            return TalpResult(name=self.name, regions=regions)
        finally:
            self.overhead.end("sample", t0)
