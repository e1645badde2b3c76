"""repro_torch.core — the TALP metric engine, copied from ``repro.core``.

The modules here are copies of their namesakes in ``repro.core`` with
their relative imports kept; the port may not import ``repro``.
``tests/test_torch_core_copy.py`` holds every copy to its original: the
same regions, device records, spools and step closes give identical JSON
and text reports, merges, payloads, step rows, traces and metric streams.
The runtime backend is a port: :mod:`.backends.cuda_runtime`.

The changes from the copies, each for the card, where one eager step
runs thousands of kernels whose activity CUPTI delivers only when a
collection closes:

  * ``TalpMonitor.instrument``'s backend-less fallback synchronises CUDA
    instead of calling ``jax.block_until_ready``.
  * ``TalpMonitor.computational_efficiency`` counts the backend's
    ``launch`` calls (``launch_counts``), the unit its flop model is
    per, where the backend keeps them; the JAX backend gives one kernel
    record per launch, the CUDA one a record per kernel. A backend
    without the count (or one record per launch) gives what the copy
    gives.
  * ``TalpMonitor.on_flush`` calls back after every drain of the
    backend, and :class:`~.telemetry.stepseries.StepSeriesRecorder`
    defers a step's device columns to the next drain (a sample,
    ``finalize``, or a bounded number of steps) where the backend says a
    flush closes its collection (``flush_closes_collection``); elsewhere
    it flushes at every step close, as the copy does.
  * :class:`~.merge.AllGatherTransport` runs on ``torch.distributed``;
    :mod:`.backends.analytical`'s default hardware is one H100.
  * :mod:`.telemetry.phases` is the port's own (no namesake in
    ``repro.core``): spans of named phases inside a launched step, each
    with a device window from two CUDA events that the runtime backend
    places on the monitor's clock through its anchor.
    ``CudaRuntimeBackend.start()`` installs a recorder, and the backend
    charges its per-launch markers to the overhead section ``mark``.
"""

from . import intervals
from . import telemetry
from .analysis import TraceAnalysis, analyze_trace
from .device_metrics import DeviceMetrics, device_metrics
from .hierarchy import DEVICE, HOST, Hierarchy, MetricFrame, MetricSpec, StateDurations
from .host_metrics import HostMetrics, host_metrics
from .pop import PopMetrics, elapsed_time, pop_metrics
from .states import DeviceActivity, DeviceRecord, DeviceTimeline, HostState
from .collect import FaultPlan, QuarantinedSpool, RankCoverage
from .merge import (
    AllGatherTransport,
    FileSpoolTransport,
    InProcessGather,
    merge_region_results,
    merge_results,
    merge_samples,
    merge_spool,
    talp_result_from_json,
)
from .talp import RegionResult, TalpMonitor, TalpResult

__all__ = [
    "intervals",
    "telemetry",
    "TraceAnalysis",
    "analyze_trace",
    "DeviceMetrics",
    "device_metrics",
    "HostMetrics",
    "host_metrics",
    "PopMetrics",
    "elapsed_time",
    "pop_metrics",
    "DEVICE",
    "HOST",
    "Hierarchy",
    "MetricFrame",
    "MetricSpec",
    "StateDurations",
    "DeviceActivity",
    "DeviceRecord",
    "DeviceTimeline",
    "HostState",
    "AllGatherTransport",
    "FaultPlan",
    "FileSpoolTransport",
    "InProcessGather",
    "QuarantinedSpool",
    "RankCoverage",
    "merge_region_results",
    "merge_results",
    "merge_samples",
    "merge_spool",
    "talp_result_from_json",
    "RegionResult",
    "TalpMonitor",
    "TalpResult",
]
