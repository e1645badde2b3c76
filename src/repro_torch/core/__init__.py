"""repro_torch.core — the TALP metric engine, copied from ``repro.core``.

The modules here are copies of their namesakes in ``repro.core`` with
their relative imports kept; the port may not import ``repro``. The one
change is the backend-less fallback of ``TalpMonitor.instrument``, which
synchronises CUDA instead of calling ``jax.block_until_ready``.
``tests/test_torch_core_copy.py`` holds the copy to the original: the
same regions and device records give identical JSON and text reports.
The runtime backend is a port: :mod:`.backends.cuda_runtime`.

Not copied yet: ``merge``, ``collect`` and the telemetry exporters,
step series and watchdog.
"""

from . import intervals
from .analysis import TraceAnalysis, analyze_trace
from .device_metrics import DeviceMetrics, device_metrics
from .hierarchy import DEVICE, HOST, Hierarchy, MetricFrame, MetricSpec, StateDurations
from .host_metrics import HostMetrics, host_metrics
from .pop import PopMetrics, elapsed_time, pop_metrics
from .states import DeviceActivity, DeviceRecord, DeviceTimeline, HostState
from .talp import RegionResult, TalpMonitor, TalpResult

__all__ = [
    "intervals",
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
    "RegionResult",
    "TalpMonitor",
    "TalpResult",
]
