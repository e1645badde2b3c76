"""Activity-backend plugin protocol (≙ the paper's CUPTI / rocprofiler plugins).

Each backend implements two complementary paths, mirroring §4.2:

  (i)  synchronous monitoring of host API calls — in TALP-JAX this is
       the monitor's ``offload()`` / ``instrument()`` scopes, which the
       backend may hook;
  (ii) asynchronous collection of device activity records, delivered in
       batches and post-processed uniformly by the core (flatten kernels
       → subtract overlap from memory → classify idle).

Delivery has two shapes. The legacy ``flush()`` yields one ``(device,
DeviceRecord)`` pair per event — simple, but it materializes a Python
object per activity record. The **batch path**, ``flush_arrays()``,
yields whole activity buffers as columns ``(device, kinds, starts,
ends, streams)`` that feed straight into
:meth:`~repro.core.states.DeviceTimeline.ingest_arrays` with no
per-event objects — the shape a real CUPTI activity-buffer flush has.
:class:`~repro.core.talp.TalpMonitor` prefers ``flush_arrays`` when a
backend provides it; implementing only ``flush`` remains valid.

Backends register by name so a deployment enables whichever matches the
runtime environment (the paper: CUPTI plugin if CUDA, rocprofiler if HIP,
OpenACC hooks if the OpenACC runtime is detected).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Protocol, Tuple, runtime_checkable

from ..states import DeviceRecord

__all__ = [
    "ActivityBackend",
    "ColumnarActivityBackend",
    "register_backend",
    "get_backend",
    "available_backends",
]


@runtime_checkable
class ActivityBackend(Protocol):
    """Protocol every plugin implements."""

    def start(self) -> None:
        """Enable collection (≙ cuptiActivityEnable / rocprofiler filters)."""
        ...

    def stop(self) -> None:
        """Disable collection and release resources."""
        ...

    def flush(self) -> Iterable[Tuple[int, DeviceRecord]]:
        """Drain buffered (device, record) pairs (≙ activity-buffer flush)."""
        ...


@runtime_checkable
class ColumnarActivityBackend(ActivityBackend, Protocol):
    """Extended protocol for backends that deliver whole column batches.

    ``flush_arrays()`` drains every buffered batch as
    ``(device, kinds, starts, ends, streams)`` tuples of equal-length
    arrays (``streams`` may be ``None`` for stream 0). A backend
    implementing this is never asked to materialize ``DeviceRecord``
    objects on the hot path.
    """

    def flush_arrays(self) -> Iterable[Tuple[int, object, object, object, object]]:
        """Drain buffered per-device column batches."""
        ...


_REGISTRY: Dict[str, Callable[..., ActivityBackend]] = {}


def register_backend(name: str):
    def deco(factory: Callable[..., ActivityBackend]):
        _REGISTRY[name] = factory
        return factory
    return deco


def get_backend(name: str, **kwargs) -> ActivityBackend:
    if name not in _REGISTRY:
        raise KeyError(f"unknown backend {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def available_backends() -> List[str]:
    return sorted(_REGISTRY)
