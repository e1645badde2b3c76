from .base import ActivityBackend, available_backends, get_backend, register_backend
from .synthetic import SyntheticBackend, SyntheticTraceBuilder
from .cuda_runtime import CudaRuntimeBackend
from .analytical import (
    AnalyticalBackend,
    H100_SXM,
    HardwareSpec,
    StepModel,
    trace_from_step_model,
)

__all__ = [
    "ActivityBackend",
    "available_backends",
    "get_backend",
    "register_backend",
    "SyntheticBackend",
    "SyntheticTraceBuilder",
    "CudaRuntimeBackend",
    "AnalyticalBackend",
    "H100_SXM",
    "HardwareSpec",
    "StepModel",
    "trace_from_step_model",
]
