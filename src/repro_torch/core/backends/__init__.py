from .base import ActivityBackend, available_backends, get_backend, register_backend
from .synthetic import SyntheticBackend, SyntheticTraceBuilder
from .cuda_runtime import CudaRuntimeBackend
from .analytical import H100_SXM, HardwareSpec, StepModel

__all__ = [
    "ActivityBackend",
    "available_backends",
    "get_backend",
    "register_backend",
    "SyntheticBackend",
    "SyntheticTraceBuilder",
    "CudaRuntimeBackend",
    "H100_SXM",
    "HardwareSpec",
    "StepModel",
]
