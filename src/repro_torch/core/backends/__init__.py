from .base import ActivityBackend, available_backends, get_backend, register_backend
from .cuda_runtime import CudaRuntimeBackend

__all__ = [
    "ActivityBackend",
    "available_backends",
    "get_backend",
    "register_backend",
    "CudaRuntimeBackend",
]
