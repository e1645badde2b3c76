"""Hand-written CUDA AdamW over a whole tree of leaves (``csrc/adamw.cu``):
the global gradient norm and the update, each one multi-tensor pass, and
their ``ctypes`` bindings.

It replaces no TPU kernel (the JAX package leaves the update to XLA,
which fuses it); it takes the place of the eager per-leaf ops of
``optim.adamw.adamw_update``, which stay as its plain version and the CPU
path. Bytes bound it: 26 a parameter for the update with a bf16
gradient, 2 for the norm (the source's header says what its design does
about that). Both passes are deterministic: the norm sums fixed
per-block partials in a fixed order, with no float atomics.

:func:`adamw_norm` launches ``adamw_norm_partials`` (one per 64 leaves of
one gradient dtype) and ``adamw_norm_total``, and returns the fp32 sum of
squares on the device. :func:`adamw_update` launches ``adamw_update_pass``
(one per 64 leaves of one gradient dtype), which reads that sum (after
its all-reduce, over a mesh), computes the clip's scale on the device,
updates p, mu and nu in place and writes the norm. Neither synchronises
nor copies anything to or from the device: the leaf table (pointers,
sizes) travels as a kernel parameter. The library is built with ``nvcc``
at its first launch, never at import, so this module imports on machines
without CUDA.

Both take CUDA tensors only (DTensors raise ``TypeError``: the optimizer
hands them each rank's shards) and raise ``ValueError`` for anything the
kernels do not take (another dtype, a non-contiguous leaf, leaves on
different devices or of different shapes), before any library is loaded.
A fake tensor takes the kernels' place (``kernels.fake``): the same checks
but the device's, the same outputs and scratch as fakes, and the work of
:mod:`.work` given to its fake mode; nothing is launched or counted. Each
function's ``launches`` attribute counts its calls (one a training step),
not the kernels a call launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Sequence

import torch

from ...sharding.local import refuse_dtensor
from .. import cuda_build
from ..fake import is_fake, record_work
from .work import adamw_norm_work, adamw_update_work

__all__ = ["NORM_CHUNK", "SOURCE", "adamw_norm", "adamw_update", "library",
           "norm_partials"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "adamw.cu"
NORM_CHUNK = 32768      # elements of one norm partial (kNormChunk)
_GRAD_DTYPES = (torch.float32, torch.bfloat16)
_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        sizes = ctypes.POINTER(ctypes.c_longlong)
        flags = ctypes.POINTER(ctypes.c_int)
        lib.adamw_norm.argtypes = [ctypes.c_int, ptrs, sizes, flags,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p]
        lib.adamw_norm.restype = ctypes.c_int
        lib.adamw_update.argtypes = ([ctypes.c_int] + [ptrs] * 4
                                     + [sizes, flags, ctypes.c_void_p,
                                        ctypes.c_void_p]
                                     + [ctypes.c_float] * 10
                                     + [ctypes.c_void_p])
        lib.adamw_update.restype = ctypes.c_int
        lib.adamw_error_string.argtypes = [ctypes.c_int]
        lib.adamw_error_string.restype = ctypes.c_char_p
        if lib.adamw_norm_chunk() != NORM_CHUNK:
            raise RuntimeError(f"{SOURCE.name} sums {lib.adamw_norm_chunk()}"
                               f" elements a partial, this module {NORM_CHUNK}")
        _lib = lib
    return _lib


def norm_partials(grads: Sequence[torch.Tensor]) -> int:
    """The partial sums the norm pass writes: one per ``NORM_CHUNK``
    elements of each leaf, rounded up."""
    return sum(-(-g.numel() // NORM_CHUNK) for g in grads)


def _check(where: str, tensors: Sequence[torch.Tensor], device) -> None:
    """Raise for a leaf the kernels do not take: contiguity, and (for real
    tensors) one CUDA device, theirs, or ``device`` where there are none."""
    refuse_dtensor(where, *tensors)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{where} wants contiguous leaves")
    if any(is_fake(t) for t in tensors):   # no memory: the device is theirs
        return
    devices = {t.device for t in tensors} or {torch.device(device)}
    if any(d.type != "cuda" for d in devices):
        raise ValueError(f"{where} launches a CUDA kernel and wants CUDA "
                         "tensors; optim.adamw takes the plain version for "
                         "CPU tensors")
    if len(devices) > 1:
        raise ValueError(f"{where}: leaves on different devices: "
                         f"{sorted(str(d) for d in devices)}")


def _grad_dtypes(where: str, grads: Sequence[torch.Tensor]) -> None:
    bad = sorted({str(g.dtype) for g in grads if g.dtype not in _GRAD_DTYPES})
    if bad:
        raise ValueError(f"{where} takes float32 or bfloat16 gradients, "
                         f"got {bad}")


def _array(ctype, values):
    return (ctype * len(values))(*values)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def adamw_norm(grads: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """The sum of the squares of every element of ``grads`` (fp32 or bf16
    leaves), in fp32, as a 0-d fp32 tensor on their device (``device``
    where ``grads`` is empty). Launches on the current stream and does not
    synchronise; reruns on the same inputs give the same bits."""
    grads = list(grads)
    if grads:
        device = grads[0].device
    elif device is None:
        raise ValueError("adamw_norm: no leaves and no device")
    _check("adamw_norm", grads, device)
    _grad_dtypes("adamw_norm", grads)
    partials = torch.empty((norm_partials(grads),), dtype=torch.float32,
                           device=device)
    out = torch.empty((), dtype=torch.float32, device=device)
    if is_fake(out):
        record_work(out, "adamw_norm", *adamw_norm_work(
            (g.numel(), g.dtype) for g in grads))
        return out
    lib = library()
    with torch.cuda.device(device):
        rc = lib.adamw_norm(
            len(grads), _array(ctypes.c_void_p, [g.data_ptr() for g in grads]),
            _array(ctypes.c_longlong, [g.numel() for g in grads]),
            _array(ctypes.c_int, [int(g.dtype == torch.bfloat16)
                                  for g in grads]),
            partials.data_ptr(), out.data_ptr(), _stream(device))
    if rc != 0:
        msg = lib.adamw_error_string(rc).decode()
        raise RuntimeError(f"adamw_norm launch failed: {msg} ({rc})")
    adamw_norm.launches += 1
    return out


adamw_norm.launches = 0


def adamw_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor],
                 mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
                 sumsq: torch.Tensor, *, lr: float, b1: float, b2: float,
                 eps: float, weight_decay: float, grad_clip: float,
                 b1c: float, b2c: float) -> torch.Tensor:
    """One AdamW step in place on fp32 ``params``, ``mus`` and ``nus``,
    leaf by leaf with ``grads`` (fp32 or bf16, each of its parameter's
    shape), the gradients scaled by min(grad_clip / max(norm, 1e-9), 1)
    with norm = sqrt(``sumsq``), read on the device. The step's scalars
    (``lr``, the bias corrections ``b1c``, ``b2c``) are host floats.
    Returns the norm, a 0-d fp32 tensor on the device. Launches on the
    current stream and does not synchronise."""
    params, grads, mus, nus = (list(t) for t in (params, grads, mus, nus))
    if not len(params) == len(grads) == len(mus) == len(nus):
        raise ValueError(f"adamw_update: {len(params)} parameters, "
                         f"{len(grads)} gradients, {len(mus)} and {len(nus)}"
                         " moments")
    for leaf in zip(params, grads, mus, nus):
        if len({tuple(t.shape) for t in leaf}) != 1:
            raise ValueError("adamw_update: a leaf's parameter, gradient and"
                             " moments differ in shape: "
                             f"{[tuple(t.shape) for t in leaf]}")
    device = sumsq.device
    _check("adamw_update", params + grads + mus + nus + [sumsq], device)
    _grad_dtypes("adamw_update", grads)
    if any(t.dtype != torch.float32 for t in params + mus + nus + [sumsq]):
        raise ValueError("adamw_update wants float32 parameters, moments and"
                         " sum of squares")
    if sumsq.numel() != 1:
        raise ValueError(f"sumsq has {sumsq.numel()} elements, want 1")
    norm = torch.empty((), dtype=torch.float32, device=device)
    if is_fake(norm):
        record_work(norm, "adamw_update", *adamw_update_work(
            (g.numel(), g.dtype) for g in grads))
        return norm
    lib = library()
    ptrs = lambda ts: _array(  # noqa: E731
        ctypes.c_void_p, [t.data_ptr() for t in ts])
    with torch.cuda.device(device):
        rc = lib.adamw_update(
            len(params), ptrs(grads), ptrs(params), ptrs(mus), ptrs(nus),
            _array(ctypes.c_longlong, [p.numel() for p in params]),
            _array(ctypes.c_int, [int(g.dtype == torch.bfloat16)
                                  for g in grads]),
            sumsq.data_ptr(), norm.data_ptr(), lr, b1, b2, 1 - b1, 1 - b2,
            eps, weight_decay, grad_clip, b1c, b2c, _stream(device))
    if rc != 0:
        msg = lib.adamw_error_string(rc).decode()
        raise RuntimeError(f"adamw_update launch failed: {msg} ({rc})")
    adamw_update.launches += 1
    return norm


adamw_update.launches = 0
