"""Hand-written CUDA SSD chunked-scan forward (``csrc/ssd_fwd.cu``) and
its ``ctypes`` binding.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd/kernel.py::
_ssd_kernel``; the source's header says what bounds it on the H100 and
what its design does about that. For bf16 inputs one call launches three
kernels on the current stream (chunk states, the state recurrence over
the chunks, outputs) through an fp32 scratch of (B, chunks, H, P, N)
that the wrapper allocates; for fp32 inputs it launches one. Beyond the TPU kernel it takes an
initial state, returns the final state and takes any L (a ragged last
chunk is masked), as :func:`..ref.ssd_reference` does. The library is
built with ``nvcc`` at the first launch, never at import, so this module
imports on machines without CUDA.

:func:`ssd_scan` takes CUDA tensors only and raises for anything the
kernel does not take; it never falls back to the plain version. Its
``launches`` attribute counts calls (one per model layer), not the
kernels a call launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .. import cuda_build

__all__ = ["MAX_CHUNK", "SIZES", "SOURCE", "check_inputs", "library",
           "ssd_scan"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_fwd.cu"
SIZES = (16, 32, 64, 128)   # the head dims P and state sizes N compiled
MAX_CHUNK = 1024
_MAX_GRID_Y = 65535
_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        lib.ssd_fwd.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                                + [ctypes.c_void_p])
        lib.ssd_fwd.restype = ctypes.c_int
        lib.ssd_error_string.argtypes = [ctypes.c_int]
        lib.ssd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_inputs(x, dt, a, b_mat, c_mat, chunk: int, d_skip=None,
                 initial_state=None) -> None:
    """Raise ``ValueError`` for any input the kernel does not take."""
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b_mat.dim() != 4:
        raise ValueError("ssd wants x (B,L,H,P), dt (B,L,H), a (H,), "
                         "B/C (B,L,G,N)")
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if (tuple(dt.shape) != (bsz, l, h) or tuple(a.shape) != (h,)
            or tuple(b_mat.shape[:2]) != (bsz, l)
            or c_mat.shape != b_mat.shape):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"a {tuple(a.shape)}, B {tuple(b_mat.shape)}, "
            f"C {tuple(c_mat.shape)}")
    if g < 1 or h % g:
        raise ValueError(f"groups must divide heads, got H={h} G={g}")
    if p not in SIZES or n not in SIZES:
        raise ValueError(f"head dim P={p} or state N={n} not supported; "
                         f"have {SIZES}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")
    if min(bsz, l) < 1 or bsz > _MAX_GRID_Y:
        raise ValueError(f"sizes out of range: B={bsz} L={l}")
    if x.dtype not in (torch.float32, torch.bfloat16) or not (
            b_mat.dtype == c_mat.dtype == x.dtype):
        raise ValueError(f"x/B/C dtypes {x.dtype}/{b_mat.dtype}/"
                         f"{c_mat.dtype}: want all float32 or all bfloat16")
    extra = [t for t in (d_skip, initial_state) if t is not None]
    if any(t.dtype != torch.float32 for t in [dt, a] + extra):
        raise ValueError("dt, a, d_skip and initial_state must be float32")
    if d_skip is not None and tuple(d_skip.shape) != (h,):
        raise ValueError(f"d_skip shape {tuple(d_skip.shape)} != ({h},)")
    if (initial_state is not None
            and tuple(initial_state.shape) != (bsz, h, p, n)):
        raise ValueError(f"initial_state shape {tuple(initial_state.shape)}"
                         f" != {(bsz, h, p, n)}")
    tensors = [x, dt, a, b_mat, c_mat] + extra
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd wants contiguous tensors")
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("ssd_scan launches a CUDA kernel and wants CUDA "
                         "tensors; ops.ssd takes the plain version for CPU "
                         "tensors")
    if any(t.device != x.device for t in tensors):
        raise ValueError("tensors on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if any(t.data_ptr() % t.element_size() for t in tensors):
        raise ValueError("ssd wants tensors aligned to their element size")


def ssd_scan(
    x: torch.Tensor,       # (B, L, H, P)
    dt: torch.Tensor,      # (B, L, H) fp32
    a: torch.Tensor,       # (H,) fp32
    b_mat: torch.Tensor,   # (B, L, G, N)
    c_mat: torch.Tensor,   # (B, L, G, N)
    chunk: int = 256,
    d_skip: Optional[torch.Tensor] = None,         # (H,) fp32
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N) fp32
    return_final_state: bool = False,
):
    """Launch the kernel on the current stream; returns y (B, L, H, P) in
    x's dtype and, if asked, the final state (B, H, P, N) fp32. Does not
    synchronise."""
    check_inputs(x, dt, a, b_mat, c_mat, chunk, d_skip, initial_state)
    lib = library()
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        # the bf16 kernels load x, B, C and the initial state 16 bytes at a
        # time; a tensor that is not 16-byte aligned is copied once
        x, b_mat, c_mat, initial_state = (
            t if t is None or t.data_ptr() % 16 == 0 else t.clone()
            for t in (x, b_mat, c_mat, initial_state))
    y = torch.empty_like(x)
    final = (torch.empty((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if return_final_state else None)
    nc = -(-l // chunk)
    states = (torch.empty((bsz, nc, h, p, n), dtype=torch.float32,
                          device=x.device) if bf16 else None)
    decay = (torch.empty((bsz, nc, h), dtype=torch.float32, device=x.device)
             if bf16 else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_fwd(
            ptr(x), ptr(dt), ptr(a), ptr(b_mat), ptr(c_mat), ptr(d_skip),
            ptr(initial_state), ptr(y), ptr(final), ptr(states), ptr(decay),
            bsz, l, h, p, g, n, chunk, int(bf16), stream,
        )
    if rc != 0:
        msg = lib.ssd_error_string(rc).decode()
        raise RuntimeError(f"ssd_fwd launch failed: {msg} ({rc})")
    ssd_scan.launches += 1
    return (y, final) if return_final_state else y


ssd_scan.launches = 0
