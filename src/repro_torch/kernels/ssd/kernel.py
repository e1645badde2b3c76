"""Hand-written CUDA SSD chunked scan, forward (``csrc/ssd_fwd.cu``) and
backward (``csrc/ssd_bwd.cu``), their ``ctypes`` bindings and the
``torch.autograd.Function`` that joins them.

The forward replaces the Pallas TPU kernel ``src/repro/kernels/ssd/
kernel.py::_ssd_kernel``; the backward has no TPU counterpart (the JAX
package differentiates ``ssd_reference`` through XLA). Each source's
header says what bounds it on the H100 and what its design does about
that. x, B and C are bf16; dt, a, the skip weights and the states fp32.
One forward call launches three kernels on the current stream (chunk
states, the state recurrence over the chunks, outputs) through an fp32
scratch of (B, chunks, H, P, N) that the wrapper allocates. Beyond the TPU
kernel it takes an initial state, returns the final state and takes any L
(a ragged last chunk is masked), as :func:`..ref.ssd_reference` does. One
backward call launches ten kernels through one fp32 workspace; it
recomputes the carried states from the inputs, so the forward saves
nothing but its inputs. Operations bound the backward (167.91 GFLOP,
0.1698 ms at mamba2-130m's training shape, B 8, L 4096, H 24, P 64, N
128). Every product runs on the tensor cores (bf16 ``mma.sync``, each fp32
operand split into bf16 hi + lo), the chunk-state product and the
recurrence over the chunks being the forward's own
(``csrc/ssd_states.cuh``). The libraries are built with ``nvcc`` at their
first launch, never at import, so this module imports on machines without
CUDA.

A fake tensor takes the kernels' place (``kernels.fake``): the same
checks but the device's, the same outputs and forward scratch as fakes
(not the backward's workspace, whose size the library computes), and the
work of :mod:`.work` given to its fake mode; nothing is launched or
counted.

:func:`ssd_scan` and :func:`ssd_scan_backward` take CUDA tensors only
and raise ``ValueError`` for anything their kernels do not take, before
any library is loaded; they never fall back to the plain version.
:func:`ssd_scan` returns a tensor with no autograd graph, so it refuses
inputs that require grad under grad mode: :class:`SSDScan` (through
``ops.ssd``) is the differentiable path. Each function's ``launches``
attribute counts its calls (one per model layer), not the kernels a call
launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ...sharding.local import refuse_dtensor
from .. import cuda_build
from ..fake import is_fake, record_work
from .work import ssd_backward_work, ssd_work

__all__ = ["BWD_SOURCE", "MAX_CHUNK", "SIZES", "SOURCE", "SSDScan",
           "backward_library", "check_inputs", "library", "ssd_scan",
           "ssd_scan_backward"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_fwd.cu"
BWD_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_bwd.cu"
SIZES = (16, 32, 64, 128)   # the head dims P and state sizes N compiled
MAX_CHUNK = 1024
_MAX_GRID_Y = 65535
_lib: Optional[ctypes.CDLL] = None
_bwd_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        lib.ssd_fwd.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                                + [ctypes.c_void_p])
        lib.ssd_fwd.restype = ctypes.c_int
        lib.ssd_error_string.argtypes = [ctypes.c_int]
        lib.ssd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def backward_library() -> ctypes.CDLL:
    """Build (at first use) and load the backward's library."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = cuda_build.load(BWD_SOURCE)
        lib.ssd_bwd.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 7
                                + [ctypes.c_void_p])
        lib.ssd_bwd.restype = ctypes.c_int
        lib.ssd_bwd_workspace_floats.argtypes = [ctypes.c_int] * 6
        lib.ssd_bwd_workspace_floats.restype = ctypes.c_longlong
        lib.ssd_bwd_error_string.argtypes = [ctypes.c_int]
        lib.ssd_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def check_inputs(x, dt, a, b_mat, c_mat, chunk: int, d_skip=None,
                 initial_state=None) -> None:
    """Raise ``ValueError`` for any input the kernel does not take. A
    DTensor raises ``TypeError`` (``ops.ssd`` maps it to its shards
    first)."""
    refuse_dtensor("ssd_scan", x, dt, a, b_mat, c_mat, d_skip, initial_state)
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
    if not x.dtype == b_mat.dtype == c_mat.dtype == torch.bfloat16:
        raise ValueError(f"x/B/C dtypes {x.dtype}/{b_mat.dtype}/"
                         f"{c_mat.dtype}: want all bfloat16")
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
    if is_fake(x):   # no memory: the device and alignment are the launch's
        return
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("ssd_scan launches a CUDA kernel and wants CUDA "
                         "tensors; ops.ssd takes the plain version for CPU "
                         "tensors")
    if any(t.device != x.device for t in tensors):
        raise ValueError("tensors on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if any(t.data_ptr() % t.element_size() for t in tensors):
        raise ValueError("ssd wants tensors aligned to their element size")


def _aligned16(*tensors):
    """Each tensor as it is when its data is 16-byte aligned (or it is
    None), else an aligned copy: the kernels move x, dy, B, C and the
    states 16 bytes at a time (``cp.async``, ``float4``)."""
    return tuple(t if t is None or t.data_ptr() % 16 == 0 else t.clone()
                 for t in tensors)


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
    bf16 and, if asked, the final state (B, H, P, N) fp32. Does not
    synchronise. Refuses inputs that require grad under grad mode."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, b_mat, c_mat, d_skip, initial_state)):
        raise RuntimeError(
            "kernel.ssd_scan returns a tensor with no autograd graph and "
            "would cut the gradient to its inputs; call ops.ssd (SSDScan) "
            "for inputs that require grad")
    check_inputs(x, dt, a, b_mat, c_mat, chunk, d_skip, initial_state)
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    fake = is_fake(x)
    if not fake:
        x, b_mat, c_mat, initial_state = _aligned16(x, b_mat, c_mat,
                                                    initial_state)
    y = torch.empty_like(x)
    final = (torch.empty((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if return_final_state else None)
    nc = -(-l // chunk)
    states = torch.empty((bsz, nc, h, p, n), dtype=torch.float32,
                         device=x.device)
    decay = torch.empty((bsz, nc, h), dtype=torch.float32, device=x.device)
    if fake:
        record_work(x, "ssd_fwd", *ssd_work(
            bsz, l, h, p, g, n, chunk, x.dtype, initial_state is not None
            or return_final_state))
        return (y, final) if return_final_state else y
    lib = library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_fwd(
            ptr(x), ptr(dt), ptr(a), ptr(b_mat), ptr(c_mat), ptr(d_skip),
            ptr(initial_state), ptr(y), ptr(final), ptr(states), ptr(decay),
            bsz, l, h, p, g, n, chunk, stream,
        )
    if rc != 0:
        msg = lib.ssd_error_string(rc).decode()
        raise RuntimeError(f"ssd_fwd launch failed: {msg} ({rc})")
    ssd_scan.launches += 1
    return (y, final) if return_final_state else y


ssd_scan.launches = 0


def ssd_scan_backward(
    x: torch.Tensor,       # (B, L, H, P)
    dt: torch.Tensor,      # (B, L, H) fp32
    a: torch.Tensor,       # (H,) fp32
    b_mat: torch.Tensor,   # (B, L, G, N)
    c_mat: torch.Tensor,   # (B, L, G, N)
    dy: torch.Tensor,      # (B, L, H, P) bf16
    chunk: int = 256,
    d_skip: Optional[torch.Tensor] = None,         # (H,) fp32
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N) fp32
    d_final_state: Optional[torch.Tensor] = None,  # (B, H, P, N) fp32
):
    """Launch the backward's ten kernels on the current stream; returns
    (dx, ddt, da, dB, dC, dd_skip, d_initial_state), each in its input's
    dtype, dd_skip and d_initial_state None where that input is None, as
    :func:`..ref.ssd_backward_reference`. Does not synchronise."""
    bsz, l, h, p = x.shape if x.dim() == 4 else (0, 0, 0, 0)
    n = b_mat.shape[-1] if b_mat.dim() == 4 else 0
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device}: "
                         f"want x's {tuple(x.shape)} {x.dtype} on {x.device}")
    if d_final_state is not None and (
            tuple(d_final_state.shape) != (bsz, h, p, n)
            or d_final_state.dtype != torch.float32
            or d_final_state.device != x.device):
        raise ValueError(f"d_final_state {tuple(d_final_state.shape)} "
                         f"{d_final_state.dtype}: want {(bsz, h, p, n)} "
                         f"float32 on {x.device}")
    check_inputs(x, dt, a, b_mat, c_mat, chunk, d_skip, initial_state)
    dy = dy.contiguous()
    if d_final_state is not None:
        d_final_state = d_final_state.contiguous()
    if is_fake(x):
        f32 = dict(dtype=torch.float32, device=x.device)
        grads = tuple(torch.empty_like(t) for t in (x, dt, a, b_mat, c_mat))
        record_work(x, "ssd_bwd", *ssd_backward_work(
            bsz, l, h, p, b_mat.shape[2], n, chunk, x.dtype,
            initial_state is not None or d_final_state is not None))
        return grads + (
            torch.empty((h,), **f32) if d_skip is not None else None,
            torch.empty((bsz, h, p, n), **f32) if initial_state is not None
            else None)
    # the state recurrences run on float4s; x, dy, B and C are loaded by
    # cp.async
    x, b_mat, c_mat, dy, initial_state, d_final_state = _aligned16(
        x, b_mat, c_mat, dy, initial_state, d_final_state)
    lib = backward_library()
    g = b_mat.shape[2]
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, ddt, db, dc = (torch.empty_like(t) for t in (x, dt, b_mat, c_mat))
    da = torch.empty((h,), **f32)
    dd = torch.empty((h,), **f32) if d_skip is not None else None
    ds0 = (torch.empty((bsz, h, p, n), **f32) if initial_state is not None
           else None)
    work = torch.empty(
        (lib.ssd_bwd_workspace_floats(bsz, l, h, p, n, chunk),), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_bwd(
            ptr(x), ptr(dt), ptr(a), ptr(b_mat), ptr(c_mat), ptr(d_skip),
            ptr(initial_state), ptr(dy), ptr(d_final_state), ptr(dx),
            ptr(ddt), ptr(da), ptr(db), ptr(dc), ptr(dd), ptr(ds0),
            ptr(work), bsz, l, h, p, g, n, chunk, stream,
        )
    if rc != 0:
        msg = lib.ssd_bwd_error_string(rc).decode()
        raise RuntimeError(f"ssd_bwd launch failed: {msg} ({rc})")
    ssd_scan_backward.launches += 1
    return dx, ddt, da, db, dc, dd, ds0


ssd_scan_backward.launches = 0


class SSDScan(torch.autograd.Function):
    """The SSD scan whose forward is the CUDA forward and whose backward is
    the CUDA backward. The forward saves its inputs only: the backward
    recomputes the states it needs."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat, chunk, d_skip, initial_state,
                return_final_state):
        ctx.config = (chunk, return_final_state)
        ctx.save_for_backward(x, dt, a, b_mat, c_mat, d_skip, initial_state)
        return ssd_scan(x, dt, a, b_mat, c_mat, chunk, d_skip, initial_state,
                        return_final_state)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, *d_final):
        chunk, return_final_state = ctx.config
        x, dt, a, b_mat, c_mat, d_skip, initial_state = ctx.saved_tensors
        dx, ddt, da, db, dc, dd, ds0 = ssd_scan_backward(
            x, dt, a, b_mat, c_mat, dy, chunk, d_skip, initial_state,
            d_final[0] if return_final_state else None)
        return dx, ddt, da, db, dc, None, dd, ds0, None
