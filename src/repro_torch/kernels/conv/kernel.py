"""Hand-written CUDA causal depthwise conv + SiLU of the Mamba-2 mixer
(``csrc/conv.cu``), forward and backward over all of a layer's conv inputs
at once, their ``ctypes`` bindings and the ``torch.autograd.Function`` that
joins them.

It replaces no TPU kernel (the JAX package's ``repro.models.ssm.
_causal_conv`` is plain jnp, which XLA fuses); it takes the place of the
eager ops of :func:`.ref.causal_conv` (about 16 kernels a tensor forward
and 40 in autograd's backward, most of them strided bf16 products), which
stays as its plain version, the CPU path and decode's one-token conv.
x, w, dy and every output are bf16. Bytes bound it: the forward reads x
and writes y, the backward reads x and dy and writes dx (4 and 6 bytes an
element; :mod:`.work`).
One forward call launches ``causal_conv_silu_fwd`` once for every tensor;
one backward call launches ``causal_conv_silu_bwd`` and the fixed-order
sum of its fp32 partials of dw, ``causal_conv_dw_sum``, through a scratch
the wrapper allocates. The backward recomputes the pre-activation from
the inputs, so the forward saves nothing but its inputs. Both are
deterministic: no float atomics, so a rerun on the same inputs gives the
same bits. The library is built with ``nvcc`` at its first launch, never
at import, so this module imports on machines without CUDA.

:func:`causal_conv_fwd` and :func:`causal_conv_bwd` take CUDA tensors only
(DTensors raise ``TypeError``: ``ops.causal_conv_silu`` hands them each
rank's shards) and raise ``ValueError`` for anything the kernels do not
take (a dtype other than bf16, a non-contiguous tensor, tensors of
different batch, length or taps, K other than 4, more than ``MAX_TENSORS``
tensors, tensors on different devices), before any library is loaded; they
never fall back to the plain version. :func:`causal_conv_fwd` returns
tensors with no autograd graph, so it refuses inputs that require grad
under grad mode: :class:`CausalConvSilu` (through
``ops.causal_conv_silu``) is the differentiable path. A fake tensor takes
the kernels' place (``kernels.fake``): the same checks but the device's,
the same outputs and scratch as fakes, and the work of :mod:`.work` given
to its fake mode; nothing is launched or counted. Each function's
``launches`` attribute counts its calls (one a layer and pass), not the
kernels a call launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from ...sharding.local import refuse_dtensor
from .. import cuda_build
from ..fake import is_fake, record_work
from .work import conv_backward_work, conv_work

__all__ = ["BWD_RUN", "BLOCK_RUNS", "MAX_TENSORS", "SOURCE", "TAPS",
           "CausalConvSilu", "causal_conv_bwd", "causal_conv_fwd",
           "library", "partial_rows"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "conv.cu"
MAX_TENSORS = 4        # tensors in one launch (kMaxTensors)
TAPS = (4,)            # the K the kernels take (kTaps: every config's)
BWD_RUN = 32           # time steps of a backward run (kBwdRun)
BLOCK_RUNS = 8         # runs of a block (kRuns)
_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        ints = ctypes.POINTER(ctypes.c_int)
        lib.causal_conv_fwd.argtypes = ([ctypes.c_int] + [ptrs] * 3
                                        + [ints] + [ctypes.c_int] * 3
                                        + [ctypes.c_void_p])
        lib.causal_conv_fwd.restype = ctypes.c_int
        lib.causal_conv_bwd.argtypes = ([ctypes.c_int] + [ptrs] * 5
                                        + [ints] + [ctypes.c_int] * 3
                                        + [ctypes.c_void_p] * 2)
        lib.causal_conv_bwd.restype = ctypes.c_int
        lib.causal_conv_error_string.argtypes = [ctypes.c_int]
        lib.causal_conv_error_string.restype = ctypes.c_char_p
        got = (lib.causal_conv_bwd_run(), lib.causal_conv_block_runs())
        if got != (BWD_RUN, BLOCK_RUNS):
            raise RuntimeError(f"{SOURCE.name} runs {got} (backward run, "
                               f"runs a block), this module "
                               f"{(BWD_RUN, BLOCK_RUNS)}")
        _lib = lib
    return _lib


def partial_rows(batch: int, length: int) -> int:
    """The backward's partial rows of dw a tensor: one per batch row and
    block of ``BLOCK_RUNS`` runs of ``BWD_RUN`` steps."""
    runs = -(-length // BWD_RUN)
    return batch * -(-runs // BLOCK_RUNS)


def _check(where: str, xs: Sequence[torch.Tensor],
           ws: Sequence[torch.Tensor],
           dys: Sequence[torch.Tensor] = ()) -> None:
    """Raise for tensors the kernels do not take: ``ValueError``, or
    ``TypeError`` for a DTensor."""
    refuse_dtensor(where, *xs, *ws, *dys)
    if not 1 <= len(xs) <= MAX_TENSORS or len(ws) != len(xs):
        raise ValueError(f"{where} takes 1 to {MAX_TENSORS} inputs and a "
                         f"weight each, got {len(xs)} and {len(ws)}")
    if any(x.dim() != 3 for x in xs) or any(w.dim() != 2 for w in ws):
        raise ValueError(f"{where} wants x (B, L, C) and w (K, C)")
    b, length = xs[0].shape[:2]
    k = ws[0].shape[0]
    for x, w in zip(xs, ws):
        if (tuple(x.shape[:2]) != (b, length) or w.shape[0] != k
                or w.shape[1] != x.shape[2]):
            raise ValueError(
                f"{where}: shapes {[tuple(t.shape) for t in xs]} and "
                f"{[tuple(t.shape) for t in ws]}: want one (B, L), one K "
                "and each weight's width its input's")
    if k not in TAPS:
        raise ValueError(f"{where} takes K in {TAPS}, got {k}")
    if min(b, length, *(x.shape[2] for x in xs)) < 1:
        raise ValueError(f"{where}: empty input {[tuple(x.shape) for x in xs]}")
    if any(t.dtype != torch.bfloat16 for t in (*xs, *ws)):
        raise ValueError(f"{where} takes bfloat16 inputs and weights, all "
                         "of one dtype, got "
                         f"{sorted({str(t.dtype) for t in (*xs, *ws)})}")
    for x, dy in zip(xs, dys):
        if dy.shape != x.shape or dy.dtype != x.dtype:
            raise ValueError(f"{where}: dy {tuple(dy.shape)} {dy.dtype}, "
                             f"want x's {tuple(x.shape)} {x.dtype}")
    tensors = [*xs, *ws, *dys]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{where} wants contiguous tensors")
    if is_fake(xs[0]):   # no memory: the device and alignment are the launch's
        return
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{where} launches a CUDA kernel and wants CUDA "
                         "tensors; ops.causal_conv_silu takes the plain "
                         "version for CPU tensors")
    if any(t.device != xs[0].device for t in tensors):
        raise ValueError(f"{where}: tensors on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")


def _ptrs(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _widths(xs: Sequence[torch.Tensor]):
    return (ctypes.c_int * len(xs))(*[x.shape[2] for x in xs])


def _work_args(xs, ws):
    b, length = xs[0].shape[:2]
    return b, length, [x.shape[2] for x in xs], ws[0].shape[0], xs[0].dtype


def causal_conv_fwd(xs: Sequence[torch.Tensor],
                    ws: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """silu(causal_conv(x, w)) for each x (B, L, C_x) and its w (K, C_x),
    in one launch on the current stream; each output in bf16. Does
    not synchronise. Refuses inputs that require grad under grad mode."""
    xs, ws = list(xs), list(ws)
    if torch.is_grad_enabled() and any(t.requires_grad for t in xs + ws):
        raise RuntimeError(
            "kernel.causal_conv_fwd returns tensors with no autograd graph "
            "and would cut the gradient to its inputs; call "
            "ops.causal_conv_silu (CausalConvSilu) for inputs that require "
            "grad")
    _check("causal_conv_fwd", xs, ws)
    ys = [torch.empty_like(x) for x in xs]
    if is_fake(xs[0]):
        record_work(xs[0], "causal_conv_fwd", *conv_work(*_work_args(xs, ws)))
        return tuple(ys)
    b, length = xs[0].shape[:2]
    lib = library()
    with torch.cuda.device(xs[0].device):
        rc = lib.causal_conv_fwd(
            len(xs), _ptrs(xs), _ptrs(ws), _ptrs(ys), _widths(xs), b, length,
            ws[0].shape[0],
            torch.cuda.current_stream(xs[0].device).cuda_stream)
    if rc != 0:
        msg = lib.causal_conv_error_string(rc).decode()
        raise RuntimeError(f"causal_conv_fwd launch failed: {msg} ({rc})")
    causal_conv_fwd.launches += 1
    return tuple(ys)


causal_conv_fwd.launches = 0


def causal_conv_bwd(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                    dys: Sequence[torch.Tensor]
                    ) -> Tuple[Tuple[torch.Tensor, ...],
                               Tuple[torch.Tensor, ...]]:
    """From dys, the gradients of :func:`causal_conv_fwd`'s outputs: (the
    dx of each x, the dw of each w), each in bf16, in two
    launches on the current stream. Does not synchronise."""
    xs, ws = list(xs), list(ws)
    dys = [dy.contiguous() for dy in dys]
    if len(dys) != len(xs):
        raise ValueError(f"causal_conv_bwd: {len(dys)} gradients for "
                         f"{len(xs)} outputs")
    _check("causal_conv_bwd", xs, ws, dys)
    b, length = xs[0].shape[:2]
    k = ws[0].shape[0]
    dxs = [torch.empty_like(x) for x in xs]
    dws = [torch.empty_like(w) for w in ws]
    partials = torch.empty(
        (partial_rows(b, length) * k * sum(x.shape[2] for x in xs),),
        dtype=torch.float32, device=xs[0].device)
    if is_fake(xs[0]):
        record_work(xs[0], "causal_conv_bwd",
                    *conv_backward_work(*_work_args(xs, ws)))
        return tuple(dxs), tuple(dws)
    lib = library()
    with torch.cuda.device(xs[0].device):
        rc = lib.causal_conv_bwd(
            len(xs), _ptrs(xs), _ptrs(ws), _ptrs(dys), _ptrs(dxs), _ptrs(dws),
            _widths(xs), b, length, k, partials.data_ptr(),
            torch.cuda.current_stream(xs[0].device).cuda_stream)
    if rc != 0:
        msg = lib.causal_conv_error_string(rc).decode()
        raise RuntimeError(f"causal_conv_bwd launch failed: {msg} ({rc})")
    causal_conv_bwd.launches += 1
    return tuple(dxs), tuple(dws)


causal_conv_bwd.launches = 0


class CausalConvSilu(torch.autograd.Function):
    """silu(causal_conv(x_i, w_i)) for n inputs and their weights, given
    flat as (x_1 .. x_n, w_1 .. w_n), whose forward and backward are the
    CUDA kernels. The forward saves its inputs only: the backward
    recomputes the pre-activation."""

    @staticmethod
    def forward(ctx, *tensors):
        n = len(tensors) // 2
        ctx.save_for_backward(*tensors)
        return causal_conv_fwd(tensors[:n], tensors[n:])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *dys):
        tensors = ctx.saved_tensors
        n = len(tensors) // 2
        dxs, dws = causal_conv_bwd(tensors[:n], tensors[n:], dys)
        return (*dxs, *dws)
