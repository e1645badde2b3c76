"""Hand-written CUDA flash attention, forward (``csrc/flash_fwd.cu``) and
backward (``csrc/flash_bwd.cu``), their ``ctypes`` bindings and the
``torch.autograd.Function`` that joins them.

The forward replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py::_flash_kernel``; the
backward has no TPU counterpart (the JAX package differentiates its
attention through XLA). Each source's header says what bounds it on the
H100 and what its design does about that. The libraries are built with
``nvcc`` at their first launch, never at import, so this module imports on
machines without CUDA.

:func:`flash_attention` and :func:`flash_attention_backward` take bf16
CUDA tensors only and raise for anything the kernels do not take; they
never fall back to the plain version. :func:`flash_attention` returns a
tensor with no autograd graph, so it refuses inputs that require grad
under grad mode: :class:`FlashAttention` (through ``ops.attention``) is
the differentiable path. Each function's ``launches`` attribute counts its
calls; one backward call launches three kernels.

A fake tensor takes the kernels' place (``kernels.fake``): the same
checks but the device's, the same outputs as fakes, and the work of
:mod:`.work` given to its fake mode; nothing is launched or counted.

Head dims: the forward takes 32, 64, 80, 120, 128, 224 and 256 (80 is
zamba2-2.7b's 2560 / 32, 120 h2o-danube-3-4b's 3840 / 32, 224
zamba2-7b's 7168 / 32, 256 gemma2-2b's), and so does the backward. D 80
and 120 run the D-128 tiles over columns TMA fills with zeros; D 256 runs
tiles of fewer keys, and D 224 the D-256 tiles over zero columns 224-255
(each source's header says how). Any other head dim is refused with
``ValueError`` here, before the library's dispatch.

The softmax scale is a kernel argument: D^-1/2 unless ``scale`` is given
(Zamba-2's shared blocks take (D / 2)^-1/2), applied in fp32 inside the
kernels, never folded into q in bf16.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ...sharding.local import refuse_dtensor
from .. import cuda_build
from ..fake import is_fake, record_work
from .work import attention_backward_work, attention_work

__all__ = ["BWD_HEAD_DIMS", "BWD_SOURCE", "FWD_HEAD_DIMS", "FlashAttention",
           "SOURCE", "backward_library", "check_inputs", "flash_attention",
           "flash_attention_backward", "library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
BWD_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_bwd.cu"
FWD_HEAD_DIMS = (32, 64, 80, 120, 128, 224, 256)
BWD_HEAD_DIMS = (32, 64, 80, 120, 128, 224, 256)
_MAX_GRID_YZ = 65535
_lib: Optional[ctypes.CDLL] = None
_bwd_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """Build (at first use) and load the forward's library."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
            + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def backward_library() -> ctypes.CDLL:
    """Build (at first use) and load the backward's library."""
    global _bwd_lib
    if _bwd_lib is None:
        lib = cuda_build.load(BWD_SOURCE)
        lib.flash_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
            + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.flash_attention_bwd.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def check_inputs(q, k, v, causal: bool, window: Optional[int],
                 softcap: Optional[float],
                 head_dims: tuple = FWD_HEAD_DIMS,
                 scale: Optional[float] = None) -> None:
    """Raise ``ValueError`` for any input the kernel does not take; the
    head dim must be one of ``head_dims``, a given scale finite and > 0. A
    DTensor raises ``TypeError`` (``ops.attention`` maps it to its shards
    first)."""
    refuse_dtensor("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants q (B,S,H,D), k/v (B,T,K,D)")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    t, nk = k.shape[1], k.shape[2]
    if nk == 0 or h % nk:
        raise ValueError(f"GQA requires H % K == 0, got {h} % {nk}")
    if d not in head_dims:
        raise ValueError(f"head dim {d} not supported; have {head_dims}")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: want all "
                         "bfloat16")
    if min(b, s, t, h) < 1 or b > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"sizes out of range: B={b} S={s} T={t} H={h}")
    if causal and s > t:
        raise ValueError(f"causal attention needs S <= T (got {s} > {t}): "
                         "earlier query rows would see no key")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if scale is not None and not 0 < scale < float("inf"):
        raise ValueError(f"scale must be finite and > 0, got {scale}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention wants contiguous q, k, v")
    if is_fake(q):   # no memory: the device and alignment are the launch's
        return
    if any(x.device.type != "cuda" for x in (q, k, v)):
        raise ValueError("flash_attention launches a CUDA kernel and wants "
                         "CUDA tensors; ops.attention takes the plain version "
                         "for CPU tensors")
    if not (q.device == k.device == v.device):
        raise ValueError(f"tensors on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention wants 16-byte aligned tensors")


def _refuse_grad(*tensors) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise RuntimeError(
            "kernel.flash_attention returns a tensor with no autograd graph "
            "and would cut the gradient to q, k and v; call "
            "ops.attention (FlashAttention) for inputs that require grad")


def flash_attention(
    q: torch.Tensor,            # (B, S, H, D)
    k: torch.Tensor,            # (B, T, K, D)
    v: torch.Tensor,            # (B, T, K, D)
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    return_lse: bool = False,
    scale: Optional[float] = None,
):
    """Launch the forward on the current stream; returns o (B, S, H, D) in
    bf16, and with ``return_lse`` also each row's log-sum-exp of the
    scaled, soft-capped, masked scores, fp32 (B, H, S). ``scale``: the
    softmax scale, D^-1/2 by default. Does not synchronise. Refuses inputs
    that require grad under grad mode."""
    _refuse_grad(q, k, v)
    check_inputs(q, k, v, causal, window, softcap, scale=scale)
    b, s, h, d = q.shape
    t, nk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if is_fake(q):
        record_work(q, "flash_attention_fwd", *attention_work(
            b, s, t, h, nk, d, window, q.dtype, causal))
        return (o, lse) if return_lse else o
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, s, t, h, nk, d, int(causal),
            window or 0, float(softcap or 0.0),
            d ** -0.5 if scale is None else scale, stream,
        )
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: {msg} ({rc})")
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


flash_attention.launches = 0


def flash_attention_backward(
    q: torch.Tensor,            # (B, S, H, D)
    k: torch.Tensor,            # (B, T, K, D)
    v: torch.Tensor,            # (B, T, K, D)
    o: torch.Tensor,            # (B, S, H, D), the forward's output
    lse: torch.Tensor,          # (B, H, S) fp32, the forward's log-sum-exp
    do: torch.Tensor,           # (B, S, H, D), the gradient of o
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
):
    """Launch the three backward kernels on the current stream; returns
    (dq, dk, dv) in bf16; ``scale`` as the forward's. Does not
    synchronise."""
    check_inputs(q, k, v, causal, window, softcap, BWD_HEAD_DIMS, scale)
    do = do.contiguous()
    b, s, h, d = q.shape
    t, nk = k.shape[1], k.shape[2]
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype} on {x.device}:"
                             f" want q's {tuple(q.shape)} {q.dtype} on "
                             f"{q.device}")
    if (lse.shape != (b, h, s) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: want "
                         f"({b}, {h}, {s}) float32 on {q.device}")
    if not (o.is_contiguous() and lse.is_contiguous()):
        raise ValueError("flash_attention_backward wants contiguous o, lse")
    if is_fake(q):
        grads = tuple(torch.empty_like(x) for x in (q, k, v))
        record_work(q, "flash_attention_bwd", *attention_backward_work(
            b, s, t, h, nk, d, window, q.dtype, causal))
        return grads
    if any(x.data_ptr() % 16 for x in (o, do, lse)):
        raise ValueError("flash_attention_backward wants 16-byte aligned "
                         "tensors")
    lib = backward_library()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            b, s, t, h, nk, d, int(causal),
            window or 0, float(softcap or 0.0),
            d ** -0.5 if scale is None else scale, stream,
        )
    if rc != 0:
        msg = lib.flash_attention_bwd_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_bwd launch failed: {msg} ({rc})")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is the CUDA forward and whose backward is
    the CUDA backward. The forward writes the log-sum-exp the backward
    needs only when some input requires grad."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale=None):
        ctx.config = (causal, window, softcap, scale)
        if not any(ctx.needs_input_grad[:3]):
            return flash_attention(q, k, v, causal, window, softcap,
                                   scale=scale)
        o, lse = flash_attention(q, k, v, causal, window, softcap,
                                 return_lse=True, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                              *ctx.config)
        return dq, dk, dv, None, None, None, None
