"""Hand-written CUDA flash-attention forward (``csrc/flash_fwd.cu``) and
its ``ctypes`` binding.

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py::_flash_kernel``; the
source's header says what bounds it on the H100 and what its design does
about that. The library is built with ``nvcc`` at the first launch, never
at import, so this module imports on machines without CUDA.

:func:`flash_attention` takes CUDA tensors only and raises for anything
the kernel does not take; it never falls back to the plain version. Its
``launches`` attribute counts kernel launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .. import cuda_build

__all__ = ["HEAD_DIMS", "SOURCE", "check_inputs", "flash_attention", "library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
HEAD_DIMS = (32, 64, 128)
_MAX_GRID_YZ = 65535
_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
            + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_inputs(q, k, v, causal: bool, window: Optional[int],
                 softcap: Optional[float]) -> None:
    """Raise ``ValueError`` for any input the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants q (B,S,H,D), k/v (B,T,K,D)")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    t, nk = k.shape[1], k.shape[2]
    if nk == 0 or h % nk:
        raise ValueError(f"GQA requires H % K == 0, got {h} % {nk}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; have {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: want all "
                         "float32 or all bfloat16")
    if min(b, s, t, h) < 1 or b > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"sizes out of range: B={b} S={s} T={t} H={h}")
    if causal and s > t:
        raise ValueError(f"causal attention needs S <= T (got {s} > {t}): "
                         "earlier query rows would see no key")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention wants contiguous q, k, v")
    if any(x.device.type != "cuda" for x in (q, k, v)):
        raise ValueError("flash_attention launches a CUDA kernel and wants "
                         "CUDA tensors; ops.attention takes the plain version "
                         "for CPU tensors")
    if not (q.device == k.device == v.device):
        raise ValueError(f"tensors on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention wants 16-byte aligned tensors")


def flash_attention(
    q: torch.Tensor,            # (B, S, H, D)
    k: torch.Tensor,            # (B, T, K, D)
    v: torch.Tensor,            # (B, T, K, D)
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Launch the kernel on the current stream; returns (B, S, H, D) in
    q's dtype. Does not synchronise."""
    check_inputs(q, k, v, causal, window, softcap)
    lib = library()
    b, s, h, d = q.shape
    t, nk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, s, t, h, nk, d, int(q.dtype == torch.bfloat16), int(causal),
            window or 0, float(softcap or 0.0), d ** -0.5, stream,
        )
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: {msg} ({rc})")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
