"""Build a CUDA source with a plain C interface into a shared library
and load it with ``ctypes``.

Each kernel source is compiled with ``nvcc`` for ``sm_90a`` at its first
use, into ``_build/`` beside this file (listed in ``.gitignore``). The
library's name carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. ``ptxas -v``
output (registers, shared memory, spills) is kept in a ``.log`` beside
the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load", "nvcc"]

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                       "the CUDA kernels need the CUDA toolkit")


def build(source: Path) -> Path:
    """Compile ``source`` unless a library of the same content exists."""
    tag = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}-{tag}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode} on {source}:\n"
            f"{proc.stderr[-6000:]}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return out


def load(source: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source)))
