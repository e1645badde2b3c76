"""Build a CUDA source with a plain C interface into a shared library
and load it with ``ctypes``.

Each kernel source is compiled with ``nvcc`` for ``sm_90a`` at its first
use, into ``_build/`` beside this file (listed in ``.gitignore``). The
library's name carries a hash of the source, of every header it includes
from the port's ``csrc`` directories (its own and the shared
:data:`INCLUDE_DIR`, which holds ``hopper.cuh``), and of the flags, so an
edit to any of them rebuilds it and an unchanged one is loaded as it is.
``ptxas -v`` output (registers, shared memory, spills) is kept in a
``.log`` beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, List

__all__ = ["BUILD_DIR", "INCLUDE_DIR", "NVCC_FLAGS", "build", "includes",
           "load", "nvcc", "tag"]

BUILD_DIR = Path(__file__).resolve().parent / "_build"
INCLUDE_DIR = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-I", str(INCLUDE_DIR),
)
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


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


def includes(source: Path,
             include_dirs: Iterable[Path] = (INCLUDE_DIR,)) -> List[Path]:
    """The headers ``source`` includes with ``#include "..."``, directly or
    through another such header, found beside the including file or in
    ``include_dirs``; system headers (``<...>``) and names found nowhere
    there are not followed."""
    dirs = [Path(d) for d in include_dirs]
    found: List[Path] = []
    todo = [Path(source)]
    while todo:
        cur = todo.pop()
        for name in _INCLUDE.findall(cur.read_text()):
            for d in [cur.parent, *dirs]:
                cand = (d / name).resolve()
                if cand.is_file():
                    if cand not in found:
                        found.append(cand)
                        todo.append(cand)
                    break
    return sorted(found)


def tag(source: Path, include_dirs: Iterable[Path] = (INCLUDE_DIR,),
        flags: Iterable[str] = NVCC_FLAGS) -> str:
    """Hash of the source, the headers it includes and the flags."""
    h = hashlib.sha256(Path(source).read_bytes())
    for header in includes(source, include_dirs):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build(source: Path) -> Path:
    """Compile ``source`` unless a library of the same content exists."""
    out = BUILD_DIR / f"{source.stem}-{tag(source)}.so"
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
