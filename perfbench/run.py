"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the run's result as the last line of standard output and each
number the correctness check compares, beside its limit, as the last
lines of standard error. Exits non-zero, printing no result, without as
many CUDA cards as the cell asks for, or when a module of JAX or of the
JAX package is loaded at the end."""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    # this file's directory first on the path would shadow modules of
    # the standard library by the benchmark's own
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(REPO), str(REPO / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != here]
    # kernel caches inside the checkout, at fixed paths (the program's
    # nvcc builds go to its own src/repro_torch/kernels/_build/)
    cache = REPO / "perfbench" / "_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "extensions"))
    from perfbench.harness import main as run

    return run(started=STARTED)


if __name__ == "__main__":
    sys.exit(main())
