"""The benchmark's own tests: run with ``python -m pytest perfbench/tests``
from the repository's root. They put the root (for ``perfbench``) and
``src`` (for the program, ``repro_torch``) on the import path. Tests that
need a CUDA card carry the ``gpu`` marker and decide inside a fixture."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for path in (str(REPO / "src"), str(REPO)):
    if path not in sys.path:
        sys.path.insert(0, path)
