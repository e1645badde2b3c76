"""Self-overhead accounting, copied from ``repro.core.telemetry``.

Only :mod:`.overhead` is copied: the core modules time their hot paths
against it. The trace exporter, metric stream, step series and watchdog
of ``repro.core.telemetry`` are not ported yet.
"""

from __future__ import annotations

from .overhead import OverheadAccumulator, current, install, section  # noqa: F401
from . import overhead  # noqa: F401

__all__ = ["OverheadAccumulator", "current", "install", "section", "overhead"]
