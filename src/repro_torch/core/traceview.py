"""ASCII trace rendering — the Paraver-style visual check.

The paper validates every metric against an execution trace ("the traces
serve as a visual confirmation that the reported metrics are consistent
with the observed behavior"). This renderer draws a ``Trace`` as one
timeline row per host rank and per device, with the paper's color
legend mapped to characters:

  host:   '#' useful (blue)   'o' offload (orange)   'm' MPI (red)
  device: '#' kernel (blue)   '=' memory (green)     '.' idle (gray)

Host rows are rendered from state *durations* in recorded order when the
trace was built synthetically (cursor order is chronological); device
rows are exact (records carry timestamps).
"""

from __future__ import annotations

from typing import List

import numpy as np

from . import intervals as ivx
from .states import DeviceState, Trace

__all__ = ["render_trace"]


def _paint(row: np.ndarray, intervals, ch: str, t0: float, scale: float):
    for s, e in intervals:
        a = int(round((s - t0) * scale))
        b = max(a + 1, int(round((e - t0) * scale)))
        row[a: min(b, len(row))] = ch


def render_trace(trace: Trace, width: int = 72, legend: bool = True) -> str:
    """Render one row per host rank and per device; ``legend=False``
    drops the state-character key from the header (embedding in logs
    that print it once)."""
    if trace.window is not None:
        t0, t1 = trace.window
    else:
        t1 = trace.elapsed
        t0 = 0.0
    span = t1 - t0
    # A degenerate (zero-width) window renders empty rows rather than
    # scaling finite durations by an effectively infinite factor.
    scale = width / span if span > 1e-12 else 0.0
    header = f"trace '{trace.name}'  [{t0:.3f}s .. {t1:.3f}s]"
    if legend:
        header += (
            "  (host: #=useful o=offload m=mpi"
            " | device: #=kernel ==memory .=idle)"
        )
    lines: List[str] = [header]
    # Host rows: reconstruct order-free proportional bars (durations only)
    for rank in sorted(trace.hosts):
        h = trace.hosts[rank]
        row = np.full(width, " ", dtype="<U1")
        cursor = 0
        for dur, ch in ((h.useful, "#"), (h.offload, "o"), (h.mpi, "m")):
            # Clamp to the remaining row: state totals can exceed the
            # window (or the window can be zero-width) without the
            # cursor running past the bar.
            n = min(int(round(dur * scale)), width - cursor)
            if n > 0:
                row[cursor: cursor + n] = ch
                cursor += n
        lines.append(f"rank {rank:3d} |{''.join(row)}|")
    # Device rows: exact interval painting
    for dev in sorted(trace.devices):
        tl = trace.devices[dev]
        states = tl.state_intervals((t0, t1))
        row = np.full(width, ".", dtype="<U1")
        if scale > 0:
            _paint(row, states[DeviceState.MEMORY], "=", t0, scale)
            _paint(row, states[DeviceState.KERNEL], "#", t0, scale)
        lines.append(f"dev  {dev:3d} |{''.join(row)}|")
    return "\n".join(lines)
