"""Columnar device-record storage — the zero-object ingestion core.

The paper's "lightweight monitoring" claim (§3.2, §4.2) only survives
CUPTI-scale activity streams if the record path does *not* allocate one
Python object per event. Production monitoring systems keep per-event
data in compact arrays (MPCDF's job monitor, arXiv:1909.11704; CERN's
heterogeneous-workload profiler streams batched activity buffers,
arXiv:2511.13928); this module is that discipline for TALP-JAX:

  * one activity record is one row of a NumPy **structured array** with
    layout ``kind:u1, start:f8, end:f8, stream:u4`` (21 bytes packed,
    vs ~200+ bytes for a ``DeviceRecord`` dataclass instance);
  * :class:`ColumnStore` is a preallocated append buffer with an
    amortized-doubling growth policy — scalar ``append`` for the legacy
    object façade, ``extend_columns`` for whole activity buffers;
  * kind codes are plain integers so per-kind selection during
    compaction is a vectorized boolean mask, not a Python comprehension.

:class:`~repro.core.states.DeviceTimeline` builds on this store;
backends deliver whole buffers through ``flush_arrays()`` (see
:mod:`repro.core.backends.base`) so records never materialize as
objects anywhere on the hot path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "RECORD_DTYPE",
    "KIND_KERNEL",
    "KIND_MEMORY",
    "ColumnStore",
    "as_record_columns",
]

#: Packed per-record layout (≙ one CUPTI activity record).
RECORD_DTYPE = np.dtype(
    [("kind", "u1"), ("start", "f8"), ("end", "f8"), ("stream", "u4")]
)

# Integer kind codes (array-friendly stand-ins for DeviceActivity).
KIND_KERNEL = 0
KIND_MEMORY = 1


class ColumnStore:
    """Preallocated structured-array append buffer (amortized doubling).

    Rows live in a single contiguous ``RECORD_DTYPE`` array; ``append``
    writes one row, ``extend_columns`` writes a whole batch with four
    column assignments. ``view()`` exposes the filled prefix without a
    copy — callers must treat it as read-only and must not hold it
    across a ``clear()``/``append`` (the buffer may be reallocated).
    """

    __slots__ = ("_buf", "_n")

    def __init__(self, capacity: int = 1024):
        self._buf = np.empty(max(int(capacity), 16), dtype=RECORD_DTYPE)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    @property
    def capacity(self) -> int:
        return len(self._buf)

    def _grow(self, need: int) -> None:
        cap = len(self._buf)
        while cap < need:
            cap *= 2
        new = np.empty(cap, dtype=RECORD_DTYPE)
        new[: self._n] = self._buf[: self._n]
        self._buf = new

    def append(self, kind: int, start: float, end: float, stream: int = 0) -> None:
        if self._n >= len(self._buf):
            self._grow(self._n + 1)
        self._buf[self._n] = (kind, start, end, stream)
        self._n += 1

    def extend_columns(
        self,
        kinds: np.ndarray,
        starts: np.ndarray,
        ends: np.ndarray,
        streams: Optional[np.ndarray] = None,
    ) -> int:
        """Bulk-append one batch of columns; returns rows written."""
        m = len(starts)
        if m == 0:
            return 0
        need = self._n + m
        if need > len(self._buf):
            self._grow(need)
        rows = self._buf[self._n:need]
        rows["kind"] = kinds
        rows["start"] = starts
        rows["end"] = ends
        rows["stream"] = 0 if streams is None else streams
        self._n = need
        return m

    def view(self) -> np.ndarray:
        """Read-only view of the filled prefix (no copy)."""
        return self._buf[: self._n]

    def take(self) -> np.ndarray:
        """Copy out the filled rows and clear the store."""
        out = self._buf[: self._n].copy()
        self._n = 0
        return out

    def clear(self) -> None:
        self._n = 0


def as_record_columns(
    kinds,
    starts,
    ends,
    streams=None,
    n: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Coerce and validate one activity-buffer batch to canonical columns.

    ``kinds`` may be an integer array, a scalar kind code applied to the
    whole batch, or a sequence of ``DeviceActivity`` members (converted
    via their ``code``). ``streams=None`` becomes a zero column. Raises
    ``ValueError`` on length mismatch or any ``end < start``.
    """
    starts = np.asarray(starts, dtype=np.float64).ravel()
    ends = np.asarray(ends, dtype=np.float64).ravel()
    m = len(starts) if n is None else n
    if len(starts) != m or len(ends) != m:
        raise ValueError(
            f"column length mismatch: starts={len(starts)} ends={len(ends)}"
        )
    if np.any(ends < starts):
        raise ValueError("record end < start in batch")
    if np.ndim(kinds) == 0 and not isinstance(kinds, np.ndarray):
        code = getattr(kinds, "code", kinds)
        kind_col = np.full(m, int(code), dtype=np.uint8)
    else:
        seq = [getattr(k, "code", k) for k in kinds] if not isinstance(
            kinds, np.ndarray
        ) else kinds
        kind_col = np.asarray(seq, dtype=np.uint8).ravel()
        if len(kind_col) != m:
            raise ValueError(
                f"column length mismatch: kinds={len(kind_col)} starts={m}"
            )
    if streams is None:
        stream_col = np.zeros(m, dtype=np.uint32)
    else:
        stream_col = np.asarray(streams, dtype=np.uint32).ravel()
        if len(stream_col) != m:
            raise ValueError(
                f"column length mismatch: streams={len(stream_col)} starts={m}"
            )
    return kind_col, starts, ends, stream_col
