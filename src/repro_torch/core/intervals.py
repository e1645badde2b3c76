"""Interval algebra for TALP activity-record post-processing.

Implements the paper's uniform, backend-independent post-processing step
(§4.2):

  * kernel records from all streams are *flattened* into disjoint
    execution intervals,
  * memory-transfer records are flattened and any overlap with kernel
    intervals is *subtracted* (device-level overlap counts as
    computation),
  * the uncovered remainder of the window is classified as *idle*.

Intervals are represented as float64 ndarrays of shape (N, 2) with
columns (start, end), ``end >= start``. All functions return flattened
(sorted, disjoint) intervals and are pure.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "EMPTY",
    "as_intervals",
    "flatten",
    "total",
    "subtract",
    "intersect",
    "union",
    "gaps",
    "clip",
    "is_flat",
    "window_total",
]

EMPTY = np.zeros((0, 2), dtype=np.float64)


def as_intervals(pairs) -> np.ndarray:
    """Coerce a sequence of (start, end) pairs to the canonical ndarray form."""
    arr = np.asarray(pairs, dtype=np.float64)
    if arr.size == 0:
        return EMPTY.copy()
    arr = arr.reshape(-1, 2)
    if np.any(arr[:, 1] < arr[:, 0]):
        raise ValueError("interval with end < start")
    return arr


def is_flat(iv: np.ndarray) -> bool:
    """True if intervals are sorted, disjoint and non-degenerate-ordered."""
    iv = as_intervals(iv)
    if len(iv) <= 1:
        return True
    return bool(np.all(iv[1:, 0] >= iv[:-1, 1]))


def flatten(iv: np.ndarray) -> np.ndarray:
    """Merge overlapping/touching intervals into a sorted disjoint set.

    This is the paper's "kernel execution records are flattened so that
    overlapping launches across streams are merged into a single
    continuous execution interval".
    """
    iv = as_intervals(iv)
    # Drop zero-length intervals; they carry no duration.
    iv = iv[iv[:, 1] > iv[:, 0]]
    if len(iv) == 0:
        return EMPTY.copy()
    # Fast path: already sorted and disjoint (the common case on the hot
    # post-processing path, where most inputs were flattened upstream).
    if len(iv) == 1 or bool(np.all(iv[1:, 0] > iv[:-1, 1])):
        return iv.copy()
    # Sort by start only: the merged output is independent of the order
    # of equal starts (an interval never opens a group inside its own
    # equal-start block, since every earlier end > the shared start), so
    # the cheaper single-key unstable sort is exact.
    order = np.argsort(iv[:, 0], kind="quicksort")
    iv = iv[order]
    # Vectorized merge: a new group starts where start > running max of
    # previous ends.
    run_max_end = np.maximum.accumulate(iv[:, 1])
    new_group = np.ones(len(iv), dtype=bool)
    new_group[1:] = iv[1:, 0] > run_max_end[:-1]
    group_id = np.cumsum(new_group) - 1
    n_groups = group_id[-1] + 1
    starts = np.zeros(n_groups)
    ends = np.zeros(n_groups)
    # first element of each group has the min start (sorted by start)
    first_idx = np.flatnonzero(new_group)
    starts = iv[first_idx, 0]
    ends = np.maximum.reduceat(iv[:, 1], first_idx)
    return np.stack([starts, ends], axis=1)


def total(iv: np.ndarray) -> float:
    """Total covered duration. Flattens first so overlap is not double counted."""
    iv = flatten(iv)
    if len(iv) == 0:
        return 0.0
    return float(np.sum(iv[:, 1] - iv[:, 0]))


def _intersect_flat(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized core: intersection of two flattened, non-empty sets.

    For each interval of ``a`` the overlapping run of ``b`` intervals is
    located with two binary searches; the (a_i, b_j) overlap pairs are then
    materialized with a repeat/cumsum expansion. For flattened inputs the
    total number of pairs is at most ``len(a) + len(b) - 1``, so the
    expansion is linear in the input size.
    """
    # first j with b_end > a_start  /  first j with b_start >= a_end
    lo = np.searchsorted(b[:, 1], a[:, 0], side="right")
    hi = np.searchsorted(b[:, 0], a[:, 1], side="left")
    cnt = hi - lo
    total = int(cnt.sum())
    if total == 0:
        return EMPTY.copy()
    ai = np.repeat(np.arange(len(a)), cnt)
    offsets = np.concatenate(([0], np.cumsum(cnt)[:-1]))
    bj = lo[ai] + np.arange(total) - np.repeat(offsets, cnt)
    s = np.maximum(a[ai, 0], b[bj, 0])
    e = np.minimum(a[ai, 1], b[bj, 1])
    keep = e > s
    if not keep.all():
        s, e = s[keep], e[keep]
    if len(s) == 0:
        return EMPTY.copy()
    return np.stack([s, e], axis=1)


def subtract(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Parts of ``a`` not covered by ``b`` (both flattened first).

    Used for "memory transfer records ... segments overlapping with
    kernel intervals are removed to avoid double counting".

    Computed as ``a ∩ complement(b)`` over a hull containing ``a``, with
    the vectorized intersection core (no Python-level loops).
    """
    a = flatten(a)
    if len(a) == 0:
        return a
    b = flatten(b)
    if len(b) == 0:
        return a
    # Complement of b within a hull strictly containing a: the gaps
    # between consecutive b intervals plus two sentinel flanks.
    hull_lo = min(a[0, 0], b[0, 0]) - 1.0
    hull_hi = max(a[-1, 1], b[-1, 1]) + 1.0
    comp = np.empty((len(b) + 1, 2), dtype=np.float64)
    comp[0, 0] = hull_lo
    comp[1:, 0] = b[:, 1]
    comp[:-1, 1] = b[:, 0]
    comp[-1, 1] = hull_hi
    comp = comp[comp[:, 1] > comp[:, 0]]
    if len(comp) == 0:
        return EMPTY.copy()
    return _intersect_flat(a, comp)


def intersect(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intervals covered by both ``a`` and ``b``."""
    a = flatten(a)
    b = flatten(b)
    if len(a) == 0 or len(b) == 0:
        return EMPTY.copy()
    return _intersect_flat(a, b)


def _subtract_loop(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Reference scalar implementation of :func:`subtract` (kept for the
    equivalence property tests and the vectorization benchmark)."""
    a = flatten(a)
    b = flatten(b)
    if len(a) == 0 or len(b) == 0:
        return a
    out = []
    j = 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j, 1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k, 0] < e:
            bs, be = b[k]
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            if cur >= e:
                break
            k += 1
        if cur < e:
            out.append((cur, e))
    return as_intervals(out) if out else EMPTY.copy()


def _intersect_loop(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Reference scalar implementation of :func:`intersect` (kept for the
    equivalence property tests and the vectorization benchmark)."""
    a = flatten(a)
    b = flatten(b)
    if len(a) == 0 or len(b) == 0:
        return EMPTY.copy()
    out = []
    i = j = 0
    while i < len(a) and j < len(b):
        s = max(a[i, 0], b[j, 0])
        e = min(a[i, 1], b[j, 1])
        if s < e:
            out.append((s, e))
        if a[i, 1] <= b[j, 1]:
            i += 1
        else:
            j += 1
    return as_intervals(out) if out else EMPTY.copy()


def union(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Flattened union of two interval sets."""
    a = as_intervals(a)
    b = as_intervals(b)
    if len(a) == 0:
        return flatten(b)
    if len(b) == 0:
        return flatten(a)
    return flatten(np.concatenate([a, b], axis=0))


def gaps(iv: np.ndarray, start: float, end: float) -> np.ndarray:
    """Uncovered sub-intervals of [start, end] — the paper's *inactive time*."""
    if end < start:
        raise ValueError("window end < start")
    window = as_intervals([(start, end)])
    return subtract(window, iv)


def clip(iv: np.ndarray, start: float, end: float) -> np.ndarray:
    """Restrict intervals to the window [start, end]."""
    return intersect(iv, as_intervals([(start, end)]))


def window_total(flat: np.ndarray, start: float, end: float) -> float:
    """Total overlap of an *already flattened* interval set with the
    window [start, end].

    The per-step capture path calls this once per region close against
    the full flattened history, so it must not touch intervals outside
    the window: two binary searches locate the overlapping run and only
    that slice is clipped — O(log n + k) instead of the O(n) revalidation
    a generic ``total(intersect(...))`` would pay."""
    if len(flat) == 0 or end <= start:
        return 0.0
    lo = int(np.searchsorted(flat[:, 1], start, side="right"))
    hi = int(np.searchsorted(flat[:, 0], end, side="left"))
    if hi <= lo:
        return 0.0
    s = np.maximum(flat[lo:hi, 0], start)
    e = np.minimum(flat[lo:hi, 1], end)
    return float(np.sum(e - s))
