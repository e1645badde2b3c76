"""Shared arithmetic of the ``*_roofline.*`` readers: a kernel family's
share of its roofline over a profiled segment, the sum of each launch's
bound (the larger of its operations at the bf16 peak and its bytes at the
HBM peak, by the frozen work formulas) over the sum of the device time
of the operations whose names mark the family. Launches come from the
program's own counters, read around the segment; time from the trace."""

from __future__ import annotations

import re
from typing import Iterable, Optional, Tuple

from perfbench.work.peaks import BF16_FLOPS, HBM_BYTES


def bound_s(work: Tuple[float, int]) -> float:
    flops, nbytes = work
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)


def share(segment: Optional[dict], pattern: str,
          launches: Iterable[Tuple[str, Tuple[float, int]]]
          ) -> Optional[float]:
    """Percent of the roofline over ``segment`` (a profile summary): each
    (counter name, work of one launch) of ``launches`` counts the
    counter's launches in the segment at that work."""
    if not segment:
        return None
    busy = sum(sec for name, sec in segment["ops"]
               if re.search(pattern, name))
    bound = sum(segment["launches"].get(counter, 0) * bound_s(work)
                for counter, work in launches)
    if busy <= 0 or bound <= 0:
        return None
    return 100.0 * bound / busy
