"""A profiled segment of a run: ``torch.profiler`` with CUDA activity only,
around work the cell's traffic drives, with no TALP collection open
(CUPTI serves one client at a time). From its device events: the busy
time (the union of every operation's interval), the segment's wall, each
operation's total time by name, the longest idle gaps, each named by the
harness span the host was in at the gap's middle, and the program's
kernel launches in the segment (its own counters, read before and
after).

The profiler's clock is tied to the host's by a marker: the segment
starts on an idle card with a short sleep kernel launched right after a
read of ``perf_counter_ns``; its recorded start, less that read (a launch
latency of some microseconds included), is the offset between the two
clocks. The marker is not counted as work."""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import torch

__all__ = ["profiled", "launch_counts"]

MARKER_CYCLES = 1000


def launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import launch_counts as counts

    return dict(counts())


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def profiled(fn: Callable[[], object], device, spans) -> dict:
    """Run ``fn`` under the profiler and summarise its device events;
    ``spans`` (a ``harness.Spans``) records what the host does meanwhile.
    Raises if the card ran work the profiler did not see."""
    from torch.profiler import ProfilerActivity, profile

    before = launch_counts()
    spans.timeline = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        marked = time.perf_counter_ns()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    timeline, spans.timeline = spans.timeline, None
    after = launch_counts()
    cpu = torch.autograd.DeviceType.CPU
    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() != cpu and not e.is_user_annotation())
    if len(ops) < 2:
        raise RuntimeError("the profiled segment holds no device event: "
                           "torch.profiler saw none of the card's work")
    offset = ops[0][0] - marked          # profiler clock less the host's
    ops = [(name, s, e) for s, e, name in ops[1:]]
    busy = _union([(s, e) for _, s, e in ops])
    by_name: Dict[str, float] = {}
    for name, s, e in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
    gaps = []
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        # the innermost host span around the gap's middle
        middle = (end + nxt) // 2 - offset
        inner = [(e - s, name) for name, s, e in timeline
                 if s <= middle <= e]
        gaps.append([min(inner)[1] if inner else "other",
                     (nxt - end) * 1e-9])
    return {
        "wall_s": wall,
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "ops": sorted(by_name.items(), key=lambda x: -x[1]),
        "gaps": sorted(gaps, key=lambda x: -x[1])[:10],
        "launches": {k: after.get(k, 0) - before.get(k, 0) for k in after},
    }
