"""TALP reporting: post-mortem text (paper-style) + JSON, node-scan tables.

TALP's post-mortem output is "available both as plain text in a
human-readable format and as a JSON file, enabling automated processing".
We reproduce both, plus the paper's Tables 1–3 layout (metric hierarchy
vs node count) and — beyond the paper — a multi-run scalability join.

Every layout is *derived* from the declarative specs in
:mod:`repro.core.hierarchy`: the text tree drawing, the JSON key order
and the table rows all walk the hierarchy, so a metric registered with
``Hierarchy.with_child`` appears in every output format automatically.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .analysis import TraceAnalysis
from .hierarchy import DEVICE, HOST, Hierarchy, MetricFrame
from .talp import RegionResult, TalpResult

__all__ = [
    "render_text",
    "render_tables",
    "render_metrics",
    "to_json",
    "from_json",
    "node_scan_table",
]

Result = Union[RegionResult, TraceAnalysis]


def _pct(x: Optional[float]) -> str:
    return "   n/a" if x is None else f"{100.0 * x:5.1f}%"


def _as_frame(obj, hierarchy: Hierarchy) -> MetricFrame:
    """Metrics façade (or already-computed frame) → MetricFrame."""
    if isinstance(obj, MetricFrame):
        return obj
    return hierarchy.frame_of(obj)


def _labelled_rows(frame: MetricFrame) -> List[Tuple[str, float]]:
    """(tree-drawn label, value) rows in report order: the multiplicative
    tree first (``|-``/`` `-`` prefixes), then annotation/extension nodes
    flagged ``[ext]``."""
    h = frame.hierarchy
    rows: List[Tuple[str, float]] = []
    ext: List[Tuple[str, float]] = []

    def rec(spec, prefix: str) -> None:
        mult = [
            c for c in spec.children
            if c.multiplicative and c.key in frame.values
        ]
        for c in spec.children:
            if c.key not in frame.values:
                continue
            if not c.multiplicative:
                ext.append((f"[ext] {c.display}", frame.values[c.key]))
                continue
            last = c is mult[-1]
            rows.append(
                (f"{prefix}{'`- ' if last else '|- '}{c.display}",
                 frame.values[c.key])
            )
            rec(c, prefix + ("    " if last else "|   "))

    rows.append((h.root.display, frame.values[h.root.key]))
    rec(h.root, "")
    return rows + ext


def render_metrics(frame_or_metrics, hierarchy: Optional[Hierarchy] = None) -> str:
    """Render one hierarchy's metric block (the per-side lines of
    :func:`render_text`) from a frame or a metrics façade."""
    if isinstance(frame_or_metrics, MetricFrame):
        frame = frame_or_metrics
    else:
        if hierarchy is None:
            raise ValueError("need a hierarchy to render a plain metrics object")
        frame = hierarchy.frame_of(frame_or_metrics)
    return "\n".join(_metric_lines(frame))


def _metric_lines(frame: MetricFrame) -> List[str]:
    side = frame.hierarchy.side
    return [
        f"{side if i == 0 else '':8s}{label:27s}{_pct(value)}"
        for i, (label, value) in enumerate(_labelled_rows(frame))
    ]


def render_text(result: Result, title: Optional[str] = None) -> str:
    """Paper-figure-style text report for one region/trace."""
    name = getattr(result, "name", "Global")
    n_ranks = getattr(result, "n_ranks", None) or len(result.host_states) or 0
    n_devs = getattr(result, "n_devices", None) or len(result.device_states) or 0
    head = title or f'TALP report - region "{name}"'
    lines = [
        "=" * 64,
        f"{head}",
        f"elapsed {result.elapsed:.6f} s | {n_ranks} rank(s) | {n_devs} device(s)",
        "=" * 64,
    ]
    if result.host is not None:
        lines += _metric_lines(_as_frame(result.host, HOST))
    if result.device is not None:
        lines += _metric_lines(_as_frame(result.device, DEVICE))
    if result.host_states:
        lines.append("-" * 64)
        lines.append("host states (s):   rank    useful    offload        mpi")
        for r, st in sorted(result.host_states.items()):
            lines.append(
                f"                  {r:5d} {st['useful']:9.4f}  {st['offload']:9.4f}  {st['mpi']:9.4f}"
            )
    if result.device_states:
        lines.append("device states (s): dev     kernel     memory       idle")
        for d, st in sorted(result.device_states.items()):
            lines.append(
                f"                  {d:5d} {st['kernel']:9.4f}  {st['memory']:9.4f}  {st['idle']:9.4f}"
            )
    lines.append("=" * 64)
    return "\n".join(lines)


def render_tables(result: TalpResult) -> str:
    """Render every region of a TalpResult; a partial job report
    (``rank_coverage`` set by a tolerant merge) gets a trailing coverage
    block naming the missing/quarantined ranks."""
    parts = [render_text(r, title=f'{result.name} - region "{name}"')
             for name, r in sorted(result.regions.items())]
    cov = getattr(result, "rank_coverage", None)
    if cov is not None:
        parts.append(cov.render_text())
    return "\n\n".join(parts)


def _result_dict(result: Result) -> Dict:
    return {
        "name": getattr(result, "name", "Global"),
        "elapsed": result.elapsed,
        "host_metrics": result.host.as_dict() if result.host else None,
        "device_metrics": result.device.as_dict() if result.device else None,
        "host_states": {str(k): v for k, v in result.host_states.items()},
        "device_states": {str(k): v for k, v in result.device_states.items()},
    }


def to_json(result: Union[Result, TalpResult], indent: int = 2) -> str:
    """Machine-readable output (TALP's JSON path). A tolerant merge's
    ``rank_coverage`` annotation round-trips as a top-level node."""
    if isinstance(result, TalpResult):
        payload = {
            "talp": result.name,
            "regions": {n: _result_dict(r) for n, r in result.regions.items()},
        }
        cov = result.rank_coverage
        if cov is not None:
            payload["rank_coverage"] = (
                cov.as_dict() if hasattr(cov, "as_dict") else cov
            )
    else:
        payload = _result_dict(result)
    return json.dumps(payload, indent=indent)


def from_json(text: str) -> Dict:
    return json.loads(text)


def _table_rows(hierarchy: Hierarchy) -> List[Tuple[str, str]]:
    """Paper Tables 1–3 row labels, derived from the spec: depth-0 bare,
    depth-1 ``- `` bullet, deeper indented; annotation nodes excluded."""
    rows: List[Tuple[str, str]] = []

    def rec(spec, depth: int) -> None:
        if not spec.multiplicative:
            return
        indent = "" if depth == 0 else ("- " if depth == 1 else "    ")
        rows.append((indent + spec.display, spec.key))
        for c in spec.children:
            rec(c, depth + 1)

    rec(hierarchy.root, 0)
    return rows


def node_scan_table(
    results: Sequence[Result],
    labels: Sequence[str],
    title: str = "TALP Output",
    host_hierarchy: Hierarchy = HOST,
    device_hierarchy: Hierarchy = DEVICE,
) -> str:
    """Paper Tables 1–3 layout: metric hierarchy rows × run columns."""
    if len(results) != len(labels):
        raise ValueError("results/labels length mismatch")
    width = max(7, max(len(str(l)) for l in labels) + 2)
    header = f"{title}\n{'':8s}{'Metrics':28s}" + "".join(
        f"{str(l):>{width}s}" for l in labels
    )
    lines = [header]

    def row(side: str, label: str, values: List[Optional[float]]):
        cells = "".join(
            f"{'':>{width - 4}s} n/a" if v is None else f"{v:>{width}.2f}"
            for v in values
        )
        lines.append(f"{side:8s}{label:28s}{cells}")

    def value_of(obj, key: str) -> Optional[float]:
        if obj is None:
            return None
        if isinstance(obj, MetricFrame):
            return obj.get(key)
        return getattr(obj, key, None)

    for i, (label, key) in enumerate(_table_rows(host_hierarchy)):
        row(host_hierarchy.side if i == 0 else "", label,
            [value_of(r.host, key) for r in results])
    for i, (label, key) in enumerate(_table_rows(device_hierarchy)):
        row(device_hierarchy.side if i == 0 else "", label,
            [value_of(r.device, key) for r in results])
    return "\n".join(lines)
