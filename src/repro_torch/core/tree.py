"""Multiplicative metric trees (paper Figs. 1–3).

POP metrics are organized hierarchically where each parent is the
product of its children. ``MetricNode`` captures that structure
generically; the trees themselves are *derived* from the declarative
specs in :mod:`repro.core.hierarchy` (``tree_from_frame``), so the shape
lives in exactly one place. ``validate`` enforces the multiplicative
invariant (a property test target).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, Iterator, List, Optional

from .hierarchy import DEVICE, HOST, MetricFrame, MetricSpec

if TYPE_CHECKING:  # façade types, for signatures only
    from .device_metrics import DeviceMetrics
    from .host_metrics import HostMetrics

__all__ = ["MetricNode", "tree_from_frame", "host_tree", "device_tree"]


@dataclass
class MetricNode:
    name: str
    value: float
    children: List["MetricNode"] = field(default_factory=list)
    # Leaf metrics that are *not* multiplicative children (annotations):
    multiplicative: bool = True

    def validate(self, tol: float = 1e-6) -> None:
        mult_children = [c for c in self.children if c.multiplicative]
        if mult_children:
            prod = 1.0
            for c in mult_children:
                prod *= c.value
            if abs(prod - self.value) > tol:
                raise AssertionError(
                    f"{self.name}: value {self.value:.6f} != product of "
                    f"children {prod:.6f}"
                )
        for c in self.children:
            c.validate(tol)

    def walk(self) -> Iterator["MetricNode"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str) -> Optional["MetricNode"]:
        for node in self.walk():
            if node.name == name:
                return node
        return None

    def as_dict(self) -> Dict:
        return {
            "name": self.name,
            "value": self.value,
            "children": [c.as_dict() for c in self.children],
        }

    @staticmethod
    def from_dict(d: Dict) -> "MetricNode":
        return MetricNode(
            name=d["name"],
            value=d["value"],
            children=[MetricNode.from_dict(c) for c in d.get("children", [])],
        )


def tree_from_frame(frame: MetricFrame) -> MetricNode:
    """Derive the MetricNode tree from a computed hierarchy frame.

    Non-multiplicative (annotation/extension) nodes are suffixed
    ``(ext)`` and excluded from the product invariant; optional nodes
    absent from the frame are skipped entirely.
    """

    def build(spec: MetricSpec) -> Optional[MetricNode]:
        if spec.key not in frame.values:
            return None
        name = spec.display if spec.multiplicative else f"{spec.display} (ext)"
        node = MetricNode(
            name, frame.values[spec.key], multiplicative=spec.multiplicative
        )
        for c in spec.children:
            child = build(c)
            if child is not None:
                node.children.append(child)
        return node

    root = build(frame.hierarchy.root)
    if root is None:
        raise ValueError(
            f"frame for hierarchy {frame.hierarchy.name!r} has no root value"
        )
    return root


def host_tree(hm: "HostMetrics") -> MetricNode:
    """Paper Fig. 2 (host resources); new metrics are the orange boxes."""
    return tree_from_frame(HOST.frame_of(hm))


def device_tree(dm: "DeviceMetrics") -> MetricNode:
    """Paper Fig. 3 (device resources), Parallel Efficiency branch."""
    return tree_from_frame(DEVICE.frame_of(dm))
