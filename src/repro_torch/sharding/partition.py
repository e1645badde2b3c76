"""Logical-axis partitioning rules: a spec for every parameter, train-state,
batch and cache leaf, and its DTensor placements. Port of
``repro.sharding.partition``, rule for rule.

Strategy (as in the JAX package):

* mesh axes ``("pod", "data", "model")`` (multi-pod) or ``("data",
  "model")`` (one pod); ``pod`` and ``data`` form one FSDP/DP super-axis
  (batch sharding and ZeRO-3 parameter/optimizer sharding), ``model``
  carries tensor/expert parallelism;
* every rule checks divisibility against the mesh and falls back (shard
  another dim, or replicate), which lets one rule set serve every
  architecture (gemma2's 4 KV heads cannot split 16 ways, so its decode
  caches shard over the sequence instead; the hot decode ring never
  shards its sequence);
* stacked parameters (``slots/slot<i>``) carry a leading repeat dim that
  is never sharded.

A spec is a tuple with one entry per tensor dim: ``None`` (replicated),
an axis name, or a tuple of axis names (the dim split over all of them,
the first the major one), as a JAX ``PartitionSpec`` holds them.

Deliberate differences from the JAX namesake:

* Paths are tuples of the nested dicts' keys (the port's trees), where
  JAX gives ``DictKey`` paths; the names read are the same.
* ``make_sharding_tree`` and ``state_shardings`` return trees of specs;
  the JAX ones wrap each spec in a ``NamedSharding``. The mesh comes with
  the call that places a tree: :func:`placements` turns a spec into one
  DTensor placement per mesh dim and :func:`distribute_tree` places a
  tree. A mesh is a named ``DeviceMesh`` or an :class:`AbstractMesh`
  (axis names and sizes only, no process group: the plan reads nothing
  else, so the plan for a production mesh is computed and tested without
  its ranks).
* :func:`distribute_tree` leaves a 0-d integer leaf (a train state's
  step counts, whose spec is ``()``) where it is: the port's schedule
  reads them on the host, where JAX replicates them on the mesh.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Sequence, Tuple

__all__ = [
    "AbstractMesh",
    "axis_sizes",
    "fsdp_axes",
    "param_pspec",
    "state_shardings",
    "batch_pspec",
    "cache_pspec",
    "check_partitioned",
    "make_sharding_tree",
    "placements",
    "distribute_tree",
]

Spec = Tuple[Any, ...]


class AbstractMesh:
    """A mesh's axis names and sizes, with no devices."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return "AbstractMesh({})".format(
            "x".join(f"{n}{a}" for a, n in self.shape.items()))


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} in the mesh's axis order, for an
    :class:`AbstractMesh` or a named ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the partition rules need a mesh with named axes "
                         "(mesh_dim_names)")
    return {name: mesh.size(i) for i, name in enumerate(names)}


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _fits(dim: int, mesh, axes) -> bool:
    return dim % _axis_size(mesh, axes) == 0


def _maybe(dim: int, mesh, axes):
    """axes if divisible else None (replicate)."""
    return axes if _fits(dim, mesh, axes) else None


def _names(path) -> list:
    return [str(p) for p in path]


def param_pspec(path: Tuple[str, ...], leaf, mesh, cfg) -> Spec:
    """Partition spec for one parameter, keyed by its tree path."""
    fsdp = fsdp_axes(mesh)
    names = _names(path)
    name = names[-1]
    stacked = "slots" in names  # leading repeat dim
    shape = tuple(leaf.shape[1:]) if stacked else tuple(leaf.shape)

    def out(*spec):
        spec = tuple(
            _maybe(shape[i], mesh, ax) if ax is not None else None
            for i, ax in enumerate(spec)
        )
        return ((None,) + spec) if stacked else spec

    if name == "embed":
        return out(fsdp, "model")
    if name == "unembed":
        return out(fsdp, "model")
    if name in ("wq", "wk", "wv", "wz", "wx", "wb", "wc", "wdt",
                "w_gate", "w_up", "router"):
        if len(shape) == 3:  # MoE expert-stacked (E, M, F)
            if _fits(shape[0], mesh, ("model",)):
                return out("model", fsdp, None)   # expert parallel
            return out(None, fsdp, "model")       # TP inside each expert
        return out(fsdp, "model")
    if name in ("wo", "w_down"):
        if len(shape) == 3:  # MoE (E, F, M)
            if _fits(shape[0], mesh, ("model",)):
                return out("model", None, fsdp)
            return out(None, "model", fsdp)
        return out("model", fsdp)
    if name.startswith("conv_"):
        return out(None, "model")
    if name == "norm":  # ssm gated-norm scale over d_inner
        return out("model")
    # 1-D scales / biases (ln*, final_norm, a_log, dt_bias, d_skip)
    return (None,) * leaf.ndim


def _map_with_path(fn: Callable, tree, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def check_partitioned(cfg) -> None:
    """Raise ``NotImplementedError`` for a block kind the plan has no rule
    for: ``zamba_hybrid`` (its shared blocks, stacked over blocks and not
    over repeats, and its caches of two kinds of state are not placed)."""
    if "zamba_hybrid" in cfg.pattern:
        raise NotImplementedError(
            f"{cfg.name}: the partition plan has no rule for the "
            "zamba_hybrid kind; it runs unsharded on one card")


def make_sharding_tree(tree, mesh, cfg, spec_fn):
    """The spec of every leaf of ``tree`` (tensors, meta tensors included)
    by ``spec_fn(path, leaf, mesh, cfg)``; a config the plan does not
    cover raises (:func:`check_partitioned`)."""
    check_partitioned(cfg)
    return _map_with_path(lambda path, leaf: spec_fn(path, leaf, mesh, cfg),
                          tree)


def state_shardings(state_shapes, mesh, cfg):
    """Specs for a train state {params, opt{mu, nu, count}, step}: the
    optimizer moments take the parameter rule (ZeRO: sharded exactly like
    the FSDP parameters); scalars take ``()``."""

    def spec(path, leaf, mesh_, cfg_):
        names = _names(path)
        if names and names[0] in ("params", "mu", "nu"):
            return param_pspec(tuple(path[1:]), leaf, mesh_, cfg_)
        if names[:2] == ["opt", "mu"] or names[:2] == ["opt", "nu"]:
            return param_pspec(tuple(path[2:]), leaf, mesh_, cfg_)
        return ()  # scalars (step counters)

    return make_sharding_tree(state_shapes, mesh, cfg, spec)


def batch_pspec(mesh, batch_size: int, ndim: int) -> Spec:
    """Batch-leading activations: batch over the FSDP axes when divisible
    (a batch of 1 replicates)."""
    fsdp = fsdp_axes(mesh)
    lead = fsdp if batch_size % _axis_size(mesh, fsdp) == 0 else None
    return (lead,) + (None,) * (ndim - 1)


def cache_pspec(path: Tuple[str, ...], leaf, mesh, cfg) -> Spec:
    """Decode-cache specs (stacked leading repeat dim).

    kv caches (R, B, T, K, D): batch over FSDP when divisible; KV heads
    over ``model`` when divisible, else sequence over ``model`` (and for a
    batch the FSDP axes do not divide, sequence also takes them)."""
    fsdp = fsdp_axes(mesh)
    name = _names(path)[-1]
    shape = tuple(leaf.shape)
    if name in ("hk", "hv"):
        # hot decode ring: written every step, so batch-local only; heads
        # over model when divisible, never the (short) sequence dim
        _, b, _, k, _ = shape
        b_ax = fsdp if _fits(b, mesh, fsdp) else None
        return (None, b_ax, None, _maybe(k, mesh, ("model",)), None)
    if name == "h_pos":
        _, b, _ = shape
        b_ax = fsdp if _fits(b, mesh, fsdp) else None
        return (None, b_ax, None)
    if name in ("k", "v"):
        _, b, t, k, d = shape
        b_ax = fsdp if _fits(b, mesh, fsdp) else None
        if _fits(k, mesh, ("model",)):
            t_ax = None if b_ax is not None else _maybe(t, mesh, fsdp)
            return (None, b_ax, t_ax, "model", None)
        # sequence sharding fallback
        t_axes = ("model",) if b_ax is not None else tuple(fsdp) + ("model",)
        return (None, b_ax, _maybe(t, mesh, t_axes), None, None)
    if name == "kv_pos":
        _, b, t = shape
        b_ax = fsdp if _fits(b, mesh, fsdp) else None
        kv = cfg.num_kv_heads
        if _fits(kv, mesh, ("model",)):
            t_ax = None if b_ax is not None else _maybe(t, mesh, fsdp)
            return (None, b_ax, t_ax)
        t_axes = ("model",) if b_ax is not None else tuple(fsdp) + ("model",)
        return (None, b_ax, _maybe(t, mesh, t_axes))
    if name == "state":  # (R, B, H, P, N)
        _, b, h, _, _ = shape
        b_ax = fsdp if _fits(b, mesh, fsdp) else None
        return (None, b_ax, _maybe(h, mesh, ("model",)), None, None)
    if name.startswith("conv_"):  # (R, B, K-1, C)
        _, b, _, c = shape
        b_ax = fsdp if _fits(b, mesh, fsdp) else None
        return (None, b_ax, None, _maybe(c, mesh, ("model",)))
    return (None,) * leaf.ndim


def placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placement on each mesh dim of a tensor with ``spec``:
    ``Shard(d)`` on every axis that dim ``d``'s entry names (a dim over
    ``("pod", "data")`` is ``Shard(d)`` on both, pod the major one), else
    ``Replicate()``. Raises ``ValueError`` for an axis the mesh lacks, an
    axis named twice, or a tuple whose order is not the mesh's (DTensor
    shards a dim over several mesh dims in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(axis_sizes(mesh))
    by_axis = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [order.index(a) if a in order else -1 for a in axes]
        if -1 in idx:
            raise ValueError(f"spec {tuple(spec)} names an axis the mesh "
                             f"{order} lacks")
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(spec)}: dim {d} splits over "
                             f"{axes}, not in the mesh's order {order}")
        for a in axes:
            if a in by_axis:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r} twice")
            by_axis[a] = d
    return tuple(Shard(by_axis[a]) if a in by_axis else Replicate()
                 for a in order)


def distribute_tree(tree, mesh, specs):
    """``tree`` with every leaf placed on ``mesh`` by its spec in ``specs``
    (a matching tree), each rank keeping its own slice of its own values
    (``torch.distributed.tensor.distribute_tensor`` with no source rank:
    every rank calls it with the same values, so nothing is broadcast). A
    0-d integer leaf stays as it is."""
    from torch.distributed.tensor import distribute_tensor

    def place(path, leaf):
        spec = specs
        for key in path:
            spec = spec[key]
        if leaf.dim() == 0 and not leaf.is_floating_point():
            return leaf
        if len(spec) != leaf.dim():
            raise ValueError(f"{'/'.join(path)}: spec {spec} for a "
                             f"{leaf.dim()}-d tensor")
        local = leaf.to(mesh.device_type)
        return distribute_tensor(local, mesh, placements(spec, mesh),
                                 src_data_rank=None)

    return _map_with_path(place, tree)
