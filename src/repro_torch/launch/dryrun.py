"""Dry run: every (architecture × input shape) cell's step, run on fake
tensors over the production meshes, counted per device, with its roofline
terms and the TALP device metrics they predict. Port of
``repro.launch.dryrun``.

Per cell this:
  1. starts a fake process group of the mesh's ranks (256 for 16×16, 512
     for 2×16×16) in this one process, which is rank 0, and builds the
     production mesh over it (``launch.mesh.make_production_mesh``);
  2. makes the state (training) or bf16 parameters (serving), the inputs
     and the decode caches as fake tensors (shapes and dtypes, no memory)
     from ``train_state_shapes``/``serve_params_shapes``/``input_specs``,
     and places them by ``state_shardings``/``param_pspec``/
     ``batch_pspec``/``cache_pspec``;
  3. runs the step once under the activation and MoE weight layouts the
     JAX dry run pins (``_act_spec``, ``_moe_specs``), counting rank 0's
     local ops: FLOPs, HBM bytes, collective bytes by kind and the memory
     the step holds (:class:`FakeCounter`);
  4. counts R = 1 and R = 2 stacks and extrapolates to the config's depth
     (``--no-calibrate`` keeps the full stack's count);
  5. emits the roofline report and the TALP analytical device metrics (the
     paper's Device PE tree, *predicted* for this mesh) as JSON, with the
     keys of the JAX ``run_cell``.

Nothing is allocated, and no card is needed for the ranks: the group is
``torch.distributed``'s fake backend, torn down when ``run_cell``
returns. A process that has a real group raises.

Deliberate differences from the JAX namesake:

* Nothing is lowered or compiled: the step runs eagerly on fake tensors.
  ``lower_s`` holds the seconds of making and placing the fakes,
  ``compile_s`` those of the counted step.
* FLOPs: each local op's by torch's own formulas
  (``torch.utils.flop_counter``; matmuls, convolutions, attention), and
  each hand-written kernel's by its ``work`` module: a fake tensor takes
  the kernel's place (``repro_torch.kernels.fake``).
* HBM bytes: each local op's operand and result bytes, a view or
  metadata op (its results alias its operands) and an allocation at 0,
  and each kernel's ``work`` bytes. This is the eager program's unfused
  traffic, each op reading and writing HBM; XLA counts after fusion.
* Collective bytes: each collective's result bytes, by the JAX kind, from
  both of torch's namespaces (``_c10d_functional.*``, DTensor's
  redistributions; ``c10d.*_``, eager ``torch.distributed`` calls such as
  AdamW's global norm); ``wait_tensor`` is not counted.
* Only rank 0's local ops count. DTensor's sharding propagation runs the
  global op on global-shaped fakes to learn the output's shape; that run
  is never counted.
* The device type is the card's, ``"cuda"``, by default (it needs torch
  with CUDA). ``device="cpu"`` counts a CPU mesh, another program:
  DTensor replaces an all-to-all by an all-gather and a chunk there. The
  report's ``mesh`` names the device counted (``16datax16model@cuda``).
* Eager runs every layer, so the full stack's count is exact where the
  JAX cost analysis counts a scan body once; the calibrated count (R = 1
  and R = 2 extrapolated) agrees with it, and ``raw_scan_cost`` holds the
  full stack's, the counterpart of the JAX production compile.
* Memory per device: arguments are the local shards of the state or
  parameters, inputs and caches; temp is the step's own peak of live
  tensors it made; output the new tensors it returns; peak is arguments
  plus temp. AdamW updates the state in place, as on the card.
* The train state's step counts are host scalars: their fakes carry
  their values (fake-tensor constants), so AdamW's schedule, which reads
  them on the host (``optim.adamw``), computes what the card's step does.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen3-moe-235b-a22b \
      --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod] \
      [--out experiments/dryrun] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import os
import sys
import time
import traceback
import weakref
from contextlib import contextmanager
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import SHAPES, ShapeConfig, get_config, list_configs
from ..core.analysis import analyze_trace
from ..core.backends.analytical import StepModel, trace_from_step_model
from ..roofline.analysis import CollectiveStats, build_report, collective_kind
from ..sharding.act_sharding import activation_sharding, moe_weight_sharding
from ..sharding.partition import (
    axis_sizes,
    batch_pspec,
    cache_pspec,
    check_partitioned,
    distribute_tree,
    fsdp_axes,
    make_sharding_tree,
    param_pspec,
    state_shardings,
)
from .mesh import (describe_mesh, make_mesh, make_production_mesh,
                   production_shape)
from .serve import resolve_device
from .steps import (
    input_specs,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    model_flops,
    serve_params_shapes,
    train_state_shapes,
)

__all__ = ["Counts", "FakeCounter", "MemoryAnalysis", "count_step",
           "fake_world", "run_cell", "main"]

_aten = torch.ops.aten
# allocations: no traffic (the memory account still takes them)
_ALLOCATIONS = {_aten.empty.memory_format, _aten.empty_strided.default,
                _aten.empty_like.default, _aten.new_empty.default,
                _aten.new_empty_strided.default}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")


@dataclasses.dataclass(frozen=True)
class MemoryAnalysis:
    """Per-device bytes of one counted step, under the attribute names of
    XLA's ``CompiledMemoryStats`` that ``build_report`` reads."""

    argument_size_in_bytes: int
    temp_size_in_bytes: int
    output_size_in_bytes: int

    @property
    def peak_memory_in_bytes(self) -> int:
        return self.argument_size_in_bytes + self.temp_size_in_bytes


@dataclasses.dataclass(frozen=True)
class Counts:
    """Rank 0's counts of one step: FLOPs, HBM bytes, collective bytes and
    ops by kind, memory."""

    flops: float
    hbm_bytes: float
    collective_bytes: Dict[str, int]
    collective_count: Dict[str, int]
    memory: MemoryAnalysis


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class FakeCounter(FakeTensorMode):
    """A fake-tensor mode that counts the ops run on its fakes between
    :meth:`start` and :meth:`stop`: FLOPs, HBM bytes and collectives (see
    the module docstring), each kernel's work (``record_kernel``, called
    by a kernel wrapper given a fake), and the bytes of the live tensors
    made meanwhile, with their peak. DTensor ops reach it as the local ops
    they run on this rank's shards."""

    def __init__(self):
        super().__init__()
        self._depth = 0         # dispatches of this mode under way
        self._generation = 0
        self.start()
        self.stop()

    def start(self) -> None:
        """Zero every count and start counting."""
        self._generation += 1
        self._live: Dict[int, int] = {}   # id(storage) -> bytes
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collectives = CollectiveStats()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.counting = True

    def stop(self) -> None:
        self.counting = False

    def made_here(self, t: torch.Tensor) -> bool:
        """Whether ``t``'s storage was made since :meth:`start` and lives."""
        return id(t.untyped_storage()) in self._live

    def record_kernel(self, name: str, flops: float, nbytes: int) -> None:
        if self.counting:
            self.flops += flops
            self.hbm_bytes += nbytes

    @contextmanager
    def dtensor_bookkeeping(self):
        """Run DTensor's own computations outside this mode, where they are
        not the step's work and need no fakes of it: sharding propagation
        (its run of each op on global-shaped fakes, in a fake mode of its
        own, to learn the output's shape) and a strided shard's offsets
        (computed on a host index tensor, whose values a fake lacks)."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor import DTensor, placement_types

        def outside(fn):
            @functools.wraps(fn)
            def run(*args, **kwargs):
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            return run

        prop = DTensor._op_dispatcher.sharding_propagator
        targets = [(prop, "propagate_op_sharding"),
                   (prop, "propagate_op_sharding_non_cached")]
        strided = getattr(placement_types, "_StridedShard", None)
        if strided is not None:
            targets.append((strided, "local_shard_size_and_offset"))
        # (object, attribute, what the object's own dict held, or None)
        saved = [(obj, name, vars(obj).get(name)) for obj, name in targets
                 if hasattr(obj, name)]
        for obj, name, _ in saved:
            setattr(obj, name, outside(getattr(obj, name)))
        try:
            yield
        finally:
            for obj, name, own in saved:
                if own is None:
                    delattr(obj, name)
                else:
                    setattr(obj, name, own)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _aten.equal.default:
            # DTensor's masked (vocab-parallel) embedding asks whether the
            # masks of two mesh dims agree, values a fake lacks; they
            # agree on the card, or the step would raise there
            return True
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        # an op the mode runs inside another (a decomposition, re-entering
        # the mode) is part of that op, whose count it already is
        if self.counting and not self._depth and out is not NotImplemented:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        in_storages = {id(t.untyped_storage()) for t in ins}
        new = {}
        for t in outs:
            st = t.untyped_storage()
            if id(st) not in in_storages and id(st) not in self._live:
                new[id(st)] = st
        for key, st in new.items():
            nbytes = st.nbytes()
            self._live[key] = nbytes
            self.live_bytes += nbytes
            weakref.finalize(st, self._free, self._generation, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

        packet = func._overloadpacket
        op = str(packet)
        if op.split(".")[0] in _COLLECTIVE_NAMESPACES:
            kind = collective_kind(op)
            if kind is not None:
                self.collectives.add(kind, sum(_nbytes(t) for t in outs))
            return
        formula = flop_registry.get(packet)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if func in _ALLOCATIONS:
            return
        if func._schema.is_mutable or new:   # else a view or metadata op
            self.hbm_bytes += (sum(_nbytes(t) for t in ins)
                               + sum(_nbytes(t) for t in outs))

    def _free(self, generation: int, key: int) -> None:
        if generation == self._generation and key in self._live:
            self.live_bytes -= self._live.pop(key)


@contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks in this process (rank
    0), destroyed on exit. Raises ``RuntimeError`` where a group exists: a
    fake group must not meet a real one."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts a fake process group and "
                           "needs a process without one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# layouts pinned for the step (as repro.launch.dryrun)
# ---------------------------------------------------------------------------
def _axsize(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes) if axes else 1


def _act_spec(cfg, shape, mesh):
    """Layer-boundary activation sharding: batch over FSDP, sequence over
    the model axis (SP) when divisible. Decode steps (S=1) skip it."""
    if shape.kind == "decode":
        return None
    if shape.seq_len % axis_sizes(mesh)["model"] != 0:
        return None
    fsdp = fsdp_axes(mesh)
    b_ax = fsdp if shape.global_batch % _axsize(mesh, fsdp) == 0 else None
    return (b_ax, "model", None)


def _moe_specs(cfg, mesh):
    """Compute-time MoE weight layout: expert-parallel over ``model`` when
    E divides it, else TP over d_ff; the FSDP d_model dim is always
    gathered."""
    if not cfg.is_moe:
        return (None, None)
    model = axis_sizes(mesh)["model"]
    if cfg.moe_experts_physical % model == 0:
        return (("model", None, None), ("model", None, None))
    if cfg.moe_d_ff % model == 0:
        return ((None, None, "model"), (None, "model", None))
    return ((), ())


# ---------------------------------------------------------------------------
# one counted step
# ---------------------------------------------------------------------------
def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(fn, v) for v in tree)
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class _Scalar:
    """A host scalar of the step's arguments (a train state's step count),
    read before the fake mode starts."""

    value: Any
    dtype: torch.dtype


def _abstract_args(cfg, shape) -> Tuple[Any, ...]:
    """The step's arguments as meta tensors, each host scalar a
    :class:`_Scalar`; built before the counter's mode is entered."""
    inputs = input_specs(cfg, shape)
    if shape.kind == "train":
        first = train_state_shapes(cfg)
    else:
        first = serve_params_shapes(cfg)
    return _map(lambda x: x if x.is_meta else _Scalar(x.item(), x.dtype),
                (first,) + inputs)


def _fake(x, device: str):
    """A fake of ``x`` inside the counter's mode: a meta tensor's on
    ``device``; a host scalar's a constant on the host, whose value a host
    read sees (AdamW's schedule reads its step count)."""
    if isinstance(x, _Scalar):
        return torch.tensor(x.value, dtype=x.dtype)
    return torch.empty(tuple(x.shape), dtype=x.dtype, device=device)


def _placed_args(cfg, shape, mesh, device, abstract):
    """(the step, its arguments as fakes placed on ``mesh`` by the
    partition plan); call inside the counter's mode."""
    fakes = _map(lambda x: _fake(x, device), abstract)

    def batched(tree):
        return distribute_tree(tree, mesh, _map(
            lambda t: batch_pspec(mesh, t.shape[0], t.ndim), tree))

    first, inputs = fakes[0], fakes[1:]
    if shape.kind == "train":
        state = distribute_tree(first, mesh, state_shardings(first, mesh, cfg))
        return make_train_step(cfg), (state, batched(inputs[0]))
    params = distribute_tree(first, mesh, make_sharding_tree(
        first, mesh, cfg, param_pspec))
    if shape.kind == "prefill":
        return make_prefill_step(cfg), (params, batched(inputs[0]))
    token, pos, caches = inputs
    caches = distribute_tree(caches, mesh, make_sharding_tree(
        caches, mesh, cfg, cache_pspec))
    return make_serve_step(cfg), (params, batched(token), batched(pos),
                                  caches)


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def count_step(cfg, shape: ShapeConfig, mesh, device: str
               ) -> Tuple[Counts, float, float]:
    """Rank 0's counts of one step of ``cfg`` at ``shape`` on ``mesh``
    (built over the fake group), and the seconds spent placing the fakes
    and running the counted step."""
    t0 = time.perf_counter()
    abstract = _abstract_args(cfg, shape)
    counter = FakeCounter()
    with counter, counter.dtensor_bookkeeping():
        step, args = _placed_args(cfg, shape, mesh, device, abstract)
        arg_bytes = sum(_nbytes(_local(t)) for t in tree_leaves(args)
                        if isinstance(t, torch.Tensor)
                        and t.device.type == device)
        t_place = time.perf_counter() - t0
        gate_up, down = _moe_specs(cfg, mesh)
        with activation_sharding(_act_spec(cfg, shape, mesh)), \
                moe_weight_sharding(gate_up, down), \
                torch.set_grad_enabled(shape.kind == "train"):
            counter.start()
            out = step(*args)
            counter.stop()
        local_out = {id(_local(t).untyped_storage()): _local(t)
                     for t in tree_leaves(out) if isinstance(t, torch.Tensor)}
        out_bytes = sum(t.untyped_storage().nbytes()
                        for t in local_out.values() if counter.made_here(t))
        t_count = time.perf_counter() - t0 - t_place
        counts = Counts(
            flops=counter.flops,
            hbm_bytes=counter.hbm_bytes,
            collective_bytes=dict(counter.collectives.bytes_by_kind),
            collective_count=dict(counter.collectives.count_by_kind),
            memory=MemoryAnalysis(arg_bytes, counter.peak_bytes, out_bytes),
        )
        del step, args, out, local_out
    gc.collect()
    return counts, t_place, t_count


def _calibrated(cfg, shape, mesh, device) -> Counts:
    """Counts of R = 1 and R = 2 stacks extrapolated linearly in depth, as
    the JAX dry run calibrates its cost analysis:
        total(R) = m1 + (R - 1) · (m2 - m1).
    Eager counts every layer, so this equals the full stack's count; it is
    kept so that both packages report the same quantity."""
    period = len(cfg.pattern)
    r = cfg.repeats
    c1 = count_step(dataclasses.replace(cfg, num_layers=period,
                                        scan_layers=False),
                    shape, mesh, device)[0]
    if r == 1:
        return c1
    c2 = count_step(dataclasses.replace(cfg, num_layers=2 * period,
                                        scan_layers=False),
                    shape, mesh, device)[0]

    def extrap(m1, m2):
        return m1 + (r - 1) * max(0.0, m2 - m1)

    kinds = set(c1.collective_bytes) | set(c2.collective_bytes)
    coll = {k: int(extrap(c1.collective_bytes.get(k, 0),
                          c2.collective_bytes.get(k, 0))) for k in kinds}
    cnt = {k: int(extrap(c1.collective_count.get(k, 0),
                         c2.collective_count.get(k, 0))) for k in kinds}
    return Counts(extrap(c1.flops, c2.flops),
                  extrap(c1.hbm_bytes, c2.hbm_bytes), coll, cnt, c1.memory)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------
MeshSpec = Tuple[Sequence[int], Sequence[str]]


def run_cell(arch: str, shape_name: Union[str, ShapeConfig],
             multi_pod: bool = False, out_dir: Optional[str] = None,
             verbose: bool = True, arch_overrides: Optional[dict] = None,
             calibrate: bool = True, device: str = "cuda",
             mesh: Optional[MeshSpec] = None) -> Dict[str, Any]:
    """One cell: ``arch`` at ``shape_name`` (a name of ``SHAPES``, or a
    ``ShapeConfig``) on the production mesh (``multi_pod``: 2×16×16), or
    on ``mesh`` = (shape, axis names) where given. Returns the JAX
    ``run_cell``'s dict and writes it under ``out_dir``."""
    cfg = get_config(arch)
    if arch_overrides:
        cfg = dataclasses.replace(cfg, **arch_overrides)
    check_partitioned(cfg)   # before any fake world is built
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if shape.name == "long_500k" and not cfg.long_context_ok:
        return {
            "arch": arch, "shape": shape.name,
            "status": "skipped",
            "reason": "pure full attention at every layer (DESIGN.md "
                      "long_500k skip policy)",
        }
    device = resolve_device(device).type
    mesh_shape, axes = mesh if mesh is not None else production_shape(
        multi_pod)
    chips = math.prod(mesh_shape)
    with fake_world(chips):
        dmesh = (make_production_mesh(multi_pod=multi_pod, device_type=device)
                 if mesh is None else make_mesh(mesh_shape, axes, device))
        mesh_desc = f"{describe_mesh(dmesh)}@{device}"

        # 1) the full stack: counts, memory (the JAX production compile)
        raw, t_place, t_count = count_step(cfg, shape, dmesh, device)
        # 2) the depth-calibrated terms
        counts = _calibrated(cfg, shape, dmesh, device) if calibrate else raw

    stats = CollectiveStats(dict(counts.collective_bytes),
                            dict(counts.collective_count))
    report = build_report(
        arch=arch, shape=shape.name, mesh_desc=mesh_desc, chips=chips,
        cost={"flops": counts.flops, "bytes accessed": counts.hbm_bytes},
        collectives=stats,
        model_flops_global=model_flops(cfg, shape),
        memory_analysis=raw.memory,
    )

    # TALP analytical device metrics (paper eqs. 9–12 predicted for this
    # mesh) + the beyond-paper Computational Efficiency branch.
    sm = StepModel(
        flops=report.flops,
        hbm_bytes=report.hbm_bytes,
        collective_bytes=report.collective_bytes,
        model_flops=report.model_flops,
    )
    talp = analyze_trace(
        trace_from_step_model([sm], steps=1),
        computational_efficiency=sm.computational_efficiency,
    )

    result = {
        "status": "ok",
        "lower_s": round(t_place, 2),
        "compile_s": round(t_count, 2),
        **report.to_dict(),
        "raw_scan_cost": {   # the full stack's count
            "flops": raw.flops,
            "hbm_bytes": raw.hbm_bytes,
            "collective_bytes": raw.collective_bytes,
        },
        "memory_analysis": {
            "peak_memory": report.peak_memory,
            "argument_size": report.argument_size,
            "output_size": report.output_size,
            "temp_size": report.temp_size,
        },
        "talp_device": talp.device.as_dict() if talp.device else None,
    }

    if verbose:
        print(f"=== {arch} × {shape.name} × {mesh_desc} ===")
        print(f"memory_analysis: {raw.memory}")
        print(f"calibrated: flops={counts.flops:.3e} "
              f"hbm_bytes={counts.hbm_bytes:.3e}")
        print(
            f"roofline: compute={report.compute_s*1e3:.3f}ms "
            f"memory={report.memory_s*1e3:.3f}ms "
            f"collective={report.collective_s*1e3:.3f}ms "
            f"dominant={report.dominant} "
            f"fraction={report.roofline_fraction:.3f} "
            f"useful_ratio={report.useful_flop_ratio:.3f}"
        )
        print(f"collectives: {report.collective_detail}")
        sys.stdout.flush()

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}__{shape.name}__{mesh_desc}".replace("/", "_")
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(result, f, indent=2)
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_configs())
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch × shape) cell on this mesh")
    ap.add_argument("--no-calibrate", action="store_true",
                    help="skip the R=1/R=2 depth-calibration counts")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the mesh's device type: cuda counts the card's "
                    "program; cpu a CPU mesh's (all-to-all as all-gather)")
    args = ap.parse_args()

    cells = []
    if args.all:
        for arch in list_configs():
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        try:
            res = run_cell(arch, shape, multi_pod=args.multi_pod,
                           out_dir=args.out,
                           calibrate=not args.no_calibrate,
                           device=args.device)
            if res["status"] == "skipped":
                print(f"--- {arch} × {shape}: SKIPPED ({res['reason']})")
        except NotImplementedError as err:
            print(f"--- {arch} × {shape}: REFUSED ({err})")
        except Exception:
            failures += 1
            print(f"!!! {arch} × {shape}: FAILED")
            traceback.print_exc()
        sys.stdout.flush()
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
