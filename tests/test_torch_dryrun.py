"""The port's dry run (repro_torch.launch.dryrun) and what it stands on,
against the JAX package where the JAX package has the same thing: the
abstract inputs and model FLOPs of every cell, the roofline report, the
qwen3-moe-235b-a22b config, ``consolidate_caches``; and, with no JAX
counterpart (XLA's cost analysis counts a compiled module), the per-device
counts of local ops on a fake process group, the kernels' place taken by
fake tensors, calibration against the full stack, and a smoke cell on the
16×16 production mesh. Every fake group is destroyed before its test
returns (``dryrun.fake_world``)."""

import dataclasses
import functools
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

import repro.roofline.analysis as jroof  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.backends.analytical import HardwareSpec as JHardwareSpec  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import (ALL_ARCHS, SHAPES, ShapeConfig,  # noqa: E402
                                 get_config, smoke_config)
from repro.configs import list_configs as jax_list_configs  # noqa: E402

# the archs both packages register: the JAX trees are the yardstick
# (zamba2-7b is the port's alone; test_torch_zamba2.py holds it)
JAX_ARCHS = [a for a in ALL_ARCHS if a in jax_list_configs()]
from repro_torch.core.backends.analytical import HardwareSpec  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.kernels.flash_attention.work import (  # noqa: E402
    attention_backward_work, attention_work)
from repro_torch.kernels.ssd import kernel as skernel  # noqa: E402
from repro_torch.kernels.ssd import ops as sops  # noqa: E402
from repro_torch.kernels.ssd import ref as sref  # noqa: E402
from repro_torch.kernels.ssd.work import ssd_backward_work, ssd_work  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.train import check_train_state_fits  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.roofline import analysis as troof  # noqa: E402

QWEN3 = "qwen3-moe-235b-a22b"
# the run_cell keys of repro.launch.dryrun beside the report's own
CELL_KEYS = {"status", "lower_s", "compile_s", "raw_scan_cost",
             "memory_analysis", "talp_device"}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (str(i),)))
        return out
    return {"/".join(prefix): tree}


def _jax_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


@functools.lru_cache(maxsize=None)
def _jax_serve_params(arch):
    return _jax_flat(jsteps.serve_params_shapes(jax_get_config(arch)))


# ---------------------------------------------------------------------------
# abstract inputs, model FLOPs, the config
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_input_specs_equal_jax(arch, shape):
    """input_specs and serve_params_shapes: the JAX trees' leaves, shapes
    and dtypes (jax.eval_shape against meta tensors: nothing allocated)."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    want = _jax_flat(jsteps.input_specs(jcfg, JAX_SHAPES[shape]))
    got = _flat(tsteps.input_specs(cfg, SHAPES[shape]))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.is_meta, name
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype).split(".")[-1] == str(want[name].dtype), name
    if shape == "train_4k":    # the parameters once an arch
        want = _jax_serve_params(arch)
        got = _flat(tsteps.serve_params_shapes(cfg))
        assert sorted(got) == sorted(want)
        for name, t in got.items():
            assert (tuple(t.shape), t.dtype, t.is_meta) == (
                want[name].shape, torch.bfloat16, True), name
            assert want[name].dtype == jnp.bfloat16, name


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_model_flops_equal_jax(arch):
    for shape in SHAPES:
        assert tsteps.model_flops(get_config(arch), SHAPES[shape]) == \
            jsteps.model_flops(jax_get_config(arch), JAX_SHAPES[shape])


def test_qwen3_config_equals_jax_and_is_refused_on_one_card():
    """qwen3-moe-235b-a22b is registered with the JAX config's fields and
    parameter count (235.1 B), and train's memory check refuses its train
    state on one 80 GB card before anything is drawn."""
    cfg, jcfg = get_config(QWEN3), jax_get_config(QWEN3)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_params() == jcfg.n_params()
    assert round(cfg.n_params() / 1e9, 1) == 235.1
    assert tlm.param_count(tlm.init_params(cfg, None, device="meta")) == \
        sum(x.size for x in jax.tree.leaves(jax.eval_shape(
            lambda: jlm.init_params(jcfg, jax.random.PRNGKey(0)))))
    with pytest.raises(ValueError, match="qwen3-moe-235b-a22b"):
        check_train_state_fits(cfg, 80 * 2**30)


# ---------------------------------------------------------------------------
# the roofline report
# ---------------------------------------------------------------------------
_HLO = """
  %ag = bf16[8,128]{1,0} all-gather(bf16[1,128]{1,0} %p), dims={0}
  %ar = (f32[4], f32[4]) all-reduce-start(f32[4] %a, f32[4] %b)
  %ard = (f32[4], f32[4]) all-reduce-done(%ar)
  %rs = f32[2,64]{1,0} reduce-scatter(f32[16,64]{1,0} %x), dimensions={0}
  %aa = s32[16]{0} all-to-all(s32[16]{0} %y)
"""


@pytest.mark.parametrize("cost,memory", [
    ({"flops": 4e14, "bytes accessed": 1e11}, None),
    ({"flops": 1e12, "bytes accessed": 3e12},
     SimpleNamespace(peak_memory_in_bytes=7e10, argument_size_in_bytes=5e10,
                     output_size_in_bytes=1e6, temp_size_in_bytes=2e10)),
    ({"flops": 0.0, "bytes accessed": 0.0}, None),
], ids=["compute", "memory", "empty"])
def test_roofline_report_equals_jax(cost, memory):
    """build_report from the same costs, the same collectives (the HLO text
    on the JAX side, its stats on the port's) and the same memory analysis
    gives the JAX report's dict, derived terms included."""
    hw = dict(name="h", peak_flops=5e14, hbm_bw=2e12, ici_bw=1e11)
    j = jroof.build_report("a", "s", "2datax2model", 4, cost, _HLO, 8e14,
                           memory_analysis=memory, hw=JHardwareSpec(**hw))
    stats = troof.CollectiveStats()
    for kind, nbytes in (("all-gather", 2048), ("all-reduce", 32),
                         ("reduce-scatter", 512), ("all-to-all", 64)):
        stats.add(kind, nbytes)
    t = troof.build_report("a", "s", "2datax2model", 4, cost, stats, 8e14,
                           memory_analysis=memory, hw=HardwareSpec(**hw))
    assert j.to_dict() == t.to_dict()
    assert json.loads(j.to_json()) == json.loads(t.to_json())
    assert dataclasses.asdict(j.step_model())["flops"] == \
        dataclasses.asdict(t.step_model())["flops"]


def test_collective_kinds():
    """Both torch namespaces map onto the JAX kinds; a wait moves nothing;
    a collective with no kind raises rather than going uncounted."""
    kind = troof.collective_kind
    assert kind("_c10d_functional.all_gather_into_tensor") == "all-gather"
    assert kind("c10d._allgather_base_") == "all-gather"
    assert kind("_c10d_functional.reduce_scatter_tensor") == "reduce-scatter"
    assert kind("c10d.allreduce_") == "all-reduce"
    assert kind("_c10d_functional.all_to_all_single") == "all-to-all"
    assert kind("c10d.send") == "collective-permute"
    assert set(troof._KIND.values()) == set(troof.COLLECTIVES)
    assert kind("_c10d_functional.wait_tensor") is None
    assert kind("aten.mm") is None
    with pytest.raises(KeyError):
        kind("c10d.some_new_collective_")


# ---------------------------------------------------------------------------
# counting on a fake process group
# ---------------------------------------------------------------------------
def test_counts_are_local_on_a_fake_4x4_mesh():
    """A bf16 4096³ matmul, (Shard(0), Replicate) by (Shard(0), Shard(1)),
    on a 4×4 CPU mesh over 16 fake ranks: 2·4096³/16 FLOPs on rank 0 (its
    local (1024, 4096) @ (4096, 1024); sharding propagation's run of the
    global op is not counted), one all-gather of the right operand's
    (4096, 1024) bf16 column block, and HBM bytes of the local product.
    An eager ``dist.all_reduce`` (c10d.allreduce_) counts as all-reduce.
    The group is gone afterwards."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with dryrun.fake_world(16):
        mesh = make_mesh((4, 4), ("data", "model"), "cpu")
        counter = dryrun.FakeCounter()
        with counter, counter.dtensor_bookkeeping():
            a, b = (distribute_tensor(
                torch.empty(4096, 4096, dtype=torch.bfloat16), mesh, pl,
                src_data_rank=None)
                for pl in ([Shard(0), Replicate()], [Shard(0), Shard(1)]))
            counter.start()
            out = a @ b
            counter.stop()
            assert tuple(out.to_local().shape) == (1024, 1024)
            assert counter.flops == 2 * 4096 ** 3 / 16
            assert counter.collectives.bytes_by_kind == {
                "all-gather": 8_388_608}
            assert counter.collectives.count_by_kind == {"all-gather": 1}
            assert counter.hbm_bytes == 2 * (2 * 1024 * 4096 + 1024 * 1024)
            assert counter.peak_bytes >= 2 * 1024 * 1024
            g = torch.empty(8)
            counter.start()
            dist.all_reduce(g)
            counter.stop()
            assert counter.collectives.bytes_by_kind == {"all-reduce": 32}
            assert counter.flops == 0 and counter.hbm_bytes == 0
    assert not dist.is_initialized()


def _old_attention_flops(s, t, window):
    """chip_smoke.py's count before it moved: the visible pairs of an S×T
    boolean mask."""
    rows = torch.arange(s)[:, None]
    cols = torch.arange(t)[None, :]
    vis = cols <= rows + (t - s)
    if window is not None:
        vis &= cols > rows + (t - s) - window
    return int(vis.sum())


def _old_ssd_flops(l, chunk, per_chunk):
    flops = 0.0
    for c0 in range(0, l, chunk):
        flops += per_chunk(min(chunk, l - c0))
    return flops


@pytest.mark.parametrize("s,t", [(1, 1), (5, 5), (7, 19), (64, 64),
                                 (100, 130), (257, 1024)])
def test_work_formulas_equal_the_mask_counts(s, t):
    """The closed forms give the counts of the formulas they replaced: the
    mask's visible pairs (with and without a window, the window below,
    across and past the diagonal) and the SSD's loop over chunks (L a
    multiple of the chunk and a ragged one)."""
    for window in (None, 1, 3, 16, 64, 500, 5000):
        pairs = _old_attention_flops(s, t, window)
        flops, nbytes = attention_work(2, s, t, 4, 2, 32, window,
                                       torch.bfloat16)
        assert flops == 4.0 * 32 * pairs * 2 * 4
        assert nbytes == 2 * (2 * 2 * s * 4 * 32 + 2 * 2 * t * 2 * 32)
        bflops, bbytes = attention_backward_work(2, s, t, 4, 2, 32, window,
                                                 torch.float32)
        assert bflops == flops * 10 / 4
        assert bbytes == 4 * (4 * 2 * s * 4 * 32 + 4 * 2 * t * 2 * 32) \
            + 4 * 2 * 4 * s
    assert attention_work(1, s, t, 1, 1, 8, None, torch.bfloat16,
                          causal=False)[0] == 4.0 * 8 * s * t
    n, p = 16, 32
    for l in (t, t + 1):
        for chunk in (32, 256):
            want = _old_ssd_flops(l, chunk, lambda q: q * (q + 1) / 2 * 2
                                  * (n + p) + 4.0 * q * n * p) * 2 * 3
            assert ssd_work(2, l, 3, p, 1, n, chunk, torch.bfloat16,
                            False)[0] == want
            want = _old_ssd_flops(l, chunk, lambda q: q * (q + 1) / 2 * 2
                                  * (3 * n + 2 * p) + 10.0 * q * n * p) * 2 * 3
            assert ssd_backward_work(2, l, 3, p, 1, n, chunk, torch.bfloat16,
                                     True)[0] == want


class _Recorder(FakeTensorMode):
    """A fake mode that keeps every kernel's work given to it."""

    def __init__(self):
        super().__init__()
        self.work = []

    def record_kernel(self, name, flops, nbytes):
        self.work.append((name, flops, nbytes))


@pytest.fixture
def no_plain_versions(monkeypatch):
    """Every plain version a wrapper could reach raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a fake tensor reached a plain version")

    for mod, names in ((fref, ("attention_reference", "attention_reference_lse",
                               "attention_backward_reference")),
                       (sref, ("ssd_reference", "ssd_backward_reference"))):
        for name in names:
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("window", [None, 24])
def test_fake_cuda_attention_counts_its_work(window, no_plain_versions):
    """Fake cuda tensors take the flash kernels' place: the forward through
    ops.attention and the backward call give their outputs' shapes, give
    the fake mode exactly attention_work and attention_backward_work, and
    launch nothing (the launch counters do not move)."""
    before = launch_counts()
    rec = _Recorder()
    with rec, torch.no_grad():
        q = torch.empty(2, 96, 8, 64, dtype=torch.bfloat16, device="cuda")
        k, v = (torch.empty(2, 128, 2, 64, dtype=torch.bfloat16,
                            device="cuda") for _ in range(2))
        o = fops.attention(q, k, v, window=window, softcap=30.0)
        o2, lse = fkernel.flash_attention(q, k, v, window=window,
                                          return_lse=True)
        grads = fkernel.flash_attention_backward(q, k, v, o2, lse, o2,
                                                 window=window)
    assert o.device.type == "cuda" and o.shape == q.shape
    assert lse.shape == (2, 8, 96) and lse.dtype == torch.float32
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    fwd = attention_work(2, 96, 128, 8, 2, 64, window, torch.bfloat16)
    bwd = attention_backward_work(2, 96, 128, 8, 2, 64, window,
                                  torch.bfloat16)
    assert rec.work == [("flash_attention_fwd", *fwd)] * 2 + [
        ("flash_attention_bwd", *bwd)]
    assert launch_counts() == before


@pytest.mark.parametrize("with_state", [False, True])
def test_fake_cuda_ssd_counts_its_work(with_state, no_plain_versions):
    """Fake cuda tensors take the SSD kernels' place: ops.ssd and the
    backward call give their outputs' shapes and exactly ssd_work and
    ssd_backward_work, and launch nothing."""
    before = launch_counts()
    rec = _Recorder()
    b, l, h, p, g, n, chunk = 2, 300, 4, 32, 1, 16, 128
    with rec, torch.no_grad():
        x = torch.empty(b, l, h, p, dtype=torch.bfloat16, device="cuda")
        dt = torch.empty(b, l, h, device="cuda")
        a = torch.empty(h, device="cuda")
        bm, cm = (torch.empty(b, l, g, n, dtype=torch.bfloat16,
                              device="cuda") for _ in range(2))
        s0 = torch.empty(b, h, p, n, device="cuda") if with_state else None
        out = sops.ssd(x, dt, a, bm, cm, chunk=chunk, initial_state=s0,
                       return_final_state=with_state)
        y = out[0] if with_state else out
        grads = skernel.ssd_scan_backward(
            x, dt, a, bm, cm, y, chunk=chunk, initial_state=s0,
            d_final_state=out[1] if with_state else None)
    assert y.shape == x.shape and y.device.type == "cuda"
    assert [None if t is None else tuple(t.shape) for t in grads] == [
        x.shape, dt.shape, a.shape, bm.shape, cm.shape, None,
        (b, h, p, n) if with_state else None]
    assert rec.work == [
        ("ssd_fwd", *ssd_work(b, l, h, p, g, n, chunk, torch.bfloat16,
                              with_state)),
        ("ssd_bwd", *ssd_backward_work(b, l, h, p, g, n, chunk,
                                       torch.bfloat16, with_state))]
    assert launch_counts() == before


def test_fake_cpu_tensors_train_through_the_kernels(no_plain_versions):
    """A fake CPU tensor goes to the kernels too (a CPU mesh's dry run):
    autograd through ops.attention and ops.ssd reaches both backwards,
    each kernel's work given once, no plain version entered. The
    activations are bf16, the one dtype the kernels take; dt and a fp32."""
    rec = _Recorder()
    bf16 = dict(dtype=torch.bfloat16, requires_grad=True)
    with rec:
        q = torch.empty(1, 64, 4, 32, **bf16)
        kv = torch.empty(1, 64, 2, 32, **bf16)
        x = torch.empty(1, 64, 2, 16, **bf16)
        dt = torch.empty(1, 64, 2, requires_grad=True)
        a = torch.empty(2, requires_grad=True)
        bm = torch.empty(1, 64, 1, 16, **bf16)
        loss = fops.attention(q, kv, kv).sum() + sops.ssd(
            x, dt, a, bm, bm, chunk=32).sum()
        loss.backward()
        assert q.grad.shape == q.shape and x.grad.shape == x.shape
    assert sorted(name for name, _, _ in rec.work) == [
        "flash_attention_bwd", "flash_attention_fwd", "ssd_bwd", "ssd_fwd"]


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------
def _smoke_overrides(arch, **extra):
    """The smoke config's fields as run_cell overrides, at a head dim the
    flash kernels take (32)."""
    full, smoke = get_config(arch), smoke_config(arch)
    out = {k: v for k, v in dataclasses.asdict(smoke).items()
           if v != getattr(full, k)}
    if smoke.num_heads:
        out["head_dim"] = 32
    out.update(extra)
    return out


@pytest.mark.parametrize("arch,shape", [
    ("llama3.2-3b", ShapeConfig("train", 64, 4, "train")),
    ("zamba2-2.7b", ShapeConfig("prefill", 64, 4, "prefill")),
    ("granite-moe-3b-a800m", ShapeConfig("decode", 48, 4, "decode")),
], ids=["llama-train", "zamba2-prefill", "granite-decode"])
def test_calibrated_counts_equal_the_full_stack(arch, shape):
    """R = 1 and R = 2 counts extrapolated to R = 3 equal the three-repeat
    stack's own count (raw_scan_cost) to 1e-9 relative: eager counts every
    layer, and every layer counts alike."""
    period = len(get_config(arch).pattern)
    res = dryrun.run_cell(arch, shape, verbose=False, device="cpu",
                          mesh=((2, 2), ("data", "model")),
                          arch_overrides=_smoke_overrides(
                              arch, num_layers=3 * period))
    raw = res["raw_scan_cost"]
    assert res["status"] == "ok" and res["flops"] > 0
    assert math.isclose(res["flops"], raw["flops"], rel_tol=1e-9)
    assert math.isclose(res["hbm_bytes"], raw["hbm_bytes"], rel_tol=1e-9)
    assert res["collective_detail"].keys() == raw["collective_bytes"].keys()
    for kind, nbytes in raw["collective_bytes"].items():
        assert math.isclose(res["collective_detail"][kind], nbytes,
                            rel_tol=1e-9), kind


def test_smoke_cell_on_the_production_mesh(tmp_path):
    """llama3.2-3b's smoke config at train_4k on the 16×16 production mesh
    over 256 fake ranks (a CPU mesh): status ok, the JAX run_cell's keys,
    collectives counted, every memory field set, the predicted TALP device
    tree valid, the JSON written under ``out_dir``, the group gone."""
    res = dryrun.run_cell("llama3.2-3b", "train_4k", out_dir=str(tmp_path),
                          verbose=False, calibrate=False, device="cpu",
                          arch_overrides=_smoke_overrides("llama3.2-3b"))
    report_keys = set(jroof.RooflineReport(
        "a", "s", "m", 1, 0.0, 0.0, 0.0, {}, 0, 0.0).to_dict())
    assert set(res) == report_keys | CELL_KEYS
    assert res["status"] == "ok" and res["chips"] == 256
    assert res["mesh"] == "16datax16model@cpu"
    assert res["collective_bytes"] > 0 and res["collective_count"] > 0
    assert set(res["collective_detail"]) <= set(troof.COLLECTIVES)
    mem = res["memory_analysis"]
    assert all(mem[k] is not None and mem[k] > 0 for k in mem), mem
    assert mem["peak_memory"] == mem["argument_size"] + mem["temp_size"]
    assert 0 < res["talp_device"]["parallel_efficiency"] <= 1
    assert res["flops"] > res["model_flops"] > 0
    written = json.loads((tmp_path / "llama3.2-3b__train_4k__"
                          "16datax16model@cpu.json").read_text())
    assert written == json.loads(json.dumps(res))
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,kind", [("llama3.2-3b", "train"),
                                       ("zamba2-2.7b", "train"),
                                       ("granite-moe-3b-a800m", "decode")])
def test_sharded_steps_take_torch_2_11_dtensor(arch, kind, monkeypatch):
    """What the card's torch (2.11) refuses of a DTensor, refused here too
    by patching this torch: a view that folds a sharded dim behind the
    fold's leading one, and F.pad (its DTensor strategy there gives one
    placement whatever the mesh). The sharded steps, sequence-parallel
    training included, take neither (2×2 fake CPU mesh, smoke configs)."""
    import torch.nn.functional as F
    from torch.distributed.tensor._ops import _view_ops

    analyze = _view_ops._ViewShardingPropagator._analyze_flatten

    def strict_fold(self, cmd):
        if self.strict_view:
            for dim in cmd.input_dims[1:]:
                if self._find_plain_shard(dim)[0] is not None:
                    raise RuntimeError(f"folds sharded dim {dim.input_dim} "
                                       "behind another")
        return analyze(self, cmd)

    pad = F.pad

    def no_dtensor_pad(x, *args, **kwargs):
        assert not hasattr(x, "device_mesh"), "F.pad of a DTensor"
        return pad(x, *args, **kwargs)

    monkeypatch.setattr(_view_ops._ViewShardingPropagator,
                        "_analyze_flatten", strict_fold)
    monkeypatch.setattr(F, "pad", no_dtensor_pad)
    cfg = dataclasses.replace(smoke_config(arch),
                              **_smoke_overrides(arch))
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        counts = dryrun.count_step(cfg, ShapeConfig(kind, 64, 4, kind),
                                   mesh, "cpu")[0]
    assert counts.flops > 0 and sum(counts.collective_bytes.values()) > 0


def test_long_500k_is_skipped_for_full_attention():
    """The JAX package's skip policy: pure full attention at every layer
    skips long_500k (no group is started)."""
    assert dryrun.run_cell("llama3.2-3b", "long_500k") == {
        "arch": "llama3.2-3b", "shape": "long_500k", "status": "skipped",
        "reason": "pure full attention at every layer (DESIGN.md "
                  "long_500k skip policy)"}


def test_cuda_dry_run_without_cuda_raises():
    """The default device is the card's; without CUDA it raises, never
    counting a CPU mesh in its place."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.run_cell("llama3.2-3b", "train_4k", verbose=False)
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# consolidate_caches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama3.2-3b", "h2o-danube-3-4b",
                                  "zamba2-2.7b"])
def test_consolidate_caches_equals_jax(arch):
    """After a prefill of 60 tokens and 22 decode steps (more than the smoke
    ring's 16 slots, past h2o-danube's window of 64), the port's caches
    (fp32) consolidated by both packages are equal exactly: valid hot slots
    at pos % T, the rings zero with h_pos -1; an SSM slot passes through
    unchanged."""
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32")
    jcfg = dataclasses.replace(jax_get_config(arch),
                               **dataclasses.asdict(cfg))
    gen = torch.Generator().manual_seed(0)
    params = tlm.init_params(cfg, gen)
    prompt, steps = 60, 22
    toks = torch.randint(0, cfg.vocab_size, (2, prompt + steps),
                         generator=gen, dtype=torch.int32)
    with torch.no_grad():
        _, caches, pos = tlm.prefill(cfg, params, toks[:, :prompt])
        caches = tlm.grow_caches(cfg, caches, prompt + steps)
        for t in range(prompt, prompt + steps):
            _, caches, pos = tlm.decode_step(cfg, params, toks[:, t:t + 1],
                                             pos, caches)
    got = _flat(tlm.consolidate_caches(cfg, caches))
    want = _jax_flat(jlm.consolidate_caches(
        jcfg, jax.tree.map(lambda t: jnp.asarray(t.numpy()), caches)))
    assert sorted(got) == sorted(want)
    flushed = 0
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]),
                                      err_msg=name)
        if name.endswith("/h_pos"):
            assert (t == -1).all()
            before = _flat(caches)[name]
            flushed += int((before >= 0).sum())
    assert flushed > 0
    for name, t in _flat(caches).items():
        if name.split("/")[-1] in ("state", "conv_x", "conv_b", "conv_c"):
            assert got[name] is t, name
