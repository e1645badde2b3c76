"""The optimizer's dispatch on the CPU: CPU leaves take the plain update,
fake CUDA leaves reach the fused kernels' wrappers (``kernels.adamw``),
which count their work and launch nothing, and the wrappers' checks. The
kernels themselves run only on the card (tests/test_torch_gpu.py)."""

import re

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.adamw import kernel as fused  # noqa: E402
from repro_torch.kernels.adamw.work import (  # noqa: E402
    adamw_norm_work, adamw_update_work)
from repro_torch.launch.dryrun import FakeCounter  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,  # noqa: E402
                                     adamw_update_reference, init_opt_state)

SHAPES = {"embed": (40, 16), "w": (3, 16, 24), "norm": (16,), "one": (1,)}
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)


class _Recorder(FakeTensorMode):
    """A fake mode that keeps every kernel's work given to it."""

    def __init__(self):
        super().__init__()
        self.work = []

    def record_kernel(self, name, flops, nbytes):
        self.work.append((name, flops, nbytes))


def _tree(device, grad_dtype=torch.float32, seed=0):
    """(params, grads, opt state): random CPU leaves, or (under a fake
    mode) empty ones on ``device``, the step count a fake that carries its
    value (made from a literal), as the dry run's."""
    gen = torch.Generator().manual_seed(seed)

    def leaf(shape, dtype):
        if device == "cpu":
            return torch.randn(shape, generator=gen).to(dtype)
        return torch.empty(shape, dtype=dtype, device=device)

    params = {k: leaf(s, torch.float32) for k, s in SHAPES.items()}
    grads = {k: leaf(s, grad_dtype) for k, s in SHAPES.items()}
    return params, grads, {**init_opt_state(params),
                           "count": torch.tensor(0, dtype=torch.int32)}


def _numel(tree):
    return [(t.numel(), t.dtype) for t in tree.values()]


@pytest.fixture
def no_plain_update(monkeypatch):
    """The plain update's norm raises: a fake leaf must not reach it."""
    def refuse(*args, **kwargs):
        raise AssertionError("a fake tensor reached the plain update")

    monkeypatch.setattr(adamw, "_global_norm", refuse)


@pytest.fixture
def no_library(monkeypatch):
    """Loading the kernels' library raises (a CPU leaf that reached the
    wrappers would raise there already)."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the fused kernels")

    monkeypatch.setattr(fused, "library", refuse)


def test_launch_counts_hold_the_adamw_keys():
    counts = launch_counts()
    assert {"adamw_norm", "adamw_update"} <= set(counts)
    assert counts["adamw_norm"] == fused.adamw_norm.launches
    assert counts["adamw_update"] == fused.adamw_update.launches


@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cpu_tree_takes_the_plain_path(grad_dtype, no_library):
    """Two steps on CPU leaves equal adamw_update_reference's bit for bit
    (the same code), and no launch counter moves."""
    before = launch_counts()
    params, grads, state = _tree("cpu", grad_dtype)
    ref_params, _, ref_state = _tree("cpu", grad_dtype)
    for _ in range(2):
        _, state, m = adamw_update(OPT, params, grads, state)
        _, ref_state, m_ref = adamw_update_reference(OPT, ref_params, grads,
                                                     ref_state)
        assert torch.equal(m["grad_norm"], m_ref["grad_norm"])
    for name in SHAPES:
        assert torch.equal(params[name], ref_params[name])
        assert torch.equal(state["mu"][name], ref_state["mu"][name])
        assert torch.equal(state["nu"][name], ref_state["nu"][name])
    assert int(state["count"]) == 2
    assert launch_counts() == before


@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_fake_cuda_leaves_reach_the_fused_wrappers(grad_dtype,
                                                   no_plain_update):
    """Fake CUDA leaves go to both wrappers: each gives its fake mode
    exactly its work.py work, the outputs are fakes (no real memory), the
    step count and lr are the plain path's, and nothing launches."""
    before = launch_counts()
    rec = _Recorder()
    with rec:
        params, grads, state = _tree("cuda", grad_dtype)
        _, new_state, m = adamw_update(OPT, params, grads, state)
    assert rec.work == [
        ("adamw_norm", *adamw_norm_work(_numel(grads))),
        ("adamw_update", *adamw_update_work(_numel(grads)))]
    gnorm = m["grad_norm"]
    assert fused.is_fake(gnorm) and gnorm.device.type == "cuda"
    assert gnorm.shape == () and gnorm.dtype == torch.float32
    assert int(new_state["count"]) == 1
    assert float(m["lr"]) == pytest.approx(OPT.lr / 2)
    assert launch_counts() == before


def test_fused_path_pairs_leaves_by_key(monkeypatch, no_plain_update):
    """Gradients and moments whose dicts hold the keys in another order
    than the parameters' reach the update's wrapper paired by key, as the
    plain version pairs them (leaves of one shape would pair silently by
    position)."""
    seen = {}

    def capture(params, grads, mus, nus, sumsq, **kw):
        seen.update(params=params, grads=grads, mus=mus, nus=nus)
        return torch.empty((), device=sumsq.device)

    monkeypatch.setattr(fused, "adamw_update", capture)
    with FakeTensorMode():
        params, grads, state = _tree("cuda")
        rev = lambda tree: dict(reversed(tree.items()))  # noqa: E731
        adamw_update(OPT, params, rev(grads),
                     {**state, "mu": rev(state["mu"]),
                      "nu": rev(state["nu"])})
    for part, tree in (("params", params), ("grads", grads),
                       ("mus", state["mu"]), ("nus", state["nu"])):
        assert [id(t) for t in seen[part]] == [id(tree[k]) for k in SHAPES]


def test_dry_run_counts_the_fused_pass_in_place_of_the_eager_ops():
    """The dry run's counter over one AdamW step of fake CUDA leaves (bf16
    gradients) counts the two passes' work.py operations and bytes (26 a
    parameter and 2 for the norm), and beyond them only the host scalars
    of the step count and the schedule; no allocation adds bytes."""
    counter = FakeCounter()
    with counter:
        params, grads, state = _tree("cuda", torch.bfloat16)
        counter.start()
        adamw_update(OPT, params, grads, state)
        counter.stop()
    n = sum(t.numel() for t in params.values())
    nf, nb = adamw_norm_work(_numel(grads))
    uf, ub = adamw_update_work(_numel(grads))
    assert (nb, ub) == (2 * n + 4, 26 * n + 8)
    assert counter.flops == nf + uf
    # the schedule and bias corrections: a few dozen ops on 0-d host tensors
    assert nb + ub <= counter.hbm_bytes <= nb + ub + 512


@pytest.mark.parametrize("case", ["cpu", "strided", "shape", "param_dtype",
                                  "grad_dtype", "count"])
def test_fused_wrappers_refuse_what_the_kernels_do_not_take(case):
    """Real CPU tensors, a non-contiguous leaf, a leaf whose tensors differ
    in shape, a bf16 parameter, an int gradient, and lists of different
    lengths each raise ValueError in the wrapper, before any library is
    loaded (fake CUDA tensors, but for the CPU case)."""
    kw = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
              grad_clip=1.0, b1c=0.1, b2c=0.05)
    before = launch_counts()
    if case == "cpu":
        p = torch.zeros(8)
        with pytest.raises(ValueError, match="CUDA"):
            fused.adamw_norm([p])
        with pytest.raises(ValueError, match="CUDA"):
            fused.adamw_update([p], [p], [p.clone()], [p.clone()],
                               torch.zeros(()), **kw)
        assert launch_counts() == before
        return
    with FakeTensorMode():
        p, g, mu, nu = (torch.zeros(4, 8, device="cuda") for _ in range(4))
        sumsq = torch.zeros((), device="cuda")
        if case == "strided":
            p = torch.zeros(8, 4, device="cuda").t()
        elif case == "shape":
            g = torch.zeros(32, device="cuda")
        elif case == "param_dtype":
            p = p.bfloat16()
        elif case == "grad_dtype":
            g = torch.zeros(4, 8, dtype=torch.int32, device="cuda")
        args = ([p], [g], [mu], [nu] if case != "count" else [nu, nu])
        with pytest.raises(ValueError):
            fused.adamw_update(*args, sumsq, **kw)
        if case in ("strided", "grad_dtype"):
            with pytest.raises(ValueError):
                fused.adamw_norm([g if case == "grad_dtype" else p])
    assert launch_counts() == before


def test_norm_chunk_and_leaf_limit_match_the_source():
    """kernel.NORM_CHUNK is the source's kNormChunk (the wrapper sizes the
    partials the library fills); the update's chunk and the table's 64
    leaves, which the docstrings state, are the source's too."""
    src = fused.SOURCE.read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    val = {}
    for name, expr in const.items():
        val[name] = eval(re.sub(r"\bk\w+", lambda m: str(val[m.group(0)]),
                                expr.split("//")[0]))
    assert val["kNormChunk"] == fused.NORM_CHUNK
    assert val["kLeaves"] == 64 and val["kChunk"] == 8192


@pytest.mark.parametrize("sizes,want", [
    ((), 0), ((0,), 0), ((1,), 1), ((32768,), 1), ((32769,), 2),
    ((0, 7, 32768 * 3, 5), 5)])
def test_norm_partials_one_per_chunk_of_each_leaf(sizes, want):
    with FakeTensorMode():
        grads = [torch.empty(n, device="cuda") for n in sizes]
        assert fused.norm_partials(grads) == want
