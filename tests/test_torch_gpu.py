"""Tests of the port that need a CUDA card (marker ``gpu``); each skips
without one. They import no JAX, so they run on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import TalpMonitor  # noqa: E402
from repro_torch.core.backends import CudaRuntimeBackend  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402

pytestmark = pytest.mark.gpu

# tests/test_kernels.py::ATTN_SWEEP with torch dtypes (that module imports
# JAX); tests/test_torch_flash_attention.py holds the two equal.
# (B, S, T, H, K, D, window, softcap, dtype)
SWEEP = [
    (1, 128, 128, 4, 4, 64, None, None, torch.float32),
    (2, 256, 256, 4, 2, 64, None, None, torch.float32),
    (1, 256, 256, 8, 2, 32, None, None, torch.float32),
    (1, 256, 256, 4, 1, 64, None, None, torch.float32),
    (1, 256, 256, 4, 2, 64, 64, None, torch.float32),
    (1, 256, 256, 4, 2, 64, None, 50.0, torch.float32),
    (1, 256, 256, 4, 2, 64, 128, 30.0, torch.float32),
    (1, 384, 384, 2, 2, 128, None, None, torch.float32),
    (2, 128, 128, 4, 2, 64, None, None, torch.bfloat16),
    (1, 256, 256, 4, 2, 64, 64, 50.0, torch.bfloat16),
]
# Shapes the TPU kernel refused: S, T off the tile grid, S < T.
RAGGED = [
    (1, 1000, 1000, 24, 8, 128, None, None, torch.bfloat16),
    (1, 1000, 1000, 4, 2, 64, 256, 30.0, torch.float32),
    (2, 100, 300, 8, 2, 32, None, None, torch.bfloat16),
    (1, 100, 300, 4, 2, 128, 50, None, torch.float32),
]
# The edges of the bf16 kernel's tiling (128 query rows, 128-key tiles, TMA
# boxes): S and T off the tile grid with S < T, window and soft-cap at D
# 128, D 32 (64-byte swizzle) with GQA 4, S below one query tile. Then the
# edges of the bf16 backward's tiling (128-key and 128-row blocks, 64-row
# query steps): GQA 3 across a ragged 128-key block, T - S off the 64-row
# grid, a window inside one 128-key block with a soft-cap, one query row
# against a ragged key tile at D 32, and S < T with a window narrower than
# T - S, so that one 128-key block is seen by no query row.
EDGES = [
    (1, 200, 328, 8, 2, 64, None, None, torch.bfloat16),
    (2, 384, 384, 4, 1, 128, 100, 50.0, torch.bfloat16),
    (2, 256, 256, 8, 2, 32, None, None, torch.bfloat16),
    (1, 64, 64, 4, 2, 128, None, None, torch.bfloat16),
    (1, 320, 320, 6, 2, 128, None, None, torch.bfloat16),
    (1, 150, 270, 4, 2, 64, None, None, torch.bfloat16),
    (1, 300, 300, 4, 2, 128, 96, 30.0, torch.bfloat16),
    (1, 1, 130, 4, 4, 32, None, None, torch.bfloat16),
    (1, 100, 400, 4, 2, 64, 64, None, torch.bfloat16),
]

# tests/test_kernels.py::SSD_SWEEP with torch dtypes;
# tests/test_torch_ssd.py holds the two equal.
# (B, L, H, P, G, N, chunk, dtype)
SSD_SWEEP = [
    (1, 64, 2, 16, 1, 16, 16, torch.float32),
    (2, 128, 4, 16, 2, 32, 32, torch.float32),
    (1, 128, 4, 64, 1, 64, 64, torch.float32),
    (1, 256, 8, 32, 1, 16, 128, torch.float32),
    (2, 128, 4, 16, 4, 32, 32, torch.float32),
    (1, 128, 4, 16, 2, 32, 32, torch.bfloat16),
]
# Shapes the TPU kernel refused (L not a multiple of the chunk), and
# mamba2-130m's head shape (P 64, N 128, chunk 256).
SSD_RAGGED = [
    (1, 1000, 4, 64, 1, 128, 256, torch.bfloat16),
    (2, 100, 4, 16, 2, 32, 64, torch.float32),
]
# The edges of the bf16 kernels' chunk-parallel form: L shorter than one
# chunk, many chunks (the state recurrence over 64), two groups.
SSD_EDGES = [
    (1, 100, 4, 64, 1, 128, 256, torch.bfloat16),
    (1, 4096, 4, 64, 1, 128, 64, torch.bfloat16),
    (2, 512, 8, 64, 2, 128, 256, torch.bfloat16),
]


def _tol(dtype):
    """tests/test_kernels.py::_tol."""
    t = 2e-2 if dtype == torch.bfloat16 else 2e-4
    return dict(rtol=t, atol=t)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("row", SWEEP + RAGGED + EDGES,
                         ids=[f"attn{i}" for i in range(len(SWEEP))]
                         + [f"ragged{i}" for i in range(len(RAGGED))]
                         + [f"edge{i}" for i in range(len(EDGES))])
def test_cuda_kernel_vs_plain(cuda, row):
    b, s, t, h, k, d, window, softcap, dtype = row
    gen = torch.Generator(device=cuda).manual_seed(42)
    q, kk, vv = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
                 for shape in ((b, s, h, d), (b, t, k, d), (b, t, k, d)))
    before = kernel.flash_attention.launches
    got = ops.attention(q, kk, vv, causal=True, window=window,
                        softcap=softcap)
    assert kernel.flash_attention.launches == before + 1
    want = ref.attention_reference(q, kk, vv, causal=True, window=window,
                                   softcap=softcap)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def _attn_grad_inputs(device, b, s, t, h, k, d, dtype, seed=43):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for shape in ((b, s, h, d), (b, t, k, d), (b, t, k, d),
                          (b, s, h, d))]


def _close_grads(got, want, dtype):
    """fp32: elementwise at _tol; bf16: each gradient over the reference
    gradient's max-abs, at _tol(bfloat16)."""
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        g, w = g.float(), w.float()
        if dtype == torch.bfloat16:
            m = w.abs().max().clamp_min(1e-30)
            g, w = g / m, w / m
        torch.testing.assert_close(g, w, **_tol(dtype))


@pytest.mark.parametrize("row", SWEEP + RAGGED + EDGES,
                         ids=[f"attn{i}" for i in range(len(SWEEP))]
                         + [f"ragged{i}" for i in range(len(RAGGED))]
                         + [f"edge{i}" for i in range(len(EDGES))])
def test_cuda_backward_vs_plain(cuda, row):
    """The forward's output against the plain version's at the dtype's
    _tol and its LSE at fp32 _tol; dq, dk, dv of the backward kernels
    against attention_backward_reference and against autograd through
    attention_reference, both in fp32 from the same inputs; a second
    backward run is bit-identical."""
    b, s, t, h, k, d, window, softcap, dtype = row
    q, kk, vv, do = _attn_grad_inputs(cuda, b, s, t, h, k, d, dtype)
    cfg = dict(causal=True, window=window, softcap=softcap)
    o, lse = kernel.flash_attention(q, kk, vv, return_lse=True, **cfg)
    o_want, lse_want = ref.attention_reference_lse(q, kk, vv, **cfg)
    before = kernel.flash_attention_backward.launches
    got = kernel.flash_attention_backward(q, kk, vv, o, lse, do, **cfg)
    again = kernel.flash_attention_backward(q, kk, vv, o, lse, do, **cfg)
    assert kernel.flash_attention_backward.launches == before + 2
    up = [x.float() for x in (q, kk, vv, o)]
    want = ref.attention_backward_reference(*up, lse, do.float(), **cfg)
    leaves = [x.float().requires_grad_() for x in (q, kk, vv)]
    ref.attention_reference(*leaves, **cfg).backward(do.float())
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_want.float(), **_tol(dtype))
    torch.testing.assert_close(lse, lse_want, **_tol(torch.float32))
    _close_grads(got, want, dtype)
    _close_grads(got, [x.grad for x in leaves], dtype)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_cuda_ops_attention_gradients_reach_qkv(cuda):
    """Under grad mode ops.attention runs FlashAttention: one forward and
    one backward call, and the gradients are the backward kernels'."""
    q, kk, vv, do = _attn_grad_inputs(cuda, 2, 256, 256, 4, 2, 128,
                                      torch.bfloat16)
    leaves = [x.clone().requires_grad_() for x in (q, kk, vv)]
    fwd = kernel.flash_attention.launches
    bwd = kernel.flash_attention_backward.launches
    out = ops.attention(*leaves)
    out.backward(do)
    assert kernel.flash_attention.launches == fwd + 1
    assert kernel.flash_attention_backward.launches == bwd + 1
    o, lse = kernel.flash_attention(q, kk, vv, return_lse=True)
    want = kernel.flash_attention_backward(q, kk, vv, o, lse, do)
    torch.cuda.synchronize()
    assert all(torch.equal(x.grad, w) for x, w in zip(leaves, want))


def test_cuda_kernel_refuses_inputs_that_require_grad(cuda):
    q, kk, vv, _ = _attn_grad_inputs(cuda, 1, 64, 64, 4, 2, 64,
                                     torch.bfloat16)
    with pytest.raises(RuntimeError, match="autograd"):
        kernel.flash_attention(q.requires_grad_(), kk, vv)
    with torch.no_grad():
        assert kernel.flash_attention(q, kk, vv).shape == q.shape


def test_cuda_kernel_refuses_unsupported_head_dim(cuda):
    q = torch.zeros(1, 64, 4, 96, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 2, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ops.attention(q, k, k)


def test_cuda_event_records_lie_inside_the_region(cuda):
    be = CudaRuntimeBackend(cuda)
    mon = TalpMonitor("cuda", backend=be)
    x = torch.randn(2048, 2048, device=cuda)
    with mon.region("step"):
        h = be.launch(lambda a: (a @ a).sum(), x, name="mm")
        with mon.offload():
            be.wait(h)
    r = mon.finalize()["step"]
    assert 0 < r.device_states[0]["kernel"] <= r.elapsed
    r.device.validate()


def _ssd_inputs(device, b, l, h, p, g, n, dtype, seed=7):
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=gen, device=device)
    x = rnd(b, l, h, p).to(dtype)
    dt = torch.nn.functional.softplus(rnd(b, l, h))
    a = -torch.exp(rnd(h) * 0.3)
    bm, cm = rnd(b, l, g, n).to(dtype), rnd(b, l, g, n).to(dtype)
    d = torch.full((h,), 0.5, device=device)
    s0 = rnd(b, h, p, n)
    return x, dt, a, bm, cm, d, s0


@pytest.mark.parametrize("row", SSD_SWEEP + SSD_RAGGED + SSD_EDGES,
                         ids=[f"ssd{i}" for i in range(len(SSD_SWEEP))]
                         + [f"ragged{i}" for i in range(len(SSD_RAGGED))]
                         + [f"edge{i}" for i in range(len(SSD_EDGES))])
def test_cuda_ssd_kernel_vs_plain(cuda, row):
    """y within _tol of its dtype, initial state in and final state out
    within fp32 _tol, of the plain version evaluated in float64 on the
    same inputs (the plain version's fp32 cumsum alone can move an output
    by more than _tol at N 128, chunk 256)."""
    b, l, h, p, g, n, chunk, dtype = row
    x, dt, a, bm, cm, d, s0 = _ssd_inputs(cuda, b, l, h, p, g, n, dtype)
    before = ssd_kernel.ssd_scan.launches
    got, s_got = ssd_ops.ssd(x, dt, a, bm, cm, chunk=chunk, d_skip=d,
                             initial_state=s0, return_final_state=True)
    assert ssd_kernel.ssd_scan.launches == before + 1
    up = [t.double() for t in (x, dt, a, bm, cm)]
    want, s_want = ssd_ref.ssd_reference(*up, chunk=chunk, d_skip=d.double(),
                                         initial_state=s0.double(),
                                         return_final_state=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.to(dtype).float(),
                               **_tol(dtype))
    torch.testing.assert_close(s_got, s_want.float(), **_tol(torch.float32))


def test_cuda_ssd_kernel_refuses_cpu_tensor_and_mixed_dtype(cuda):
    x, dt, a, bm, cm, d, _ = _ssd_inputs(cuda, 1, 64, 4, 64, 1, 128,
                                         torch.bfloat16)
    before = ssd_kernel.ssd_scan.launches
    with pytest.raises(ValueError):
        ssd_kernel.ssd_scan(x, dt.cpu(), a, bm, cm, chunk=64)
    with pytest.raises(ValueError):
        ssd_kernel.ssd_scan(x, dt, a, bm.float(), cm, chunk=64)
    assert ssd_kernel.ssd_scan.launches == before


def _first_step_grads(state, metrics, opt):
    """The gradient of the first AdamW step, leaf by leaf, on the CPU: the
    first moment is then (1 - b1)·clip·g, clip = min(1, grad_clip / norm)."""
    clip = min(1.0, opt.grad_clip / max(float(metrics["grad_norm"]), 1e-9))
    out = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for key, val in tree.items():
                walk(val, f"{prefix}/{key}")
        else:
            out[prefix] = tree.cpu() / ((1 - opt.b1) * clip)

    walk(state["opt"]["mu"], "")
    return out


def _rel_norm(got, want):
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cuda_train_step_matches_cpu(cuda, compute_dtype):
    """One make_train_step step of smoke_config("llama3.2-3b") (head_dim
    32: the kernels take no 16) on the card, through the flash kernels
    (2 forwards per layer with remat, 1 backward), against the same step
    on the CPU from the same state: loss and grad norm within the compute
    dtype's _tol. The gradient leaf by leaf, from the first moment: fp32
    elementwise at _tol and at a relative norm of its tol; bf16 no further
    from the CPU's fp32 gradient, in relative norm, than twice the CPU's
    bf16 gradient is, plus the bf16 tol (the plain version's own bf16
    gradient lies 1e-2 to 2e-2 from the fp32 one). Params within fp32
    _tol plus 2·lr (Adam's first step moves an element by about
    lr·sign(g))."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig

    cfg = dataclasses.replace(smoke_config("llama3.2-3b"), head_dim=32,
                              compute_dtype=compute_dtype)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    cpu = init_train_state(cfg, torch.Generator().manual_seed(3), "cpu")
    gpu = lm.tree_map(
        lambda x: x.to(cuda, copy=True) if x.dim() else x.clone(), cpu)
    batch = SyntheticTokenPipeline(DataConfig(2, 64, cfg.vocab_size,
                                              seed=4)).batch_at(0)
    cpu_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    fwd = kernel.flash_attention.launches
    bwd = kernel.flash_attention_backward.launches
    new_gpu, m_gpu = make_train_step(cfg, opt)(
        gpu, {k: v.to(cuda) for k, v in cpu_batch.items()})
    torch.cuda.synchronize()
    assert kernel.flash_attention.launches == fwd + 2 * cfg.num_layers
    assert kernel.flash_attention_backward.launches == bwd + cfg.num_layers
    new_cpu, m_cpu = make_train_step(cfg, opt)(cpu, cpu_batch)
    dtype = getattr(torch, compute_dtype)
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(m_gpu[key].cpu(), m_cpu[key], **_tol(dtype))
    g_gpu = _first_step_grads(new_gpu, m_gpu, opt)
    g_cpu = _first_step_grads(new_cpu, m_cpu, opt)
    tol32 = _tol(torch.float32)["atol"]
    if dtype == torch.float32:
        for name, want in g_cpu.items():
            torch.testing.assert_close(g_gpu[name], want, **_tol(dtype),
                                       msg=name)
            assert _rel_norm(g_gpu[name], want) <= tol32, name
    else:
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        ref_state = init_train_state(cfg32, torch.Generator().manual_seed(3),
                                     "cpu")
        g32 = _first_step_grads(*make_train_step(cfg32, opt)(ref_state,
                                                            cpu_batch), opt)
        tol = _tol(dtype)["atol"]
        for name, want in g32.items():
            card, plain = (_rel_norm(g[name], want) for g in (g_gpu, g_cpu))
            assert card <= 2 * plain + tol, (name, card, plain)
    got = lm.tree_map(lambda x: x.cpu(), new_gpu["params"])

    def pairs(a, b):
        if isinstance(a, dict):
            for key in a:
                yield from pairs(a[key], b[key])
        else:
            yield a, b

    for g, w in pairs(got, new_cpu["params"]):
        torch.testing.assert_close(g, w, rtol=tol32, atol=2 * opt.lr + tol32)
