"""Tests of the port that need a CUDA card (marker ``gpu``); each skips
without one. They import no JAX, so they run on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import DeviceActivity, TalpMonitor  # noqa: E402
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
# Head dim 80 (zamba2-2.7b's shared block: 2560 / 32, MHA), forward only:
# fp32 and bf16 MHA, GQA 2:1, S and T off the tile grid with S < T, window
# and soft-cap in both dtypes. tests/test_torch_flash_attention.py holds
# the plain version at these rows against the JAX package's.
D80 = [
    (1, 256, 256, 4, 4, 80, None, None, torch.float32),
    (2, 256, 256, 4, 4, 80, None, None, torch.bfloat16),
    (1, 256, 256, 8, 4, 80, None, None, torch.bfloat16),
    (1, 200, 328, 4, 2, 80, None, None, torch.bfloat16),
    (1, 256, 256, 4, 2, 80, 64, 30.0, torch.float32),
    (1, 384, 384, 4, 2, 80, 100, 50.0, torch.bfloat16),
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
# State size 64 on the bf16 path (zamba2-2.7b: P 64, N 64, chunk 256): one
# ragged chunk, many chunks, two groups, and zamba2's 80 heads on a ragged
# L. Every row takes an initial state.
SSD_N64 = [
    (1, 100, 4, 64, 1, 64, 256, torch.bfloat16),
    (1, 4096, 4, 64, 1, 64, 64, torch.bfloat16),
    (2, 512, 8, 64, 2, 64, 256, torch.bfloat16),
    (1, 1000, 80, 64, 1, 64, 256, torch.bfloat16),
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


@pytest.mark.parametrize("row", SWEEP + RAGGED + EDGES + D80,
                         ids=[f"attn{i}" for i in range(len(SWEEP))]
                         + [f"ragged{i}" for i in range(len(RAGGED))]
                         + [f"edge{i}" for i in range(len(EDGES))]
                         + [f"d80_{i}" for i in range(len(D80))])
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


def test_cuda_backward_refuses_head_dim_80(cuda):
    """The forward takes D 80; the backward refuses it with ValueError
    before its library dispatches, launching nothing."""
    q, kk, vv, do = _attn_grad_inputs(cuda, 1, 128, 128, 4, 2, 80,
                                      torch.bfloat16)
    o, lse = kernel.flash_attention(q, kk, vv, return_lse=True)
    before = kernel.flash_attention_backward.launches
    with pytest.raises(ValueError, match="head dim 80"):
        kernel.flash_attention_backward(q, kk, vv, o, lse, do)
    out = ops.attention(*(x.clone().requires_grad_() for x in (q, kk, vv)))
    with pytest.raises(ValueError, match="head dim 80"):
        out.backward(do)
    assert kernel.flash_attention_backward.launches == before


def test_cuda_event_records_lie_inside_the_region(cuda):
    """The CUPTI activity records of one launch (a matmul, a reduction and
    the copy of its result) fall inside the region: Kernel and Memory are
    positive and no larger than the region."""
    be = CudaRuntimeBackend(cuda)
    mon = TalpMonitor("cuda", backend=be)
    x = torch.randn(2048, 2048, device=cuda)
    with mon.region("step"):
        h = be.launch(lambda a: (a @ a).sum().cpu(), x, name="mm")
        with mon.offload():
            be.wait(h)
    r = mon.finalize()["step"]
    assert 0 < r.device_states[0]["kernel"] <= r.elapsed
    assert 0 < r.device_states[0]["memory"] <= r.elapsed
    r.device.validate()


def test_cuda_host_gap_inside_one_launch_is_device_idle(cuda):
    """A sleep kernel, a host sleep of 50 ms, a sleep kernel, in one
    launch/wait window: TALP reports the host gap as device Idle, where a
    record spanning the launch counted it as Kernel."""
    be = CudaRuntimeBackend(cuda)
    mon = TalpMonitor("gap", backend=be)

    def step():
        torch.cuda._sleep(1_000_000)
        time.sleep(0.05)
        torch.cuda._sleep(1_000_000)

    with mon.region("step"):
        h = be.launch(step, name="sleeps")
        with mon.offload():
            be.wait(h)
    r = mon.finalize()["step"]
    assert r.device_states[0]["idle"] >= 0.04, r.device_states
    assert 0 < r.device_states[0]["kernel"] < 0.01, r.device_states
    assert r.device.parallel_efficiency < 0.2


def test_cuda_activity_clock_agrees_with_cuda_events(cuda):
    """The activity records are moved onto the monitor clock through a
    marker kernel at the collection's open; the CUDA events are the
    yardstick. A sleep kernel queued behind another (so that the event
    before it and its start are not split by a launch) starts and ends
    within 50 us of the events around it, on every one of five tries spread
    over 0.3 s; a sleep kernel launched on the idle card lies inside the
    host's window around its launch and wait, within 50 us."""
    _check_activity_clock(cuda)


def test_cuda_activity_clock_after_a_profiler_session(cuda):
    """A torch.profiler session registers Kineto's timestamp callback, and
    CUPTI's records then count the CPU's time-stamp counter, not ns: the
    rows still agree with the CUDA events within 50 us."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
    _check_activity_clock(cuda)


def test_cuda_drain_reads_rows_in_well_under_a_us_each(cuda):
    """A drain of 20,000 kernel rows (CUPTI's forced flush, the rows'
    placement) takes under 0.1 s: reading them through torch.profiler's
    stop and events took about 27 us a row."""
    x = torch.ones(16, device=cuda)
    be = CudaRuntimeBackend(cuda)
    be.start()

    def many():
        for _ in range(20_000):
            x.add_(1)

    be.wait(be.launch(many))
    t0 = time.perf_counter()
    [(_, kinds, _, _, _)] = be.flush_arrays()
    took = time.perf_counter() - t0
    be.stop()
    assert len(kinds) == 20_000
    assert took < 0.1, took


def _check_activity_clock(cuda):
    be = CudaRuntimeBackend(cuda)
    be.start()

    def bracketed():
        torch.cuda._sleep(2_000_000)      # holds the queue while we enqueue
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        torch.cuda._sleep(1_000_000)
        e1.record()
        return e0, e1

    events, windows = [], []
    for _ in range(5):
        events.append(be.wait(be.launch(bracketed)))
        time.sleep(0.06)
    for _ in range(5):
        h0 = be.clock()
        be.wait(be.launch(torch.cuda._sleep, 1_000_000))
        windows.append((h0, be.clock()))
    [(_, kinds, starts, ends, _)] = be.flush_arrays()
    be.stop()
    assert len(kinds) == 15 and set(kinds) == {DeviceActivity.KERNEL.code}
    order = np.argsort(starts)
    for (e0, e1), i in zip(events, order[1:10:2]):
        assert abs(starts[i] - be._event_time(e0)) <= 50e-6
        assert abs(ends[i] - be._event_time(e1)) <= 50e-6
    for (h0, h1), i in zip(windows, order[10:]):
        assert h0 - 50e-6 <= starts[i] < ends[i] <= h1 + 50e-6


def test_cuda_activity_collection_closes_for_a_later_profiler(cuda):
    """finalize() closes the collection, so torch.profiler can open after a
    monitored run, as chip_smoke.py's profile phases do."""
    be = CudaRuntimeBackend(cuda)
    mon = TalpMonitor("t", backend=be)
    with mon.region("step"):
        be.wait(be.launch(lambda: torch.ones(8, device=cuda) * 2))
    mon.finalize()
    assert not be.activity.is_open
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(8, device=cuda).sum()


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


@pytest.mark.parametrize("row", SSD_SWEEP + SSD_RAGGED + SSD_EDGES + SSD_N64,
                         ids=[f"ssd{i}" for i in range(len(SSD_SWEEP))]
                         + [f"ragged{i}" for i in range(len(SSD_RAGGED))]
                         + [f"edge{i}" for i in range(len(SSD_EDGES))]
                         + [f"n64_{i}" for i in range(len(SSD_N64))])
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


# The SSD backward on the card: fp32 sweep rows, a ragged L with G > 1,
# mamba2-130m's head shape (P 64, N 128, chunk 256) in bf16 over two
# chunks and a ragged one, and N 64 with two groups. Every row takes an
# initial state and a final-state gradient.
SSD_BWD = [
    (1, 64, 2, 16, 1, 16, 16, torch.float32),
    (1, 128, 4, 64, 1, 64, 64, torch.float32),
    (2, 100, 4, 16, 2, 32, 64, torch.float32),
    (1, 600, 4, 64, 1, 128, 256, torch.bfloat16),
    (2, 300, 8, 64, 2, 64, 256, torch.bfloat16),
]


def _ssd_bwd_close(got, want, dtype, name):
    """fp32 elementwise at _tol; bf16 at _tol on the gradient divided by
    its reference's max-abs (dx, dB and dC are rounded to bf16 once)."""
    got, want = got.double(), want.double()
    if dtype == torch.bfloat16:
        m = want.abs().max().clamp_min(1e-30)
        got, want = got / m, want / m
    torch.testing.assert_close(got, want, **_tol(dtype), msg=name)


@pytest.mark.parametrize("row", SSD_BWD,
                         ids=[f"ssd_bwd{i}" for i in range(len(SSD_BWD))])
def test_cuda_ssd_backward_vs_float64_autograd(cuda, row):
    """Every gradient of ops.ssd on the card (SSDScan: the CUDA forward and
    backward) against autograd through the plain version evaluated in
    float64 on the same inputs; a second backward call is bit-identical."""
    b, l, h, p, g, n, chunk, dtype = row
    x, dt, a, bm, cm, d, s0 = _ssd_inputs(cuda, b, l, h, p, g, n, dtype)
    gen = torch.Generator(device=cuda).manual_seed(11)
    dy = torch.randn(x.shape, generator=gen, device=cuda).to(dtype)
    dfin = torch.randn(s0.shape, generator=gen, device=cuda)
    leaves = [t.clone().requires_grad_() for t in (x, dt, a, bm, cm, d, s0)]
    fwd = ssd_kernel.ssd_scan.launches
    bwd = ssd_kernel.ssd_scan_backward.launches
    y, s_out = ssd_ops.ssd(*leaves[:5], chunk=chunk, d_skip=leaves[5],
                           initial_state=leaves[6], return_final_state=True)
    got = torch.autograd.grad([y, s_out], leaves, [dy, dfin])
    assert ssd_kernel.ssd_scan.launches == fwd + 1
    assert ssd_kernel.ssd_scan_backward.launches == bwd + 1
    again = ssd_kernel.ssd_scan_backward(x, dt, a, bm, cm, dy, chunk, d, s0,
                                         dfin)
    up = [t.double().requires_grad_() for t in (x, dt, a, bm, cm, d, s0)]
    y64, s64 = ssd_ref.ssd_reference(*up[:5], chunk=chunk, d_skip=up[5],
                                     initial_state=up[6],
                                     return_final_state=True)
    want = torch.autograd.grad([y64, s64], up, [dy.double(), dfin.double()])
    torch.cuda.synchronize()
    for name, gg, ag, ww, t in zip(("dx", "ddt", "da", "dB", "dC", "dD",
                                    "ds0"), got, again, want,
                                   (x, dt, a, bm, cm, d, s0)):
        assert gg.dtype == t.dtype and gg.shape == t.shape, name
        assert torch.equal(gg, ag), f"{name}: two backward runs differ"
        _ssd_bwd_close(gg, ww, dtype, name)


def test_cuda_ssd_backward_on_unaligned_views_matches_aligned_copies(cuda):
    """bf16 x, dy, B and C and the fp32 initial state and final-state
    gradient that are not 16-byte aligned (views one element into a larger
    buffer) give, bit for bit, what the same call on aligned copies gives:
    the kernels move them 16 bytes at a time, so the wrapper copies such a
    tensor once."""
    b, l, h, p, g, n, chunk = 1, 300, 4, 64, 1, 128, 256
    x, dt, a, bm, cm, d, s0 = _ssd_inputs(cuda, b, l, h, p, g, n,
                                          torch.bfloat16)
    gen = torch.Generator(device=cuda).manual_seed(12)
    dy = torch.randn(x.shape, generator=gen, device=cuda).to(torch.bfloat16)
    dfin = torch.randn(s0.shape, generator=gen, device=cuda)

    def unaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16
        return view

    xv, bv, cv, dyv, s0v, dfv = map(unaligned, (x, bm, cm, dy, s0, dfin))
    before = ssd_kernel.ssd_scan_backward.launches
    got = ssd_kernel.ssd_scan_backward(xv, dt, a, bv, cv, dyv, chunk, d, s0v,
                                       dfv)
    want = ssd_kernel.ssd_scan_backward(x, dt, a, bm, cm, dy, chunk, d, s0,
                                        dfin)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_scan_backward.launches == before + 2
    for name, gg, ww in zip(("dx", "ddt", "da", "dB", "dC", "dD", "ds0"),
                            got, want):
        assert torch.equal(gg, ww), name


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


def test_cuda_zamba_smoke_decode_matches_cpu(cuda):
    """smoke_config("zamba2-2.7b") with head_dim 80 (the smoke 16 is no head
    dim the flash kernel takes): prefill of 40 tokens (a ragged SSD chunk)
    and 4 decode steps on the card (flash D 80 and the SSD kernel at P 16,
    N 16) against the CPU (plain versions), the same bf16 weights,
    rtol = atol = 0.15 as tests/test_torch_lm.py's bf16 parity; the two
    repeats of the shared block write their own KV rows."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(smoke_config("zamba2-2.7b"), head_dim=80)
    gen = torch.Generator().manual_seed(9)
    cpu_params = lm.init_params(cfg, gen, device="cpu", dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (2, 44), generator=gen,
                         dtype=torch.int32)
    outs, rows = [], []
    for dev in (torch.device("cpu"), cuda):
        params = lm.tree_map(lambda x: x.to(dev), cpu_params)
        fwd, ssd = kernel.flash_attention.launches, ssd_kernel.ssd_scan.launches
        with torch.inference_mode():
            logits, caches, pos = lm.prefill(cfg, params, toks[:, :40].to(dev))
            caches = lm.grow_caches(cfg, caches, 44)
            seq = [logits]
            for t in range(40, 44):
                logits, caches, pos = lm.decode_step(
                    cfg, params, toks[:, t:t + 1].to(dev), pos, caches)
                seq.append(logits)
        on_card = dev.type == "cuda"
        assert kernel.flash_attention.launches - fwd == 2 * on_card
        assert ssd_kernel.ssd_scan.launches - ssd == 10 * on_card
        outs.append(torch.stack(seq).float().cpu())
        rows.append(caches["slot5"]["k"].float().cpu())
    assert torch.isfinite(outs[1]).all()
    torch.testing.assert_close(outs[1], outs[0], rtol=0.15, atol=0.15)
    assert not torch.equal(rows[1][0], rows[1][1])
    torch.testing.assert_close(rows[1], rows[0], rtol=0.15, atol=0.15)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cuda_mamba_train_step_matches_cpu(cuda, compute_dtype):
    """One make_train_step step of smoke_config("mamba2-130m") (P 16, N 16,
    chunk 32) on the card, through the SSD forward (2 calls per layer with
    remat) and the SSD backward (1), against the same step on the CPU
    (the plain version under autograd) from the same state, with the
    criteria of test_cuda_train_step_matches_cpu."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig

    import dataclasses

    cfg = dataclasses.replace(smoke_config("mamba2-130m"),
                              compute_dtype=compute_dtype)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    cpu = init_train_state(cfg, torch.Generator().manual_seed(5), "cpu")
    gpu = lm.tree_map(
        lambda x: x.to(cuda, copy=True) if x.dim() else x.clone(), cpu)
    batch = SyntheticTokenPipeline(DataConfig(2, 96, cfg.vocab_size,
                                              seed=6)).batch_at(0)
    cpu_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    fwd = ssd_kernel.ssd_scan.launches
    bwd = ssd_kernel.ssd_scan_backward.launches
    new_gpu, m_gpu = make_train_step(cfg, opt)(
        gpu, {k: v.to(cuda) for k, v in cpu_batch.items()})
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_scan.launches == fwd + 2 * cfg.num_layers
    assert ssd_kernel.ssd_scan_backward.launches == bwd + cfg.num_layers
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
        ref_state = init_train_state(cfg32, torch.Generator().manual_seed(5),
                                     "cpu")
        g32 = _first_step_grads(*make_train_step(cfg32, opt)(ref_state,
                                                            cpu_batch), opt)
        tol = _tol(dtype)["atol"]
        for name, want in g32.items():
            card, plain = (_rel_norm(g[name], want) for g in (g_gpu, g_cpu))
            assert card <= 2 * plain + tol, (name, card, plain)


# ---------------------------------------------------------------------------
# TALP's runtime outputs on the card
# ---------------------------------------------------------------------------
PE_BOUND = 0.10   # chip_smoke.py::PE_BOUND


def test_cuda_computational_efficiency_counts_launches(cuda):
    """Five launches of four fp32 matmuls (2048³ each, TF32 off): the flop
    model's FLOPs are per launch, so CE is the matmuls' share of the fp32
    peak, in (0, 1], though CUPTI records every kernel (counting those
    rows in place of the launches would read four times as much)."""
    from repro_torch.core.backends import HardwareSpec, StepModel

    n = 2048
    x = torch.randn(n, n, device=cuda) / n ** 0.5
    fm = StepModel(flops=0.0, hbm_bytes=0.0, collective_bytes=0.0,
                   model_flops=4 * 2 * n ** 3,
                   hw=HardwareSpec(peak_flops=67e12))
    be = CudaRuntimeBackend(cuda)
    mon = TalpMonitor("ce", backend=be, flop_model=fm)

    def step(a):
        for _ in range(4):
            a = a @ x
        return a

    with mon.region("loop"):
        for _ in range(5):
            h = be.launch(step, x)
            with mon.offload():
                be.wait(h)
    ce = mon.finalize()["Global"].device.computational_efficiency
    assert be.launch_counts == {torch.cuda.current_device(): 5}
    assert mon.devices[0].n_kernel_records >= 20
    assert 0.2 < ce <= 1, ce


def test_cuda_decode_step_series_matches_the_profiler(cuda, tmp_path):
    """16 decode steps of the llama3.2-3b smoke config (head_dim 32) with
    --talp-step-series: the rows' mean device PE lies within PE_BOUND of
    the profiler's busy share, its kernel time per decode step over the
    rows' mean wall."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.core.merge import FileSpoolTransport
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm

    cfg = dataclasses.replace(smoke_config("llama3.2-3b"), head_dim=32)
    serve(cfg, requests=2, prompt_len=64, gen_len=16, verbose=False,
          device=cuda, talp_step_series=16, talp_spool=str(tmp_path))
    rows = FileSpoolTransport(str(tmp_path)).collect_steps()[0]
    assert len(rows) == 16
    pe = float(rows.column("device_parallel_efficiency").mean())
    wall = float(rows.column("elapsed").mean())

    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.inference_mode():
        params = lm.init_params(cfg, gen, device=cuda, dtype=torch.bfloat16)
        prompts = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                                device=cuda, dtype=torch.int32)
        logits, caches, pos = lm.prefill(cfg, params, prompts)
        caches = lm.grow_caches(cfg, caches, 80)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        lm.decode_step(cfg, params, tok, pos, caches)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                lm.decode_step(cfg, params, tok, pos, caches)
            torch.cuda.synchronize()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() != torch.autograd.DeviceType.CPU
                   and not e.is_user_annotation()
                   and not e.name().startswith(("Memcpy", "Memset")))
    busy, reach = 0, None
    for start, end in spans:
        if reach is None or start > reach:
            busy, reach = busy + end - start, end
        elif end > reach:
            busy, reach = busy + end - reach, end
    share = busy * 1e-9 / 8 / wall
    assert abs(pe - share) <= PE_BOUND, (pe, share)


def test_cuda_two_rank_training_job_report_equals_in_process_merge(
        cuda, tmp_path):
    """Two processes of one mamba2-130m smoke training job on the card,
    sharing a spool: the job report they publish equals InProcessGather's
    merge of their payloads, with two host-state rows and each rank's CE
    in (0, 1]."""
    import json
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from mp_harness import launch_fleet
    from repro_torch.core.merge import InProcessGather, load_spool_payload
    from repro_torch.core.report import to_json

    spool = tmp_path / "spool"
    res = launch_fleet(str(spool), n_ranks=2,
                       driver="repro_torch.launch.train",
                       extra_args=("--arch", "mamba2-130m", "--seq", "64",
                                   "--talp-step-series", "3"))
    assert res.ok, res.report()
    gather = InProcessGather(world_size=2)
    for rank in range(2):
        result = load_spool_payload(
            str(spool / f"talp_rank{rank:05d}.npz"))[0]
        ce = result.regions["Global"].device.computational_efficiency
        assert ce is not None and 0 < ce <= 1, (rank, ce)
        gather.submit(result, rank=rank)
    job = (spool / "talp_job.json").read_text()
    assert job == to_json(gather.merge(name="train"))
    assert len(json.loads(job)["regions"]["Global"]["host_states"]) == 2
