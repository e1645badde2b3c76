"""Tests of the port that need a CUDA card (marker ``gpu``); each skips
without one. They import no JAX, so they run on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The card's kernels take bf16 activations only: a kernel row written with
fp32 (the lists the CPU tests import and hold to the JAX package's) runs
here at bf16 (``_bf16``), keeping its shape, mask and soft-cap case, and a
model runs in bf16 compute, held to the CPU by ``card_rules``.
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

from card_rules import bf16_no_worse  # noqa: E402

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
    (1, 1000, 1000, 4, 2, 64, 256, 30.0, torch.bfloat16),
    (2, 100, 300, 8, 2, 32, None, None, torch.bfloat16),
    (1, 100, 300, 4, 2, 128, 50, None, torch.bfloat16),
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
# Head dim 80 (zamba2-2.7b's shared block: 2560 / 32, MHA), forward (D80_BWD
# below holds the backward): fp32 and bf16 MHA, GQA 2:1, S and T off the
# tile grid with S < T, window and soft-cap in both dtypes. tests/test_torch_flash_attention.py holds
# the plain version at these rows against the JAX package's.
D80 = [
    (1, 256, 256, 4, 4, 80, None, None, torch.float32),
    (2, 256, 256, 4, 4, 80, None, None, torch.bfloat16),
    (1, 256, 256, 8, 4, 80, None, None, torch.bfloat16),
    (1, 200, 328, 4, 2, 80, None, None, torch.bfloat16),
    (1, 256, 256, 4, 2, 80, 64, 30.0, torch.float32),
    (1, 384, 384, 4, 2, 80, 100, 50.0, torch.bfloat16),
]
# Head dims 120 (h2o-danube-3-4b: 3840 / 32, GQA 4:1) and 256 (gemma2-2b,
# GQA 2:1), forward and backward: fp32 and bf16 MHA, the model's GQA ratio,
# S and T off the tile grid with S < T, a window with a soft-cap in both
# dtypes, S below one query tile, and S < T with a window narrower than
# T - S, so that a whole key block is seen by no query row.
# tests/test_torch_flash_attention.py and test_torch_flash_backward.py hold
# the plain version at these rows against the JAX package's.
D120 = [
    (1, 256, 256, 4, 4, 120, None, None, torch.float32),
    (2, 256, 256, 4, 4, 120, None, None, torch.bfloat16),
    (1, 256, 256, 8, 2, 120, None, None, torch.bfloat16),
    (1, 200, 328, 8, 2, 120, None, None, torch.bfloat16),
    (1, 256, 256, 4, 1, 120, 64, 30.0, torch.float32),
    (1, 384, 384, 8, 2, 120, 100, 50.0, torch.bfloat16),
    (1, 40, 300, 4, 1, 120, None, None, torch.bfloat16),
    (1, 100, 400, 8, 2, 120, 64, 50.0, torch.bfloat16),
]
# Head dim 80 backward (zamba2-2.7b's shared block trains): the rows of
# D120 at D 80 and bf16, MHA and GQA 4:1 and 2:1.
D80_BWD = [
    (1, 256, 256, 4, 4, 80, None, None, torch.bfloat16),
    (2, 256, 256, 4, 4, 80, None, None, torch.bfloat16),
    (1, 256, 256, 8, 2, 80, None, None, torch.bfloat16),
    (1, 200, 328, 8, 4, 80, None, None, torch.bfloat16),
    (1, 256, 256, 4, 1, 80, 64, 30.0, torch.bfloat16),
    (1, 384, 384, 8, 2, 80, 100, 50.0, torch.bfloat16),
    (1, 40, 300, 4, 1, 80, None, None, torch.bfloat16),
    (1, 100, 400, 8, 4, 80, 64, 50.0, torch.bfloat16),
]
D256 = [
    (1, 256, 256, 4, 4, 256, None, None, torch.float32),
    (2, 256, 256, 4, 4, 256, None, None, torch.bfloat16),
    (1, 256, 256, 8, 4, 256, None, None, torch.bfloat16),
    (1, 200, 328, 8, 4, 256, None, None, torch.bfloat16),
    (1, 256, 256, 4, 2, 256, 64, 30.0, torch.float32),
    (1, 384, 384, 8, 4, 256, 100, 50.0, torch.bfloat16),
    (1, 40, 300, 4, 2, 256, None, None, torch.bfloat16),
    (1, 100, 400, 8, 4, 256, 64, 50.0, torch.bfloat16),
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
    (2, 100, 4, 16, 2, 32, 64, torch.bfloat16),
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
    # zamba2-7b's Mamba-2 layer: 112 heads of 64 in two groups, N 64
    (1, 1000, 112, 64, 2, 64, 256, torch.bfloat16),
]


def _tol(dtype):
    """tests/test_kernels.py::_tol."""
    t = 2e-2 if dtype == torch.bfloat16 else 2e-4
    return dict(rtol=t, atol=t)


def _bf16(rows):
    """``rows`` with their dtype field bf16, the one the card's kernels
    take."""
    return [row[:-1] + (torch.bfloat16,) for row in rows]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("row", _bf16(SWEEP) + RAGGED + EDGES + _bf16(D80)
                         + _bf16(D120) + _bf16(D256),
                         ids=[f"attn{i}" for i in range(len(SWEEP))]
                         + [f"ragged{i}" for i in range(len(RAGGED))]
                         + [f"edge{i}" for i in range(len(EDGES))]
                         + [f"d80_{i}" for i in range(len(D80))]
                         + [f"d120_{i}" for i in range(len(D120))]
                         + [f"d256_{i}" for i in range(len(D256))])
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


def _close_grads(got, want):
    """Each bf16 gradient over the reference gradient's max-abs, at
    _tol(bfloat16)."""
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
        m = w.float().abs().max().clamp_min(1e-30)
        torch.testing.assert_close(g.float() / m, w.float() / m,
                                   **_tol(torch.bfloat16))


@pytest.mark.parametrize("row", _bf16(SWEEP) + RAGGED + EDGES + _bf16(D120)
                         + _bf16(D256) + D80_BWD,
                         ids=[f"attn{i}" for i in range(len(SWEEP))]
                         + [f"ragged{i}" for i in range(len(RAGGED))]
                         + [f"edge{i}" for i in range(len(EDGES))]
                         + [f"d120_{i}" for i in range(len(D120))]
                         + [f"d256_{i}" for i in range(len(D256))]
                         + [f"d80_{i}" for i in range(len(D80_BWD))])
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
    _close_grads(got, want)
    _close_grads(got, [x.grad for x in leaves])
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


def test_cuda_backward_refuses_a_head_dim_it_lacks(cuda):
    """Head dim 96 is one neither kernel takes: the backward refuses it
    with ValueError before its library dispatches, launching nothing (its
    o and lse are placeholders: the forward refuses D 96 too)."""
    q, kk, vv, do = _attn_grad_inputs(cuda, 1, 128, 128, 4, 2, 96,
                                      torch.bfloat16)
    o = torch.zeros_like(q)
    lse = torch.zeros((1, 4, 128), dtype=torch.float32, device=cuda)
    before = kernel.flash_attention_backward.launches
    with pytest.raises(ValueError, match="head dim 96"):
        kernel.flash_attention_backward(q, kk, vv, o, lse, do)
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


@pytest.mark.parametrize("row", _bf16(SSD_SWEEP) + SSD_RAGGED + SSD_EDGES
                         + SSD_N64,
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


# The SSD backward on the card: sweep rows, a ragged L with G > 1,
# mamba2-130m's head shape (P 64, N 128, chunk 256) over two chunks and a
# ragged one, and N 64 with two groups. Every row takes an initial state
# and a final-state gradient.
SSD_BWD = [
    (1, 64, 2, 16, 1, 16, 16, torch.bfloat16),
    (1, 128, 4, 64, 1, 64, 64, torch.bfloat16),
    (2, 100, 4, 16, 2, 32, 64, torch.bfloat16),
    (1, 600, 4, 64, 1, 128, 256, torch.bfloat16),
    (2, 300, 8, 64, 2, 64, 256, torch.bfloat16),
    # zamba2-7b's Mamba-2 layer: 112 heads of 64 in two groups, N 64
    (1, 600, 112, 64, 2, 64, 256, torch.bfloat16),
]


def _ssd_bwd_close(got, want, name):
    """At bf16 _tol on the gradient divided by its reference's max-abs (dx,
    dB and dC are rounded to bf16 once)."""
    m = want.double().abs().max().clamp_min(1e-30)
    torch.testing.assert_close(got.double() / m, want.double() / m,
                               **_tol(torch.bfloat16), msg=name)


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
        _ssd_bwd_close(gg, ww, name)


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


def _grads_no_worse(g_card, g_cpu, g32):
    """bf16_no_worse leaf by leaf: the card's first-step gradient against
    the CPU's bf16 and fp32 ones."""
    for name, want in g32.items():
        bf16_no_worse(g_card[name], g_cpu[name], want, name)


def _cpu_fp32_step(cfg, opt, seed, batch):
    """make_train_step's first step of ``cfg`` in fp32 compute on the CPU
    from the state of ``seed``: (new state, metrics), the yardstick of
    bf16_no_worse."""
    import dataclasses

    from repro_torch.launch.steps import init_train_state, make_train_step

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    state = init_train_state(cfg32, torch.Generator().manual_seed(seed),
                             "cpu")
    return make_train_step(cfg32, opt)(state, batch)


def test_cuda_train_step_matches_cpu(cuda):
    """One make_train_step step of smoke_config("llama3.2-3b") (head_dim
    32: the kernels take no 16) in bf16 compute on the card, through the
    flash kernels (2 forwards per layer with remat, 1 backward), against
    the same step on the CPU from the same state: loss and grad norm
    within bf16 _tol; the gradient leaf by leaf, from the first moment,
    held to the CPU's fp32 gradient by bf16_no_worse (the plain version's
    own bf16 gradient lies 1e-2 to 2e-2 from the fp32 one). Params within
    fp32 _tol plus 2·lr (Adam's first step moves an element by about
    lr·sign(g))."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig

    cfg = dataclasses.replace(smoke_config("llama3.2-3b"), head_dim=32)
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
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(m_gpu[key].cpu(), m_cpu[key],
                                   **_tol(torch.bfloat16))
    _grads_no_worse(_first_step_grads(new_gpu, m_gpu, opt),
                    _first_step_grads(new_cpu, m_cpu, opt),
                    _first_step_grads(*_cpu_fp32_step(cfg, opt, 3, cpu_batch),
                                      opt))
    got = lm.tree_map(lambda x: x.cpu(), new_gpu["params"])

    def pairs(a, b):
        if isinstance(a, dict):
            for key in a:
                yield from pairs(a[key], b[key])
        else:
            yield a, b

    tol32 = _tol(torch.float32)["atol"]
    for g, w in pairs(got, new_cpu["params"]):
        torch.testing.assert_close(g, w, rtol=tol32, atol=2 * opt.lr + tol32)


def test_cuda_zamba_smoke_decode_matches_cpu(cuda):
    """smoke_config("zamba2-2.7b") with head_dim 80 (the smoke 16 is no head
    dim the flash kernel takes): prefill of 40 tokens (a ragged SSD chunk)
    and 4 decode steps on the card (flash D 80, the SSD kernel at P 16,
    N 16 and the conv kernel) against the CPU (plain versions), the same
    bf16 weights: the logits and the shared block's KV rows no further from
    the CPU's fp32 run of those weights than the CPU's bf16 run is
    (card_rules.bf16_no_worse: the card's conv rounds once where the plain
    version rounds after every op, and this model carries that ulp to some
    5% of the logits' norm); the two repeats of the shared block write
    their own KV rows."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(smoke_config("zamba2-2.7b"), head_dim=80)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    gen = torch.Generator().manual_seed(9)
    cpu_params = lm.init_params(cfg, gen, device="cpu", dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (2, 44), generator=gen,
                         dtype=torch.int32)
    outs, rows = [], []
    for dev, c, dtype in ((torch.device("cpu"), cfg, torch.bfloat16),
                          (torch.device("cpu"), cfg32, torch.float32),
                          (cuda, cfg, torch.bfloat16)):
        params = lm.tree_map(lambda x: x.to(dev, dtype), cpu_params)
        fwd, ssd = kernel.flash_attention.launches, ssd_kernel.ssd_scan.launches
        with torch.inference_mode():
            logits, caches, pos = lm.prefill(c, params, toks[:, :40].to(dev))
            caches = lm.grow_caches(c, caches, 44)
            seq = [logits]
            for t in range(40, 44):
                logits, caches, pos = lm.decode_step(
                    c, params, toks[:, t:t + 1].to(dev), pos, caches)
                seq.append(logits)
        on_card = dev.type == "cuda"
        assert kernel.flash_attention.launches - fwd == 2 * on_card
        assert ssd_kernel.ssd_scan.launches - ssd == 10 * on_card
        outs.append(torch.stack(seq).float().cpu())
        rows.append(caches["slot5"]["k"].float().cpu())
    assert torch.isfinite(outs[2]).all()
    bf16_no_worse(outs[2], outs[0], outs[1], "logits")
    assert not torch.equal(rows[2][0], rows[2][1])
    bf16_no_worse(rows[2], rows[0], rows[1], "shared-block KV rows")


def test_cuda_mamba_train_step_matches_cpu(cuda):
    """One make_train_step step of smoke_config("mamba2-130m") (P 16, N 16,
    chunk 32) in bf16 compute on the card, through the SSD forward (2
    calls per layer with remat) and the SSD backward (1), against the same
    step on the CPU (the plain version under autograd) from the same
    state: loss and grad norm within bf16 _tol, the gradient leaf by leaf
    held to the CPU's fp32 gradient by bf16_no_worse."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig

    cfg = smoke_config("mamba2-130m")
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
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(m_gpu[key].cpu(), m_cpu[key],
                                   **_tol(torch.bfloat16))
    _grads_no_worse(_first_step_grads(new_gpu, m_gpu, opt),
                    _first_step_grads(new_cpu, m_cpu, opt),
                    _first_step_grads(*_cpu_fp32_step(cfg, opt, 5, cpu_batch),
                                      opt))


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


# ---------------------------------------------------------------------------
# MoE and checkpoint/restart on the card
# ---------------------------------------------------------------------------
def _granite_smoke(**change):
    """smoke_config("granite-moe-3b-a800m") with head dim 64 (the smoke 16
    is no head dim the flash kernels take) and granite's own capacity
    factor, 1.25, at which tokens are dropped."""
    import dataclasses

    from repro_torch.configs import smoke_config

    return dataclasses.replace(smoke_config("granite-moe-3b-a800m"),
                               head_dim=64, capacity_factor=1.25, **change)


def _routings(cfg, run):
    """(result of ``run()``, each MoE call's (experts, capacity slots))."""
    from unittest import mock

    from repro_torch.models import moe

    seen, real = [], moe.route

    def spy(cfg_, router, xg):
        out = real(cfg_, router, xg)
        seen.append((out[2].cpu(), out[4].cpu()))
        return out

    with mock.patch.object(moe, "route", spy):
        return run(), seen


def test_cuda_granite_smoke_serving_routes_as_cpu(cuda):
    """The MoE model in bf16 on the card (flash forward at D 64, the MoE's
    einsums) against the CPU from the same weights: a 64-token prefill and
    4 decode steps route through every MoE call on both, tokens are
    dropped on both, and the logits are held to the CPU's fp32 run by
    bf16_no_worse; the flash forward runs once per layer in the prefill.
    bf16 router logits tie or nearly tie often, so the two roundings may
    pick different experts for some tokens: the share of (token, layer)
    routings that agree is printed, and the logits, which carry the flips'
    effect, are what is held."""
    import dataclasses

    from repro_torch.models import lm
    from repro_torch.models.moe import moe_capacity

    cfg = _granite_smoke()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    gen = torch.Generator().manual_seed(11)
    cpu_params = lm.init_params(cfg, gen, device="cpu", dtype=torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (2, 68), generator=gen,
                         dtype=torch.int32)
    outs, routes = [], []
    for dev, c, dtype in ((torch.device("cpu"), cfg, torch.bfloat16),
                          (torch.device("cpu"), cfg32, torch.float32),
                          (cuda, cfg, torch.bfloat16)):
        params = lm.tree_map(lambda x: x.to(dev, dtype), cpu_params)
        fwd = kernel.flash_attention.launches

        def run():
            with torch.inference_mode():
                logits, caches, pos = lm.prefill(c, params,
                                                 toks[:, :64].to(dev))
                caches = lm.grow_caches(c, caches, 68)
                seq = [logits]
                for t in range(64, 68):
                    logits, caches, pos = lm.decode_step(
                        c, params, toks[:, t:t + 1].to(dev), pos, caches)
                    seq.append(logits)
            return torch.stack(seq).float().cpu()

        out, seen = _routings(c, run)
        assert kernel.flash_attention.launches - fwd == (
            cfg.num_layers if dev.type == "cuda" else 0)
        outs.append(out)
        routes.append(seen)
    cpu, cpu32, card = outs
    assert torch.isfinite(card).all()
    assert len(routes[0]) == len(routes[2]) == 5 * cfg.num_layers
    c = moe_capacity(cfg, 64)
    for seen in (routes[0], routes[2]):
        assert any((s >= c).any() for _, s in seen[:cfg.num_layers])
    same = sum(int(((ei == ej).all(-1) & (si == sj).all(-1)).sum())
               for (ei, si), (ej, sj) in zip(routes[0], routes[2]))
    total = sum(ei[..., 0].numel() for ei, _ in routes[0])
    print(f"(token, layer) routings equal on card and CPU: {same} of {total}")
    bf16_no_worse(card, cpu, cpu32, "logits")


def test_cuda_granite_train_step_matches_cpu(cuda):
    """One bf16 make_train_step step of the MoE model on the card (both
    flash kernels at D 64) against the CPU from the same state: loss, grad
    norm and moe_aux held to the CPU's fp32 step by bf16_no_worse."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig

    cfg = _granite_smoke()
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    cpu = init_train_state(cfg, torch.Generator().manual_seed(3), "cpu")
    gpu = lm.tree_map(
        lambda x: x.to(cuda, copy=True) if x.dim() else x.clone(), cpu)
    batch = SyntheticTokenPipeline(DataConfig(2, 64, cfg.vocab_size,
                                              seed=4)).batch_at(0)
    cpu_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    bwd = kernel.flash_attention_backward.launches
    _, m_gpu = make_train_step(cfg, opt)(
        gpu, {k: v.to(cuda) for k, v in cpu_batch.items()})
    torch.cuda.synchronize()
    assert kernel.flash_attention_backward.launches == bwd + cfg.num_layers
    _, m_cpu = make_train_step(cfg, opt)(cpu, cpu_batch)
    _, m32 = _cpu_fp32_step(cfg, opt, 3, cpu_batch)
    for key in ("loss", "grad_norm", "moe_aux"):
        bf16_no_worse(m_gpu[key].cpu(), m_cpu[key], m32[key], key)


def test_cuda_resume_after_a_failure_is_bit_identical(cuda, tmp_path):
    """The MoE smoke model trained on the card for 6 steps with a
    checkpoint every 3 and a failure injected before step 4, restarted by
    run_with_restarts (the failed run's CUPTI collection is closed, so the
    second opens its own): the resumed steps' losses and grad norms and
    the final state are bit-identical to an uninterrupted run's; a restored
    checkpoint is bit-identical to the state it was written from, its float
    leaves on the card and its counts on the CPU."""
    from repro_torch.checkpoint import checkpointer
    from repro_torch.launch.steps import train_state_devices
    from repro_torch.launch.train import train
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import run_with_restarts

    cfg = _granite_smoke()
    kw = dict(steps=6, global_batch=2, seq_len=64, verbose=False,
              opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6),
              device=cuda)
    full, h_full, _ = train(cfg, **kw)
    runs = []
    report = run_with_restarts(lambda i: runs.append(train(
        cfg, ckpt_dir=str(tmp_path), ckpt_every=3,
        fail_at_step=4 if i == 0 else None, **kw)), max_restarts=1)
    assert report.restarts == 1
    state, h_res, result = runs[0]
    assert [h["step"] for h in h_res] == [3, 4, 5]
    for got, want in zip(h_res, h_full[3:]):
        assert (got["loss"], got["grad_norm"]) == (want["loss"],
                                                   want["grad_norm"])
    assert result.regions["train_loop"].device_states[0]["kernel"] > 0
    got = dict(checkpointer.flatten_with_keys(state))
    for key, want in checkpointer.flatten_with_keys(full):
        assert torch.equal(got[key], want), key
    restored = checkpointer.restore_checkpoint(
        str(tmp_path), 5, state, train_state_devices(state, cuda))
    for key, leaf in checkpointer.flatten_with_keys(restored):
        assert leaf.device.type == ("cuda" if leaf.is_floating_point()
                                    else "cpu"), key
        assert torch.equal(leaf, got[key]), key


# ---------------------------------------------------------------------------
# The embed frontend, M-RoPE and the new model heads on the card
# ---------------------------------------------------------------------------
# The flash kernels at this slice's head layouts: musicgen-large's MHA with
# H = K = 32 at D 64, starcoder2-15b's GQA 48/4 (ratio 12) and qwen2-vl-72b's
# 64/8 at D 128; a ragged S < T row each for the first two.
NEW_HEADS = [
    (1, 512, 512, 32, 32, 64, None, None, torch.bfloat16),
    (1, 300, 428, 32, 32, 64, None, None, torch.bfloat16),
    (1, 512, 512, 48, 4, 128, None, None, torch.bfloat16),
    (1, 300, 428, 48, 4, 128, None, None, torch.bfloat16),
    (1, 512, 512, 64, 8, 128, None, None, torch.bfloat16),
]


@pytest.mark.parametrize("row", NEW_HEADS,
                         ids=[f"heads{i}" for i in range(len(NEW_HEADS))])
def test_cuda_kernel_vs_plain_at_new_model_heads(cuda, row):
    test_cuda_kernel_vs_plain(cuda, row)


@pytest.mark.parametrize("row", NEW_HEADS[:2],
                         ids=["mha32_d64", "mha32_d64_ragged"])
def test_cuda_backward_vs_plain_at_musicgen_heads(cuda, row):
    """The flash backward at musicgen-large's H = K = 32, D 64."""
    test_cuda_backward_vs_plain(cuda, row)


def test_cuda_mrope_matches_cpu_at_d128(cuda):
    """apply_mrope on the card against the CPU at qwen2-vl-72b's D 128,
    sections (16, 24, 24) and rope theta, three distinct position streams;
    fp32 within _tol."""
    from repro_torch.models.common import apply_mrope

    gen = torch.Generator().manual_seed(12)
    x = torch.randn((2, 64, 8, 128), generator=gen)
    pos = torch.randint(0, 8192, (3, 2, 64), generator=gen, dtype=torch.int32)
    want = apply_mrope(x, pos, (16, 24, 24), 1e6)
    got = apply_mrope(x.to(cuda), pos.to(cuda), (16, 24, 24), 1e6)
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, **_tol(torch.float32))


@pytest.mark.parametrize("arch,head_dim", [("musicgen-large", 64),
                                           ("qwen2-vl-72b", 128)])
def test_cuda_embed_smoke_decode_matches_cpu(cuda, arch, head_dim):
    """The ``embed`` frontend on the card: the smoke config with a head dim
    the flash kernels take (musicgen-large at its D 64; qwen2-vl-72b at its
    D 128 with its published M-RoPE sections (16, 24, 24)), prefill of 2 x
    72 bf16 embeddings and 4 decode steps on embedded frames against the
    CPU (plain attention), the same bf16 weights, rtol = atol = 0.15 as
    tests/test_torch_lm.py's bf16 parity; the flash forward runs once a
    layer in the prefill on the card, never on the CPU."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import lm

    change = dict(head_dim=head_dim)
    if arch == "qwen2-vl-72b":
        change["mrope_sections"] = (16, 24, 24)
    cfg = dataclasses.replace(smoke_config(arch), **change)
    gen = torch.Generator().manual_seed(13)
    cpu_params = lm.init_params(cfg, gen, device="cpu", dtype=torch.bfloat16)
    emb = torch.randn((2, 76, cfg.d_model), generator=gen).to(torch.bfloat16)
    outs = []
    for dev in (torch.device("cpu"), cuda):
        params = lm.tree_map(lambda x: x.to(dev), cpu_params)
        fwd = kernel.flash_attention.launches
        with torch.inference_mode():
            logits, caches, pos = lm.prefill(cfg, params, emb[:, :72].to(dev))
            caches = lm.grow_caches(cfg, caches, 76)
            seq = [logits]
            for t in range(72, 76):
                logits, caches, pos = lm.decode_step(
                    cfg, params, emb[:, t:t + 1].to(dev), pos, caches)
                seq.append(logits)
        assert kernel.flash_attention.launches - fwd == (
            cfg.num_layers if dev.type == "cuda" else 0)
        outs.append(torch.stack(seq).float().cpu())
    assert torch.isfinite(outs[1]).all()
    torch.testing.assert_close(outs[1], outs[0], rtol=0.15, atol=0.15)


# ---------------------------------------------------------------------------
# Head dims 120 (h2o-danube-3-4b) and 256 (gemma2-2b) on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d,h,k", [(120, 32, 8), (256, 8, 4)],
                         ids=["danube_d120", "gemma2_d256"])
def test_cuda_ops_attention_gradients_reach_qkv_at_new_dims(cuda, d, h, k):
    """ops.attention under grad mode at each model's head layout, window
    4096 and gemma2's soft-cap where it has one: one forward and one
    backward launch, the gradients those of the backward kernels, nonzero
    on q, k and v, and within bf16 _tol of autograd through the plain
    version."""
    softcap = 50.0 if d == 256 else None
    cfg = dict(causal=True, window=96, softcap=softcap)
    q, kk, vv, do = _attn_grad_inputs(cuda, 1, 320, 320, h, k, d,
                                      torch.bfloat16)
    leaves = [x.clone().requires_grad_() for x in (q, kk, vv)]
    fwd = kernel.flash_attention.launches
    bwd = kernel.flash_attention_backward.launches
    ops.attention(*leaves, **cfg).backward(do)
    assert kernel.flash_attention.launches == fwd + 1
    assert kernel.flash_attention_backward.launches == bwd + 1
    o, lse = kernel.flash_attention(q, kk, vv, return_lse=True, **cfg)
    want = kernel.flash_attention_backward(q, kk, vv, o, lse, do, **cfg)
    plain = [x.float().requires_grad_() for x in (q, kk, vv)]
    ref.attention_reference(*plain, **cfg).backward(do.float())
    torch.cuda.synchronize()
    assert all(torch.equal(x.grad, w) for x, w in zip(leaves, want))
    assert all(x.grad.abs().max() > 0 for x in leaves)
    _close_grads([x.grad for x in leaves], [x.grad for x in plain])


# ---------------------------------------------------------------------------
# Phase spans inside the train step (core/telemetry/phases.py) on the card
# ---------------------------------------------------------------------------
def test_cuda_phase_window_matches_the_sleep_kernels_row(cuda):
    """A span around a sleep kernel queued behind another (so that the
    span's first event and the kernel's start are not split by a launch):
    its device window, read through the backend's anchor at the drain,
    lies within 50 us of the kernel's CUPTI row at both ends, on each of
    three launches."""
    from repro_torch.core.telemetry import phases

    be = CudaRuntimeBackend(cuda)
    be.start()

    def step():
        torch.cuda._sleep(2_000_000)      # holds the queue while we enqueue
        with phases.section("sleep"):
            torch.cuda._sleep(1_000_000)

    for _ in range(3):
        be.wait(be.launch(step))
        time.sleep(0.02)
    [(_, kinds, starts, ends, _)] = be.flush_arrays()
    be.stop()
    assert len(kinds) == 6
    spans = be.phases.spans()
    assert [s.name for s in spans] == ["sleep"] * 3
    order = np.argsort(starts)
    for span, i in zip(spans, order[1::2]):
        assert abs(span.d0 - starts[i]) <= 50e-6, (span, starts[i])
        assert abs(span.d1 - ends[i]) <= 50e-6, (span, ends[i])


def _phased_mamba_steps(cuda, steps=4):
    """``steps`` steps of smoke_config("mamba2-130m") at 2 x 96 under
    TalpOutputs, launched and waited as the trainer does; the monitor and
    the backend, finished."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.launch.talp_outputs import TalpOutputs
    from repro_torch.optim.adamw import AdamWConfig

    cfg = smoke_config("mamba2-130m")
    state = init_train_state(
        cfg, torch.Generator(device=cuda).manual_seed(5), device=cuda)
    data = SyntheticTokenPipeline(DataConfig(2, 96, cfg.vocab_size, seed=6))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=steps))
    be = CudaRuntimeBackend(cuda)
    talp = TalpOutputs("train", be, "step", lambda: 0.0, verbose=False)
    mon = talp.mon
    with mon.region("train_loop"):
        for i in range(steps):
            batch = {k: torch.from_numpy(v).to(cuda)
                     for k, v in data.batch_at(i).items()}
            h = be.launch(step, state, batch, name="train_step")
            with mon.offload():
                state, metrics = be.wait(h)
            float(metrics["loss"])
    talp.finish(None)
    return mon, be


def _tiles(be):
    spans = be.phases.spans()
    return sorted([(s.d0, s.d1) for s in spans]
                  + [(g.d0, g.d1) for g in be.phases.outside])


def test_cuda_phase_windows_and_outside_tile_the_steps(cuda):
    """Four real steps: forward, backward and adamw in each, the markers
    and the spans' bookkeeping charged (2 and 6 sections a step); their
    device windows and the 3 ``outside`` gaps do not overlap and cover at
    least 99% of the device time from the first forward to the last
    adamw; each span's busy plus idle is its window."""
    steps = 4
    mon, be = _phased_mamba_steps(cuda, steps)
    spans = be.phases.spans()
    assert [s.name for s in spans] == ["forward", "backward",
                                       "adamw"] * steps
    assert len(be.phases.outside) == steps - 1
    assert mon.overhead.counts["mark"] == 2 * steps
    assert mon.overhead.counts["phases"] == 6 * steps
    tiles = _tiles(be)
    for (a0, a1), (b0, b1) in zip(tiles, tiles[1:]):
        assert a0 <= a1 <= b0 + 1e-6 and b0 <= b1
    whole = tiles[-1][1] - tiles[0][0]
    assert sum(b - a for a, b in tiles) >= 0.99 * whole
    for s in spans + be.phases.outside:
        assert s.busy >= 0 and s.idle >= -1e-9
        assert s.busy + s.idle == pytest.approx(s.d1 - s.d0, abs=1e-9)


def test_cuda_phase_busy_sums_to_talps_device_busy(cuda):
    """The busy time of the phases and ``outside`` together is within 1%
    of TALP's device busy (the union of its Kernel and Memory rows) from
    the first forward's device start to the last adamw's device end."""
    from repro_torch.core import intervals as ivx

    mon, be = _phased_mamba_steps(cuda)
    kernel, memory = mon._device_flats()[be._ordinal]
    tiles = _tiles(be)
    talp_busy = ivx.window_total(ivx.union(kernel, memory), tiles[0][0],
                                 tiles[-1][1])
    ours = sum(s.busy for s in be.phases.spans() + be.phases.outside)
    assert talp_busy > 0
    assert ours == pytest.approx(talp_busy, rel=0.01)


# ---------------------------------------------------------------------------
# The fused AdamW (kernels/adamw) against the plain update
# ---------------------------------------------------------------------------
# Leaf sizes: 1, 7 and 4,099 (all below the 8-element vector or with a
# tail), 2^20 + 3, and one above 2^27 elements (many blocks, a tail); and
# 4,099 elements whose four tensors start 4 bytes past a 16-byte boundary
# (the scalar loop).
ADAMW_SIZES = (1, 7, 4099, 2 ** 20 + 3, 2 ** 27 + 5)
ADAMW_UNALIGNED = 4099


def _adamw_tree(cuda, grad_dtype, grad_scale, seed=0):
    """(params, grads, opt state) of ADAMW_SIZES and the unaligned leaf,
    moments from a few steps' worth of noise (nu >= 0), gradients times
    ``grad_scale``."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def leaf(n, offset=0):
        t = torch.empty(n + offset, device=cuda)[offset:]
        return t.normal_(generator=gen)

    params, grads, mu, nu = {}, {}, {}, {}
    names = [f"n{n}" for n in ADAMW_SIZES] + ["unaligned"]
    for name, n in zip(names, ADAMW_SIZES + (ADAMW_UNALIGNED,)):
        off = 1 if name == "unaligned" else 0
        params[name] = leaf(n, off)
        mu[name] = leaf(n, off).mul_(1e-2)
        nu[name] = leaf(n, off).square_().mul_(1e-4)
        g = leaf(n, off).mul_(grad_scale)
        grads[name] = g if grad_dtype == torch.float32 else (
            torch.empty(n + off, dtype=grad_dtype, device=cuda)[off:]
            .copy_(g))
    assert params["unaligned"].data_ptr() % 16 != 0
    state = {"mu": mu, "nu": nu, "count": torch.tensor(3, dtype=torch.int32)}
    return params, grads, state


# The fused update's error on a leaf may reach this share of the largest
# element of the plain update's change to the leaf, plus 4 eps of the
# value: the change, and not only the value, is compared, so that a pass
# that writes nothing or half a step fails wherever the step is far below
# _tol (the moments' change is).
ADAMW_CHANGE_TOL = 1e-3


def _assert_change_close(got, want, start, msg):
    """``got`` within ADAMW_CHANGE_TOL of the change ``want - start`` (its
    largest element) and 4 eps of the value, leaf by leaf."""
    for name in want:
        change = (want[name] - start[name]).abs().max().item()
        assert change > 0, (msg, name)
        torch.testing.assert_close(
            got[name], want[name], rtol=4 * torch.finfo(torch.float32).eps,
            atol=ADAMW_CHANGE_TOL * change, msg=f"{msg} {name}")


def _adamw_copy(tree):
    """A copy that keeps each leaf's offset from a 16-byte boundary."""
    if isinstance(tree, dict):
        return {k: _adamw_copy(v) for k, v in tree.items()}
    if tree.dim() == 0 or tree.data_ptr() % 16 == 0:
        return tree.clone()
    off = (tree.data_ptr() % 16) // tree.element_size()
    return torch.empty(tree.numel() + off, dtype=tree.dtype,
                       device=tree.device)[off:].copy_(tree)


@pytest.mark.parametrize("grad_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("clip", [True, False], ids=["clip", "noclip"])
def test_cuda_fused_adamw_matches_plain(cuda, grad_dtype, clip):
    """Two steps of the fused update (optim.adamw.adamw_update on CUDA
    leaves) against adamw_update_reference on copies of the same state:
    each step's grad norm and lr, and p, mu, nu after both, at fp32 _tol;
    with clipping on (norm about 1.2e4, scale below 1e-4) and off (the
    gradients scaled to a norm below grad_clip)."""
    from repro_torch.kernels.adamw import kernel as fused
    from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                         adamw_update_reference)

    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    params, grads, state = _adamw_tree(cuda, grad_dtype,
                                       1.0 if clip else 1e-5)
    ref_params, ref_state = _adamw_copy(params), _adamw_copy(state)
    start_params, start_state = _adamw_copy(params), _adamw_copy(state)
    before = (fused.adamw_norm.launches, fused.adamw_update.launches)
    for _ in range(2):
        _, state, m = adamw_update(opt, params, grads, state)
        _, ref_state, m_ref = adamw_update_reference(opt, ref_params, grads,
                                                     ref_state)
        torch.cuda.synchronize()
        scale = min(1.0, opt.grad_clip / float(m_ref["grad_norm"]))
        assert (scale < 1e-3) if clip else scale == 1.0, scale
        torch.testing.assert_close(m["grad_norm"], m_ref["grad_norm"],
                                   **_tol(torch.float32))
        assert float(m["lr"]) == float(m_ref["lr"])
    assert (fused.adamw_norm.launches, fused.adamw_update.launches) == (
        before[0] + 2, before[1] + 2)
    for part, got, want in (("p", params, ref_params),
                            ("mu", state["mu"], ref_state["mu"]),
                            ("nu", state["nu"], ref_state["nu"])):
        for name in got:
            torch.testing.assert_close(got[name], want[name],
                                       **_tol(torch.float32),
                                       msg=f"{part} {name}")
    _assert_change_close(params, ref_params, start_params, "p")
    for part in ("mu", "nu"):
        _assert_change_close(state[part], ref_state[part], start_state[part],
                             part)


def test_cuda_fused_adamw_many_leaves_of_both_gradient_dtypes(cuda):
    """A tree of 150 leaves (every seventh empty, sizes up to 19,522), a
    third of the gradients bf16 and the rest fp32, every fifth leaf one
    element off a 16-byte boundary: the kernels take it in three batches
    (64 fp32 leaves, the other 22, the 42 bf16 ones), and two steps change
    every leaf as the plain update does (ADAMW_CHANGE_TOL), the norm at
    fp32 _tol."""
    from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                         adamw_update_reference)

    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    gen = torch.Generator(device=cuda).manual_seed(3)

    def leaf(n, off, dtype=torch.float32):
        t = torch.empty(n + off, dtype=dtype, device=cuda)[off:]
        return t.copy_(torch.randn(n, generator=gen, device=cuda))

    params, grads, mu, nu = {}, {}, {}, {}
    for i in range(150):
        name = f"leaf{i:03d}"
        n, off = (0 if i % 7 == 0 else 131 * i + 3), int(i % 5 == 1)
        params[name] = leaf(n, off)
        grads[name] = leaf(n, off, torch.bfloat16 if i % 3 == 0
                           else torch.float32)
        mu[name] = leaf(n, off).mul_(1e-2)
        nu[name] = leaf(n, off).square_().add_(0.5).mul_(1e-4)
    state = {"mu": mu, "nu": nu, "count": torch.tensor(3, dtype=torch.int32)}
    ref_params, ref_state = _adamw_copy(params), _adamw_copy(state)
    start_params, start_state = _adamw_copy(params), _adamw_copy(state)
    for _ in range(2):
        _, state, m = adamw_update(opt, params, grads, state)
        _, ref_state, m_ref = adamw_update_reference(opt, ref_params, grads,
                                                     ref_state)
        torch.testing.assert_close(m["grad_norm"], m_ref["grad_norm"],
                                   **_tol(torch.float32))
    torch.cuda.synchronize()
    nonempty = [k for k in params if params[k].numel()]
    pick = lambda tree: {k: tree[k] for k in nonempty}  # noqa: E731
    _assert_change_close(pick(params), pick(ref_params), pick(start_params),
                         "p")
    for part in ("mu", "nu"):
        _assert_change_close(pick(state[part]), pick(ref_state[part]),
                             pick(start_state[part]), part)


def test_cuda_fused_adamw_reruns_are_bit_identical(cuda):
    """The same step on two copies of one state (bf16 gradients, clipping
    on): the norm and every element of p, mu and nu bit for bit."""
    from repro_torch.optim.adamw import AdamWConfig, adamw_update

    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    params, grads, state = _adamw_tree(cuda, torch.bfloat16, 1.0, seed=1)
    runs = []
    for _ in range(2):
        p, s = _adamw_copy(params), _adamw_copy(state)
        _, s, m = adamw_update(opt, p, grads, s)
        torch.cuda.synchronize()
        runs.append((m["grad_norm"], p, s["mu"], s["nu"]))
    (n0, *trees0), (n1, *trees1) = runs
    assert torch.equal(n0, n1)
    for a, b in zip(trees0, trees1):
        for name in a:
            assert torch.equal(a[name], b[name]), name


def test_cuda_fused_adamw_refuses_what_it_does_not_take(cuda):
    """A CPU leaf among CUDA ones, a non-contiguous leaf and a bf16
    parameter each raise ValueError before any launch."""
    from repro_torch.kernels.adamw import kernel as fused

    p = torch.zeros(64, device=cuda)
    g = torch.zeros(64, dtype=torch.bfloat16, device=cuda)
    sumsq = fused.adamw_norm([g])
    kw = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
              grad_clip=1.0, b1c=0.1, b2c=0.05)
    before = fused.adamw_update.launches
    for args in (([p], [g.cpu()], [p.clone()], [p.clone()]),
                 ([torch.zeros(64, 2, device=cuda).t()],
                  [torch.zeros(2, 64, device=cuda)],
                  [torch.zeros(2, 64, device=cuda)],
                  [torch.zeros(2, 64, device=cuda)]),
                 ([p.bfloat16()], [g], [p.clone()], [p.clone()])):
        with pytest.raises(ValueError):
            fused.adamw_update(*args, sumsq, **kw)
    assert fused.adamw_update.launches == before


def test_cuda_fused_adamw_launches_once_a_step(cuda):
    """A make_train_step step of smoke_config("mamba2-130m") on the card
    moves adamw_norm and adamw_update by one each (launch_counts()), and
    the SSD and conv kernels by their counts."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim.adamw import AdamWConfig

    cfg = smoke_config("mamba2-130m")
    state = init_train_state(cfg, torch.Generator(device=cuda).manual_seed(2),
                             cuda)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in
             SyntheticTokenPipeline(DataConfig(2, 96, cfg.vocab_size,
                                               seed=6)).batch_at(0).items()}
    step = make_train_step(cfg, AdamWConfig())
    before = launch_counts()
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in launch_counts().items()}
    assert moved == {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
                     "ssd_fwd": 4 * cfg.num_layers,
                     "ssd_bwd": 2 * cfg.num_layers,
                     "adamw_norm": 2, "adamw_update": 2,
                     "causal_conv_fwd": 4 * cfg.num_layers,
                     "causal_conv_bwd": 2 * cfg.num_layers}, moved


def test_cuda_mamba_three_steps_fused_adamw_match_plain(cuda):
    """Three make_train_step steps of smoke_config("mamba2-130m") in bf16
    compute on the card from one state, with the fused AdamW and with
    adamw_update_reference in its place: every step's loss and grad norm
    within bf16 _tol; after the steps the moments within fp32 _tol, and
    the parameters within fp32 _tol plus 2·lr (a parameter an ulp apart
    after step 1 can round its bf16 cast the other way, and Adam moves an
    element by about lr·sign(g))."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, adamw_update_reference

    cfg = smoke_config("mamba2-130m")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    start = init_train_state(cfg, torch.Generator(device=cuda).manual_seed(4),
                             cuda)
    data = SyntheticTokenPipeline(DataConfig(2, 96, cfg.vocab_size, seed=8))
    runs = []
    for plain in (False, True):
        state = lm.tree_map(lambda x: x.clone(), start)
        history = []
        with pytest.MonkeyPatch.context() as mp:
            if plain:
                mp.setattr(steps_mod, "adamw_update", adamw_update_reference)
            step = make_train_step(cfg, opt)
            for i in range(3):
                batch = {k: torch.from_numpy(v).to(cuda)
                         for k, v in data.batch_at(i).items()}
                state, m = step(state, batch)
                history.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((history, state))
    (h_fused, s_fused), (h_plain, s_plain) = runs
    torch.testing.assert_close(torch.tensor(h_fused), torch.tensor(h_plain),
                               **_tol(torch.bfloat16))
    tol32 = _tol(torch.float32)["atol"]

    def pairs(a, b):
        if isinstance(a, dict):
            for key in a:
                yield from pairs(a[key], b[key])
        else:
            yield a, b

    for part in ("mu", "nu"):
        for got, want in pairs(s_fused["opt"][part], s_plain["opt"][part]):
            torch.testing.assert_close(got, want, rtol=tol32, atol=tol32)
    for got, want in pairs(s_fused["params"], s_plain["params"]):
        torch.testing.assert_close(got, want, rtol=tol32,
                                   atol=2 * opt.lr + tol32)


# Head dim 224 (zamba2-7b's shared blocks: 7168 / 32, MHA; the D-256 tiles
# over TMA's zero columns 224-255) with Zamba-2's softmax scale (D/2)^-1/2,
# forward and backward: the D256 rows at D 224 and bf16, and one row at the
# default scale D^-1/2.
ZAMBA_SCALE = (224 / 2) ** -0.5
D224 = [
    (1, 256, 256, 4, 4, 224, None, None, torch.bfloat16, ZAMBA_SCALE),
    (2, 256, 256, 4, 4, 224, None, None, torch.bfloat16, ZAMBA_SCALE),
    (1, 256, 256, 8, 4, 224, None, None, torch.bfloat16, ZAMBA_SCALE),
    (1, 200, 328, 8, 4, 224, None, None, torch.bfloat16, ZAMBA_SCALE),
    (1, 256, 256, 4, 2, 224, 64, 30.0, torch.bfloat16, ZAMBA_SCALE),
    (1, 384, 384, 8, 4, 224, 100, 50.0, torch.bfloat16, ZAMBA_SCALE),
    (1, 40, 300, 4, 2, 224, None, None, torch.bfloat16, ZAMBA_SCALE),
    (1, 100, 400, 8, 4, 224, 64, 50.0, torch.bfloat16, ZAMBA_SCALE),
    (1, 256, 256, 4, 4, 224, None, None, torch.bfloat16, None),
]


@pytest.mark.parametrize("row", D224,
                         ids=[f"d224_{i}" for i in range(len(D224))])
def test_cuda_d224_with_a_scale_vs_plain(cuda, row):
    """At head dim 224 with the scale as a kernel argument: the forward's
    output at the dtype's _tol and its LSE at fp32 _tol against the plain
    version's at the same scale; dq, dk, dv against the plain backward
    and autograd in fp32, a second backward run bit-identical; and
    ops.attention's autograd path (FlashAttention) giving the same."""
    b, s, t, h, k, d, window, softcap, dtype, scale = row
    q, kk, vv, do = _attn_grad_inputs(cuda, b, s, t, h, k, d, dtype)
    cfg = dict(causal=True, window=window, softcap=softcap, scale=scale)
    o, lse = kernel.flash_attention(q, kk, vv, return_lse=True, **cfg)
    o_want, lse_want = ref.attention_reference_lse(q, kk, vv, **cfg)
    got = kernel.flash_attention_backward(q, kk, vv, o, lse, do, **cfg)
    again = kernel.flash_attention_backward(q, kk, vv, o, lse, do, **cfg)
    up = [x.float() for x in (q, kk, vv, o)]
    want = ref.attention_backward_reference(*up, lse, do.float(), **cfg)
    leaves = [x.float().requires_grad_() for x in (q, kk, vv)]
    ref.attention_reference(*leaves, **cfg).backward(do.float())
    mine = [x.detach().clone().requires_grad_() for x in (q, kk, vv)]
    ops.attention(*mine, **cfg).backward(do)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_want.float(), **_tol(dtype))
    torch.testing.assert_close(lse, lse_want, **_tol(torch.float32))
    _close_grads(got, want)
    _close_grads(got, [x.grad for x in leaves])
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert all(torch.equal(x.grad, y) for x, y in zip(mine, got))


def test_cuda_d224_scale_is_not_the_default(cuda):
    """The kernel applies the scale it is given: at (D/2)^-1/2 its output
    leaves the default-scale plain version by far more than _tol."""
    q, kk, vv, _ = _attn_grad_inputs(cuda, 1, 256, 256, 4, 4, 224,
                                     torch.bfloat16)
    got = kernel.flash_attention(q, kk, vv, scale=ZAMBA_SCALE)
    default = ref.attention_reference(q, kk, vv)
    torch.cuda.synchronize()
    err = (got.float() - default.float()).abs().max().item()
    assert err > 10 * _tol(torch.bfloat16)["atol"]


def test_cuda_zamba2_7b_smoke_train_step_and_decode_match_cpu(cuda):
    """smoke_config("zamba2-7b") at head dim 32 (2M / H; the kernels take
    no 16) and 24 layers (four applications of two shared blocks) in bf16
    compute: one make_train_step step on the card (flash D 32 twice an
    application with remat and a backward, the SSD pair at G 2, the conv
    kernels) against the CPU from the same state; then, at the smoke
    depth (12 layers, both blocks once: bf16 rounding on two paths grows
    with depth), prefill of 40 tokens and 4 decode steps through the grown
    caches on both from fresh weights. The card's loss, grad norm and
    logits are held to the CPU's fp32 run by bf16_no_worse: this model's
    bf16 roundings alone move its grad norm by percents (the card's conv
    rounds once where the plain version rounds after every op)."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig

    cfg = dataclasses.replace(smoke_config("zamba2-7b"), head_dim=32,
                              num_layers=24)
    apps = cfg.hybrid_applications
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
    assert kernel.flash_attention.launches == fwd + 2 * apps
    assert kernel.flash_attention_backward.launches == bwd + apps
    new_cpu, m_cpu = make_train_step(cfg, opt)(cpu, cpu_batch)
    _, m32 = _cpu_fp32_step(cfg, opt, 3, cpu_batch)
    for key in ("loss", "grad_norm"):
        bf16_no_worse(m_gpu[key].cpu(), m_cpu[key], m32[key], key)
    toks = torch.from_numpy(batch["inputs"][:, :44])
    cfg = dataclasses.replace(cfg, num_layers=12)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    fresh = init_train_state(cfg, torch.Generator().manual_seed(3),
                             "cpu")["params"]
    outs = []
    for dev, c, dt in ((torch.device("cpu"), cfg, torch.bfloat16),
                       (cuda, cfg, torch.bfloat16),
                       (torch.device("cpu"), cfg32, torch.float32)):
        params = lm.tree_map(lambda x: x.to(dev, dt), fresh)
        with torch.inference_mode():
            logits, caches, pos = lm.prefill(c, params, toks[:, :40].to(dev))
            caches = lm.grow_caches(c, caches, 44)
            seq = [logits]
            for t in range(40, 44):
                logits, caches, pos = lm.decode_step(
                    c, params, toks[:, t:t + 1].to(dev), pos, caches)
                seq.append(logits)
        outs.append(torch.stack(seq).float().cpu())
    assert torch.isfinite(outs[1]).all()
    bf16_no_worse(outs[1], outs[0], outs[2], "logits")


# The Mamba-2 mixer's causal conv + SiLU (kernels/conv): (B, L, widths of
# the layer's x, B and C, dtype, unaligned). The two cells' layers
# (mamba2-2.7b at 4 x 2048, zamba2-7b at 2 x 4096), then widths that are
# not multiples of 8 (the scalar path), L below K, and views one element
# into a buffer (not 16-byte aligned).
CONV = [
    (4, 2048, (5120, 128, 128), torch.bfloat16, False),
    (2, 4096, (7168, 128, 128), torch.bfloat16, False),
    (3, 37, (13, 24, 5), torch.bfloat16, False),
    (2, 2, (16, 9, 8), torch.bfloat16, False),
    (2, 300, (264, 8, 8), torch.bfloat16, True),
]


def _conv_inputs(device, b, l, widths, dtype, unaligned, seed=5):
    from repro_torch.kernels.conv import kernel as conv_kernel

    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(shape, scale=1.0):
        t = (scale * torch.randn(shape, generator=gen, device=device)).to(
            dtype)
        if not unaligned:
            return t
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=device)
        view = buf[1:].view(shape)
        view.copy_(t)
        assert view.data_ptr() % 16
        return view

    k = 4
    assert k in conv_kernel.TAPS
    xs = [rnd((b, l, c)) for c in widths]
    ws = [rnd((k, c), 0.5) for c in widths]
    dys = [rnd((b, l, c)) for c in widths]
    return xs, ws, dys


@pytest.mark.parametrize("row", CONV, ids=[f"conv{i}" for i in range(len(CONV))])
def test_cuda_conv_vs_float64_plain(cuda, row):
    """The conv kernels (one forward launch, one backward call for the
    three tensors) against the plain version evaluated in float64 on the
    same inputs (its closed-form backward for dx and dw), elementwise at
    _tol; a second forward and backward give the same bits."""
    from repro_torch.kernels.conv import kernel as conv_kernel
    from repro_torch.kernels.conv import ref as conv_ref

    b, l, widths, dtype, unaligned = row
    xs, ws, dys = _conv_inputs(cuda, b, l, widths, dtype, unaligned)
    fwd = conv_kernel.causal_conv_fwd.launches
    bwd = conv_kernel.causal_conv_bwd.launches
    ys = conv_kernel.causal_conv_fwd(xs, ws)
    dxs, dws = conv_kernel.causal_conv_bwd(xs, ws, dys)
    ys2 = conv_kernel.causal_conv_fwd(xs, ws)
    dxs2, dws2 = conv_kernel.causal_conv_bwd(xs, ws, dys)
    torch.cuda.synchronize()
    assert conv_kernel.causal_conv_fwd.launches == fwd + 2
    assert conv_kernel.causal_conv_bwd.launches == bwd + 2
    for i, (x, w, dy) in enumerate(zip(xs, ws, dys)):
        want_y = conv_ref.causal_conv(x.double(), w.double())
        want_dx, want_dw = conv_ref.causal_conv_silu_backward_reference(
            x, w, dy)
        for name, got, again, want, like in (
                ("y", ys[i], ys2[i], want_y, x), ("dx", dxs[i], dxs2[i],
                                                  want_dx, x),
                ("dw", dws[i], dws2[i], want_dw, w)):
            assert got.dtype == like.dtype and got.shape == like.shape
            assert torch.equal(got, again), f"{name}[{i}]: reruns differ"
            torch.testing.assert_close(got.double(), want, **_tol(dtype),
                                       msg=f"{name}[{i}]")
        del want_y, want_dx, want_dw


def test_cuda_conv_op_trains_through_the_kernels(cuda):
    """ops.causal_conv_silu with grad on the card: one forward and one
    backward launch for the three tensors, fp32 weights cast to the bf16
    inputs' dtype, and every gradient (the weights' in fp32) within _tol
    of autograd through the plain version in float64."""
    from repro_torch.kernels.conv import kernel as conv_kernel
    from repro_torch.kernels.conv import ops as conv_ops
    from repro_torch.kernels.conv import ref as conv_ref

    xs, ws, dys = _conv_inputs(cuda, 2, 200, (64, 16, 16), torch.bfloat16,
                               False)
    leaves = [t.clone().requires_grad_() for t in xs] + [
        w.float().requires_grad_() for w in ws]
    fwd = conv_kernel.causal_conv_fwd.launches
    bwd = conv_kernel.causal_conv_bwd.launches
    ys = conv_ops.causal_conv_silu(leaves[:3], leaves[3:])
    got = torch.autograd.grad(ys, leaves, dys)
    assert conv_kernel.causal_conv_fwd.launches == fwd + 1
    assert conv_kernel.causal_conv_bwd.launches == bwd + 1
    up = [t.detach().double().requires_grad_() for t in leaves]
    want = torch.autograd.grad(
        [conv_ref.causal_conv(x, w) for x, w in zip(up[:3], up[3:])], up,
        [dy.double() for dy in dys])
    for i, (g, w, leaf) in enumerate(zip(got, want, leaves)):
        assert g.dtype == leaf.dtype, i
        torch.testing.assert_close(g.double(), w, **_tol(torch.bfloat16),
                                   msg=str(i))
