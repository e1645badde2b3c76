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
# 128, D 32 (64-byte swizzle) with GQA 4, S below one query tile.
EDGES = [
    (1, 200, 328, 8, 2, 64, None, None, torch.bfloat16),
    (2, 384, 384, 4, 1, 128, 100, 50.0, torch.bfloat16),
    (2, 256, 256, 8, 2, 32, None, None, torch.bfloat16),
    (1, 64, 64, 4, 2, 128, None, None, torch.bfloat16),
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
