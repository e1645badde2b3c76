"""Tests of the port that need a CUDA card (marker ``gpu``); each skips
without one. They import no JAX, so they run on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import TalpMonitor  # noqa: E402
from repro_torch.core.backends import CudaRuntimeBackend  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402

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


@pytest.mark.parametrize("row", SWEEP + RAGGED,
                         ids=[f"attn{i}" for i in range(len(SWEEP))]
                         + [f"ragged{i}" for i in range(len(RAGGED))])
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
