"""The port's flash attention (repro_torch.kernels.flash_attention) on the
CPU: its plain version against the JAX package's oracle and Pallas
kernel (interpreted), the dispatching wrapper, and the launch checks of
the CUDA wrapper. The CUDA kernel itself runs only on the card:
tests/test_torch_gpu.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_reference as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402
from test_kernels import ATTN_SWEEP, _tol  # noqa: E402

_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _inputs(seed, b, s, t, h, k, d, dtype):
    """Same values for both packages: numpy normals rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, t, k, d), (b, t, k, d))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tx = [torch.from_numpy(np.array(a, np.float32)).to(_TORCH[dtype])
          for a in jx]
    return jx, tx


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


@pytest.mark.parametrize(
    "b,s,t,h,k,d,window,softcap,dtype", ATTN_SWEEP,
    ids=[f"attn{i}" for i in range(len(ATTN_SWEEP))],
)
def test_plain_flash_vs_jax_reference(b, s, t, h, k, d, window, softcap,
                                      dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(42, b, s, t, h, k, d, dtype)
    want = jax_ref(jq, jk, jv, causal=True, window=window, softcap=softcap)
    got = ref.attention_reference(tq, tk, tv, causal=True, window=window,
                                  softcap=softcap)
    assert got.dtype == _TORCH[dtype] and got.shape == (b, s, h, d)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    # the wrapper takes the plain version for CPU tensors, bit for bit
    via_ops = ops.attention(tq, tk, tv, causal=True, window=window,
                            softcap=softcap)
    assert torch.equal(via_ops, got)


@pytest.mark.parametrize("row", [0, 2, 6], ids=["mha", "gqa4", "win_cap"])
def test_plain_flash_vs_pallas_interpret(row):
    b, s, t, h, k, d, window, softcap, dtype = ATTN_SWEEP[row]
    (jq, jk, jv), (tq, tk, tv) = _inputs(7, b, s, t, h, k, d, dtype)
    want = jax_flash(jq, jk, jv, causal=True, window=window, softcap=softcap,
                     interpret=True)
    got = ref.attention_reference(tq, tk, tv, causal=True, window=window,
                                  softcap=softcap)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def _ok_inputs(dtype=torch.bfloat16, d=64):
    q = torch.zeros(1, 64, 4, d, dtype=dtype)
    k = torch.zeros(1, 64, 2, d, dtype=dtype)
    return q, k, k.clone()


@pytest.mark.parametrize("case", [
    "head_dim", "dtype", "mixed_dtype", "gqa", "shape", "noncontig",
    "s_gt_t", "window", "softcap", "cpu_tensor",
])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(case):
    """Every refusal raises before any launch; a CPU tensor is refused too
    (the wrapper never falls back to the plain version)."""
    q, k, v = _ok_inputs()
    kw = dict(causal=True, window=None, softcap=None)
    if case == "head_dim":
        q, k, v = _ok_inputs(d=80)
    elif case == "dtype":
        q, k, v = (x.half() for x in (q, k, v))
    elif case == "mixed_dtype":
        k = k.float()
    elif case == "gqa":
        q = torch.zeros(1, 64, 3, 64, dtype=torch.bfloat16)
    elif case == "shape":
        v = torch.zeros(1, 32, 2, 64, dtype=torch.bfloat16)
    elif case == "noncontig":
        q = torch.zeros(1, 4, 64, 64, dtype=torch.bfloat16).transpose(1, 2)
    elif case == "s_gt_t":
        q = torch.zeros(1, 128, 4, 64, dtype=torch.bfloat16)
    elif case == "window":
        kw["window"] = 0
    elif case == "softcap":
        kw["softcap"] = -1.0
    before = kernel.flash_attention.launches
    with pytest.raises(ValueError):
        kernel.flash_attention(q, k, v, **kw)
    assert kernel.flash_attention.launches == before


def test_gpu_sweep_copy_matches_attn_sweep():
    """tests/test_torch_gpu.py runs on the card, where JAX is absent, so it
    keeps its own copy of ATTN_SWEEP; the copy must stay the same."""
    from test_torch_gpu import SWEEP

    assert [row[:-1] + (_TORCH[row[-1]],) for row in ATTN_SWEEP] == SWEEP
