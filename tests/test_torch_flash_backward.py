"""The flash-attention backward of the port on the CPU: its plain version
(ref.attention_backward_reference, the CUDA backward's algebra) against
autograd, autograd through the port's plain forward against jax.vjp
through the JAX package's oracle, the row log-sum-exp the CUDA forward
writes against the JAX oracle's scores, and the CUDA wrapper's refusal of
inputs that require grad (checked before it looks at the device). The
CUDA kernels run only on the card: tests/test_torch_gpu.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import attention_reference as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402
from test_kernels import ATTN_SWEEP, _tol  # noqa: E402
from test_torch_gpu import D120, D256, EDGES  # noqa: E402
from torch_parity import to_np  # noqa: E402

_JAX = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
# ATTN_SWEEP, then the edges of the bf16 CUDA kernels' tiling, then head
# dims 120 (h2o-danube-3-4b) and 256 (gemma2-2b)
ROWS = ATTN_SWEEP + [row[:-1] + (_JAX[row[-1]],)
                     for row in EDGES + D120 + D256]
IDS = ([f"attn{i}" for i in range(len(ATTN_SWEEP))]
       + [f"edge{i}" for i in range(len(EDGES))]
       + [f"d120_{i}" for i in range(len(D120))]
       + [f"d256_{i}" for i in range(len(D256))])


def _inputs(seed, b, s, t, h, k, d, dtype):
    """q, k, v, dO for both packages: numpy normals rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, t, k, d), (b, t, k, d),
                          (b, s, h, d))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tx = [torch.from_numpy(np.array(a, np.float32)).to(_TORCH[dtype])
          for a in jx]
    return jx, tx


@pytest.mark.parametrize("b,s,t,h,k,d,window,softcap,dtype", ROWS, ids=IDS)
def test_backward_reference_equals_autograd(b, s, t, h, k, d, window,
                                            softcap, dtype):
    """In fp32 from the row's inputs: the kernel's algebra (Delta, the
    recomputed P, the soft-cap derivative) gives autograd's gradients."""
    _, tx = _inputs(11, b, s, t, h, k, d, dtype)
    q, kk, vv, do = (x.float() for x in tx)
    cfg = dict(causal=True, window=window, softcap=softcap)
    leaves = [x.clone().requires_grad_() for x in (q, kk, vv)]
    o, lse = ref.attention_reference_lse(*leaves, **cfg)
    o.backward(do)
    got = ref.attention_backward_reference(q, kk, vv, o.detach(),
                                           lse.detach(), do, **cfg)
    for g, leaf in zip(got, leaves):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(to_np(g), to_np(leaf.grad),
                                   **_tol(jnp.float32))


@pytest.mark.parametrize("b,s,t,h,k,d,window,softcap,dtype", ROWS, ids=IDS)
def test_autograd_through_plain_matches_jax_grad(b, s, t, h, k, d, window,
                                                 softcap, dtype):
    (jq, jk, jv, jdo), tx = _inputs(12, b, s, t, h, k, d, dtype)
    cfg = dict(causal=True, window=window, softcap=softcap)
    _, vjp = jax.vjp(lambda q, k, v: jax_ref(q, k, v, **cfg), jq, jk, jv)
    want = vjp(jdo)
    leaves = [x.clone().requires_grad_() for x in tx[:3]]
    out = ops.attention(*leaves, **cfg)   # CPU tensors: the plain version
    out.backward(tx[3])
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == _TORCH[dtype]
        np.testing.assert_allclose(to_np(leaf.grad), to_np(w), **_tol(dtype))


@pytest.mark.parametrize("b,s,t,h,k,d,window,softcap,dtype", ROWS, ids=IDS)
def test_lse_matches_logsumexp_of_jax_scores(b, s, t, h, k, d, window,
                                             softcap, dtype):
    """The log-sum-exp (B, H, S) against logsumexp of the scores the JAX
    oracle builds (scaled, soft-capped, masked), in fp32."""
    (jq, jk, _, _), tx = _inputs(13, b, s, t, h, k, d, dtype)
    g = h // k
    qr = jq.reshape(b, s, k, g, d).astype(jnp.float32)
    scores = jnp.einsum("bskgd,btkd->bskgt", qr,
                        jk.astype(jnp.float32)) * (d ** -0.5)
    if softcap is not None:
        scores = softcap * jnp.tanh(scores / softcap)
    rows, cols = jnp.arange(s)[:, None], jnp.arange(t)[None, :]
    mask = cols <= rows + (t - s)
    if window is not None:
        mask &= cols > rows + (t - s) - window
    scores = jnp.where(mask[None, :, None, None, :], scores, -1e30)
    want = jax.nn.logsumexp(scores, axis=-1).reshape(b, s, h)
    want = jnp.transpose(want, (0, 2, 1))
    _, lse = ref.attention_reference_lse(*tx[:3], causal=True, window=window,
                                         softcap=softcap)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(to_np(lse), np.asarray(want),
                               **_tol(jnp.float32))


def test_cuda_wrapper_refuses_inputs_that_require_grad():
    """kernel.flash_attention returns no autograd graph, so under grad mode
    it refuses inputs that require grad, before any device check (these
    are CPU tensors) and before any launch."""
    q = torch.zeros(1, 64, 4, 64, dtype=torch.bfloat16, requires_grad=True)
    k = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    before = kernel.flash_attention.launches
    with pytest.raises(RuntimeError, match="autograd"):
        kernel.flash_attention(q, k, k.clone())
    with pytest.raises(RuntimeError, match="autograd"):
        kernel.flash_attention(q.detach(), k.requires_grad_(), k.detach())
    assert kernel.flash_attention.launches == before
    # without grad mode the refusal is the device check's
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention(q, k, k)


def test_backward_wrapper_refuses_cpu_and_mismatched_inputs():
    q = torch.zeros(1, 64, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 64)
    before = kernel.flash_attention_backward.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_backward(q, k, k, q, lse, q)
    # head dim 96, which neither kernel takes: the backward refuses it
    # before looking at the device; head dim 80 (zamba2-2.7b) it takes,
    # and refuses only the CPU tensors
    q96 = torch.zeros(1, 64, 4, 96, dtype=torch.bfloat16)
    k96 = torch.zeros(1, 64, 2, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 96"):
        kernel.flash_attention_backward(q96, k96, k96, q96, lse, q96)
    q80 = torch.zeros(1, 64, 4, 80, dtype=torch.bfloat16)
    k80 = torch.zeros(1, 64, 2, 80, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_backward(q80, k80, k80, q80, lse, q80)
    assert kernel.flash_attention_backward.launches == before
