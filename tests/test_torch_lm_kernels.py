"""The port's LM kernels (``repro_torch.kernels.ops.flash_attention``,
``rmsnorm``, ``rmsnorm_residual``) against the reference's
``repro.kernels.ops`` (Pallas in interpret mode), on the shape, dtype and
softcap sweeps and tolerances of the reference's own kernel tests
(``tests/test_kernels.py``).  On the CPU the wrappers run the plain
versions; the kernels themselves are held against those on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as R

from repro_torch.kernels import library
from repro_torch.kernels import ops as T
from repro_torch.kernels import ref as TR

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _pair(a: np.ndarray, dtype):
    """The same float32 draws in both packages, rounded alike to ``dtype``."""
    return jnp.asarray(a, JNP[dtype]), torch.from_numpy(a).to(dtype)


def _close(got: torch.Tensor, want, rtol, atol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("B,S,H,KVH,D", [
    (1, 128, 2, 2, 64), (2, 256, 4, 2, 64), (1, 256, 8, 1, 128),
    (2, 100, 4, 2, 32),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flash_attention_matches_reference(B, S, H, KVH, D, dtype, softcap):
    rng = np.random.default_rng(B * S + H * D)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D))]
    pairs = [_pair(a, dtype) for a in arrs]
    want = R.flash_attention(*(p[0] for p in pairs), softcap=softcap)
    library.reset_launches()
    got = T.flash_attention(*(p[1] for p in pairs), softcap=softcap)
    assert library.LAUNCHES["flash_attention"] == 0  # CPU: the plain version
    assert got.dtype == dtype and got.shape == (B, S, H, D)
    tol = 2e-6 if dtype == torch.float32 else 2e-2
    _close(got, want, tol, tol * 5)


def test_flash_attention_heads_read_their_kv_group():
    """Query head h attends over kv head h // (H / KVH), causally: each head
    against a per-head softmax written out here."""
    rng = np.random.default_rng(7)
    B, S, H, KVH, D = 1, 12, 6, 2, 8
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    got = T.flash_attention(q, k, v)
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    for h in range(H):
        g = h // (H // KVH)
        s = (q[0, :, h] @ k[0, :, g].T) / D ** 0.5
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        torch.testing.assert_close(got[0, :, h], p @ v[0, :, g], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("rows,d", [(128, 64), (1024, 256), (96, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_matches_reference(rows, d, dtype):
    rng = np.random.default_rng(rows + d)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    w = (rng.standard_normal(d) * 0.1).astype(np.float32)
    xj, xt = _pair(x, dtype)
    want = R.rmsnorm(xj, jnp.asarray(w))
    got = T.rmsnorm(xt, torch.from_numpy(w))
    assert got.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    _close(got, want, tol, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_residual_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x, r = (rng.standard_normal((64, 128)).astype(np.float32)
            for _ in range(2))
    w = (rng.standard_normal(128) * 0.1).astype(np.float32)
    (xj, xt), (rj, rt) = _pair(x, dtype), _pair(r, dtype)
    n_want, s_want = R.rmsnorm_residual(xj, rj, jnp.asarray(w))
    n_got, s_got = T.rmsnorm_residual(xt, rt, torch.from_numpy(w))
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    _close(n_got, n_want, tol, tol)
    _close(s_got, s_want, tol, tol)
    # the new residual is x + r rounded once; the norm is of the unrounded sum
    assert torch.equal(s_got, (xt.float() + rt.float()).to(dtype))
    assert torch.equal(n_got, TR.rmsnorm_ref(xt.float() + rt.float(),
                                             torch.from_numpy(w)).to(dtype))


def test_ref_backend_is_the_plain_version():
    q = torch.randn(1, 16, 4, 16)
    k = torch.randn(1, 16, 2, 16)
    assert torch.equal(T.flash_attention(q, k, k, backend="ref"),
                       TR.flash_attention_ref(q, k, k))
    assert torch.equal(T.flash_attention(q, k, k, softcap=5.0),
                       TR.flash_attention_ref(q, k, k, softcap=5.0))
    w = torch.randn(16)
    assert torch.equal(T.rmsnorm(q, w, backend="ref"), TR.rmsnorm_ref(q, w))
    n, s = T.rmsnorm_residual(q, q, w, backend="ref")
    n2, s2 = TR.rmsnorm_residual_ref(q, q, w)
    assert torch.equal(n, n2) and torch.equal(s, s2)
    for fn, args in ((T.flash_attention, (q, k, k)), (T.rmsnorm, (q, w)),
                     (T.rmsnorm_residual, (q, q, w))):
        with pytest.raises(ValueError, match="backend"):
            fn(*args, backend="pallas")


def test_wrappers_check_their_inputs():
    q = torch.randn(1, 16, 4, 16)
    k = torch.randn(1, 16, 2, 16)
    with pytest.raises(TypeError):
        T.flash_attention(q.numpy(), k, k)
    with pytest.raises(ValueError, match="multiple of KVH"):
        T.flash_attention(q, torch.randn(1, 16, 3, 16),
                          torch.randn(1, 16, 3, 16))
    with pytest.raises(ValueError, match="do not fit"):
        T.flash_attention(q, k[:, :8], k[:, :8])
    with pytest.raises(ValueError, match="dtype"):
        T.flash_attention(q, k.double(), k.double())
    with pytest.raises(ValueError, match="weight"):
        T.rmsnorm(q, torch.zeros(8))
    with pytest.raises(ValueError, match="one shape"):
        T.rmsnorm_residual(q, q[:, :8], torch.zeros(16))
    with pytest.raises(ValueError, match="no kernel"):
        T.rmsnorm(q.to("meta"), torch.zeros(16, device="meta"))
