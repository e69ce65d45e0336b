"""The port's standalone FV3 kernels (``repro_torch.kernels.ops``) against
the reference's ``repro.kernels.ops`` (Pallas in interpret mode), on the
shapes, dtypes and tolerances of the reference's own kernel tests.  On the
CPU the wrappers run the plain versions; the kernels themselves are held
against those on the card (``tests/test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as R

from repro_torch.kernels import library
from repro_torch.kernels import ops as T
from repro_torch.kernels import ref as TR


def _system(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, shape).astype(dtype)
            for lo, hi in ((0.1, 0.5), (2.0, 3.0), (0.1, 0.5), (-1, 1))]


@pytest.mark.parametrize("nk,nj,ni", [(8, 8, 8), (16, 8, 16), (80, 4, 12),
                                      (5, 3, 7)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tridiag_matches_reference(nk, nj, ni, dtype):
    arrs = _system((nk, nj, ni), dtype, seed=nk * nj + ni)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(R.tridiag(*(jnp.asarray(a) for a in arrs)))
    assert want.dtype == dtype
    library.reset_launches()
    x = T.tridiag(*(torch.from_numpy(a) for a in arrs))
    assert x.dtype == torch.from_numpy(arrs[0]).dtype
    assert library.LAUNCHES["tridiag"] == 0  # the CPU takes the plain version
    tol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(x.numpy(), want, rtol=tol, atol=tol)
    # residual against the linear system itself
    a, b, c, d = arrs
    xs = x.numpy()
    res = b * xs
    res[1:] += a[1:] * xs[:-1]
    res[:-1] += c[:-1] * xs[1:]
    np.testing.assert_allclose(res, d, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("halo,nk,nj,ni", [(3, 8, 10, 12), (4, 4, 6, 6),
                                           (6, 16, 8, 8)])
def test_fvt_flux_matches_reference(halo, nk, nj, ni):
    rng = np.random.default_rng(halo + nk)
    shape = (nk, nj + 2 * halo, ni + 2 * halo)
    q = rng.uniform(1, 2, shape).astype(np.float32)
    cx = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    want = np.asarray(R.fvt_flux(jnp.asarray(q), jnp.asarray(cx), halo=halo))
    f = T.fvt_flux(torch.from_numpy(q), torch.from_numpy(cx), halo=halo)
    np.testing.assert_allclose(f.numpy(), want, rtol=1e-5, atol=1e-6)
    assert not f[..., :halo].any() and not f[..., -halo:].any()


def test_ref_backend_is_the_plain_version():
    arrs = [torch.from_numpy(a) for a in _system((6, 3, 4), np.float32, 1)]
    assert torch.equal(T.tridiag(*arrs, backend="ref"), TR.tridiag_ref(*arrs))
    assert torch.equal(T.tridiag(*arrs), TR.tridiag_ref(*arrs))
    q = torch.rand(2, 9, 10)
    assert torch.equal(T.fvt_flux(q, q - 0.5, halo=3, backend="ref"),
                       TR.fvt_flux_ref(q, q - 0.5, halo=3))
    with pytest.raises(ValueError, match="backend"):
        T.tridiag(*arrs, backend="pallas")
    with pytest.raises(ValueError, match="backend"):
        T.fvt_flux(q, q, halo=3, backend="triton")


def test_wrappers_check_their_inputs():
    arrs = [torch.from_numpy(a) for a in _system((6, 3, 4), np.float32, 2)]
    with pytest.raises(TypeError):
        T.tridiag(arrs[0].numpy(), *arrs[1:])
    with pytest.raises(ValueError, match="shape"):
        T.tridiag(arrs[0][:, :2], *arrs[1:])
    with pytest.raises(ValueError, match="dtype"):
        T.tridiag(arrs[0].double(), *arrs[1:])
    with pytest.raises(ValueError, match="no kernel"):
        T.tridiag(*(a.to("meta") for a in arrs))
    q = torch.rand(2, 9, 10)
    with pytest.raises(ValueError, match="halo"):
        T.fvt_flux(q, q, halo=2)
    with pytest.raises(ValueError, match="shape"):
        T.fvt_flux(q, q[..., 1:], halo=3)
    with pytest.raises(ValueError, match="no kernel"):
        T.fvt_flux(q.to("meta"), q.to("meta"), halo=3)


@pytest.mark.parametrize("itemsize, deepest", [(4, 892), (8, 438)])
def test_tridiag_plan_keeps_cp_and_dp_on_chip_where_they_fit(itemsize,
                                                             deepest):
    """K6's launch plan: a warp of columns a CTA keeps cp and dp of every
    level in shared memory, beside a ring of 8 levels of a, b, c, d, while
    they fit a CTA's 227 KB; past that every level beyond the deepest that
    fits keeps cp in a scratch and dp in x."""
    from repro_torch.kernels import tridiag as KT

    def smem(levels):
        return (2 * levels + 4 * KT.RING) * KT.TILE * itemsize

    assert KT.TILE == 32
    for nk in (1, 2, 80, 200, 439, deepest, deepest + 1, 4 * deepest):
        levels = KT.plan(nk, itemsize)
        assert levels == min(nk, deepest)
        assert smem(levels) <= KT.SMEM_MAX < smem(levels + 1) or levels == nk
