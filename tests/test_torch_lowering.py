"""Per-stencil parity of the PyTorch port with the reference package.

Every ``@gtstencil`` of ``fv3/stencils.py`` goes through both packages on
the same numpy inputs (seeded), at a small extended domain on six-tile
batches:

 * the port's plain lowering (``"torch"``) against the reference's ``"jnp"``
   oracle, whole arrays;
 * the port's ``"cuda"`` backend on CPU tensors — the kernels' plain
   version: offset temporaries inlined, one statement per launch — against
   the reference's ``"pallas-tpu"`` in interpret mode, whole arrays.

Tolerance rtol = atol = 1e-6 (f32).  The level search bisects in the plain
lowering and in ``"jnp"`` and marches in Pallas; march and bisection select
the same layer on a monotone coordinate column, so ``remap_interp`` gets
monotone ``pe``/``pe_ref`` columns (the remap's ``pe`` is a cumulative sum
of positive thicknesses), and the Thomas solve a diagonally dominant system
(as ``riem_coeffs`` builds it with ``beta = 4``), where it is stable.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core.backend import compile_stencil as ref_compile_stencil
from repro.core.stencil import DomainSpec as RefDomainSpec
from repro.core.stencil.ir import Stencil as RefStencil
from repro.fv3 import stencils as RS

from repro_torch.core.backend import compile_stencil
from repro_torch.core.stencil import DomainSpec, Stencil
from repro_torch.fv3 import stencils as TS

NAMES = sorted(k for k, v in vars(RS).items() if isinstance(v, RefStencil))
DOM = dict(ni=6, nj=5, nk=4, halo=3, extend=(1, 1))
RTOL = ATOL = 1e-6


def _inputs(st, seed):
    rng = np.random.default_rng(seed)
    dom = DomainSpec(**DOM)
    ranges = {"aa": (-0.5, 0.5), "cc": (-0.5, 0.5), "bb": (2.0, 3.0)}
    out = {}
    for f in st.fields:
        lo, hi = ranges.get(f, (0.5, 1.5))
        a = rng.uniform(lo, hi, dom.padded_shape(st.is_interface(f)))
        if st.name == "remap_interp" and f in ("pe", "pe_ref", "fm"):
            a = np.cumsum(a, axis=0)
        out[f] = a.astype(np.float32)
    params = {p: float(rng.uniform(0.5, 1.5)) for p in st.params}
    return out, params


def _ref(name, backend, fields, params):
    """The reference stencil over the six tiles (vmapped like its step)."""
    run = ref_compile_stencil(getattr(RS, name), RefDomainSpec(**DOM),
                              backend=backend, interpret=True)
    tiles = jax.vmap(run, in_axes=(0, None))
    six = {f: jnp.asarray(np.stack([a] * 2 + [a[..., ::-1, :].copy()] * 4))
           for f, a in fields.items()}
    out = tiles(six, params)
    return {k: np.asarray(v) for k, v in out.items()}, six


def _port(name, backend, six, params):
    run = compile_stencil(getattr(TS, name), DomainSpec(**DOM),
                          backend=backend)
    ins = {f: torch.from_numpy(np.array(a)) for f, a in six.items()}
    return {k: v.numpy() for k, v in run(ins, params).items()}


def test_every_stencil_is_covered():
    port = sorted(k for k, v in vars(TS).items() if isinstance(v, Stencil))
    assert port == NAMES and len(NAMES) == 27


@pytest.mark.parametrize("name", NAMES)
def test_plain_lowering_matches_jnp(name):
    fields, params = _inputs(getattr(RS, name), seed=NAMES.index(name))
    ref, six = _ref(name, "jnp", fields, params)
    got = _port(name, "torch", six, params)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}.{k}")


@pytest.mark.parametrize("name", NAMES)
def test_kernel_plain_version_matches_pallas_interpret(name):
    fields, params = _inputs(getattr(RS, name), seed=100 + NAMES.index(name))
    ref, six = _ref(name, "pallas-tpu", fields, params)
    got = _port(name, "cuda", six, params)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}.{k}")
