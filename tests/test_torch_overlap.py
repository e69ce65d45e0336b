"""The port's halo/compute overlap against the reference's.

Mirrors ``tests/test_overlap.py``: the strip-split runner reproduces the
full-domain run on the exchanged fields over the interior even when the
stale fields' ghost cells hold garbage — c_sw's edge-region stencil
included — and refuses domains too small for a strip-free core.  The port's
stitched output is also held against the reference's
``make_overlapped_runner(..., backend="jnp")`` on the same numpy inputs, and
the runner takes the exchange as a callable (what lets it run beside the
interior on the card), with leading rank dims.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.fv3 import dyncore as RD
from repro.fv3 import overlap as RO

from repro_torch.core.backend import TuningCache, set_default_cache
from repro_torch.core.stencil import DomainSpec
from repro_torch.fv3 import dyncore as TD
from repro_torch.fv3.overlap import make_overlapped_runner, written_fields

CFG = dict(npx=16, nk=3, halo=6, n_tracers=1)
DOM = DomainSpec(ni=16, nj=16, nk=3, halo=6)


@pytest.fixture(autouse=True, scope="module")
def _own_tuning_cache(tmp_path_factory):
    """The port's tuning cache of this file: a throwaway file, never the
    working tree's ``.repro_cache/torch_tuning.json``."""
    set_default_cache(TuningCache(
        tmp_path_factory.mktemp("torch_tuning") / "torch_tuning.json"))
    yield
    set_default_cache(None)


def _stale_fresh(p, seed, lead=()):
    """fresh: valid everywhere; stale: same interior, garbage ghost ring
    (numpy arrays)."""
    rng = np.random.default_rng(seed)
    h, ni, nj = DOM.halo, DOM.ni, DOM.nj
    I = np.s_[..., h:h + nj, h:h + ni]
    names = [f for f, d in p.fields.items() if not d.transient]
    shape = lead + DOM.padded_shape()
    fresh, stale = {}, {}
    for f in names:
        v = rng.uniform(0.8, 1.2, shape).astype(np.float32)
        g = rng.uniform(-7, 7, shape).astype(np.float32)
        g[I] = v[I]
        fresh[f], stale[f] = v, g
    return stale, fresh, I


def _torch(arrays):
    return {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}


def _check(build, seed, opt_level=0):
    cfg = TD.FV3Config(**CFG)
    p = getattr(TD, build)(cfg, DOM)
    params = TD.default_params(cfg)
    stale, fresh, I = _stale_fresh(p, seed)
    ov = make_overlapped_runner(p, opt_level=opt_level, device="cpu")
    assert ov is not None and ov.n_strips == 4
    ref = ov.full_run(_torch(fresh), params)
    got = ov(_torch(stale), _torch(fresh), params)
    assert set(ov.outputs) == set(written_fields(p))
    for k in ov.outputs:
        if opt_level == 0:
            np.testing.assert_array_equal(ref[k].numpy()[I],
                                          got[k].numpy()[I], err_msg=k)
        else:
            # strips compile at ladder level <= 1; the fused full-domain
            # program may round differently by an ulp
            np.testing.assert_allclose(ref[k].numpy()[I], got[k].numpy()[I],
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    # the reference's stitched runner on the same numpy inputs
    rcfg = RD.FV3Config(**CFG)
    rp = getattr(RD, build)(rcfg, DOM)
    rov = RO.make_overlapped_runner(rp, backend="jnp", opt_level=opt_level)
    assert rov.outputs == ov.outputs
    want = rov({k: jnp.asarray(v) for k, v in stale.items()},
               {k: jnp.asarray(v) for k, v in fresh.items()}, params)
    for k in ov.outputs:
        np.testing.assert_allclose(got[k].numpy()[I], np.asarray(want[k])[I],
                                   rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("seed,build", [(11, "build_csw_program"),
                                          (12, "build_dsw_program"),
                                          (13, "build_tracer_program")])
def test_overlap_matches_full_compute_and_the_reference(seed, build):
    # c_sw carries the paper's §IV-B edge-region stencil: the strip programs
    # rebase region bounds so edge columns fire at the same physical i/j
    _check(build, seed)


def test_overlap_composes_with_opt_ladder():
    _check("build_csw_program", seed=14, opt_level=3)


def test_overlap_refuses_small_domains():
    small = DomainSpec(ni=12, nj=12, nk=2, halo=6)  # 12 <= 2*6
    cfg = TD.FV3Config(npx=12, nk=2, halo=6)
    assert make_overlapped_runner(TD.build_csw_program(cfg, small),
                                  device="cpu") is None


def test_overlap_takes_the_exchange_as_a_callable_over_rank_dims():
    """``fresh`` as a zero-argument callable (the exchange) on fields with a
    leading rank axis: the same stitched result as the mapping, which the
    callable returns once."""
    cfg = TD.FV3Config(**CFG)
    p = TD.build_dsw_program(cfg, DOM)
    params = TD.default_params(cfg)
    stale, fresh, I = _stale_fresh(p, 15, lead=(3,))
    ov = make_overlapped_runner(p, device="cpu")
    want = ov(_torch(stale), _torch(fresh), params)
    calls = []

    def exchange():
        calls.append(1)
        return _torch(fresh)

    got = ov(_torch(stale), exchange, params)
    assert calls == [1]
    for k in ov.outputs:
        np.testing.assert_array_equal(got[k].numpy()[I], want[k].numpy()[I])
    for r in range(3):
        one = ov({k: v[r] for k, v in _torch(stale).items()},
                 {k: v[r] for k, v in _torch(fresh).items()}, params)
        for k in ov.outputs:
            np.testing.assert_array_equal(one[k].numpy()[I],
                                          got[k][r].numpy()[I])
