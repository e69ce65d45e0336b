"""The FV3-lite step of the PyTorch port against the reference package.

One whole opt-0 step of ``repro_torch.fv3.dyncore.make_step_sequential`` on
the CPU (plain versions) is held against the reference's
``make_step_sequential(backend="jnp", opt_level=0)`` from the same initial
state: max abs error < 1e-5 over the interior of every field, the
reference's own bar for a whole step (``tests/test_distributed.py``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.fv3 import dyncore as RD
from repro.fv3 import halo as RH
from repro.fv3 import state as RSt

from repro_torch.fv3 import dyncore as TD
from repro_torch.fv3 import halo as TH
from repro_torch.fv3 import state as TSt

NPX, NK = 12, 5
STEP_ATOL = 1e-5


def _interior(a, cfg):
    h = cfg.halo
    return np.asarray(a)[..., h:h + cfg.npx, h:h + cfg.npx]


@pytest.fixture(scope="module")
def reference_run():
    cfg = RD.FV3Config(npx=NPX, nk=NK)
    s0 = {k: np.asarray(v) for k, v in RSt.init_state(cfg).items()}
    step = RD.make_step_sequential(cfg, backend="jnp", opt_level=0)
    s1 = step({k: jnp.asarray(v) for k, v in s0.items()})
    return cfg, s0, {k: np.asarray(v) for k, v in s1.items()}, step


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_one_step_matches_reference(reference_run, backend):
    cfg_r, s0, ref, _ = reference_run
    cfg = TD.FV3Config(npx=NPX, nk=NK)
    step = TD.make_step_sequential(cfg, backend=backend, device="cpu")
    out = step(TSt.state_from_reference(s0, "cpu"))
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape and out[k].dtype == torch.float32
        err = np.abs(_interior(out[k].numpy(), cfg)
                     - _interior(ref[k], cfg_r)).max()
        assert err < STEP_ATOL, (k, err)


def test_total_mass_conserved_like_reference(reference_run):
    cfg_r, s0, ref, _ = reference_run
    cfg = TD.FV3Config(npx=NPX, nk=NK)
    step = TD.make_step_sequential(cfg, device="cpu")
    st = TSt.state_from_reference(s0, "cpu")
    m0 = TSt.total_mass(st, cfg)
    assert m0 == pytest.approx(RSt.total_mass(s0, cfg_r), rel=1e-6)
    for _ in range(2):
        st = step(st)
    assert abs(TSt.total_mass(st, cfg) - m0) / m0 < 1e-5
    ref_drift = abs(RSt.total_mass(ref, cfg_r) - m0) / m0
    assert ref_drift < 1e-5
    for v in st.values():
        assert torch.isfinite(v).all()


def test_step_structure_matches_reference(reference_run):
    _, _, _, ref_step = reference_run
    cfg = TD.FV3Config(npx=NPX, nk=NK)
    step = TD.make_step_sequential(cfg, device="cpu")
    assert step.n_kernels == ref_step.n_kernels == 110
    assert [p.name for p in step.programs] == \
        [p.name for p in ref_step.programs]
    step(TSt.init_state(cfg, device="cpu"))
    assert step.counters == {"acoustic_iterations": 8,
                             "runner_dispatches": 20, "step_calls": 1}


def test_init_state_matches_reference():
    cfg_r, cfg = RD.FV3Config(npx=8, nk=3), TD.FV3Config(npx=8, nk=3)
    ref = RSt.init_state(cfg_r)
    got = TSt.init_state(cfg, device="cpu")
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("lead", [(), (2,)])
def test_halo_exchange_matches_reference(lead):
    N, h = 7, 3
    rng = np.random.default_rng(3)
    shape = lead + (6, 2, N + 2 * h, N + 2 * h)
    fields = {k: rng.standard_normal(shape).astype(np.float32)
              for k in ("q", "u", "v")}
    ref = RH.exchange_reference({k: jnp.asarray(v) for k, v in fields.items()},
                                h, vector_pairs=[("u", "v")])
    got = TH.exchange_reference({k: torch.from_numpy(v)
                                 for k, v in fields.items()},
                                h, vector_pairs=[("u", "v")])
    for k in fields:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        assert not np.shares_memory(got[k].numpy(), fields[k])
