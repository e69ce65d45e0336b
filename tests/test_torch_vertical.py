"""The port's vertical remap entry points against the reference's.

Mirrors ``tests/test_vertical.py`` on ``repro_torch.fv3.dyncore``: the
memoized ``vertical_remap`` (a compiled stencil program) and the pre-DSL
oracle ``vertical_remap_reference`` against the reference's at 1e-6 on
benign columns; the oracle's thin-layer mass loss reproduced and the stencil
path's exact differencing conserving mass; opt 3 against opt 0; interface
schedules never tiling K; ``build_remap_program(unrolled_interp=True)``
against the level search; the memo dropped by ``clear_compile_cache()``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.fv3 import dyncore as RD

from repro_torch.core import compile_program
from repro_torch.core.backend import (TuningCache, clear_compile_cache,
                                      set_default_cache)
from repro_torch.core.stencil import (DomainSpec, Field, default_schedule,
                                      feasible_schedules, gtstencil,
                                      heuristic_schedule, interface)
from repro_torch.core.transforms import can_otf_fuse
from repro_torch.fv3 import dyncore as TD

BAR = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _own_tuning_cache(tmp_path_factory):
    """The port's tuning cache of this file: a throwaway file, never the
    working tree's ``.repro_cache/torch_tuning.json``."""
    set_default_cache(TuningCache(
        tmp_path_factory.mktemp("torch_tuning") / "torch_tuning.json"))
    yield
    set_default_cache(None)


def _cfgs(**kw):
    base = dict(npx=6, nk=4, halo=6, n_tracers=1)
    base.update(kw)
    return RD.FV3Config(**base), TD.FV3Config(**base)


def _interior(a, cfg):
    h, n = cfg.halo, cfg.npx
    return np.asarray(a)[:, h:h + n, h:h + n]


def _both(arrays):
    """The same numpy arrays as reference and port inputs."""
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _columns(rng, dom, lo, hi, names):
    return {k: rng.uniform(lo, hi, dom.padded_shape()).astype(np.float32)
            for k in names}


@pytest.mark.parametrize("fn", ["vertical_remap", "vertical_remap_reference"])
def test_remap_matches_reference_on_benign_columns(fn):
    rcfg, tcfg = _cfgs()
    rng = np.random.default_rng(2)
    arrays = {"delp": _columns(rng, tcfg.seq_dom(), 0.8, 1.2, ["delp"])[
        "delp"], **_columns(rng, tcfg.seq_dom(), 0.5, 1.5, ["pt", "w"])}
    r_in, t_in = _both(arrays)
    d_ref, o_ref = getattr(RD, fn)(rcfg, r_in.pop("delp"), r_in)
    d_got, o_got = getattr(TD, fn)(tcfg, t_in.pop("delp"), t_in)
    np.testing.assert_allclose(_interior(d_got, tcfg), _interior(d_ref, rcfg),
                               rtol=BAR, atol=BAR)
    assert set(o_got) == {"pt", "w"}
    for k in o_ref:
        np.testing.assert_allclose(_interior(o_got[k], tcfg),
                                   _interior(o_ref[k], rcfg),
                                   rtol=BAR, atol=BAR, err_msg=k)


def test_stencil_remap_matches_the_oracle_on_benign_columns():
    """The reference's own bar between its DSL remap and its oracle."""
    _, cfg = _cfgs()
    rng = np.random.default_rng(2)
    delp = torch.from_numpy(_columns(rng, cfg.seq_dom(), 0.8, 1.2,
                                     ["delp"])["delp"])
    flds = {k: torch.from_numpy(v) for k, v in _columns(
        rng, cfg.seq_dom(), 0.5, 1.5, ["pt", "w"]).items()}
    d_ref, o_ref = TD.vertical_remap_reference(cfg, delp, dict(flds))
    d_new, o_new = TD.vertical_remap(cfg, delp, dict(flds))
    np.testing.assert_allclose(_interior(d_ref, cfg), _interior(d_new, cfg),
                               rtol=1e-5, atol=1e-6)
    for k in flds:
        np.testing.assert_allclose(_interior(o_ref[k], cfg),
                                   _interior(o_new[k], cfg),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def _tracer_mass(q, delp, cfg):
    return float(np.sum(_interior(q, cfg).astype(np.float64)
                        * _interior(delp, cfg).astype(np.float64)))


def test_oracle_loses_mass_on_thin_layers_as_the_reference_does():
    """The oracle's ``maximum(delp_ref, 1e-10)`` floor destroys tracer mass
    when reference layers are thinner than the floor — in the port as in
    the reference — while the stencil path's exact differencing conserves
    ``sum(q * delp)``."""
    rcfg, tcfg = _cfgs(ptop=0.0)
    rng = np.random.default_rng(3)
    dom = tcfg.seq_dom()
    # delp_ref ~ 2e-11 per layer — far below the 1e-10 denominator floor
    arrays = {"delp": rng.uniform(1e-11, 3e-11, dom.padded_shape())
              .astype(np.float32),
              "q": rng.uniform(0.5, 1.5, dom.padded_shape())
              .astype(np.float32)}
    r_in, t_in = _both(arrays)
    m0 = _tracer_mass(arrays["q"], arrays["delp"], tcfg)
    d_old, o_old = TD.vertical_remap_reference(tcfg, t_in["delp"],
                                               {"q": t_in["q"]})
    m_old = _tracer_mass(o_old["q"], d_old, tcfg)
    assert abs(m_old - m0) / m0 > 0.5
    dr, orr = RD.vertical_remap_reference(rcfg, r_in["delp"],
                                          {"q": r_in["q"]})
    np.testing.assert_allclose(_interior(o_old["q"], tcfg),
                               _interior(orr["q"], rcfg), rtol=BAR)
    d_new, o_new = TD.vertical_remap(tcfg, t_in["delp"], {"q": t_in["q"]})
    assert abs(_tracer_mass(o_new["q"], d_new, tcfg) - m0) / m0 < 1e-5


def test_exact_differencing_conserves_mass_on_normal_columns():
    _, cfg = _cfgs()
    rng = np.random.default_rng(4)
    dom = cfg.seq_dom()
    delp = torch.from_numpy(rng.uniform(0.3, 1.7, dom.padded_shape())
                            .astype(np.float32))
    q = torch.from_numpy(rng.uniform(0.0, 2.0, dom.padded_shape())
                         .astype(np.float32))
    m0 = _tracer_mass(q, delp, cfg)
    d_new, o_new = TD.vertical_remap(cfg, delp, {"q": q})
    assert abs(_tracer_mass(o_new["q"], d_new, cfg) - m0) / m0 < 1e-5


def test_remap_opt3_matches_opt0():
    _, cfg = _cfgs()
    dom = cfg.seq_dom()
    p = TD.build_remap_program(cfg, dom)
    rng = np.random.default_rng(6)
    names = ("pt", "w", "u", "v", *cfg.tracers)
    ins = {k: torch.from_numpy(v) for k, v in _columns(
        rng, dom, 0.8, 1.2, ("delp", *names)).items()}
    params = TD.default_params(cfg)
    ref = compile_program(p, device="cpu")(dict(ins), params)
    got = compile_program(p, opt_level=3, device="cpu")(dict(ins), params)
    for q in names:
        np.testing.assert_allclose(_interior(got[f"{q}_out"], cfg),
                                   _interior(ref[f"{q}_out"], cfg),
                                   rtol=BAR, atol=BAR, err_msg=q)


@gtstencil
def _iface_diff(pe: Field[interface], dp: Field):
    with computation(PARALLEL), interval(...):
        dp = pe[0, 0, 1] - pe[0, 0, 0]


@pytest.mark.parametrize("hw", ["tpu-v5e", "p100", "h100"])
def test_interface_schedules_never_tile_k(hw):
    dom_shape = (8, 16, 16)
    for sched in feasible_schedules(_iface_diff, dom_shape, hw=hw):
        assert sched.block_k == 0, sched
    assert heuristic_schedule(_iface_diff, dom_shape, hw=hw).block_k == 0
    assert default_schedule(_iface_diff, dom_shape, hw=hw).block_k == 0


def test_otf_rejects_interface_center_boundary():
    _, cfg = _cfgs(npx=4, nk=3, n_tracers=0)
    p = TD.build_remap_program(cfg, cfg.seq_dom(), fields=("pt",))
    nodes = p.all_nodes()
    interp = next(n for n in nodes
                  if n.stencil.name.startswith("remap_interp"))
    remapf = next(n for n in nodes
                  if n.stencil.name.startswith("remap_field"))
    assert not can_otf_fuse(interp, remapf)


def test_unrolled_interp_matches_the_level_search():
    """``unrolled_interp=True`` swaps in the O(nk²) static-offset
    interpolation: the same remap as the level search (and as the
    reference's unrolled program), with more IR."""
    rcfg, tcfg = _cfgs(nk=5)
    dom = tcfg.seq_dom()
    rng = np.random.default_rng(7)
    names = ("pt", "w", "u", "v", *tcfg.tracers)
    arrays = _columns(rng, dom, 0.8, 1.2, ("delp", *names))
    r_in, t_in = _both(arrays)
    params = TD.default_params(tcfg)
    p_search = TD.build_remap_program(tcfg, dom)
    p_unrolled = TD.build_remap_program(tcfg, dom, unrolled_interp=True)
    assert p_unrolled.ir_node_count() > p_search.ir_node_count()
    assert [n.stencil.name for n in p_unrolled.all_nodes()].count(
        "remap_interp_unrolled") == len(names)
    search = compile_program(p_search, device="cpu")(dict(t_in), params)
    unrolled = compile_program(p_unrolled, device="cpu")(dict(t_in), params)
    from repro.core import compile_program as r_compile

    r_prog = RD.build_remap_program(rcfg, rcfg.seq_dom(),
                                    unrolled_interp=True)
    ref = r_compile(r_prog, "jnp")(dict(r_in), params)
    for q in names:
        k = f"{q}_out"
        np.testing.assert_allclose(_interior(unrolled[k], tcfg),
                                   _interior(ref[k], rcfg),
                                   rtol=BAR, atol=BAR, err_msg=q)
        np.testing.assert_allclose(_interior(unrolled[k], tcfg),
                                   _interior(search[k], tcfg),
                                   rtol=1e-5, atol=1e-5, err_msg=q)


def test_make_vertical_remap_exposes_its_runner():
    _, cfg = _cfgs()
    remap = TD.make_vertical_remap(cfg, cfg.seq_dom(), ("pt",),
                                   opt_level=3, device="cpu")
    assert remap.fields == ("pt",)
    assert remap.run.opt_report is not None
    rng = np.random.default_rng(8)
    arrays = _columns(rng, cfg.seq_dom(), 0.8, 1.2, ("delp", "pt"))
    delp, out = remap(torch.from_numpy(arrays["delp"]),
                      {"pt": torch.from_numpy(arrays["pt"])},
                      TD.default_params(cfg))
    ref_d, ref = TD.vertical_remap(cfg, torch.from_numpy(arrays["delp"]),
                                   {"pt": torch.from_numpy(arrays["pt"])})
    np.testing.assert_allclose(_interior(delp, cfg), _interior(ref_d, cfg),
                               rtol=BAR, atol=BAR)
    np.testing.assert_allclose(_interior(out["pt"], cfg),
                               _interior(ref["pt"], cfg), rtol=BAR, atol=BAR)


def test_clear_compile_cache_drops_the_remap_memo():
    _, cfg = _cfgs()
    delp = torch.ones(cfg.seq_dom().padded_shape())
    TD.vertical_remap(cfg, delp, {"pt": delp.clone()})
    assert TD._REMAP_MEMO
    clear_compile_cache()
    assert not TD._REMAP_MEMO
    TD.vertical_remap(cfg, delp, {"pt": delp.clone()})
    assert len(TD._REMAP_MEMO) == 1


def test_all_state_fields_match_the_reference():
    rcfg, tcfg = _cfgs(n_tracers=3)
    assert TD.all_state_fields(tcfg) == RD.all_state_fields(rcfg)
