"""The port's optimizer against the reference's.

The optimization pipeline (``repro_torch.core.rewrite`` / ``passes``, the
transforms, transfer tuning, the cost model and the schedule tuner) is the
reference's pure-IR code ported to torch dtypes, so it must make the same
decisions: for each of the four programs of the step at opt 0–4, the same
nodes in the same order with the same stencil fingerprints, the same rule
counts, no verifier violations, and the same tuned schedules for the
``tpu-v5e``, ``v100`` and ``p100`` presets.  The opt-3 and opt-4 steps agree
with the reference's jnp step at the same level, and ``batch="vmap:auto"``
picks the reference's chunk.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core as R
from repro.core.backend.cache import stencil_fingerprint as r_fingerprint
from repro.fv3 import dyncore as RD
from repro.fv3 import state as RSt

import repro_torch.core as T
from repro_torch.core import TuningCache, set_default_cache
from repro_torch.core.backend import cache as TC
from repro_torch.core.backend.cache import stencil_fingerprint
from repro_torch.fv3 import dyncore as TD
from repro_torch.fv3 import state as TSt

PROGRAMS = ["build_csw_program", "build_dsw_program",
            "build_tracer_program", "build_remap_program"]
HARDWARE = ["tpu-v5e", "v100", "p100"]
CFG = dict(npx=12, nk=8, n_tracers=1)
STEP_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _own_tuning_cache(tmp_path_factory):
    """The port's tuning cache of this file: a throwaway file, never the
    working tree's ``.repro_cache/torch_tuning.json``."""
    set_default_cache(TuningCache(
        tmp_path_factory.mktemp("torch_tuning") / "torch_tuning.json"))
    yield
    set_default_cache(None)


def _pair(builder, **kw):
    rc, tc = RD.FV3Config(**{**CFG, **kw}), TD.FV3Config(**{**CFG, **kw})
    return (getattr(RD, builder)(rc, rc.seq_dom()),
            getattr(TD, builder)(tc, tc.seq_dom()))


def _nodes(prog, fingerprint):
    return [(n.label, n.extend, fingerprint(n.stencil),
             None if n.schedule is None else n.schedule.to_dict())
            for n in prog.all_nodes()]


@pytest.mark.parametrize("hw", HARDWARE)
@pytest.mark.parametrize("opt_level", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("builder", PROGRAMS)
def test_optimized_program_matches_reference(builder, opt_level, hw):
    ref_prog, port_prog = _pair(builder)
    rp, rrep = R.optimize_program(ref_prog, opt_level=opt_level,
                                  backend="jnp", hardware=hw,
                                  verify="passes")
    tp, trep = T.optimize_program(port_prog, opt_level=opt_level,
                                  backend="cuda", hardware=hw,
                                  verify="passes")
    assert _nodes(tp, stencil_fingerprint) == _nodes(rp, r_fingerprint)
    assert trep.rules == rrep.rules
    assert [p.name for p in trep.passes] == [p.name for p in rrep.passes]
    assert [p.rewrites for p in trep.passes] == \
        [p.rewrites for p in rrep.passes]
    assert (trep.kernels_before, trep.kernels_after) == \
        (rrep.kernels_before, rrep.kernels_after)
    assert (trep.hbm_bytes_before, trep.hbm_bytes_after) == \
        (rrep.hbm_bytes_before, rrep.hbm_bytes_after)
    assert trep.total_verify_violations == 0
    assert trep.hardware == hw


def test_csw_kernel_ladder_matches_reference():
    ref_prog, port_prog = _pair("build_csw_program")
    got = [T.compile_program(port_prog, "cuda", opt_level=lvl,
                             hardware="tpu-v5e", device="cpu").n_kernels
           for lvl in range(5)]
    assert got == [R.compile_program(ref_prog, "jnp",
                                     opt_level=lvl).n_kernels
                   for lvl in range(5)] == [7, 5, 1, 1, 1]


@pytest.mark.parametrize("hw", ["h100", "tpu-v5e"])
def test_perf_model_matches_reference(hw):
    ref_prog, port_prog = _pair("build_dsw_program")
    rhw = "tpu-v5e" if hw == "h100" else hw
    for rn, tn in zip(ref_prog.all_nodes(), port_prog.all_nodes()):
        assert T.node_bytes(port_prog, tn) == R.node_bytes(ref_prog, rn)
        assert T.node_flops(port_prog, tn) == R.node_flops(ref_prog, rn)
    assert T.program_bound_seconds(port_prog, rhw) == \
        R.program_bound_seconds(ref_prog, rhw)
    got = [(r.label, r.bytes_moved, r.bound_s)
           for r in T.program_report(port_prog, hw=rhw)]
    assert got == [(r.label, r.bytes_moved, r.bound_s)
                   for r in R.program_report(ref_prog, hw=rhw)]


def test_transfer_tuning_matches_reference():
    (rs, ts), (rt, tt) = _pair("build_dsw_program"), _pair(
        "build_tracer_program")
    ref = R.transfer_tune(rs, rt, hw="tpu-v5e", cache=None)
    got = T.transfer_tune(ts, tt, hw="tpu-v5e", cache=None)
    for r, g in zip(ref[:2], got[:2]):
        assert [p.to_dict() for p in g.patterns] == \
            [p.to_dict() for p in r.patterns]
        assert g.n_configs == r.n_configs
    assert got[2].applied == ref[2].applied
    assert _nodes(tt, stencil_fingerprint) == _nodes(rt, r_fingerprint)


@pytest.mark.parametrize("hw", HARDWARE + ["h100"])
def test_tuned_solver_schedules_at_production_depth(hw):
    """At C192 L80 the TPU rules K-block d_sw's precompute_pe (a whole
    column misses VMEM); the GPU rules keep every solver whole-column."""
    ref_prog, port_prog = _pair("build_dsw_program", npx=192, nk=80)
    tp, _ = T.optimize_program(port_prog, opt_level=3, backend="cuda",
                               hardware=hw)
    (node,) = [n for n in tp.all_nodes() if n.stencil.is_vertical_solver()]
    if hw != "h100":
        rp, _ = R.optimize_program(ref_prog, opt_level=3, backend="jnp",
                                   hardware=hw)
        assert _nodes(tp, stencil_fingerprint) == _nodes(rp, r_fingerprint)
    assert node.schedule.block_k == (16 if hw == "tpu-v5e" else 0)


def test_tuning_cache_is_the_ports_own_file(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    cache = TC.TuningCache()
    assert cache.path == tmp_path / "torch_tuning.json"
    _, port_prog = _pair("build_dsw_program")
    node = next(n for n in port_prog.all_nodes()
                if n.base_name == "precompute_pe")
    dom = port_prog.node_dom(node)
    first = T.tune_stencil(node.stencil, dom, hw="tpu-v5e", cache=cache)
    again = T.tune_stencil(node.stencil, dom, hw="tpu-v5e",
                           cache=TC.TuningCache())
    assert not first[0].from_cache and again[0].from_cache
    assert again[0].schedule == first[0].schedule
    assert cache.path.exists() and not (tmp_path / "tuning.json").exists()
    assert TC.COST_MODEL_VERSION == R.backend.cache.COST_MODEL_VERSION


def test_wallclock_objective_times_a_compiled_program():
    """The tuner's measured objective: the median seconds of a compiled
    program's call (on a card it synchronizes around each call)."""
    _, port_prog = _pair("build_dsw_program")
    node = next(n for n in port_prog.all_nodes()
                if n.base_name == "precompute_pe")
    dom = port_prog.node_dom(node)
    run = T.compile_stencil(node.stencil, dom, backend="cuda")
    fields = {f: torch.ones(dom.padded_shape()) for f in node.stencil.fields}
    secs = T.wallclock(run, fields, {"ptop": 10.0}, iters=2)
    assert 0.0 < secs < 60.0
    timed = T.tune_stencil(node.stencil, dom, hw="tpu-v5e",
                           measure=lambda sched: 1.0)
    assert timed[0].cost == 1.0 and not timed[0].from_cache


@pytest.mark.parametrize("n_members", [3, 8])
def test_auto_chunk_picks_the_reference_chunk(n_members):
    ref_prog, port_prog = _pair("build_dsw_program")
    for hw in ("tpu-v5e", "p100"):
        got = T.tune_program_chunk(port_prog, backend="cuda", hw=hw,
                                   n_members=n_members)
        want = R.tune_program_chunk(ref_prog, backend="jnp", hw=hw,
                                    n_members=n_members)
        assert got == want
        (rn, tn) = (next(n for n in p.all_nodes()
                         if n.base_name == "fx_ppm")
                    for p in (ref_prog, port_prog))
        assert T.tune_member_chunk(
            tn.stencil, port_prog.node_dom(tn), hw=hw, backend="cuda",
            n_members=n_members) == R.tune_member_chunk(
            rn.stencil, ref_prog.node_dom(rn), hw=hw, backend="jnp",
            n_members=n_members)
    fn = T.compile_program(port_prog, "torch", hardware="tpu-v5e",
                           n_members=n_members, batch="vmap:auto",
                           device="cpu")
    ref = R.compile_program(ref_prog, "jnp", n_members=n_members,
                            batch="vmap:auto")
    assert (fn.member_chunk, fn.n_chunks, fn.batch) == \
        (ref.member_chunk, ref.n_chunks, ref.batch)


@pytest.fixture(scope="module")
def reference_steps():
    cfg = RD.FV3Config(npx=12, nk=6, n_tracers=2)
    s0 = {k: np.asarray(v) for k, v in RSt.init_state(cfg).items()}
    out = {}
    for lvl in (0, 3, 4):
        step = RD.make_step_sequential(cfg, backend="jnp", opt_level=lvl)
        s1 = step({k: jnp.asarray(v) for k, v in s0.items()})
        out[lvl] = ({k: np.asarray(v) for k, v in s1.items()}, step)
    return cfg, s0, out


@pytest.mark.parametrize("opt_level", [3, 4])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_optimized_step_matches_reference_step(reference_steps, opt_level,
                                               backend):
    cfg_r, s0, out = reference_steps
    ref, ref_step = out[opt_level]
    cfg = TD.FV3Config(npx=12, nk=6, n_tracers=2)
    step = TD.make_step_sequential(cfg, backend=backend, opt_level=opt_level,
                                   hardware="tpu-v5e", device="cpu")
    got = step(TSt.state_from_reference(s0, "cpu"))
    assert step.n_kernels == ref_step.n_kernels < 110
    assert {k: r.rules if r else None
            for k, r in step.opt_report.items()} == \
        {k: r.rules if r else None for k, r in ref_step.opt_report.items()}
    h, n = cfg.halo, cfg.npx
    for k in ref:
        assert got[k].dtype == torch.float32
        err = np.abs(got[k].numpy()[..., h:h + n, h:h + n]
                     - ref[k][..., h:h + n, h:h + n]).max()
        assert err < STEP_ATOL, (k, err)


def test_fusion_moves_the_step_as_the_reference_does(reference_steps):
    """The reference's opt-3 step is not its opt-0 step: fusion moves the
    result (in d_sw) by more than round-off.  The port's opt-3 step moves
    by the same amount, field by field, so the two differences agree to
    well under their size."""
    cfg_r, s0, out = reference_steps
    cfg = TD.FV3Config(npx=12, nk=6, n_tracers=2)
    h, n = cfg.halo, cfg.npx
    got = {lvl: TD.make_step_sequential(cfg, backend="torch", opt_level=lvl,
                                        hardware="tpu-v5e", device="cpu")(
        TSt.state_from_reference(s0, "cpu")) for lvl in (0, 3)}
    moved = 0.0
    for k in out[0][0]:
        ref_d = (out[3][0][k] - out[0][0][k])[..., h:h + n, h:h + n]
        got_d = (got[3][k] - got[0][k]).numpy()[..., h:h + n, h:h + n]
        moved = max(moved, np.abs(ref_d).max())
        assert np.abs(got_d - ref_d).max() < STEP_ATOL, k
    assert moved > 0.0


def test_default_step_is_opt3_for_the_h100():
    cfg = TD.FV3Config(npx=12, nk=6, n_tracers=2)
    step = TD.make_step_sequential(cfg, device="cpu")
    reports = list(step.opt_report.values())
    assert all(r.opt_level == 3 and r.hardware == "h100" for r in reports)
    assert step.n_kernels == TD.make_step_sequential(
        cfg, opt_level=3, hardware="h100", device="cpu").n_kernels
    assert TD.make_step_sequential(cfg, opt_level=0,
                                   device="cpu").opt_report == \
        dict.fromkeys(step.opt_report)
