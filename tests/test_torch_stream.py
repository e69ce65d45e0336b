"""The K1 launch plan and the K3 search rule, read from the kernels'
instruction stream on the CPU.

K1 runs a group of consecutive PARALLEL statements in one launch, each
thread running the group's records in order at its points
(``cuda.parallel_groups``); ``_StreamEvaluator`` (``test_torch_cuda.py``)
reads the encoded stream the way the kernels do.  Here: every node of the
four step programs at opt 0 and 3, as launched, equals the plain stencil;
the grouping rule starts a new launch exactly where a thread could see
another thread mid-launch; and the level search the stream asks for keeps
the reference's marching rule (``_march_search``) on columns that are not
monotone and on NaNs, against the reference's Pallas kernel in interpret
mode.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.backend import compile_stencil as r_compile_stencil
from repro.fv3 import stencils as RS

from repro_torch.core.backend import TuningCache, compile_program
from repro_torch.core.backend import cuda as C
from repro_torch.core.backend import set_default_cache
from repro_torch.core.stencil import (Assign, Computation, DomainSpec,
                                      FieldAccess, Stencil, ir)
from repro_torch.fv3 import dyncore as TD
from repro_torch.fv3 import stencils as TS

from test_torch_cuda import _StreamEvaluator

DOM = DomainSpec(ni=6, nj=5, nk=4, halo=3, extend=(1, 1))


@pytest.fixture(autouse=True, scope="module")
def _own_tuning_cache(tmp_path_factory):
    set_default_cache(TuningCache(
        tmp_path_factory.mktemp("torch_tuning") / "torch_tuning.json"))
    yield
    set_default_cache(None)


def _stream(run, fields, params):
    """Every launch of ``run`` read in order; the written fields."""
    env = C.plain.prepare_env(run.stencil, run.dom, fields, torch.float32)
    ev = _StreamEvaluator([env[n] for n in run.slot_names],
                          [float(params[p]) for p in run.stencil.params], [])
    for p in run.programs:
        ev.consts = torch.tensor(p.consts or [0.0], dtype=torch.float32)
        ev.launch(p)
    return {w: env[w] for w in run.written}


def _search_coords(stencil):
    return {e.coord for c in stencil.computations for s in c.statements
            for e in C._walk(s.value) if isinstance(e, ir.LevelSearch)}


def _inputs(stencil, dom, rng, lead=(2,)):
    """Uniform inputs; Courant numbers below 1; search coordinates
    monotone columns, where the plain version's bisection and the
    kernels' march agree."""
    coords = _search_coords(stencil)
    out = {}
    for f in stencil.fields:
        lo, hi = (-0.9, 0.9) if f in ("cx", "cy") else (0.5, 1.5)
        a = rng.uniform(lo, hi, lead + dom.padded_shape(
            stencil.is_interface(f)))
        if f in coords:
            a = np.cumsum(a, axis=-3)
        out[f] = torch.from_numpy(a.astype(np.float32))
    return out


#: (K1 launches, PARALLEL statements) of one call of each step program at
#: C6 with 6 levels; the remap's statements each read the one before at a
#: K offset, so none of them share a launch
GROUPS = {("c_sw+riem", 0): (5, 20), ("d_sw", 0): (29, 81),
          ("tracer_2d", 0): (46, 142), ("vertical_remap", 0): (17, 17),
          ("c_sw+riem", 3): (3, 16), ("d_sw", 3): (17, 72),
          ("tracer_2d", 3): (30, 126), ("vertical_remap", 3): (17, 17)}


@pytest.mark.parametrize("program, opt_level", sorted(GROUPS))
def test_launch_groups_of_the_step_programs_match_plain(program, opt_level):
    """Each node of a step program, launch group by launch group, equals
    its plain stencil; and the groups cut the launches to :data:`GROUPS`."""
    cfg = TD.FV3Config(npx=6, nk=6)
    prog = next(p for p in TD._build_programs(cfg, cfg.seq_dom())
                if p.name == program)
    fn = compile_program(prog, "cuda", opt_level=opt_level, device="cpu")
    params = TD.default_params(cfg)
    rng = np.random.default_rng(opt_level)
    statements = launches = 0
    for node in fn.program.all_nodes():
        run = C.CudaStencil(node.stencil, fn.program.node_dom(node),
                            schedule=node.schedule)
        fields = _inputs(run.stencil, run.dom, rng)
        ps = {p: params[p] for p in run.stencil.params}
        got = _stream(run, fields, ps)
        want = run.plain(fields, ps)
        for w in run.written:
            torch.testing.assert_close(got[w], want[w], rtol=1e-6, atol=1e-6,
                                       msg=f"{node.label}.{w}")
        for p in run.programs:
            if p.kind == "horizontal":
                launches += 1
                statements += len(p.ir.statements)
    assert (launches, statements) == GROUPS[program, opt_level]


def _probe(*statements, fields=("q", "a", "x", "out")):
    return Stencil("probe", (Computation(ir.PARALLEL, statements),), fields,
                   fields[1:])


Q, A, X = FieldAccess("q"), FieldAccess("a"), FieldAccess("x")
SEARCH_A = ir.index_search("a", Q, ir.at_found("x"))
GROUP_CASES = {
    # a later statement reads an earlier target only at its own point
    "point read": ([Assign("a", Q * Q), Assign("out", A + Q)], [2]),
    # ... at a horizontal offset, or at a K offset: a new launch
    "i offset": ([Assign("a", Q * Q), Assign("out", A.shift((1, 0, 0)))],
                 [1, 1]),
    "j offset": ([Assign("a", Q * Q), Assign("out", A.shift((0, -1, 0)))],
                 [1, 1]),
    "k offset": ([Assign("a", Q * Q), Assign("out", A.shift((0, 0, 1)))],
                 [1, 1]),
    # ... as a search coordinate
    "search coordinate": ([Assign("a", Q + 1.0), Assign("out", SEARCH_A)],
                          [1, 1]),
    # a statement writes what an earlier one read away from the point
    "write after offset read": ([Assign("out", X.shift((0, 0, -1)) + Q),
                                 Assign("x", Q * 2.0)], [1, 1]),
    "write after point read": ([Assign("out", X + Q), Assign("x", Q * 2.0),
                                Assign("a", X * Q)], [3]),
    # three launches: the cut restarts what the next one may not read
    "chain": ([Assign("a", Q * Q), Assign("x", A.shift((1, 0, 0))),
               Assign("out", X.shift((0, 1, 0)) + A)], [1, 1, 1]),
}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_grouping_rule_cuts_launches_where_threads_would_race(case):
    statements, sizes = GROUP_CASES[case]
    st = _probe(*statements)
    programs = C.encode_stencil(st, DOM)
    assert [len(p.records()) for p in programs] == sizes
    assert [len(p.ir.statements) for p in programs] == sizes
    rng = np.random.default_rng(len(case))
    fields = {f: torch.from_numpy(rng.uniform(0.5, 1.5, (2,) + DOM.padded_shape())
                                  .astype(np.float32)) for f in st.fields}
    fields["a"] = torch.cumsum(fields["a"], dim=-3)  # a search coordinate
    run = C.CudaStencil(st, DOM)
    got, want = _stream(run, fields, {}), run.plain(fields, {})
    for w in run.written:
        torch.testing.assert_close(got[w], want[w], rtol=1e-6, atol=1e-6)


def test_a_temporary_read_only_inside_its_launch_stays_on_the_stack():
    """``fx_ppm``'s six temporaries stay on the stack (no store, no
    reload); a temporary read outside its writer's box is stored."""
    (p,) = C.CudaStencil(TS.fx_ppm, DOM).programs
    assert p.kept == ("bl", "br", "b0", "fcand", "lo", "hi")
    stores = [op for op, *_ in C.decode(p.prog, p.records()[0][7],
                                        len(p.prog)) if op == C.OP_STORE]
    assert len(stores) == 1 and sum(s for *_, s in p.work()) == 1
    region = ir.Region(i_lo=(0, 0), i_hi=(0, 2))
    st = Stencil("probe", (Computation(ir.PARALLEL, (
        Assign("t", Q * Q, region=region), Assign("out", FieldAccess("t") + Q),
    )),), ("q", "out"), ("out",))
    (p,) = C.encode_stencil(st, DOM)
    assert p.kept == () and len(p.records()) == 2


def _nonmonotone_inputs(rng):
    """Coordinates in random order, with NaNs in the coordinate columns
    and among the targets."""
    shape = DOM.padded_shape(True)
    pe = rng.uniform(0.0, 1.0, shape)
    pe_ref = rng.uniform(-0.1, 1.1, shape)
    pe.flat[rng.choice(pe.size, 12, replace=False)] = np.nan
    pe_ref.flat[rng.choice(pe_ref.size, 6, replace=False)] = np.nan
    fm = rng.uniform(0.0, 2.0, shape)
    return {k: v.astype(np.float32) for k, v in
            (("fm", fm), ("pe", pe), ("pe_ref", pe_ref),
             ("fi", np.zeros(shape)))}


@pytest.mark.parametrize("seed", [0, 1])
def test_search_keeps_the_reference_march_on_any_column(seed):
    """The stream's level search on unsorted columns with NaNs: the last
    layer whose coordinate does not exceed the target (a NaN never
    qualifies), as the reference's Pallas kernel marches it in interpret
    mode, and as the plain version computes it with the march in place of
    its bisection."""
    ins = _nonmonotone_inputs(np.random.default_rng(seed))
    tins = {k: torch.from_numpy(v)[None] for k, v in ins.items()}
    run = C.CudaStencil(TS.interface_interp, DOM)
    got = _stream(run, tins, {})["fi"][0]
    want = r_compile_stencil(RS.interface_interp, DOM, backend="pallas-tpu",
                             interpret=True)(
        {k: jnp.asarray(v) for k, v in ins.items()}, {})["fi"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6, equal_nan=True)
    with C.marching_plain():
        plain = run.plain(tins, {})["fi"][0]
    torch.testing.assert_close(got, plain, rtol=0, atol=0, equal_nan=True)
    # the bisection does differ here: the columns are not monotone
    assert not torch.equal(run.plain(tins, {})["fi"][0].nan_to_num(),
                           got.nan_to_num())


def test_march_levels_equals_bisection_on_monotone_columns():
    rng = np.random.default_rng(3)
    cwin = torch.from_numpy(np.cumsum(rng.uniform(0, 1, (2, 9, 4, 5)), 1))
    target = torch.from_numpy(rng.uniform(-0.5, 5.0, (2, 9, 4, 5)))
    for lo, hi in ((0, 9), (1, 8), (2, 3)):
        assert torch.equal(C.march_levels(cwin, target, lo, hi),
                           C.plain.bisect_levels(cwin, target, lo, hi))
