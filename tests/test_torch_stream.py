"""The K1 and K2 launch plans and the K3 search rule, read from the
kernels' instruction stream on the CPU.

K1 runs a group of consecutive PARALLEL statements in one launch, each
thread running the group's records in order at its points
(``cuda.parallel_groups``); K2 runs a FORWARD/BACKWARD computation with a
thread per ``cuda.COLUMNS`` neighbouring columns, the marching-previous
level of a slot the march writes read from the thread's carry (``CARRY``)
and the reads no store of the march can change copied a level ahead
(``AHEAD``).  ``_StreamEvaluator`` (``test_torch_cuda.py``) reads the
encoded stream the way the kernels do.  Here: every node of the four step
programs at opt 0 and 3, as launched, equals the plain stencil (and, for
the solver computations, the reference's own stencil); the grouping rule
starts a new launch exactly where a thread could see another thread
mid-launch; the carry empties at each member and leaves to memory what it
must; and the level search the stream asks for keeps the reference's
marching rule (``_march_search``) on columns that are not monotone and on
NaNs, against the reference's Pallas kernel in interpret mode.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core as R
from repro.core.backend import compile_stencil as r_compile_stencil
from repro.fv3 import dyncore as RD
from repro.fv3 import stencils as RS

from repro_torch.core import optimize_program
from repro_torch.core.backend import TuningCache, compile_program
from repro_torch.core.backend import cuda as C
from repro_torch.core.backend import set_default_cache
from repro_torch.core.stencil import (Assign, Computation, DomainSpec,
                                      FieldAccess, Stencil, ir)
from repro_torch.fv3 import dyncore as TD
from repro_torch.fv3 import stencils as TS

from test_torch_cuda import _StreamEvaluator, _member_view

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


#: nodes with a FORWARD/BACKWARD computation of one call of each step
#: program at C6 with 6 levels (tracer_2d has none)
SOLVER_NODES = {("c_sw+riem", 0): 2, ("d_sw", 0): 1, ("tracer_2d", 0): 0,
                ("vertical_remap", 0): 11, ("c_sw+riem", 3): 1,
                ("d_sw", 3): 1, ("tracer_2d", 3): 0,
                ("vertical_remap", 3): 1}
THOMAS = {"aa": (-0.5, 0.5), "cc": (-0.5, 0.5), "bb": (2.0, 3.0)}


@pytest.mark.parametrize("program, opt_level", sorted(GROUPS))
def test_column_launches_of_the_step_programs_match_plain_and_reference(
        program, opt_level):
    """Every node of a step program with a FORWARD/BACKWARD computation,
    each solver computation run as K2 launches it (``cuda.COLUMNS`` rows a
    thread, ragged at the window's edge; carried slots from the carry, the
    safe reads copied a level ahead), equals its plain stencil, and the
    fields its solver computations write equal the reference's own stencil
    of the same node (the reference's program at the same opt level, on the
    reference's TPU preset, which the port's programs match node for node;
    a fused node's PARALLEL outputs are K1's, held to the plain version
    here); and the carry serves the march's marching-previous reads."""
    rc, tc = RD.FV3Config(npx=6, nk=6), TD.FV3Config(npx=6, nk=6)
    ref_prog = next(p for p in RD._build_programs(rc, rc.seq_dom())
                    if p.name == program)
    port_prog = next(p for p in TD._build_programs(tc, tc.seq_dom())
                     if p.name == program)
    rp, _ = R.optimize_program(ref_prog, opt_level=opt_level, backend="jnp",
                               hardware="tpu-v5e")
    tp, _ = optimize_program(port_prog, opt_level=opt_level, backend="cuda",
                             hardware="tpu-v5e")
    rnodes = {n.label: n for n in rp.all_nodes()}
    params = TD.default_params(tc)
    rng = np.random.default_rng(opt_level + 7)
    solvers = 0
    for node in tp.all_nodes():
        if not node.stencil.is_vertical_solver():
            continue
        run = C.CudaStencil(node.stencil, tp.node_dom(node))
        assert any(p.kind == "column" for p in run.programs)
        fields = _inputs(run.stencil, run.dom, rng)
        for f, (lo, hi) in THOMAS.items():  # a diagonally dominant solve
            if f in fields:
                fields[f] = torch.from_numpy(rng.uniform(
                    lo, hi, fields[f].shape).astype(np.float32))
        ps = {p: params[p] for p in run.stencil.params}
        ev = _reader(run, fields, ps)
        got = {w: ev.env[w] for w in run.written}
        want = run.plain(fields, ps)
        rnode = rnodes[node.label]
        ref = r_compile_stencil(rnode.stencil, rp.node_dom(rnode),
                                backend="jnp")
        marched = {st.target for c in run.stencil.computations
                   if c.direction is not ir.PARALLEL for st in c.statements}
        for t in range(2):
            rgot = ref({f: jnp.asarray(v[t].numpy())
                        for f, v in fields.items()}, ps)
            for w in marched & set(run.written):
                np.testing.assert_allclose(got[w][t].numpy(),
                                           np.asarray(rgot[w]), rtol=1e-6,
                                           atol=1e-6,
                                           err_msg=f"{node.label}.{w}")
        for w in run.written:
            torch.testing.assert_close(got[w], want[w], rtol=1e-6, atol=1e-6,
                                       msg=f"{node.label}.{w}")
        if any(p.carried for p in run.programs):
            assert ev.carry_reads["carry"] > 0
        solvers += 1
    assert solvers == SOLVER_NODES[program, opt_level]


def _reader(run, fields, params):
    """A reader that has run every launch of ``run`` on ``fields``; its
    ``env`` holds the results."""
    env = C.plain.prepare_env(run.stencil, run.dom, fields, torch.float32)
    ev = _StreamEvaluator([env[n] for n in run.slot_names],
                          [float(params[p]) for p in run.stencil.params], [])
    for p in run.programs:
        ev.consts = torch.tensor(p.consts or [0.0], dtype=torch.float32)
        ev.launch(p)
    ev.env = env
    return ev


X2, Q2 = FieldAccess("x"), FieldAccess("q")


def _march(*statements, direction=ir.FORWARD, fields=("q", "x")):
    return Stencil("march", (Computation(direction, statements),), fields,
                   ("x",))


@pytest.mark.parametrize("mchunk", [1, 2])
def test_carry_resets_for_each_member(mchunk):
    """A march whose every level reads its own marching-previous level,
    over 4 members: one reader per member chunk runs its members in turn,
    emptying the carry at each member's first level as the kernel does.
    Each member's first level reads memory (the member's own old value,
    edge-clamped), and every member equals the plain march; a carry left
    over from the member before would not."""
    st = _march(Assign("x", X2.shift((0, 0, -1)) * 0.5 + Q2))
    M = 4
    run = C.CudaStencil(st, DOM, n_members=M, member_chunk=mchunk)
    (p,) = run.programs
    assert p.carried == (run.slot_names.index("x"),)
    rng = np.random.default_rng(mchunk)
    fields = {f: torch.from_numpy(rng.uniform(0.5, 1.5, (M, 2) +
                                              DOM.padded_shape())
                                  .astype(np.float32)) for f in st.fields}
    want = run.plain(fields, {})
    for reset in (True, False):
        env = C.plain.prepare_env(run.stencil, DOM, fields, torch.float32)
        args = run.launch_args(env, {})
        views = [_member_view(env[n], args, s)
                 for s, n in enumerate(run.slot_names)]
        for chunk in range(M // mchunk):
            ev = _StreamEvaluator([v[chunk * mchunk] for v in views], [],
                                  p.consts)
            for mm in range(mchunk):
                ev.slots = [v[chunk * mchunk + mm] for v in views]
                if reset:
                    ev.reset_carry()
                ev.launch(p)
        same = torch.equal(env["x"], want["x"])
        assert same == (reset or mchunk == 1), (reset, mchunk)


MEMORY_CASES = {
    # a written field two levels back: a load, never the carry
    "dk -2": ([Assign("x", X2.shift((0, 0, -2)) + Q2)], ir.FORWARD, 0),
    # the old value at the march's first level: the carry is empty there
    "first level": ([Assign("x", X2.shift((0, 0, -1)) * 0.5 + Q2,
                             interval=ir.interval(1, None))],
                    ir.FORWARD, 1),
    # written on part of the window only: the other columns read memory
    "region": ([Assign("x", Q2 * 2.0,
                       region=ir.Region(i_lo=(0, 0), i_hi=(0, 2))),
                Assign("x", X2.shift((0, 0, 1)) + Q2,
                       interval=ir.interval(0, -1))],
               ir.BACKWARD, 1),
    # the next level of the march is not its previous one: a load
    "next level": ([Assign("x", X2.shift((0, 0, 1)) + Q2)], ir.FORWARD, 0),
    # written twice a level, the second time on rows 0-1 of a thread's 4
    # only: the carry holds each row's last store, the first one's on the
    # other rows
    "rows rewritten": ([Assign("x", X2.shift((0, 0, -1)) * 0.5 + Q2,
                               interval=ir.interval(1, None)),
                        Assign("x", Q2 * 3.0,
                               region=ir.Region(j_lo=(0, 0), j_hi=(0, 2)))],
                       ir.FORWARD, 1),
}


@pytest.mark.parametrize("case", sorted(MEMORY_CASES))
def test_carry_leaves_to_memory_what_it_must(case):
    """Reads the carry cannot serve still go to memory: a written field at
    dk = -2 or at the next level is a LOAD (the march carries nothing); a
    CARRY read at a level where the column stored nothing (the march's
    first level, a column outside the writer's region) reads memory; and
    the march equals the plain one."""
    statements, direction, n_carried = MEMORY_CASES[case]
    st = _march(*statements, direction=direction)
    run = C.CudaStencil(st, DOM)
    (p,) = run.programs
    assert len(p.carried) == n_carried
    sources = {kind for *_, pc, end in p.records()
               for _, _, src, _, _, (src2, _) in C.decode(p.prog, pc, end)
               for kind in (src, src2)}
    assert (C.SRC_CARRY in sources) == bool(n_carried)
    # x is written, so its reads at other levels are never copied ahead
    assert all(key[0] != run.slot_names.index("x") or key[3] == 0
               for key in p.ahead_keys())
    rng = np.random.default_rng(len(case))
    fields = {f: torch.from_numpy(rng.uniform(0.5, 1.5, (2,) +
                                              DOM.padded_shape())
                                  .astype(np.float32)) for f in st.fields}
    ev = _reader(run, fields, {})
    torch.testing.assert_close(ev.env["x"], run.plain(fields, {})["x"],
                               rtol=1e-6, atol=1e-6)
    if n_carried:
        assert ev.carry_reads["memory"] > 0 and ev.carry_reads["carry"] > 0


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
