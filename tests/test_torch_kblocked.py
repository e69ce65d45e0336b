"""K4, the K-blocked solver kernel of the port, checked on the CPU.

K4 (``stencil_kblocked_kernel`` in ``csrc/stencil_kernels.cu``) replaces the
reference's ``_vertical_kernel_kblocked``: a single-direction solver under a
K-blocked schedule marches all its statements level by level in marching
order.  On this card the slab is a depth of prefetch: K4 is K2's march (the
same template) over the interleaved statements, 4 rows a thread, the carry
on chip, the AHEAD copies taken a slab (``cuda.copy_depth`` levels) ahead,
and a read outside a slot's K extent 0, the reference's carry zeroed at
each member's first slab.  It cannot run here, so the stream reader of
``test_torch_cuda`` (``_StreamEvaluator``, written from the kernels' source)
reads the launch as the kernel runs it — ragged rows and columns, the carry
emptied per member, the copies of each group as memory holds them a group
earlier.  It must give the whole-column march of the plain lowering (K4's
plain version) exactly and the reference's own K-blocked Pallas kernel in
interpret mode, for ``precompute_pe`` (the node the reference's
``"tpu-v5e"`` schedules K-block), FORWARD and BACKWARD single-direction
solvers, a solver that reads a field it writes before writing it, an
SGF-fused solver, and a member axis.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import StencilProgram as RProgram
from repro.core import compile_program as r_compile_program
from repro.core.backend import compile_stencil as r_compile_stencil
from repro.core.stencil import Schedule as RSchedule
from repro.core.stencil import gtstencil as r_gtstencil
from repro.core.transforms import subgraph_fuse as r_subgraph_fuse
from repro.fv3 import stencils as RS

from repro_torch.core import StencilProgram, compile_program, set_default_cache
from repro_torch.core import optimize_program
from repro_torch.core.backend import TuningCache
from repro_torch.core.backend import cuda as C
from repro_torch.core.stencil import (Assign, Computation, DomainSpec, Field,
                                      FieldAccess, Interval, Schedule, Stencil,
                                      gtstencil, ir, solver_k_blockable)
from repro_torch.core.transforms import subgraph_fuse
from repro_torch.fv3 import dyncore as TD
from repro_torch.fv3 import stencils as TS

from test_torch_cuda import _StreamEvaluator, _member_view

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _own_tuning_cache(tmp_path_factory):
    """The port's tuning cache of this file: a throwaway file, never the
    working tree's ``.repro_cache/torch_tuning.json``."""
    set_default_cache(TuningCache(
        tmp_path_factory.mktemp("torch_tuning") / "torch_tuning.json"))
    yield
    set_default_cache(None)


def _fwd_cumsum(delp: Field, q: Field, fm: Field):
    with computation(FORWARD):
        with interval(0, 1):
            fm = q * delp
        with interval(1, None):
            fm = fm[0, 0, -1] + q[0, 0, -1] * delp[0, 0, -1]


def _bwd_subst(rhs: Field, cc: Field, pp: Field):
    with computation(BACKWARD):
        with interval(-1, None):
            pp = rhs
        with interval(0, -1):
            pp = rhs[0, 0, 0] - cc[0, 0, 0] * pp[0, 0, 1]


def _fwd_decay(q: Field, x: Field):
    # every level reads the marching-previous one, the first level too:
    # the reference's K-blocked kernel reads its zeroed carry there, the
    # plain march the level itself (edge-clamped)
    with computation(FORWARD):
        with interval(0, None):
            x = x[0, 0, -1] * 0.5 + q


def _fwd_partial(q: Field, acc: Field, out: Field):
    # acc: its old value is read at each level before the write, and level
    # 0, never written, is read at k = 1
    with computation(FORWARD):
        with interval(1, None):
            out = acc + q
            acc = acc[0, 0, -1] + q


# the same source parsed by each package
SOLVERS = {
    "precompute_pe": (TS.precompute_pe, RS.precompute_pe, ("delp", "pe"),
                      {"ptop": 10.0}),
    "fwd_cumsum": (gtstencil(_fwd_cumsum), r_gtstencil(_fwd_cumsum),
                   ("delp", "q", "fm"), {}),
    "bwd_subst": (gtstencil(_bwd_subst), r_gtstencil(_bwd_subst),
                  ("rhs", "cc", "pp"), {}),
    "fwd_partial": (gtstencil(_fwd_partial), r_gtstencil(_fwd_partial),
                    ("q", "acc", "out"), {}),
}


def _fused_solver(dom):
    """precompute_pe & fwd_cumsum SGF-fused, in each package (the
    reference's tests/test_level_search.py fused-solver case)."""
    out = []
    for prog_cls, pe, cum, fuse in (
            (StencilProgram, TS.precompute_pe, SOLVERS["fwd_cumsum"][0],
             subgraph_fuse),
            (RProgram, RS.precompute_pe, SOLVERS["fwd_cumsum"][1],
             r_subgraph_fuse)):
        p = prog_cls("fused_solver", dom)
        for f in ("delp", "q", "fm", "pe"):
            p.declare(f)
        n1 = p.add(pe, {"delp": "delp", "pe": "pe"})
        n2 = p.add(cum, {"delp": "delp", "q": "q", "fm": "fm"})
        p.propagate_extents()
        out.append(fuse(p, p.states[0], [n1, n2]).stencil)
    return out


def _case(name, dom):
    if name == "fused":
        port, ref = _fused_solver(dom)
        return port, ref, ("delp", "q", "fm", "pe"), {"ptop": 10.0}
    return SOLVERS[name]


def _inputs(fields, dom, seed, lead=()):
    rng = np.random.default_rng(seed)
    return {f: rng.uniform(0.3, 1.3, lead + dom.padded_shape()).astype(
        np.float32) for f in fields}


def _walk(run, fields, params, members=None):
    """Run ``run``'s K4 launch through the stream reader; returns its
    outputs.  With ``members``, each member's march starts from an empty
    carry, as the kernel's does."""
    (p,) = run.programs
    assert p.kind == "kblocked"
    env = C.plain.prepare_env(run.stencil, run.dom, fields, torch.float32)
    pvals = [float(params[q]) for q in run.stencil.params]
    views = ([[env[n] for n in run.slot_names]] if members is None else
             [[env[n][m].reshape((-1,) + env[n].shape[-3:])
               for n in run.slot_names] for m in range(members)])
    for slots in views:
        _StreamEvaluator(slots, pvals, p.consts).launch(p)
    return {w: env[w] for w in run.written}


#: a window whose rows are no multiple of 4 (K4's rows a thread) and whose
#: columns are no multiple of a warp; 32 levels, so block_k 8 and 16 K-block
#: it
RAGGED = DomainSpec(ni=5, nj=7, nk=32, halo=2)


@pytest.mark.parametrize("name", ["precompute_pe", "fwd_cumsum", "bwd_subst",
                                  "fwd_partial", "fused"])
@pytest.mark.parametrize("bk", [8, 16])
def test_slab_walk_matches_whole_column_and_reference(name, bk):
    """K4 as launched on a ragged window: exactly its plain version (the
    whole-column march), and the reference's K-blocked Pallas kernel."""
    dom = RAGGED
    port, ref, fields, params = _case(name, dom)
    assert solver_k_blockable(port)
    run = C.CudaStencil(port, dom, schedule=Schedule(block_k=bk,
                                                     k_as_grid=False))
    assert [p.kind for p in run.programs] == ["kblocked"]
    ins = _inputs(fields, dom, seed=bk)
    tins = {k: torch.from_numpy(v)[None] for k, v in ins.items()}  # 1 tile
    got = _walk(run, tins, params)
    whole = run.plain(tins, params)
    want = r_compile_stencil(
        ref, dom, backend="pallas-tpu", interpret=True,
        schedule=RSchedule(block_k=bk, k_as_grid=False))(
        {k: jnp.asarray(v) for k, v in ins.items()}, params)
    assert set(got) == set(want)
    for w in got:
        assert torch.equal(got[w], whole[w]), w
        np.testing.assert_allclose(got[w][0].numpy(), np.asarray(want[w]),
                                   **TOL, err_msg=w)


def _chunked_walk(run, fields, params, reset=True):
    """``run``'s K4 launch over a member axis as the kernel maps it: one
    reader per member chunk runs the chunk's members in turn through the
    member strides of the launch arguments, emptying the carry at each
    member's first level (unless ``reset`` is false)."""
    (p,) = run.programs
    env = C.plain.prepare_env(run.stencil, run.dom, fields, torch.float32)
    args = run.launch_args(env, params)
    views = [_member_view(env[n], args, s)
             for s, n in enumerate(run.slot_names)]
    pvals = [float(params[q]) for q in run.stencil.params]
    for chunk in range(args.nmember // args.mchunk):
        ev = _StreamEvaluator([v[chunk * args.mchunk] for v in views], pvals,
                              p.consts)
        for mm in range(args.mchunk):
            ev.slots = [v[chunk * args.mchunk + mm] for v in views]
            if reset:
                ev.reset_carry()
            ev.launch(p)
    return {w: env[w] for w in run.written}


def _reference_members(ref_stencil, dom, fields, written, ins, params, M,
                       mchunk, bk):
    """The reference's K-blocked Pallas kernel over a member grid
    (``"grid"``) or member chunks (``"vmap:2,grid"``)."""
    rp = RProgram("kblocked_members", dom)
    for f in fields:
        rp.declare(f)
    rp.add(ref_stencil, {f: f for f in fields})
    rp.propagate_extents()
    fn = r_compile_program(rp, "pallas-tpu", n_members=M,
                           batch="grid" if mchunk == 1 else "vmap:2,grid",
                           schedule_overrides={ref_stencil.name: RSchedule(
                               block_k=bk, k_as_grid=False)})
    return fn({k: jnp.asarray(v) for k, v in ins.items()
               if k not in written}, params)


@pytest.mark.parametrize("mchunk", [1, 2])
def test_slab_walk_resets_the_carry_per_member(mchunk):
    """A member axis (K5 on K4): a thread's members march in turn, each
    from an empty carry, so members equal single runs — against the
    reference's K-blocked member grid (``"grid"``) and chunk
    (``"vmap:2,grid"``)."""
    cfg = TD.FV3Config(npx=6, nk=16, halo=6, n_tracers=0)
    dom = cfg.seq_dom()
    M = 4
    sch = Schedule(block_k=4, k_as_grid=False)
    run = C.CudaStencil(TS.precompute_pe, dom, schedule=sch, n_members=M,
                        member_chunk=mchunk)
    ins = _inputs(("delp",), dom, seed=11, lead=(M,))
    params = {"ptop": 10.0}
    tins = {k: torch.from_numpy(v) for k, v in ins.items()}
    tins["pe"] = torch.zeros_like(tins["delp"])  # as compile_program allocates
    got = _chunked_walk(run, tins, params)["pe"]
    single = C.CudaStencil(TS.precompute_pe, dom, schedule=sch)
    for m in range(M):
        torch.testing.assert_close(got[m], single.plain(
            {k: v[m] for k, v in tins.items()}, params)["pe"], rtol=0, atol=0)
    want = _reference_members(RS.precompute_pe, dom, ("delp", "pe"), {"pe"},
                              ins, params, M, mchunk, 4)["pe"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mchunk", [1, 2])
def test_kblocked_carry_is_zeroed_at_each_members_first_level(mchunk):
    """A march whose first level reads its marching-previous level: K4
    reads 0 there, the reference's carry zeroed at each member's first
    slab, so it equals the reference's K-blocked kernel over 4 members and
    not the plain march (which reads the level itself, edge-clamped); with
    two members a thread, a carry left over from the member before would
    give another result."""
    dom = RAGGED
    M, bk = 4, 8
    port, ref = gtstencil(_fwd_decay), r_gtstencil(_fwd_decay)
    assert solver_k_blockable(port)
    run = C.CudaStencil(port, dom, schedule=Schedule(block_k=bk,
                                                     k_as_grid=False),
                        n_members=M, member_chunk=mchunk)
    ins = _inputs(("q", "x"), dom, seed=3, lead=(M,))
    tins = {k: torch.from_numpy(v) for k, v in ins.items()}
    got = _chunked_walk(run, tins, {})["x"]
    want = _reference_members(ref, dom, ("q", "x"), set(), ins, {}, M, mchunk,
                              bk)["x"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not torch.allclose(got, run.plain(tins, {})["x"], **TOL)
    leaked = _chunked_walk(run, tins, {}, reset=False)["x"]
    assert torch.equal(leaked, got) == (mchunk == 1)


def _memory_reads(run, p) -> set[str]:
    """Names of the slots K4's ops read from device memory: through the
    copies ahead (AHEAD) and loads (LOAD); a CARRY read takes memory only
    where the column stored nothing at the level before."""
    keys = p.ahead_keys()
    slots = set()
    for *_, pc, end in p.records():
        for _, _, src, sargs, _, (src2, s2args) in C.decode(p.prog, pc, end):
            for kind, operand in ((src, sargs), (src2, s2args)):
                if kind == C.SRC_AHEAD:
                    slots.add(keys[operand[0]][0])
                elif kind == C.SRC_LOAD:
                    slots.add(operand[0])
    return {run.slot_names[s] for s in slots}


@pytest.mark.parametrize("name, loaded", [
    ("precompute_pe", {"delp"}), ("fwd_cumsum", {"delp", "q"}),
    ("bwd_subst", {"rhs", "cc"}), ("fwd_partial", {"q", "acc"}),
    ("fused", {"delp", "q"})])
def test_kblocked_loads_only_old_values_the_march_reads(name, loaded):
    """K4 reads a field from device memory (a copy ahead or a load) only
    where the march reads its value from before the launch; a field the
    march writes at every level before its marching-previous read (``pe``
    of ``precompute_pe``) is read through the carry, held on chip, and one
    that is only written (``out``) is never read."""
    dom = DomainSpec(ni=5, nj=4, nk=16, halo=2)
    port = _case(name, dom)[0]
    run = C.CudaStencil(port, dom, schedule=Schedule(block_k=4,
                                                     k_as_grid=False))
    (p,) = run.programs
    read = _memory_reads(run, p)
    assert read == loaded
    written = set(run.written)
    assert read & written <= C.prior_reads(port, dom.nk)
    assert {run.slot_names[s] for s in p.carried} <= written


def test_prior_reads_follows_the_plain_order():
    """What a function must read of the fields it writes, in the plain
    lowering's order: an update in place reads the old value, a march that
    writes every level before reading it does not, and the first level of
    a clamped marching-previous read is the old value unless written."""
    nk = 8
    a, q = FieldAccess("a"), FieldAccess("q")
    bump = Stencil("bump", (Computation(ir.PARALLEL, (
        Assign("a", a + q),)),), ("q", "a"), ("a",))
    copy_then_read = Stencil("copy", (Computation(ir.PARALLEL, (
        Assign("a", q), Assign("b", FieldAccess("a", (0, 0, 1)) + q))),),
        ("q", "a", "b"), ("a", "b"))
    offset = Stencil("offset", (Computation(ir.PARALLEL, (
        Assign("a", q), Assign("b", FieldAccess("a", (1, 0, 0))))),),
        ("q", "a", "b"), ("a", "b"))
    clamped = Stencil("clamped", (Computation(ir.FORWARD, (
        Assign("a", FieldAccess("a", (0, 0, -1)) + q),)),), ("q", "a"),
        ("a",))
    assert C.prior_reads(bump, nk) == {"a"}
    assert C.prior_reads(copy_then_read, nk) == set()
    assert C.prior_reads(offset, nk) == {"a"}
    assert C.prior_reads(clamped, nk) == {"a"}
    assert C.prior_reads(TS.precompute_pe, nk) == set()
    assert C.prior_reads(SOLVERS["fwd_partial"][0], nk) == {"acc"}
    assert C.prior_reads(TS.tridiag_solve, nk) <= set(
        TS.tridiag_solve.written())


def test_kblocked_dispatch_follows_the_schedule():
    dom = DomainSpec(ni=5, nj=4, nk=16, halo=2)
    blocked = Schedule(block_k=4, k_as_grid=False)
    kinds = {name: [p.kind for p in C.CudaStencil(st, dom,
                                                  schedule=sch).programs]
             for name, st, sch in [
                 ("blocked", TS.precompute_pe, blocked),
                 ("whole", TS.precompute_pe, Schedule(block_k=0,
                                                      k_as_grid=False)),
                 ("none", TS.precompute_pe, None),
                 ("nk", TS.precompute_pe, Schedule(block_k=16)),
                 ("ragged", TS.precompute_pe, Schedule(block_k=5)),
                 ("thomas", TS.tridiag_solve, blocked)]}
    assert kinds == {"blocked": ["kblocked"], "whole": ["column"],
                     "none": ["column"], "nk": ["column"],
                     "ragged": ["column"], "thomas": ["column", "column"]}
    run = C.CudaStencil(SOLVERS["fwd_cumsum"][0], dom, schedule=blocked)
    (p,) = run.programs
    slot = {n: i for i, n in enumerate(run.slot_names)}
    assert (p.block_k, p.forward, p.lo, p.hi) == (4, True, 0, 16)
    # the written fm's marching-previous level from the carry; the inputs'
    # (delp, q) copied ahead with their own levels
    assert p.carried == (slot["fm"],)
    assert {(k[0], k[3]) for k in p.ahead_keys()} == {
        (slot[f], dk) for f in ("delp", "q") for dk in (0, -1)}
    (p,) = C.CudaStencil(SOLVERS["bwd_subst"][0], dom,
                         schedule=blocked).programs
    assert not p.forward
    # one statement list, one program: K4's is K2's, with the slab
    k4, k2 = (C.CudaStencil(TS.precompute_pe, dom, schedule=sch).programs[0]
              for sch in (blocked, None))
    assert (k4.kind, k2.kind) == ("kblocked", "column")
    assert (k4.prog, k4.carried, k4.ahead) == (k2.prog, k2.carried, k2.ahead)


def test_kblocked_copy_depth_is_the_slab_within_its_bounds():
    """K4's copies run a slab ahead, at most ``KB_DEPTH_MAX`` levels, fewer
    where two groups of copies beside the stack, the carry and the column
    table would pass the budget of four CTAs an SM; at least K2's one
    level."""
    dom = DomainSpec(ni=192, nj=192, nk=80, halo=6)
    level = C.COLUMNS * C.COLUMN_BLOCK * 4

    def depth(st, bk):
        run = C.CudaStencil(st, dom, schedule=Schedule(block_k=bk,
                                                       k_as_grid=False))
        (p,) = run.programs
        got = C.copy_depth(p)
        used = ((max(1, p.stack) + 2 * len(p.carried)
                 + 2 * got * len(p.ahead_keys())) * level
                + len(run.slot_names) * C.COLUMN_BLOCK * 8
                + p.table_bytes())
        assert used == p.smem_bytes(got)
        assert got == 1 or used <= C.KB_SMEM_BUDGET
        return got

    # precompute_pe: one key (delp a level up)
    assert C.KB_DEPTH_MAX == 4
    assert [depth(TS.precompute_pe, bk) for bk in (2, 4, 8, 16, 40)] == [
        2, 4, 4, 4, 4]
    inputs = ("q", "a", "b", "c", "e", "f", "g", "h")
    total = FieldAccess("x", (0, 0, -1))
    for f in inputs:
        total = total + FieldAccess(f)
    wide = Stencil("wide", (Computation(ir.FORWARD, (Assign("x", total),)),),
                   inputs + ("x",), ("x",))
    # eight keys: two levels of them would pass the budget, so one
    assert depth(wide, 16) == 1


def test_kblocked_refuses_a_previous_level_it_cannot_zero():
    """At the first level K4 reads 0 at the marching-previous level through
    the carry and the copies ahead only, so every such read must be one of
    them: the copies take those keys first, and K4 refuses a stencil with
    more of them than the table holds, which then marches whole-column on
    K2 (its one computation, one launch)."""
    dom = DomainSpec(ni=5, nj=4, nk=16, halo=2)
    blocked = Schedule(block_k=4, k_as_grid=False)

    def march(n_inputs):
        inputs = tuple(f"q{n}" for n in range(n_inputs))
        total = FieldAccess("x", (0, 0, -1))
        for f in inputs:  # each input at its own level and a level up
            total = total + FieldAccess(f) + FieldAccess(f, (0, 0, -1))
        return Stencil("many", (Computation(ir.FORWARD, (
            Assign("x", total),)),), inputs + ("x",), ("x",))

    run = C.CudaStencil(march(C.AHEAD_MAX), dom, schedule=blocked)
    (p,) = run.programs
    assert p.kind == "kblocked" and not run.kblocked_refused
    assert all(key[3] == -1 for key in p.ahead_keys())  # a level up first
    with pytest.raises(C.KBlockedTablesFull, match="marching-previous"):
        C.Encoder(march(C.AHEAD_MAX + 1), dom).kblocked(blocked.block_k)
    run = C.CudaStencil(march(C.AHEAD_MAX + 1), dom, schedule=blocked)
    assert [p.kind for p in run.programs] == ["column"]
    assert run.kblocked_refused



def test_kblocked_encoder_refuses_offset_reads_of_written_fields():
    """Columns march independently in K4, level by level across all
    computations: a horizontal-offset read of any field the stencil writes
    would race with a neighbour column."""
    dom = DomainSpec(ni=5, nj=4, nk=8, halo=2)
    q = FieldAccess("q")
    st = Stencil("probe", (
        Computation(ir.PARALLEL, (Assign("a", q * q),)),
        Computation(ir.FORWARD, (
            Assign("out", FieldAccess("a", (1, 0, 0)) + q,
                   Interval((0, 0), (0, 1))),
            Assign("out", FieldAccess("out", (0, 0, -1)) + q,
                   Interval((1, 0), (0, 0))))),
    ), ("q", "a", "out"), ("a", "out"))
    assert solver_k_blockable(st)
    with pytest.raises(NotImplementedError, match="horizontal"):
        C.encode_stencil(st, dom, Schedule(block_k=4, k_as_grid=False))
    with pytest.raises(ValueError, match="K-blocked"):
        C.Encoder(TS.tridiag_solve, dom).kblocked(4)


def test_tpu_schedules_put_dsw_precompute_pe_on_k4_at_c192_l80():
    """The reference's own schedules at production size: on ``tpu-v5e`` the
    tuner K-blocks d_sw's ``precompute_pe`` (a whole column misses the 16
    MiB VMEM), so the CUDA backend runs it on K4; under the H100 preset's
    GPU rules every solver stays whole-column on K2."""
    cfg = TD.FV3Config(npx=192, nk=80, halo=6, n_tracers=4)
    dom = cfg.seq_dom()
    kinds = {}
    for hw in ("tpu-v5e", "h100"):
        prog, _ = optimize_program(TD.build_dsw_program(cfg, dom),
                                   opt_level=3, backend="cuda", hardware=hw)
        (node,) = [n for n in prog.all_nodes()
                   if n.stencil.is_vertical_solver()]
        run = C.CudaStencil(node.stencil, prog.node_dom(node),
                            schedule=node.schedule)
        kinds[hw] = (node.schedule.block_k, [p.kind for p in run.programs])
    assert kinds == {"tpu-v5e": (16, ["kblocked"]), "h100": (0, ["column"])}


def test_kblocked_program_runs_plain_on_the_cpu():
    """On CPU tensors the compiled program takes K4's plain version, the
    whole-column march, whatever the schedule."""
    dom = DomainSpec(ni=5, nj=4, nk=16, halo=2)
    p = StencilProgram("pe_fwd", dom)
    p.declare("delp")
    p.declare("pe")
    p.add(TS.precompute_pe, {"delp": "delp", "pe": "pe"})
    p.propagate_extents()
    sch = {"precompute_pe": Schedule(block_k=4, k_as_grid=False)}
    ins = {"delp": torch.from_numpy(_inputs(("delp",), dom, 2)["delp"])}
    got = compile_program(p, "cuda", schedule_overrides=sch, device="cpu")(
        dict(ins), {"ptop": 10.0})
    want = compile_program(p, "torch", device="cpu")(dict(ins),
                                                     {"ptop": 10.0})
    assert torch.equal(got["pe"], want["pe"])
