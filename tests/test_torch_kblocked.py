"""K4, the K-blocked solver kernel of the port, checked on the CPU.

K4 (``stencil_kblocked_kernel`` in ``csrc/stencil_kernels.cu``) replaces the
reference's ``_vertical_kernel_kblocked``: a single-direction solver under a
K-blocked schedule marches all its statements level by level over
``nk / block_k`` slabs, staging each slab in shared memory and handing the
marching carry from slab to slab.  It cannot run here, so ``_SlabWalker``
below reads the encoded stream as the kernel does — slab staging (the
program fields whose old values the march reads from memory, the others and
temporaries from zero), the march inside the slab, the
carry at a slab's first level, the carry zeroed per member — written from
the kernel's source, not from the IR.  It must give the whole-column march
of the plain lowering (K4's plain version) and the reference's own K-blocked
Pallas kernel in interpret mode, for ``precompute_pe``, a FORWARD and a
BACKWARD single-direction solver, a solver that reads a field it writes
before writing it, an SGF-fused solver, and a member axis.
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

UNARY = {v: k for k, v in C.UNARY_OPS.items()}
BINARY = {v: k for k, v in C.BINARY_OPS.items()}
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


class _SlabWalker:
    """Torch reading of K4's launch: slabs in marching order, staged, then
    marched level by level, the carry handed on at each slab's end."""

    def __init__(self, run, p, env, params, consts):
        self.run, self.p = run, p
        self.slots = [env[n] for n in run.slot_names]  # (T, K, Jp, Ip)
        self.params = [float(params[q]) for q in run.stencil.params]
        self.consts = consts
        self.nfield = len(run.stencil.fields)
        self.loaded = set(p.loaded)

    def eval(self, pc, end, load):
        prog, stk = self.p.prog, []
        while pc < end:
            op = prog[pc]
            pc += 1
            if op == C.OP_LOAD:
                stk.append(load(*prog[pc:pc + 4]))
                pc += 4
            elif op == C.OP_CONST:
                stk.append(torch.tensor(self.consts[prog[pc]],
                                        dtype=torch.float32))
                pc += 1
            elif op == C.OP_PARAM:
                stk.append(torch.tensor(self.params[prog[pc]],
                                        dtype=torch.float32))
                pc += 1
            elif op in UNARY:
                stk.append({"neg": torch.neg, "sqrt": torch.sqrt,
                            "abs": torch.abs, "exp": torch.exp,
                            "log": torch.log, "sign": torch.sign,
                            "floor": torch.floor}[UNARY[op]](stk.pop()))
            elif op == C.OP_WHERE:
                b, a, c = stk.pop(), stk.pop(), stk.pop()
                stk.append(torch.where(c != 0, a, b))
            else:
                b, a = stk.pop(), stk.pop()
                r = ({"+": a + b, "-": a - b, "*": a * b, "/": a / b,
                      "<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b,
                      "==": a == b, "!=": a != b}[BINARY[op]]
                     if op in BINARY else
                     {C.OP_MIN: torch.minimum, C.OP_MAX: torch.maximum,
                      C.OP_POW: torch.pow}[op](a, b))
                stk.append(r.to(torch.float32))
        assert len(stk) == 1
        return stk[0]

    def walk(self):
        p, bk = self.p, self.p.block_k
        j0, j1, i0, i1 = p.box
        recs = [p.prog[1 + C.REC_INTS * q: 1 + C.REC_INTS * (q + 1)]
                for q in range(p.prog[0])]
        T = self.slots[0].shape[0]
        plane = (T, j1 - j0, i1 - i0)
        carry = {s: torch.zeros(plane) for s in p.carried}  # per member
        nblocks = (p.hi - p.lo) // bk
        for b in range(nblocks):
            k0 = p.lo + (b if p.forward else nblocks - 1 - b) * bk
            slab = {s: (self.slots[s][:, k0:k0 + bk, j0:j1, i0:i1].clone()
                        if s in self.loaded else torch.zeros((T, bk)
                                                             + plane[1:]))
                    for s in p.staged}
            for step in range(bk):
                local = step if p.forward else bk - 1 - step
                k = k0 + local

                def load(s, di, dj, dk, local=local, k=k):
                    if (di, dj) != (0, 0):
                        arr = self.slots[s]
                        kk = min(max(k + dk, 0), arr.shape[1] - 1)
                        return arr[:, kk, j0 + dj:j1 + dj, i0 + di:i1 + di]
                    lp = local + dk
                    return slab[s][:, lp] if 0 <= lp < bk else carry[s]

                for tgt, klo, khi, rj0, rj1, ri0, ri1, pc, end in recs:
                    if not klo <= k < khi:
                        continue
                    val = self.eval(pc, end, load).expand(plane)
                    jj = torch.arange(j0, j1)[:, None]
                    ii = torch.arange(i0, i1)[None, :]
                    box = (jj >= rj0) & (jj < rj1) & (ii >= ri0) & (ii < ri1)
                    slab[tgt][:, local] = torch.where(box, val,
                                                      slab[tgt][:, local])
                    if tgt < self.nfield:
                        self.slots[tgt][:, k, j0:j1, i0:i1] = \
                            slab[tgt][:, local]
            last = bk - 1 if p.forward else 0
            for s in p.carried:
                carry[s] = slab[s][:, last].clone()


def _walk(run, fields, params, members=None):
    """Run ``run``'s K4 launch through the reader; returns its outputs."""
    (p,) = run.programs
    assert p.kind == "kblocked"
    env = C.plain.prepare_env(run.stencil, run.dom, fields, torch.float32)
    if members is None:
        _SlabWalker(run, p, env, params, p.consts).walk()
    else:  # each member's march starts from a zero carry
        for m in range(members):
            member = {k: v[m].reshape((-1,) + v.shape[-3:])
                      for k, v in env.items()}
            _SlabWalker(run, p, member, params, p.consts).walk()
    return {w: env[w] for w in run.written}


@pytest.mark.parametrize("name", ["precompute_pe", "fwd_cumsum", "bwd_subst",
                                  "fwd_partial", "fused"])
@pytest.mark.parametrize("bk", [4, 8])
def test_slab_walk_matches_whole_column_and_reference(name, bk):
    dom = DomainSpec(ni=5, nj=4, nk=16, halo=2)
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
        torch.testing.assert_close(got[w], whole[w], **TOL, msg=w)
        np.testing.assert_allclose(got[w][0].numpy(), np.asarray(want[w]),
                                   **TOL, err_msg=w)


@pytest.mark.parametrize("mchunk", [1, 2])
def test_slab_walk_resets_the_carry_per_member(mchunk):
    """A member axis (K5 on K4): each member's march starts from a zero
    carry, so members equal single runs — against the reference's
    K-blocked member grid (``"grid"``) and chunk (``"vmap:2,grid"``)."""
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
    got = _walk(run, tins, params, members=M)["pe"]
    single = C.CudaStencil(TS.precompute_pe, dom, schedule=sch)
    for m in range(M):
        torch.testing.assert_close(got[m], single.plain(
            {k: v[m] for k, v in tins.items()}, params)["pe"], rtol=0, atol=0)
    rp = RProgram("pe_fwd", dom)
    rp.declare("delp")
    rp.declare("pe")
    rp.add(RS.precompute_pe, {"delp": "delp", "pe": "pe"})
    rp.propagate_extents()
    rsch = RSchedule(block_k=4, k_as_grid=False)
    fn = r_compile_program(rp, "pallas-tpu", n_members=M,
                           batch="grid" if mchunk == 1 else "vmap:2,grid",
                           schedule_overrides={"precompute_pe": rsch})
    want = fn({"delp": jnp.asarray(ins["delp"])}, params)["pe"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name, loaded", [
    ("precompute_pe", {"delp"}), ("fwd_cumsum", {"delp", "q"}),
    ("bwd_subst", {"rhs", "cc"}), ("fwd_partial", {"q", "acc"}),
    ("fused", {"delp", "q"})])
def test_kblocked_loads_only_old_values_the_march_reads(name, loaded):
    """K4's slab loads a field from memory only where the march can read its
    value from before the launch; a field written at every level before any
    read (``pe`` of ``precompute_pe``) starts at zero, as does one that is
    only written (``out``)."""
    dom = DomainSpec(ni=5, nj=4, nk=16, halo=2)
    port = _case(name, dom)[0]
    run = C.CudaStencil(port, dom, schedule=Schedule(block_k=4,
                                                     k_as_grid=False))
    (p,) = run.programs
    assert {run.slot_names[s] for s in p.loaded} == loaded
    assert set(p.loaded) <= set(p.staged)


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
    # K4 reads the zeroed carry before the first level, not memory
    assert C.prior_reads(clamped, nk, interleaved=True) == set()
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
    assert set(p.staged) == {slot["delp"], slot["q"], slot["fm"]}
    assert set(p.carried) == {slot["delp"], slot["q"], slot["fm"]}
    (p,) = C.CudaStencil(SOLVERS["bwd_subst"][0], dom,
                         schedule=blocked).programs
    assert not p.forward


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
