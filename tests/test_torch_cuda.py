"""What the CUDA stencil kernels are fed, checked on the CPU, and the kernels
themselves on a card.

The kernels interpret a postfix program per statement (``cuda.py`` encodes
it).  ``_StreamEvaluator`` below is a small torch interpreter of exactly
that encoding — records, opcodes, edge-clamped K loads, the marching level
search — written from the kernels' source, not from the IR.  Run over every
statement of ``fv3/stencils.py``, it must reproduce the kernels' plain
version (``CudaStencil.plain``, the plain lowering): that holds the
encoder's output to the IR's meaning without a card.  With a member axis,
each slot is read through the member stride of the launch arguments, as
the kernels index it, so a broadcast field (stride 0) is checked too.

Tests marked ``cuda`` need a card and skip without one; among them the LM
kernels (K8 flash attention, with and without a sliding window, K9
RMSNorm, K10 the SSM state scan) against their plain versions, a 2-layer
Granite-width prefill and decode, one Zamba2-7B group, two Gemma-2 layers,
one layer each of Llama-4 Scout and Grok-1, one xLSTM-1.3B group and two
int8 Granite-8B layers (weights, then also the KV cache) at full width
against the plain path; and training: K8's, K9's and K10's backward
kernels against their plain versions, K6 and K7 raising under autograd
(K10 running through its ``autograd.Function``), a 2-layer full-width
Granite loss and backward through the kernels against the plain path, and
a Zamba2 smoke-width training step through K10 forward and backward.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.backend import TuningCache, set_default_cache
from repro_torch.core.backend import cuda as C
from repro_torch.core.hardware import Hardware, register_hardware
from repro_torch.core.stencil import (Assign, Computation, DomainSpec,
                                      Field, FieldAccess, Interval, Schedule,
                                      Stencil, gtstencil)
from repro_torch.core.stencil import ir
from repro_torch.fv3 import dyncore as TD
from repro_torch.fv3 import state as TSt
from repro_torch.fv3 import stencils as TS
from repro_torch import configs as TC
from repro_torch import models as TM
from repro_torch.kernels import library as KL
from repro_torch.kernels import ops as KO
from repro_torch.kernels import ref as KR

NAMES = sorted(k for k, v in vars(TS).items() if isinstance(v, Stencil))
DOM = DomainSpec(ni=6, nj=5, nk=4, halo=3, extend=(1, 1))
UNARY = {v: k for k, v in C.UNARY_OPS.items()}
BINARY = {v: k for k, v in C.BINARY_OPS.items()}


@pytest.fixture(autouse=True, scope="module")
def _own_tuning_cache(tmp_path_factory):
    """The port's tuning cache of this file: a throwaway file, never the
    working tree's ``.repro_cache/torch_tuning.json``."""
    set_default_cache(TuningCache(
        tmp_path_factory.mktemp("torch_tuning") / "torch_tuning.json"))
    yield
    set_default_cache(None)


def _inputs(st, dom, seed, lead=(2,)):
    rng = np.random.default_rng(seed)
    ranges = {"aa": (-0.5, 0.5), "cc": (-0.5, 0.5), "bb": (2.0, 3.0),
              "cx": (-0.9, 0.9), "cy": (-0.9, 0.9)}
    out = {}
    for f in st.fields:
        lo, hi = ranges.get(f, (0.5, 1.5))
        a = rng.uniform(lo, hi, lead + dom.padded_shape(st.is_interface(f)))
        if st.name == "remap_interp" and f in ("pe", "pe_ref", "fm"):
            a = np.cumsum(a, axis=-3)
        out[f] = torch.from_numpy(a.astype(np.float32))
    params = {p: float(rng.uniform(0.5, 1.5)) for p in st.params}
    return out, params


def _binary(op, a, b):
    """A binary op of the stream on its two operands (``OP_R*``: the
    operands swapped)."""
    if op in BINARY:
        r = {"+": a + b, "-": a - b, "*": a * b, "/": a / b, "<": a < b,
             "<=": a <= b, ">": a > b, ">=": a >= b, "==": a == b,
             "!=": a != b}[BINARY[op]]
    else:
        r = {C.OP_MIN: torch.minimum, C.OP_MAX: torch.maximum,
             C.OP_POW: torch.pow,
             C.OP_RSUB: lambda x, y: y - x,
             C.OP_RDIV: lambda x, y: y / x,
             C.OP_RMIN: lambda x, y: torch.minimum(y, x),
             C.OP_RMAX: lambda x, y: torch.maximum(y, x),
             C.OP_RPOW: lambda x, y: torch.pow(y, x)}[op](a, b)
    return r.to(torch.float32)


class _StreamEvaluator:
    """Vectorised torch reading of the kernels' instruction stream.

    Each op word holds the op, the stack depth before it and the source of
    a push's or a binary op's operand (in K2, also a binary op's first
    operand: it then pushes its value); the reader keeps its own stack and
    checks that it holds ``depth`` values before each op.  A K1
    launch runs its records in order over the
    launch's levels and box, values staying on the stack from record to
    record, each store masked by its record's levels and box.  A K2 launch
    runs as the kernel maps it: a thread per ``C.COLUMNS`` neighbouring
    rows at one i (rows past the window clamped to its last row), the
    records of each level in marching order, each store masked per column
    by the record's box and the window; a store to a carried slot also
    goes to the carry, and a ``CARRY`` read takes the marching-previous
    level from there where that column stored it at the level before, else
    from memory (``carry_reads`` counts both).  :meth:`reset_carry` empties
    the carry, as the kernel does at each member's first level.  An
    ``AHEAD`` read takes its key's value as memory held it when the level
    before started, where the kernel's copy reads it (the first level's:
    before the march).  A K4 launch runs as K2's on all its statements,
    except that its copies are taken a group of ``C.copy_depth`` levels at
    a time, the next group's as memory holds it at the first level of the
    group before (the first group's before the march), and that a read of a
    level outside the slot's K extent (the marching-previous level of the
    first) is 0, the reference's zeroed carry, where K2 clamps it."""

    def __init__(self, slots, params, consts):
        self.slots = slots          # slot -> (T, K, Jp, Ip) tensor
        self.params = params        # f32 values in parameter order
        self.consts = torch.tensor(consts or [0.0], dtype=torch.float32)
        self.carry_reads = {"carry": 0, "memory": 0}
        self.blocked = False  # K4: 0 outside a slot's K extent
        self.reset_carry()

    def reset_carry(self):
        # slot -> (values, stored) of the level before / this level
        self.prev, self.cur = {}, {}

    def load(self, slot, ks, js, is_):
        arr = self.slots[slot]
        got = arr[:, ks.clamp(0, arr.shape[-3] - 1), js, is_]
        if self.blocked:
            got = torch.where((ks < 0) | (ks >= arr.shape[-3]), 0.0, got)
        return got

    def search(self, coord, lo, hi, target, js, is_):
        """The last layer in (lo, hi) whose coordinate is <= the target,
        else lo, per point (the reference's march)."""
        lvl = torch.full(target.shape, lo, dtype=torch.int64)
        for layer in range(lo + 1, hi):
            c = self.load(coord, torch.tensor(layer), js, is_)
            lvl = torch.where(c <= target, layer, lvl)
        return lvl

    def found(self, slot, di, dj, dk, lvl, js, is_):
        arr = self.slots[slot]
        win = arr[:, :, (js + dj)[0], (is_ + di)[0]]
        win = win.expand(lvl.shape[:1] + win.shape[1:2] + lvl.shape[2:])
        return torch.gather(win, 1, (lvl + dk).clamp(0, arr.shape[-3] - 1))

    def source(self, prog, pc, src, ks, js, is_, stk):
        """The value of a push's or binary op's source; its words."""
        if src == C.SRC_LOAD:
            s, di, dj, dk = prog[pc:pc + 4]
            return self.load(s, ks + dk, js + dj, is_ + di), 4
        if src == C.SRC_CONST:
            return self.consts[prog[pc]], 1
        if src == C.SRC_PARAM:
            return torch.tensor(self.params[prog[pc]], dtype=torch.float32), 1
        if src == C.SRC_AHEAD:
            return self.copies[prog[pc]], 1
        if src == C.SRC_CARRY:
            s, di, dj, dk = prog[pc:pc + 4]
            assert (di, dj) == (0, 0), (di, dj)
            mem = self.load(s, ks + dk, js, is_)
            val, ok = self.prev.get(s, (mem, torch.zeros_like(mem,
                                                              dtype=bool)))
            ok = ok.expand_as(mem)
            self.carry_reads["carry"] += int(ok.sum())
            self.carry_reads["memory"] += int((~ok).sum())
            return torch.where(ok, val, mem), 4
        assert src == C.SRC_PICK, src
        return stk[prog[pc]], 1

    def run(self, prog, pc, end, ks, js, is_, stk, store):
        f32 = torch.float32
        lvl = None
        while pc < end:
            word = prog[pc]
            src2, src = word >> C.SRC2_SHIFT, (word >> C.SRC_SHIFT) & 7
            op, depth = (word >> C.OP_SHIFT) & 63, word & (C.OPW - 1)
            pc += 1
            assert depth == len(stk), (op, depth, len(stk))
            if src2:  # K2: a binary op's first operand, its words first
                assert C.is_binary(op) and src, (op, src2, src)
                first, n = self.source(prog, pc, src2, ks, js, is_, stk)
                pc += n
            if src:
                val, n = self.source(prog, pc, src, ks, js, is_, stk)
                pc += n
            if op == C.OP_PUSH:
                stk.append(val)
            elif op == C.OP_FLOAD:
                s, di, dj, dk = prog[pc:pc + 4]
                pc += 4
                stk.append(self.found(s, di, dj, dk, lvl, js, is_))
            elif op == C.OP_DROP:
                top = stk.pop()
                del stk[len(stk) - prog[pc]:]
                stk.append(top)
                pc += 1
            elif op == C.OP_KEEP:
                pass
            elif op == C.OP_SEARCH:
                coord, lo, hi = prog[pc:pc + 3]
                pc += 3
                lvl = self.search(coord, lo, hi, stk.pop(), js, is_)
            elif op == C.OP_STORE:
                store(prog[pc], stk.pop())
                pc += 1
            elif op in UNARY:
                x = stk.pop()
                stk.append({"neg": torch.neg, "sqrt": torch.sqrt,
                            "abs": torch.abs, "exp": torch.exp,
                            "log": torch.log, "sign": torch.sign,
                            "floor": torch.floor}[UNARY[op]](x))
            elif op == C.OP_WHERE:
                b, a, c = stk.pop(), stk.pop(), stk.pop()
                stk.append(torch.where(c != 0, a, b))
            elif src2:  # f(src2, src), pushed
                stk.append(_binary(op, first, val))
            else:  # f(a, b): a below b, or a the top and b the source
                b = val if src else stk.pop()
                a = stk.pop()
                stk.append(_binary(op, a, b))

    def records(self, p, ks, box, stk):
        """Run every record of ``p`` over levels ``ks`` and ``box``."""
        j0, j1, i0, i1 = box
        kk = ks[:, None, None]
        js = torch.arange(j0, j1)[None, :, None]
        is_ = torch.arange(i0, i1)[None, None, :]
        for tgt, klo, khi, rj0, rj1, ri0, ri1, b, e in p.records():
            if not ((ks >= klo) & (ks < khi)).any():
                continue
            mask = ((kk >= klo) & (kk < khi) & (js >= rj0) & (js < rj1)
                    & (is_ >= ri0) & (is_ < ri1))

            def store(slot, val, mask=mask):
                out = self.slots[slot]
                win = out[:, int(ks[0]):int(ks[-1]) + 1, j0:j1, i0:i1]
                win.copy_(torch.where(mask, val.expand_as(win), win))

            self.run(p.prog, b, e, kk, js, is_, stk, store)

    def columns(self, p, ncol, depth=1):
        """K2 and K4: every level of the march for the launch's columns,
        ``ncol`` rows a thread, the copies taken ``depth`` levels at a
        time."""
        j0, j1, i0, i1 = p.box
        rows = torch.arange(j0, j0 + -(-(j1 - j0) // ncol) * ncol)
        real = rows < j1  # the rows past the window store nothing
        js = rows.clamp(max=j1 - 1)[None, :, None]
        is_ = torch.arange(i0, i1)[None, None, :]
        levels = (range(p.lo, p.hi) if p.forward
                  else range(p.hi - 1, p.lo - 1, -1))

        def copy(k):  # the AHEAD keys of level k, as memory holds them now
            kk = torch.tensor(k).reshape(1, 1, 1)
            return [self.load(s, kk + dk, js + dj, is_ + di)
                    for s, di, dj, dk in p.ahead_keys()]

        def group(g):  # the copies of group g's levels, taken now
            return [copy(k) for k in levels[g * depth:(g + 1) * depth]]

        after = group(0)
        for step, k in enumerate(levels):
            if step % depth == 0:
                this, after = after, group(step // depth + 1)
            self.copies = this[step % depth]
            kk = torch.tensor(k).reshape(1, 1, 1)
            self.prev, self.cur = self.cur, {}
            for tgt, klo, khi, rj0, rj1, ri0, ri1, b, e in p.records():
                if not klo <= k < khi:
                    continue
                live = ((rows >= rj0) & (rows < rj1) & real)[None, :, None] \
                    & (is_ >= ri0) & (is_ < ri1)
                if not live.any():
                    continue

                def store(slot, val, live=live[:, None]):
                    # val and live as (T, 1 level, rows, I)
                    out = self.slots[slot]
                    val = val.expand(out.shape[:1] + live.shape[1:])
                    win = out[:, k:k + 1, rows[real], i0:i1]
                    out[:, k:k + 1, rows[real], i0:i1] = torch.where(
                        live[..., real, :], val[..., real, :], win)
                    if slot in p.carried:
                        old, ok = self.cur.get(slot, (val, live & False))
                        self.cur[slot] = (torch.where(live, val, old),
                                          ok | live)

                self.run(p.prog, b, e, kk, js, is_, [], store)

    def launch(self, p):
        if p.empty:
            return
        self.blocked = p.kind == "kblocked"
        if p.kind == "horizontal":
            self.records(p, torch.arange(p.klo, p.khi), p.box, [])
        else:
            self.columns(p, C.COLUMNS, C.copy_depth(p)
                         if self.blocked else 1)


@pytest.mark.parametrize("name", NAMES)
def test_instruction_stream_matches_plain_version(name):
    run = C.CudaStencil(getattr(TS, name), DOM)
    fields, params = _inputs(run.stencil, DOM, seed=NAMES.index(name))
    want = run.plain(fields, params)
    env = C.plain.prepare_env(run.stencil, DOM, fields, torch.float32)
    ev = _StreamEvaluator([env[n] for n in run.slot_names],
                          [float(params[p]) for p in run.stencil.params],
                          [])
    for p in run.programs:
        ev.consts = torch.tensor(p.consts or [0.0], dtype=torch.float32)
        ev.launch(p)
    for w in run.written:
        torch.testing.assert_close(env[w], want[w], rtol=1e-6, atol=1e-6,
                                   msg=f"{name}.{w}")


def _member_view(x, args, s):
    """Slot ``s`` as the kernels address it: member m at ``m * mstride``,
    then a contiguous (tile, K, J, I) block."""
    K, jp, ip = args.kext[s], args.jp, args.ip
    return torch.as_strided(x, (args.nmember, args.ntile, K, jp, ip),
                            (args.mstride[s], K * jp * ip, jp * ip, ip, 1),
                            x.storage_offset())


MEMBER_CASES = ["fx_ppm", "edge_flux", "tridiag_solve", "interface_interp"]


@pytest.mark.parametrize("name", MEMBER_CASES)
@pytest.mark.parametrize("mchunk", [1, 2])
def test_instruction_stream_with_member_axis(name, mchunk):
    M = 4
    run = C.CudaStencil(getattr(TS, name), DOM, n_members=M,
                        member_chunk=mchunk)
    fields, params = _inputs(run.stencil, DOM, seed=MEMBER_CASES.index(name),
                             lead=(M, 2))
    bcast = next(f for f in run.stencil.fields if f not in run.written)
    fields[bcast] = fields[bcast][:1].expand_as(fields[bcast])
    want = run.plain(fields, params)
    env = C.plain.prepare_env(run.stencil, DOM, fields, torch.float32)
    args = run.launch_args(env, params)
    assert (args.nmember, args.mchunk, args.ntile) == (M, mchunk, 2)
    slot = run.slot_names.index(bcast)
    assert args.mstride[slot] == 0
    assert all(args.mstride[s] == env[n][0].numel()
               for s, n in enumerate(run.slot_names) if s != slot)
    views = [_member_view(env[n], args, s)
             for s, n in enumerate(run.slot_names)]
    pvals = [float(params[p]) for p in run.stencil.params]
    for chunk in range(args.nmember // args.mchunk):
        for mm in range(args.mchunk):
            m = chunk * args.mchunk + mm
            ev = _StreamEvaluator([v[m] for v in views], pvals, [])
            for p in run.programs:
                ev.consts = torch.tensor(p.consts or [0.0],
                                         dtype=torch.float32)
                ev.launch(p)
    for w in run.written:
        torch.testing.assert_close(env[w], want[w], rtol=1e-6, atol=1e-6,
                                   msg=f"{name}.{w}")


def test_member_axis_checks():
    with pytest.raises(ValueError, match="divide"):
        C.CudaStencil(TS.courant_x, DOM, n_members=3, member_chunk=2)
    run = C.CudaStencil(TS.courant_x, DOM, n_members=3)
    u = torch.zeros((2, 2) + DOM.padded_shape())
    with pytest.raises(ValueError, match="member axis"):
        run({"u": u, "cx": u}, {"dtdx": 1.0})
    u = torch.zeros((3, 2) + DOM.padded_shape())
    env = {"u": u.transpose(1, 2), "cx": u}
    with pytest.raises(ValueError, match="contiguous within each member"):
        run.launch_args(env, {"dtdx": 1.0})


def test_launch_plan_of_the_fv3_stencils():
    runs = {name: C.CudaStencil(getattr(TS, name), DOM) for name in NAMES}
    n = {name: len(run.programs) for name, run in runs.items()}
    records = {name: [len(p.records()) for p in run.programs]
               for name, run in runs.items()}
    # one K1 launch per group of PARALLEL statements, its statements as
    # records; one K2 per solver computation
    assert n["fx_ppm"] == 1 and records["fx_ppm"] == [7]
    assert n["edge_flux"] == 1 and records["edge_flux"] == [3]
    assert n["riem_coeffs"] == 1 and records["riem_coeffs"] == [12]
    assert n["tridiag_solve"] == 2 and records["tridiag_solve"] == [4, 2]
    assert n["column_total"] == 2 and n["interface_interp"] == 1
    kinds = {p.kind for p in C.CudaStencil(TS.tridiag_solve, DOM).programs}
    assert kinds == {"column"}
    (search,) = C.CudaStencil(TS.interface_interp, DOM).programs
    assert search.kind == "horizontal" and search.has_search
    # every FV3 stack is as shallow as the fixed stack of 16 entries was
    assert max(p.stack for name in NAMES
               for p in C.CudaStencil(getattr(TS, name), DOM).programs) \
        <= 16


def test_fv3_solvers_have_independent_columns():
    """No solver computation of fv3/stencils.py reads, at a horizontal
    offset, a field it writes — the column kernel's precondition."""
    solvers = [getattr(TS, n) for n in NAMES
               if getattr(TS, n).is_vertical_solver()]
    assert {s.name for s in solvers} >= {
        "precompute_pe", "tridiag_solve", "lagrangian_pe", "column_total",
        "reference_pe", "cumsum_mass"}
    for st in solvers:
        for comp in st.computations:
            if comp.direction is ir.PARALLEL:
                continue
            written = set(comp.written())
            for s in comp.statements:
                for a in s.value.accesses():
                    assert a.name not in written or a.offset[:2] == (0, 0)
            C._check_column_hazard(comp)


def _stencil(comps, fields, name="probe"):
    return Stencil(name, tuple(comps), fields, fields[-1:])


def test_encoder_refuses_races_deep_stacks_and_far_reads():
    q = FieldAccess("q")
    race = _stencil([Computation(ir.PARALLEL, (
        Assign("out", FieldAccess("out", (1, 0, 0)) + q),))], ("q", "out"))
    with pytest.raises(NotImplementedError, match="own target"):
        C.encode_stencil(race, DOM)
    col = _stencil([Computation(ir.FORWARD, (
        Assign("out", FieldAccess("out", (1, 0, -1)) + q,
               Interval((0, 1), (1, 0))),))], ("q", "out"))
    with pytest.raises(NotImplementedError, match="horizontal"):
        C.encode_stencil(col, DOM)
    e = q
    # each where's else-branch: 2 deeper; past the stack a K1 CTA's shared
    # memory holds (4 * STRIP * K1_BLOCK bytes an entry)
    for _ in range(C.SMEM_MAX // (4 * C.STRIP * C.K1_BLOCK) // 2 + 1):
        e = ir.Where(q, q, e)
    deep = _stencil([Computation(ir.PARALLEL, (Assign("out", e),))],
                    ("q", "out"))
    with pytest.raises(ValueError, match="stack of .* 227 KB of shared"):
        C.encode_stencil(deep, DOM)
    far = _stencil([Computation(ir.PARALLEL, (
        Assign("out", FieldAccess("q", (DOM.halo, 0, 0))),))], ("q", "out"))
    with pytest.raises(ValueError, match="outside the allocation"):
        C.encode_stencil(far, DOM)


def test_constants_fold_in_double_precision():
    (p,) = C.CudaStencil(TS.al_x, DOM).programs
    assert p.consts == [7.0 / 12.0, 1.0 / 12.0]
    ops = [op for op, *_ in C.decode(p.prog, 1 + C.REC_INTS, len(p.prog))]
    assert C.BINARY_OPS["/"] not in ops and C.OP_RDIV not in ops


def test_wrapper_checks_its_inputs():
    run = C.CudaStencil(TS.courant_x, DOM)
    u = torch.zeros((2,) + DOM.padded_shape())
    with pytest.raises(KeyError):
        run({}, {"dtdx": 1.0})
    with pytest.raises(TypeError):
        run({"u": np.zeros(DOM.padded_shape()), "cx": u}, {"dtdx": 1.0})
    with pytest.raises(ValueError, match="shape"):
        run({"u": u[..., 1:], "cx": u}, {"dtdx": 1.0})
    with pytest.raises(ValueError, match="no kernels"):
        run({"u": u.to("meta"), "cx": u.to("meta")}, {"dtdx": 1.0})
    with pytest.raises(TypeError, match="float32"):
        C.CudaStencil(TS.courant_x, DOM, dtype=torch.float64)
    out = run({"u": u + 1.0, "cx": u}, {"dtdx": 2.0})
    assert torch.equal(out["cx"][..., 3:8, 3:9], torch.full((2, 4, 5, 6), 2.0))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


# -- stencils past the encoder's old fixed tables: test_torch_tables.py reads
# them on the CPU against the reference, and they run on the card here ----

TABLE_DOM = {"ni": 6, "nj": 5, "nk": 16, "halo": 2}
TABLE_BLOCKED = {"block_k": 4, "k_as_grid": False}
TABLE_OFFSETS = [(di, dj, 0) for di in (-1, 0, 1) for dj in (-1, 0, 1)]


def _sum(terms):
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total


def _table_stencil(S, name, stmts, fields, direction=None, params=()):
    written = tuple(dict.fromkeys(s.target for s in stmts
                                  if s.target in fields))
    comp = S.Computation(direction or S.PARALLEL, tuple(stmts))
    return S.Stencil(name, (comp,), tuple(fields), written, tuple(params))


def _seventy_fields(S):
    """A FORWARD march over 69 inputs: 70 slots (K2's column table alone
    takes 70 KB of shared memory)."""
    qs = [f"q{n}" for n in range(69)]
    sums = _sum([S.FieldAccess(q) for q in qs])
    return _table_stencil(S, "seventy_fields", [
        S.Assign("x", S.FieldAccess("q0"), S.interval(0, 1)),
        S.Assign("x", S.FieldAccess("x", (0, 0, -1)) + sums * 0.01,
                 S.interval(1, None)),
    ], qs + ["x"], direction=S.FORWARD)


def _hundred_fields(S):
    """99 inputs and an output on K1: a field table past the kernels'
    small kernel parameter (TABLE_SMALL words), so the large instance."""
    qs = [f"q{n}" for n in range(99)]
    return _table_stencil(S, "hundred_fields", [
        S.Assign("out", _sum([S.FieldAccess(q) for q in qs]))],
        qs + ["out"])


def _twenty_params(S):
    ps = [f"p{n}" for n in range(20)]
    qs = ("a", "b", "c")
    terms = [S.ParamRef(p) * S.FieldAccess(qs[n % 3])
             for n, p in enumerate(ps)]
    return _table_stencil(S, "twenty_params",
                          [S.Assign("out", _sum(terms))],
                          list(qs) + ["out"], params=ps)


def _long_program(S):
    """One statement of 260 reads at offsets: ~1300 op words."""
    terms = [S.FieldAccess(("a", "b", "c")[n % 3], TABLE_OFFSETS[n % 9])
             for n in range(260)]
    return _table_stencil(S, "long_program",
                          [S.Assign("out", _sum(terms))],
                          ["a", "b", "c", "out"])


def _many_constants(S):
    """300 distinct constants in one statement."""
    terms = [S.FieldAccess(("a", "b")[n % 2]) * ((n + 1) / 4096.0)
             for n in range(300)]
    return _table_stencil(S, "many_constants",
                          [S.Assign("out", _sum(terms))], ["a", "b", "out"])


def _deep_stack(S):
    """Nested wheres, each else-branch two entries deeper: a stack of ~41,
    past the 16 entries of the fixed stack and the 31 of the old op word."""
    e = S.FieldAccess("a")
    for n in range(20):
        e = S.Where(S.FieldAccess("c") > (0.5 + n / 20.0),
                    S.FieldAccess("b") * float(n), e)
    return _table_stencil(S, "deep_stack", [S.Assign("out", e)],
                          ["a", "b", "c", "out"])


def _split_group(S):
    """A temporary defined first and read last, around 40 statements whose
    program passes K1_PROGRAM_BYTES: the group is cut, and the temporary
    (kept on the stack in one launch) is stored across the cut."""
    ins = ["a", "b", "c", "d", "e", "f"]
    outs = [f"o{n}" for n in range(40)]
    stmts = [S.Assign("tmp", S.FieldAccess("a") * S.FieldAccess("b"))]
    for n, o in enumerate(outs):
        stmts.append(S.Assign(o, _sum([
            S.FieldAccess(f, TABLE_OFFSETS[(n + m) % 9])
            for m, f in enumerate(ins)])))
    stmts.append(S.Assign("last", S.FieldAccess("tmp") + S.FieldAccess("c")))
    return _table_stencil(S, "split_group", stmts, ins + outs + ["last"])


def _k4_past_tables(S):
    """A K-blocked FORWARD march with AHEAD_MAX + 1 inputs read at the
    marching-previous level: K4 refuses it, K2 marches it."""
    qs = [f"q{n}" for n in range(C.AHEAD_MAX + 1)]
    total = S.FieldAccess("x", (0, 0, -1))
    for q in qs:
        total = total + S.FieldAccess(q) + S.FieldAccess(q, (0, 0, -1))
    return _table_stencil(S, "k4_past_tables", [
        S.Assign("x", S.FieldAccess("q0"), S.interval(0, 1)),
        S.Assign("x", total * 0.25, S.interval(1, None))],
        qs + ["x"], direction=S.FORWARD)


TABLE_CASES = {"70 fields": _seventy_fields,
         "100 fields": _hundred_fields,
         "20 parameters": _twenty_params,
         "1024 op words": _long_program,
         "256 constants": _many_constants,
         "stack of 16": _deep_stack,
         "K1 group split": _split_group,
         "K4 tables": _k4_past_tables}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_kernels_match_plain_version_on_card(card, name):
    run = C.CudaStencil(getattr(TS, name), DOM)
    fields, params = _inputs(run.stencil, DOM, seed=NAMES.index(name),
                             lead=(6,))
    fields = {k: v.to(card) for k, v in fields.items()}
    before = dict(C.LAUNCHES)
    got = run(fields, params)
    want = run.plain(fields, params)
    torch.cuda.synchronize()
    assert sum(C.LAUNCHES.values()) > sum(before.values())
    for w in run.written:
        torch.testing.assert_close(got[w], want[w], rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_step_on_card_matches_plain_step(card):
    cfg = TD.FV3Config(npx=12, nk=5)
    s0 = TSt.init_state(cfg, device=card)
    C.reset_launches()
    got = TD.make_step_sequential(cfg, opt_level=0, device=card)(s0)
    launched = dict(C.LAUNCHES)
    want = TD.make_step_sequential(cfg, backend="torch", opt_level=0,
                                   device=card)(s0)
    assert min(launched[k] for k in ("horizontal", "column", "search")) > 0
    assert launched["member"] == 0  # one member: no member axis
    h, n = cfg.halo, cfg.npx
    for k in want:
        err = (got[k] - want[k])[..., h:h + n, h:h + n].abs().max().item()
        assert err < 1e-5, (k, err)


def _broadcast_inputs(run, lead, device, seed):
    """Inputs with a member axis, the first read-only field expanded across
    members (member stride 0)."""
    fields, params = _inputs(run.stencil, DOM, seed=seed, lead=lead)
    bcast = next(f for f in run.stencil.fields if f not in run.written)
    fields = {k: v.to(device) for k, v in fields.items()}
    fields[bcast] = fields[bcast][:1].expand_as(fields[bcast])
    return fields, params


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fx_ppm", "tridiag_solve",
                                  "interface_interp"])
@pytest.mark.parametrize("mchunk", [1, 2])
def test_member_axis_matches_plain_version_on_card(card, name, mchunk):
    M = 4
    run = C.CudaStencil(getattr(TS, name), DOM, n_members=M,
                        member_chunk=mchunk)
    fields, params = _broadcast_inputs(run, (M, 6), card, seed=3)
    before = C.LAUNCHES["member"]
    got = run(fields, params)
    want = run.plain(fields, params)
    torch.cuda.synchronize()
    assert C.LAUNCHES["member"] > before
    for w in run.written:
        torch.testing.assert_close(got[w], want[w], rtol=1e-6, atol=1e-6)
        for m in range(M):  # each member as a single-member launch gives it
            single = C.CudaStencil(getattr(TS, name), DOM)(
                {k: v[m].contiguous() for k, v in fields.items()}, params)
            assert torch.equal(got[w][m], single[w])


@pytest.mark.cuda
def test_opt3_fused_node_on_card_matches_plain_version(card):
    """d_sw's heaviest node at opt 3 (PPM's fused producers): one K1 launch
    of 7 records, its temporaries kept on the stack."""
    from repro_torch.core.backend import compile_program

    cfg = TD.FV3Config(npx=12, nk=8)
    fn = compile_program(TD.build_dsw_program(cfg, cfg.seq_dom()), "cuda",
                         opt_level=3, device=card)
    node = next(n for n in fn.program.all_nodes()
                if n.label.startswith("inner_y_update+al_x+fx_ppm"))
    run = C.CudaStencil(node.stencil, fn.program.node_dom(node))
    (p,) = run.programs
    assert len(p.records()) == 7 and p.kept
    fields, params = _inputs(run.stencil, run.dom, seed=7, lead=(6,))
    fields = {k: v.to(card) for k, v in fields.items()}
    params = {k: TD.default_params(cfg)[k] for k in run.stencil.params}
    before = C.LAUNCHES["horizontal"]
    got = run(fields, params)
    want = run.plain(fields, params)
    torch.cuda.synchronize()
    assert C.LAUNCHES["horizontal"] == before + 1
    for w in run.written:
        torch.testing.assert_close(got[w], want[w], rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_search_on_unsorted_columns_with_nans_on_card(card, seed):
    """K3 on coordinates in random order with NaNs (also among the
    targets) against the plain version marching (``marching_plain``): the
    last layer whose coordinate does not exceed the target."""
    run = C.CudaStencil(TS.interface_interp, DOM)
    rng = np.random.default_rng(seed)
    fields = {}
    for f in run.stencil.fields:
        a = rng.uniform(0.0, 4.0, (6,) + DOM.padded_shape(True))
        if f in ("pe", "pe_ref"):
            a.flat[rng.choice(a.size, a.size // 50, replace=False)] = np.nan
        fields[f] = torch.from_numpy(a.astype(np.float32)).to(card)
    got = run(fields, {})["fi"]
    with C.marching_plain():
        want = run.plain(fields, {})["fi"]
    torch.cuda.synchronize()
    assert torch.isnan(want).any()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6,
                               equal_nan=True)


@pytest.mark.cuda
def test_temporary_kept_on_the_stack_on_card(card):
    """A group whose temporary stays on the stack (never stored) beside one
    that a record outside its box reads from memory."""
    q, t, u = FieldAccess("q"), FieldAccess("t"), FieldAccess("u")
    region = ir.Region(i_lo=(0, 0), i_hi=(0, 2))
    st = Stencil("kept", (Computation(ir.PARALLEL, (
        Assign("t", q * q + 1.0),
        Assign("u", q - 2.0, region=region),
        Assign("out", t * q + t),
        Assign("out2", u + t * 0.5),
    )),), ("q", "out", "out2"), ("out", "out2"))
    run = C.CudaStencil(st, DOM)
    (p,) = run.programs
    assert p.kept == ("t",)
    fields, params = _inputs(run.stencil, DOM, seed=5, lead=(6,))
    fields = {k: v.to(card) for k, v in fields.items()}
    got = run(fields, params)
    want = run.plain(fields, params)
    torch.cuda.synchronize()
    for w in run.written:
        torch.testing.assert_close(got[w], want[w], rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tridiag_kernel_matches_plain_version_on_card(card, dtype):
    rng = np.random.default_rng(0)
    shape = (80, 24, 40)
    a, b, c, d = (torch.from_numpy(rng.uniform(lo, hi, shape)).to(card, dtype)
                  for lo, hi in ((0.1, 0.5), (2.0, 3.0), (0.1, 0.5), (-1, 1)))
    KL.reset_launches()
    x = KO.tridiag(a, b, c, d)
    want = KR.tridiag_ref(a, b, c, d)
    torch.cuda.synchronize()
    assert KL.LAUNCHES["tridiag"] == 1
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(x, want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("halo", [3, 6])
def test_fvt_flux_kernel_matches_plain_version_on_card(card, halo):
    rng = np.random.default_rng(halo)
    shape = (16, 20 + 2 * halo, 24 + 2 * halo)
    q = torch.from_numpy(rng.uniform(1, 2, shape).astype(np.float32)).to(card)
    cx = torch.from_numpy(rng.uniform(-0.9, 0.9, shape).astype(
        np.float32)).to(card)
    KL.reset_launches()
    f = KO.fvt_flux(q, cx, halo=halo)
    want = KR.fvt_flux_ref(q, cx, halo=halo)
    torch.cuda.synchronize()
    assert KL.LAUNCHES["fvt_flux"] == 1
    torch.testing.assert_close(f, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ["grid", "vmap:2,grid", "vmap:2"])
def test_ensemble_step_on_card_matches_member_loop(card, batch):
    cfg = TD.FV3Config(npx=12, nk=5, n_split=1, k_split=1)
    M = 3
    ens0 = TSt.ensemble_state(cfg, M, device=card)
    step_s = TD.make_step_sequential(cfg, opt_level=0, device=card)
    C.reset_launches()
    step_s({k: v[0] for k, v in ens0.items()})
    per_member = dict(C.LAUNCHES)
    step_e = TD.make_step_ensemble(cfg, M, batch=batch, opt_level=0,
                                   device=card)
    C.reset_launches()
    out = step_e(ens0)
    launched = dict(C.LAUNCHES)
    singles = [step_s({k: v[m] for k, v in ens0.items()}) for m in range(M)]
    torch.cuda.synchronize()
    n_calls = step_e.n_chunks if batch == "vmap:2" else 1
    for k in ("horizontal", "column", "search"):
        assert launched[k] == n_calls * per_member[k], (k, launched)
    assert launched["member"] == launched["horizontal"] + launched["column"]
    for k in out:
        want = torch.stack([s[k] for s in singles])
        assert torch.equal(out[k], want), k
    assert (out["pt"][1] - out["pt"][0]).abs().max().item() > 0


#: windows whose rows are no multiple of K2's columns a thread and whose
#: columns are no multiple of a warp
RAGGED = [DomainSpec(ni=37, nj=13, nk=9, halo=3, extend=(1, 1)),
          DomainSpec(ni=45, nj=6, nk=12, halo=3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dom", RAGGED, ids=["37x13", "45x6"])
@pytest.mark.parametrize("name", ["tridiag_solve", "column_total",
                                  "precompute_pe", "cumsum_mass"])
@pytest.mark.parametrize("members", [None, 4])
def test_column_kernel_on_ragged_windows_on_card(card, dom, name, members):
    """K2 (its columns a thread, the carry, the copies a level ahead) at
    windows whose rows are no multiple of ``C.COLUMNS`` and whose columns
    are no multiple of 32, alone and over 4 members in chunks of 2 (one
    input broadcast across members): exactly its plain version."""
    st = getattr(TS, name)
    if members is None:
        run = C.CudaStencil(st, dom)
        fields, params = _inputs(run.stencil, dom, seed=11, lead=(3,))
        fields = {k: v.to(card) for k, v in fields.items()}
        before = C.LAUNCHES["column"]
    else:
        run = C.CudaStencil(st, dom, n_members=members, member_chunk=2)
        fields, params = _inputs(run.stencil, dom, seed=12,
                                 lead=(members, 3))
        bcast = next(f for f in run.stencil.fields if f not in run.written)
        fields = {k: v.to(card) for k, v in fields.items()}
        fields[bcast] = fields[bcast][:1].expand_as(fields[bcast])
        before = C.LAUNCHES["column"]
    got = run(fields, params)
    want = run.plain(fields, params)
    torch.cuda.synchronize()
    assert C.LAUNCHES["column"] > before
    for w in run.written:
        assert torch.equal(got[w], want[w]), (name, w)


KDOM = DomainSpec(ni=6, nj=5, nk=16, halo=3, extend=(1, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("bk", [4, 8])
def test_kblocked_kernel_matches_plain_and_column_on_card(card, bk):
    """K4 equals its plain version (the whole-column march) and K2 on the
    same inputs bit for bit."""
    sched = Schedule(block_k=bk, k_as_grid=False)
    run = C.CudaStencil(TS.precompute_pe, KDOM, schedule=sched)
    assert [p.kind for p in run.programs] == ["kblocked"]
    fields, params = _inputs(run.stencil, KDOM, seed=bk, lead=(6,))
    fields = {k: v.to(card) for k, v in fields.items()}
    before = C.LAUNCHES["kblocked"]
    got = run(fields, params)
    column = C.CudaStencil(TS.precompute_pe, KDOM)(fields, params)
    want = run.plain(fields, params)
    torch.cuda.synchronize()
    assert C.LAUNCHES["kblocked"] == before + 1
    for w in run.written:
        torch.testing.assert_close(got[w], want[w], rtol=1e-6, atol=1e-6)
        assert torch.equal(got[w], column[w])


@pytest.mark.cuda
@pytest.mark.parametrize("mchunk", [1, 2])
def test_kblocked_member_axis_on_card(card, mchunk):
    """K4 over 4 members: each member's carry starts from zero, so every
    member equals its own single-member launch."""
    M = 4
    sched = Schedule(block_k=4, k_as_grid=False)
    run = C.CudaStencil(TS.precompute_pe, KDOM, schedule=sched, n_members=M,
                        member_chunk=mchunk)
    fields, params = _inputs(run.stencil, KDOM, seed=5, lead=(M, 6))
    fields = {k: v.to(card) for k, v in fields.items()}
    before = C.LAUNCHES["member"]
    got = run(fields, params)
    want = run.plain(fields, params)
    torch.cuda.synchronize()
    assert C.LAUNCHES["member"] == before + 1
    single = C.CudaStencil(TS.precompute_pe, KDOM, schedule=sched)
    for w in run.written:
        torch.testing.assert_close(got[w], want[w], rtol=1e-6, atol=1e-6)
        for m in range(M):
            one = single({k: v[m].contiguous() for k, v in fields.items()},
                         params)
            assert torch.equal(got[w][m], one[w])


def _bwd_subst(rhs: Field, cc: Field, pp: Field):
    with computation(BACKWARD):
        with interval(-1, None):
            pp = rhs
        with interval(0, -1):
            pp = rhs[0, 0, 0] - cc[0, 0, 0] * pp[0, 0, 1]


def _fwd_partial(q: Field, acc: Field, out: Field):
    # acc: read at its own level before its write, and at the level below
    with computation(FORWARD):
        with interval(1, None):
            out = acc + q
            acc = acc[0, 0, -1] + q


def _many_inputs(n: int = 4) -> Stencil:
    """A march reading n inputs at its level and a level up: 2n keys to
    copy, so the copies' depth shrinks to fit the budget, and the keys
    past the table at its own level are loads."""
    inputs = tuple(f"q{m}" for m in range(n))
    total = FieldAccess("x", (0, 0, -1))
    for f in inputs:
        total = total + FieldAccess(f) * FieldAccess(f, (0, 0, -1))
    return Stencil("many_inputs", (Computation(ir.FORWARD, (
        Assign("x", total, interval=ir.interval(1, None)),)),),
        inputs + ("x",), ("x",))


#: K4's solvers on the card: d_sw's precompute_pe (the node the reference's
#: TPU schedules K-block), a BACKWARD one, one that reads a field it writes
#: before writing it, and one with more keys than its copies' full depth
#: holds
K4_SOLVERS = {"precompute_pe": TS.precompute_pe,
              "bwd_subst": gtstencil(_bwd_subst),
              "fwd_partial": gtstencil(_fwd_partial),
              "many_inputs": _many_inputs()}
#: windows whose rows are no multiple of K4's 4 a thread and whose columns
#: are no multiple of a warp, with their slabs: 8 of 16 levels, and 40 of 80
#: (the copies run at most cuda.KB_DEPTH_MAX levels ahead)
K4_RAGGED = [(DomainSpec(ni=37, nj=13, nk=16, halo=3, extend=(1, 1)), 8),
             (DomainSpec(ni=45, nj=6, nk=80, halo=3), 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dom, bk", K4_RAGGED, ids=["37x13 bk8", "45x6 bk40"])
@pytest.mark.parametrize("name", sorted(K4_SOLVERS))
@pytest.mark.parametrize("batch", [None, "grid", "vmap:2,grid"])
def test_kblocked_kernel_on_ragged_windows_on_card(card, dom, bk, name,
                                                   batch):
    """K4 (K2's march, the copies a slab ahead) at ragged windows, alone
    and over 4 members (one member a thread, or two), one input broadcast
    across members: exactly its plain version and K2 on the same inputs."""
    st = K4_SOLVERS[name]
    sched = Schedule(block_k=bk, k_as_grid=False)
    M = None if batch is None else 4
    mchunk = 2 if batch == "vmap:2,grid" else 1
    run = C.CudaStencil(st, dom, schedule=sched, n_members=M,
                        member_chunk=mchunk)
    assert [p.kind for p in run.programs] == ["kblocked"]
    (p,) = run.programs
    assert C.copy_depth(p) == (
        1 if name == "many_inputs" else C.KB_DEPTH_MAX)
    lead = (3,) if M is None else (M, 3)
    fields, params = _inputs(run.stencil, dom, seed=bk, lead=lead)
    fields = {k: v.to(card) for k, v in fields.items()}
    if M is not None:
        bcast = next(f for f in run.stencil.fields if f not in run.written)
        fields[bcast] = fields[bcast][:1].expand_as(fields[bcast])
    before = C.LAUNCHES["kblocked"]
    got = run(fields, params)
    assert C.LAUNCHES["kblocked"] == before + 1
    want = run.plain(fields, params)
    column = C.CudaStencil(st, dom, n_members=M, member_chunk=mchunk)
    k2 = column(fields, params)
    torch.cuda.synchronize()
    for w in run.written:
        assert torch.equal(got[w], want[w]), (name, w)
        assert torch.equal(got[w], k2[w]), (name, w)


@pytest.mark.cuda
@pytest.mark.parametrize("blocked", [False, True], ids=["K2", "K4"])
def test_carry_holds_only_the_rows_stored_on_card(card, blocked):
    """A carried field written twice a level, the second time on 2 of a
    thread's 4 rows: the carry of the other rows keeps the first store (a
    carry that took the second store's value on every row, stored or not,
    read it at the next level)."""
    x, q = FieldAccess("x"), FieldAccess("q")
    st = Stencil("rows", (Computation(ir.FORWARD, (
        Assign("x", x.shift((0, 0, -1)) * 0.5 + q,
               interval=ir.interval(1, None)),
        Assign("x", q * 3.0, region=ir.Region(j_lo=(0, 0), j_hi=(0, 2))),
    )),), ("q", "x"), ("x",))
    sched = Schedule(block_k=8, k_as_grid=False) if blocked else None
    run = C.CudaStencil(st, KDOM, schedule=sched)
    (p,) = run.programs
    assert p.kind == ("kblocked" if blocked else "column") and p.carried
    fields, params = _inputs(run.stencil, KDOM, seed=2, lead=(6,))
    fields = {k: v.to(card) for k, v in fields.items()}
    got = run(fields, params)
    want = run.plain(fields, params)
    torch.cuda.synchronize()
    assert torch.equal(got["x"], want["x"])


#: K6's depths: one level, two, the model's 80, and one past the levels
#: whose cp and dp fit on chip at a warp's tile (f32 892, f64 438)
TRIDIAG_DEPTHS = [1, 2, 80, "past"]


@pytest.mark.cuda
@pytest.mark.parametrize("nk", TRIDIAG_DEPTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tridiag_kernel_at_any_depth_on_card(card, nk, dtype):
    """K6 on a plane of 7 x 37 columns (no multiple of its warp) at depths
    1, 2, 80 and one past its on-chip plan, where the deeper levels keep cp
    in a scratch and dp in x: the plain version exactly in f32, within
    1e-12 in f64."""
    from repro_torch.kernels import tridiag as KT

    itemsize = torch.finfo(dtype).bits // 8
    if nk == "past":
        nk = KT.plan(10 ** 6, itemsize) + 1
    assert (KT.plan(nk, itemsize) < nk) == (
        nk > 438 if dtype == torch.float64 else nk > 892)
    rng = np.random.default_rng(nk)
    shape = (nk, 7, 37)
    a, b, c, d = (torch.from_numpy(rng.uniform(lo, hi, shape)).to(card, dtype)
                  for lo, hi in ((0.1, 0.5), (2.0, 3.0), (0.1, 0.5), (-1, 1)))
    KL.reset_launches()
    x = KO.tridiag(a, b, c, d)
    want = KR.tridiag_ref(a, b, c, d)
    torch.cuda.synchronize()
    assert KL.LAUNCHES["tridiag"] == 1
    if dtype == torch.float32:
        assert torch.equal(x, want)
    else:
        torch.testing.assert_close(x, want, rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
def test_opt3_step_on_card_with_kblocked_schedules(card):
    """The opt-3 step on a TPU-like preset whose VMEM K-blocks
    ``precompute_pe``: K4 runs once per d_sw call, and the step equals the
    default preset's opt-3 step and the plain opt-3 step."""
    register_hardware(Hardware("test-tiny-vmem", peak_flops=1e12,
                               hbm_bw=1e11, link_bw=0,
                               vmem_bytes=12 * 1024, kind="tpu"),
                      overwrite=True)
    cfg = TD.FV3Config(npx=12, nk=16, n_split=2, k_split=1)
    s0 = TSt.init_state(cfg, device=card)
    C.reset_launches()
    got = TD.make_step_sequential(cfg, hardware="test-tiny-vmem",
                                  device=card)(s0)
    launched = dict(C.LAUNCHES)
    assert launched["kblocked"] == cfg.n_split * cfg.k_split
    default = TD.make_step_sequential(cfg, device=card)(s0)
    plain = TD.make_step_sequential(cfg, backend="torch", device=card)(s0)
    h, n = cfg.halo, cfg.npx
    for k in got:
        assert torch.equal(got[k][..., h:h + n, h:h + n],
                           default[k][..., h:h + n, h:h + n]), k
        err = (got[k] - plain[k])[..., h:h + n, h:h + n].abs().max().item()
        assert err < 1e-5, (k, err)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KVH,D", [
    (1, 128, 2, 2, 64), (2, 256, 4, 2, 64), (1, 256, 8, 1, 128),
    (2, 100, 4, 2, 32), (1, 300, 6, 2, 96), (1, 70, 2, 1, 256),
    (2, 33, 4, 4, 16), (2, 130, 4, 4, 112),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flash_attention_kernel_matches_plain_version_on_card(
        card, B, S, H, KVH, D, dtype, softcap):
    """Ragged S (not a multiple of the 32-row or 64-key tiles), every head
    width the kernel takes, GQA ratios 1-8; the reference's tolerances
    (``tests/test_kernels.py``)."""
    gen = torch.Generator(device=card).manual_seed(B * S + D)
    q, k, v = (torch.randn(s, generator=gen, device=card).to(dtype)
               for s in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    KL.reset_launches()
    got = KO.flash_attention(q, k, v, softcap=softcap)
    want = KR.flash_attention_ref(q, k, v, softcap=softcap)
    torch.cuda.synchronize()
    assert KL.LAUNCHES["flash_attention"] == 1
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (2e-2, 1e-1)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KVH,D", [
    (1, 2048, 8, 2, 128), (2, 257, 4, 1, 256),
])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flash_attention_wgmma_long_and_wide_on_card(card, B, S, H, KVH, D,
                                                      softcap):
    """bf16 through many turns of the K/V ring (16 tiles of 128 keys), and
    at D = 256 (64-key tiles, 2 tiles per diagonal, a ragged last one).
    Besides the plain version at the reference's bar, the kernel and the
    plain version against float64: each (b, s, h) row's error over the
    row's norm, the kernel's mean and max within 2x the plain version's, so
    that the late rows, where |o| is below the bar's atol, count too."""
    gen = torch.Generator(device=card).manual_seed(S + D)
    q, k, v = (torch.randn(s, generator=gen, device=card).to(torch.bfloat16)
               for s in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    got = KO.flash_attention(q, k, v, softcap=softcap)
    want = KR.flash_attention_ref(q, k, v, softcap=softcap)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=1e-1)
    kk, vv = (x.double().repeat_interleave(H // KVH, dim=2) for x in (k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", q.double(), kk) / D ** 0.5
    if softcap > 0.0:
        sc = softcap * torch.tanh(sc / softcap)
    keep = torch.ones((S, S), dtype=torch.bool, device=card).tril()
    exact = torch.einsum("bhqk,bkhd->bqhd",
                         torch.softmax(torch.where(keep, sc, -1e30), -1), vv)
    rel = [(x.double() - exact).norm(dim=-1) / exact.norm(dim=-1)
           for x in (got, want)]
    for stat in (torch.mean, torch.amax):
        kernel, plain = (stat(r).item() for r in rel)
        assert kernel <= 2.0 * plain, (stat.__name__, kernel, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KVH,D", [
    (1, 2048, 8, 2, 128), (2, 257, 4, 1, 256), (1, 1000, 4, 4, 112),
    (3, 65, 6, 3, 96),
])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flash_attention_f32_long_and_wide_on_card(card, B, S, H, KVH, D,
                                                    softcap):
    """float32 (3xTF32) through many turns of the K/V ring (32 tiles of 64
    keys), at D 256 (one slot, 32-key tiles), ragged S and GQA: the plain
    version's bar (rtol = atol = 2e-5), and against float64 each (b, s, h)
    row's error over the row's norm, the kernel's mean and max within 2x
    the plain version's."""
    gen = torch.Generator(device=card).manual_seed(S + D + 1)
    q, k, v = (torch.randn(s, generator=gen, device=card)
               for s in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    got = KO.flash_attention(q, k, v, softcap=softcap)
    want = KR.flash_attention_ref(q, k, v, softcap=softcap)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    kk, vv = (x.double().repeat_interleave(H // KVH, dim=2) for x in (k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", q.double(), kk) / D ** 0.5
    if softcap > 0.0:
        sc = softcap * torch.tanh(sc / softcap)
    keep = torch.ones((S, S), dtype=torch.bool, device=card).tril()
    exact = torch.einsum("bhqk,bkhd->bqhd",
                         torch.softmax(torch.where(keep, sc, -1e30), -1), vv)
    rel = [(x.double() - exact).norm(dim=-1) / exact.norm(dim=-1)
           for x in (got, want)]
    for stat in (torch.mean, torch.amax):
        kernel, plain = (stat(r).item() for r in rel)
        assert kernel <= 2.0 * plain, (stat.__name__, kernel, plain)


# a row's error over its norm that a float32 kernel may show where the
# plain version is exact: 3xTF32 drops each operand's remainder below
# 2^-21 of it (~4.8e-7)
F32_ROW_FLOOR = 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KVH,D", [
    (1, 300, 4, 2, 128), (2, 257, 4, 1, 256), (1, 4500, 8, 4, 256),
])
@pytest.mark.parametrize("window", [1, 63, 64, 100, 4096, 5000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_flash_attention_window_on_card(card, B, S, H, KVH, D, window,
                                        dtype, softcap):
    """K8 with a sliding window (Gemma-2's local layers) against the plain
    version with the window: windows of one key, below and at one key tile
    (64), across tiles (100), Gemma-2's 4096 (binding at S 4500) and past S;
    D 128 and 256, ragged S, GQA; the reference's tolerances, and against
    float64 each (b, s, h) row's error over the row's norm, the kernel's
    mean and max within 2x the plain version's, or within F32_ROW_FLOOR
    where the plain version is exact (a window of one key: o = v, which
    3xTF32 keeps to ~2^-21 of |v|)."""
    gen = torch.Generator(device=card).manual_seed(S + D + window)
    q, k, v = (torch.randn(s, generator=gen, device=card).to(dtype)
               for s in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    KL.reset_launches()
    got = KO.flash_attention(q, k, v, softcap=softcap, window=window)
    want = KR.flash_attention_ref(q, k, v, softcap=softcap, window=window)
    torch.cuda.synchronize()
    assert KL.LAUNCHES["flash_attention"] == 1
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (2e-2, 1e-1)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    kk, vv = (x.double().repeat_interleave(H // KVH, dim=2) for x in (k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", q.double(), kk) / D ** 0.5
    if softcap > 0.0:
        sc = softcap * torch.tanh(sc / softcap)
    keep = KR.attention_mask(S, window, card)
    exact = torch.einsum("bhqk,bkhd->bqhd",
                         torch.softmax(torch.where(keep, sc, -1e30), -1), vv)
    rel = [(x.double() - exact).norm(dim=-1) / exact.norm(dim=-1)
           for x in (got, want)]
    for stat in (torch.mean, torch.amax):
        kernel, plain = (stat(r).item() for r in rel)
        assert kernel <= max(2.0 * plain, F32_ROW_FLOOR), (stat.__name__,
                                                           kernel, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_without_window_keeps_its_bits_on_card(card, D,
                                                               dtype):
    """window 0, S and past S: the causal kernel's bits."""
    gen = torch.Generator(device=card).manual_seed(D)
    q, k, v = (torch.randn(s, generator=gen, device=card).to(dtype)
               for s in ((2, 333, 8, D), (2, 333, 2, D), (2, 333, 2, D)))
    for cap in (0.0, 50.0):
        causal = KO.flash_attention(q, k, v, softcap=cap)
        for window in (0, 333, 10**6):
            assert torch.equal(KO.flash_attention(q, k, v, softcap=cap,
                                                  window=window), causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_launches_its_dtypes_kernel_once(card, dtype):
    """One call is one launch of its dtype's kernel, read from the device
    kernels of a profiler trace: bf16 never reaches the CUDA-core kernel or
    the plain version."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    name = {torch.bfloat16: "flash_attention_wgmma_kernel",
            torch.float32: "flash_attention_fwd_kernel"}[dtype]
    q = torch.randn((2, 300, 4, 128), device=card).to(dtype)
    k = torch.randn((2, 300, 2, 128), device=card).to(dtype)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):  # the tracer's own start-up
        KO.flash_attention(q, k, k)  # built and warm
        torch.cuda.synchronize()
    KL.reset_launches()
    with profile(activities=activities) as prof:
        KO.flash_attention(q, k, k)
        torch.cuda.synchronize()
    assert KL.LAUNCHES["flash_attention"] == 1
    kernels = [(e.key, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    mine = [(key, n) for key, n in kernels if "flash_attention" in key]
    assert len(mine) == 1 and mine[0][1] == 1, kernels
    assert name in mine[0][0], kernels


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(128, 64), (1024, 256), (96, 512),
                                    (7, 4096), (9, 3584), (5, 7168), (3, 12)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernels_match_plain_version_on_card(card, rows, d, dtype,
                                                     w_dtype):
    gen = torch.Generator(device=card).manual_seed(rows + d)
    x, r = (torch.randn((rows, d), generator=gen, device=card).to(dtype)
            for _ in range(2))
    w = (0.1 * torch.randn(d, generator=gen, device=card)).to(w_dtype)
    KL.reset_launches()
    got = KO.rmsnorm(x, w)
    n, s = KO.rmsnorm_residual(x, r, w)
    want = KR.rmsnorm_ref(x, w)
    n_want, s_want = KR.rmsnorm_residual_ref(x, r, w)
    torch.cuda.synchronize()
    assert KL.LAUNCHES["rmsnorm"] == 1 == KL.LAUNCHES["rmsnorm_residual"]
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    torch.testing.assert_close(n, n_want, rtol=tol, atol=tol)
    assert torch.equal(s, s_want)  # one rounding of an f32 sum


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 4096])
@pytest.mark.parametrize("d", [12, 3584, 4096, 7168, 8192])
@pytest.mark.parametrize("dtype,w_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_rmsnorm_instances_match_plain_version_on_card(card, rows, d, dtype,
                                                       w_dtype):
    """K9's two instances: the row held in registers at the models' widths
    (3584, 4096, 7168), the general one at 12 and at 8192, past them; both
    forms, at a decode step's rows, one row and a prefill's."""
    gen = torch.Generator(device=card).manual_seed(rows * 3 + d)
    x, r = (torch.randn((rows, d), generator=gen, device=card).to(dtype)
            for _ in range(2))
    w = (0.1 * torch.randn(d, generator=gen, device=card)).to(w_dtype)
    KL.reset_launches()
    got = KO.rmsnorm(x, w)
    n, s = KO.rmsnorm_residual(x, r, w)
    torch.cuda.synchronize()
    assert KL.LAUNCHES["rmsnorm"] == 1 == KL.LAUNCHES["rmsnorm_residual"]
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got, KR.rmsnorm_ref(x, w), rtol=tol, atol=tol)
    n_want, s_want = KR.rmsnorm_residual_ref(x, r, w)
    torch.testing.assert_close(n, n_want, rtol=tol, atol=tol)
    assert torch.equal(s, s_want)  # one rounding of an f32 sum


@pytest.mark.cuda
def test_lm_kernels_run_on_the_callers_stream_on_card(card):
    """K9 and K10 launched inside ``torch.cuda.stream(s)`` run on ``s``:
    each reads a tensor that ``s`` writes just before it, behind a delay on
    ``s``, and the results are read after ``s.synchronize()`` only (on
    another stream the kernels would read the tensors unwritten)."""
    gen = torch.Generator(device=card).manual_seed(5)
    x0 = torch.randn((8, 4096), generator=gen, device=card,
                     dtype=torch.bfloat16)
    r0 = torch.randn((8, 4096), generator=gen, device=card,
                     dtype=torch.bfloat16)
    w = 0.1 * torch.randn(4096, generator=gen, device=card)
    states0 = torch.randn((4, 2, 8, 16, 16), generator=gen, device=card)
    decay = torch.rand((4, 2, 8), generator=gen, device=card)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(device=card)
    KL.reset_launches()
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)  # ~50 ms of the card's clock on s
        x, r, states = x0 * 2, r0 + 1, states0 * 3
        got = KO.rmsnorm(x, w)
        n, s = KO.rmsnorm_residual(x, r, w)
        scan = KO.ssm_state_scan(states, decay)
    side.synchronize()
    assert KL.LAUNCHES["rmsnorm"] == KL.LAUNCHES["rmsnorm_residual"] == 1
    assert KL.LAUNCHES["ssm_state_scan"] == 1
    torch.testing.assert_close(got, KR.rmsnorm_ref(x0 * 2, w), rtol=1e-2,
                               atol=1e-2)
    n_want, s_want = KR.rmsnorm_residual_ref(x0 * 2, r0 + 1, w)
    torch.testing.assert_close(n, n_want, rtol=1e-2, atol=1e-2)
    assert torch.equal(s, s_want)
    assert torch.equal(scan, KR.ssm_state_scan_ref(states0 * 3, decay))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_stencils_past_the_old_tables_on_card(card, case):
    """The stencils past the encoder's old fixed tables (``TABLE_CASES``)
    run on the card exactly as their plain version computes them."""
    from repro_torch.core import stencil as S

    dom = S.DomainSpec(**TABLE_DOM)
    st = TABLE_CASES[case](S)
    blocked = case == "K4 tables"
    run = C.CudaStencil(st, dom, schedule=S.Schedule(**TABLE_BLOCKED)
                        if blocked else None)
    assert run.kblocked_refused == blocked
    fields, params = _inputs(run.stencil, dom, seed=len(case), lead=(3,))
    fields = {k: v.to(card) for k, v in fields.items()}
    before = sum(C.LAUNCHES.values())
    got = run(fields, params)
    want = run.plain(fields, params)
    torch.cuda.synchronize()
    assert sum(C.LAUNCHES.values()) > before
    for w in run.written:
        assert (got[w] - want[w]).abs().max().item() == 0.0, (case, w)


@pytest.mark.cuda
def test_granite_width_prefill_and_decode_on_card_match_plain_path(card):
    """Two Granite-8B layers at full width in float32: prefill logits and
    caches through K8/K9 within 1e-4 of the plain path, and the same greedy
    tokens over 4 decode steps."""
    import dataclasses

    cfg = dataclasses.replace(TC.get_config("granite_8b"), n_layers=2)
    model = TM.init_params(TM.Transformer(cfg, dtype=torch.float32,
                                          device=card), seed=0)
    B, S, n = 2, 96, 4
    tokens = torch.randint(0, cfg.vocab, (B, S), device=card,
                           generator=torch.Generator(device=card)
                           .manual_seed(1))
    runs = {}
    for backend in ("cuda", "ref"):
        KL.reset_launches()
        logits, caches = TM.prefill(model, tokens, cache_len=S + n,
                                    backend=backend)
        launched = dict(KL.LAUNCHES)
        toks = [logits.argmax(-1)]
        for i in range(n):
            step, caches = TM.decode_step(model, toks[-1], caches, S + i,
                                          backend=backend)
            toks.append(step.argmax(-1))
        runs[backend] = (logits, caches, torch.cat(toks, 1), launched)
    got, want = runs["cuda"], runs["ref"]
    assert got[3]["flash_attention"] == 2 and got[3]["rmsnorm"] == 3
    assert got[3]["rmsnorm_residual"] == 2
    assert sum(want[3].values()) == 0
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
    for a, b in zip(got[1], want[1]):
        torch.testing.assert_close(a["k"][:, :S], b["k"][:, :S], rtol=1e-4,
                                   atol=1e-4)
        torch.testing.assert_close(a["v"][:, :S], b["v"][:, :S], rtol=1e-4,
                                   atol=1e-4)
    assert torch.equal(got[2], want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("arch,cut", [
    ("gemma2_2b", dict(n_layers=2, window=64)),
    ("llama4_scout_17b_a16e", dict(n_layers=1)),
    ("grok1_314b", dict(n_layers=1)),
])
def test_gemma2_and_moe_layers_on_card_match_plain_path(card, arch, cut):
    """Gemma-2 (a local and a global block, the window cut to 64 so that a
    prompt of 96 runs past it and decode wraps the ring), and one layer of
    Llama-4 Scout and of Grok-1, at full width in float32: prefill logits
    and caches through K8 (with the window) and K9 within 1e-4 of the plain
    path, and the same greedy tokens over 4 decode steps."""
    import dataclasses

    cfg = dataclasses.replace(TC.get_config(arch), **cut)
    model = TM.init_params(TM.Transformer(cfg, dtype=torch.float32,
                                          device=card), seed=0)
    B, S, n = 2, 96, 4
    tokens = torch.randint(0, cfg.vocab, (B, S), device=card,
                           generator=torch.Generator(device=card)
                           .manual_seed(2))
    runs = {}
    for backend in ("cuda", "ref"):
        KL.reset_launches()
        logits, caches = TM.prefill(model, tokens, cache_len=S + n,
                                    backend=backend)
        launched = dict(KL.LAUNCHES)
        prefilled = [{k: v.clone() for k, v in c.items()} for c in caches]
        toks = [logits.argmax(-1)]
        for i in range(n):
            step, caches = TM.decode_step(model, toks[-1], caches, S + i,
                                          backend=backend)
            toks.append(step.argmax(-1))
        runs[backend] = (logits, prefilled, torch.cat(toks, 1), launched)
    got, want = runs["cuda"], runs["ref"]
    L = cfg.n_layers
    assert got[3]["flash_attention"] == L
    assert got[3]["rmsnorm"] == L * (3 if cfg.post_norm else 1) + 1
    assert got[3]["rmsnorm_residual"] == L
    assert sum(want[3].values()) == 0
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
    for a, b in zip(got[1], want[1]):
        torch.testing.assert_close(a["k"], b["k"], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(a["v"], b["v"], rtol=1e-4, atol=1e-4)
    assert torch.equal(got[2], want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("nc,B,H,N,P", [(16, 2, 112, 64, 64), (3, 2, 8, 64, 64),
                                        (1, 1, 4, 8, 8), (5, 3, 7, 5, 3)])
def test_ssm_state_scan_kernel_equals_plain_version_on_card(card, nc, B, H,
                                                            N, P):
    """Bit for bit: the kernel rounds h * d + s twice (``--fmad=false``),
    as the plain version does; odd sizes leave a ragged last block."""
    gen = torch.Generator(device=card).manual_seed(nc * B + H)
    states = torch.randn((nc, B, H, N, P), generator=gen, device=card)
    decay = torch.rand((nc, B, H), generator=gen, device=card)
    KL.reset_launches()
    got = KO.ssm_state_scan(states, decay)
    want = KR.ssm_state_scan_ref(states, decay)
    torch.cuda.synchronize()
    assert KL.LAUNCHES["ssm_state_scan"] == 1
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="contiguous"):
        KO.ssm_state_scan(states.transpose(3, 4), decay)


@pytest.mark.cuda
def test_zamba2_group_on_card_matches_plain_path(card):
    """One Zamba2-7B group at full width in float32 (the shared attention +
    MLP block at d_head 112 and 3 Mamba-2 layers of 112 heads): prefill
    logits and every cache through K8/K9/K10 within 1e-4 of the plain path,
    the same greedy tokens over 4 decode steps, and the launches of the
    design (per prefill K8 1, K9 1 + 3 + 3 + 1 and 1 fused, K10 3; per
    decode step no K8 or K10)."""
    import dataclasses

    cfg = dataclasses.replace(TC.get_config("zamba2_7b"), n_layers=3)
    model = TM.init_params(TM.Transformer(cfg, dtype=torch.float32,
                                          device=card), seed=0)
    B, S, n = 2, 300, 4   # S = 300: chunks of 100, nc = 3
    tokens = torch.randint(0, cfg.vocab, (B, S), device=card,
                           generator=torch.Generator(device=card)
                           .manual_seed(1))
    runs = {}
    for backend in ("cuda", "ref"):
        KL.reset_launches()
        logits, caches = TM.prefill(model, tokens, cache_len=S + n,
                                    backend=backend)
        launched = dict(KL.LAUNCHES)
        KL.reset_launches()
        toks = [logits.argmax(-1)]
        for i in range(n):
            step, caches = TM.decode_step(model, toks[-1], caches, S + i,
                                          backend=backend)
            toks.append(step.argmax(-1))
        runs[backend] = (logits, caches, torch.cat(toks, 1), launched,
                         dict(KL.LAUNCHES))
    got, want = runs["cuda"], runs["ref"]
    assert got[3]["flash_attention"] == 1 and got[3]["ssm_state_scan"] == 3
    assert got[3]["rmsnorm"] == 8 and got[3]["rmsnorm_residual"] == 1
    assert got[4]["flash_attention"] == 0 == got[4]["ssm_state_scan"]
    assert got[4]["rmsnorm"] == 8 * n and got[4]["rmsnorm_residual"] == n
    assert sum(want[3].values()) == 0 == sum(want[4].values())
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
    for a, b in zip(got[1], want[1]):
        assert sorted(a) == sorted(b)
        for leaf in a:
            torch.testing.assert_close(a[leaf], b[leaf], rtol=1e-4,
                                       atol=1e-4)
    assert torch.equal(got[2], want[2])


def _greedy_runs(model, tokens, n, backend_runs, **kw):
    """Per run name: (prefill logits, the prefill's caches, the greedy
    tokens, K8/K9/K10 launches of the prefill, of the decode steps)."""
    S = tokens.shape[1]
    runs = {}
    for name, (net, backend, quantized) in backend_runs.items():
        KL.reset_launches()
        logits, caches = TM.prefill(net, tokens, cache_len=S + n,
                                    backend=backend, quantized=quantized)
        launched = dict(KL.LAUNCHES)
        prefilled = [{k: v.clone() for k, v in c.items()} for c in caches]
        KL.reset_launches()
        toks = [logits.argmax(-1)]
        for i in range(n):
            step, caches = TM.decode_step(net, toks[-1], caches, S + i,
                                          backend=backend,
                                          quantized=quantized)
            toks.append(step.argmax(-1))
        runs[name] = (logits, prefilled, torch.cat(toks, 1), launched,
                      dict(KL.LAUNCHES))
    return runs


@pytest.mark.cuda
def test_xlstm_group_on_card_matches_plain_path(card):
    """One xLSTM-1.3B group at full width in float32 (7 mLSTM layers and an
    sLSTM layer, 4 heads of 512): prefill logits and every state through
    K9 within 1e-4 of the plain path, the same greedy tokens over 4 decode
    steps, and K9's launches (per prefill and step: 8 ln1 and the final
    norm; no K8)."""
    import dataclasses

    cfg = dataclasses.replace(TC.get_config("xlstm_1p3b"), n_layers=8)
    model = TM.init_params(TM.Transformer(cfg, dtype=torch.float32,
                                          device=card), seed=0)
    B, S, n = 2, 300, 4   # S = 300: chunks of 100
    tokens = torch.randint(0, cfg.vocab, (B, S), device=card,
                           generator=torch.Generator(device=card)
                           .manual_seed(3))
    runs = _greedy_runs(model, tokens, n, {"cuda": (model, "cuda", False),
                                           "ref": (model, "ref", False)})
    got, want = runs["cuda"], runs["ref"]
    assert got[3]["rmsnorm"] == 9 and got[3]["flash_attention"] == 0
    assert got[4]["rmsnorm"] == 9 * n
    assert sum(want[3].values()) == 0 == sum(want[4].values())
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
    for a, b in zip(got[1], want[1]):
        assert sorted(a) == sorted(b)
        for leaf in a:
            assert a[leaf].dtype == torch.float32
            torch.testing.assert_close(a[leaf], b[leaf], rtol=1e-4,
                                       atol=1e-4)
    assert torch.equal(got[2], want[2])


@pytest.mark.cuda
def test_int8_granite_on_card_matches_plain_and_upfront_paths(card):
    """Two Granite-8B layers at full width, int8 weights in float32
    compute: the kernel path equal to the model dequantized up front (bit
    for bit, or within 1e-6 of max |logit| should cuBLAS pick another
    algorithm), within 1e-4 of the plain path with the same greedy tokens;
    then in bf16 compute with an int8 KV cache calibrated from the
    prefill, the kernel path's decode logits within the bf16 bar of the
    plain path's, both fed the kernel path's greedy tokens."""
    import dataclasses

    from repro_torch.serve import dequantize, quantize_params

    cfg = dataclasses.replace(TC.get_config("granite_8b"), n_layers=2)
    model = TM.init_params(TM.Transformer(cfg, dtype=torch.float32,
                                          device=card), seed=0)
    qm = quantize_params(model)
    del model
    assert all(t.dtype == torch.int8 for t in qm.q.values())
    B, S, n = 2, 96, 4
    tokens = torch.randint(0, cfg.vocab, (B, S), device=card,
                           generator=torch.Generator(device=card)
                           .manual_seed(4))
    runs = _greedy_runs(qm, tokens, n, {
        "int8": (qm, "cuda", True), "plain": (qm, "ref", True),
        "upfront": (dequantize(qm), "cuda", False)})
    got, want, up = runs["int8"], runs["plain"], runs["upfront"]
    assert got[3]["flash_attention"] == 2 and got[3]["rmsnorm"] == 3
    assert sum(want[3].values()) == 0
    scale = up[0].abs().max()
    assert (got[0] - up[0]).abs().max() <= 1e-6 * scale
    assert torch.equal(got[2], up[2])
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
    assert torch.equal(got[2], want[2])

    q16 = qm.with_dtype(torch.bfloat16)
    steps, fed = {}, None
    for backend in ("cuda", "ref"):
        logits, caches = TM.prefill(q16, tokens, cache_len=S + n,
                                    backend=backend, quantized=True)
        qcaches = TM.init_caches(cfg, B, S + n, dtype=torch.bfloat16,
                                 device=card, quant_kv=True)
        for c, f in zip(qcaches, caches):
            for key in ("k", "v"):
                s = f[key].float().abs().amax(dim=(1, 3), keepdim=True)
                c[f"{key}_s"].copy_(s.clamp_min(1e-6) / 127.0)
                c[key].copy_(torch.clamp(torch.round(
                    f[key].float() / c[f"{key}_s"]), -127, 127))
        # the plain path is fed the kernel path's greedy tokens
        toks, out = [logits.argmax(-1)] if fed is None else fed, []
        for i in range(n):
            step, qcaches = TM.decode_step(q16, toks[i], qcaches, S + i,
                                           backend=backend, quantized=True)
            if fed is None:
                toks.append(step.argmax(-1))
            out.append(step)
        fed = toks
        steps[backend] = torch.cat(out, 1)
    a, b = steps["cuda"], steps["ref"]
    assert torch.isfinite(a).all()
    assert ((a - b).abs().max() / b.abs().max()).item() <= 0.1


# ---------------------------------------------------------------------------
# Training: K8's and K9's backward kernels, the kernels without one, a step
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KVH,D,window,softcap", [
    (1, 130, 4, 2, 16, 0, 0.0), (2, 300, 4, 1, 64, 100, 30.0),
    (1, 200, 2, 1, 112, 0, 0.0), (1, 333, 2, 2, 256, 64, 50.0),
    (2, 257, 8, 2, 128, 0, 0.0), (1, 190, 4, 4, 96, 1, 0.0),
    (1, 100, 2, 2, 32, 7, 20.0),
    # the bf16 kernels' tile edges: one row, one short of a 64-row tile,
    # one key past a 128-key tile, GQA 8, D 256 without a window
    (1, 1, 4, 2, 128, 0, 0.0), (2, 63, 4, 2, 128, 0, 0.0),
    (1, 129, 4, 2, 128, 0, 0.0), (1, 300, 32, 4, 128, 0, 0.0),
    (1, 257, 4, 1, 256, 0, 0.0),
    # the f32 kernels' tile edges (64 x 64 tiles, halves of 32 rows, D in
    # chunks of 32): one row short of a tile, one key past a tile and past
    # a half, GQA 8, D 112's last chunk of 16, D 256 with a window and a
    # softcap
    (1, 63, 4, 2, 64, 0, 0.0), (1, 65, 8, 1, 128, 0, 0.0),
    (2, 33, 4, 4, 112, 0, 0.0), (1, 161, 2, 1, 256, 40, 50.0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_matches_plain_version_on_card(
        card, B, S, H, KVH, D, window, softcap, dtype):
    """K8's backward (delta, dK/dV, dQ kernels) against the plain version
    on the forward kernel's output and log-sum-exp: ragged S, every head
    width, GQA 1-4, windows (1: each query sees itself alone) and
    softcaps; float32 at 1e-5 of each gradient's largest |value|, bf16 at
    K8's bf16 tolerance and row by row against float64; the lse the
    forward writes against the plain version's; the forward's output the
    same with and without lse."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    gen = torch.Generator(device=card).manual_seed(S + D)
    q, do = (torch.randn((B, S, H, D), generator=gen, device=card).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((B, S, KVH, D), generator=gen, device=card)
            .to(dtype) for _ in range(2))
    lse = torch.empty((B, H, S), device=card)
    o = flash_attention(q, k, v, softcap=softcap, window=window, lse=lse)
    assert torch.equal(o, flash_attention(q, k, v, softcap=softcap,
                                          window=window))
    _, want_lse = KR.flash_attention_fwd_ref(q, k, v, softcap=softcap,
                                             window=window)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    KL.reset_launches()
    got = flash_attention_bwd(q, k, v, o, lse, do, softcap=softcap,
                              window=window)
    want = KR.flash_attention_bwd_ref(q, k, v, o, lse, do, softcap=softcap,
                                      window=window)
    torch.cuda.synchronize()
    assert KL.LAUNCHES["flash_attention_bwd"] == 1
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        if dtype == torch.float32:
            scale = max(w.abs().max().item(), 1e-30)
            assert (g - w).abs().max().item() <= 1e-5 * max(
                scale, max(x.abs().max().item() for x in want))
        else:
            torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                       atol=1e-1)
    if dtype == torch.bfloat16:
        # and each row against float64 over the row's norm, the kernel's
        # mean and max within 2x the plain version's, so that rows below
        # the atol count too; rows whose float64 norm is at most 1e-6 of
        # the largest are left out (dq's first row; dq and dk at window 1)
        wide = [x.double() for x in (q, k, v)]
        e_o, e_lse = KR.flash_attention_fwd_ref(*wide, softcap=softcap,
                                                window=window)
        exact = KR.flash_attention_bwd_ref(*wide, e_o, e_lse, do.double(),
                                           softcap=softcap, window=window)
        floor = 1e-6 * max(e.norm(dim=-1).max().item() for e in exact)
        # (at S 1 the one key gives dS = P (dO.v - dO.o) with o = v: dq and
        # dk are 0 up to rounding, as at window 1)
        held = 0
        for g, w, e in zip(got, want, exact):
            norm = e.norm(dim=-1)
            keep = norm > floor
            if not keep.any():
                continue
            held += 1
            rel = [((x.double() - e).norm(dim=-1) / norm)[keep]
                   for x in (g, w)]
            for stat in (torch.mean, torch.amax):
                kernel, plain = (stat(r).item() for r in rel)
                assert kernel <= 2.0 * plain, (stat.__name__, kernel, plain)
        assert held == (1 if window == 1 or S == 1 else 3)


@pytest.mark.cuda
def test_flash_attention_backward_bf16_same_bits_on_card(card):
    """The bf16 backward sums every gradient in one fixed order, without
    atomics: two runs at Granite-8B's head layout (H 32, KVH 8, D 128) give
    the same bits."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    B, S, H, KVH, D = 2, 1000, 32, 8, 128
    gen = torch.Generator(device=card).manual_seed(11)
    q, do = (torch.randn((B, S, H, D), generator=gen, device=card)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, S, KVH, D), generator=gen, device=card)
            .to(torch.bfloat16) for _ in range(2))
    lse = torch.empty((B, H, S), device=card)
    o = flash_attention(q, k, v, lse=lse)
    first = flash_attention_bwd(q, k, v, o, lse, do)
    second = flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.isfinite(a.float()).all()
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_backward_f32_same_bits_on_card(card):
    """The float32 backward sums every gradient in one fixed order, without
    atomics (each chunk's and each half's sum apart, then in order in f32
    registers): two runs at Granite-8B's head layout (H 32, KVH 8, D 128)
    and at Gemma-2's (H 8, KVH 4, D 256, window and softcap) give the same
    bits."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    for B, S, H, KVH, D, window, cap in ((2, 1000, 32, 8, 128, 0, 0.0),
                                         (1, 700, 8, 4, 256, 300, 50.0)):
        gen = torch.Generator(device=card).manual_seed(12)
        q, do = (torch.randn((B, S, H, D), generator=gen, device=card)
                 for _ in range(2))
        k, v = (torch.randn((B, S, KVH, D), generator=gen, device=card)
                for _ in range(2))
        lse = torch.empty((B, H, S), device=card)
        o = flash_attention(q, k, v, softcap=cap, window=window, lse=lse)
        first = flash_attention_bwd(q, k, v, o, lse, do, softcap=cap,
                                    window=window)
        second = flash_attention_bwd(q, k, v, o, lse, do, softcap=cap,
                                     window=window)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.isfinite(a).all()
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(37, 64), (1024, 4096), (5, 1028),
                                    (300, 3584)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True],
                         ids=["rmsnorm", "residual"])
def test_rmsnorm_backward_matches_plain_version_on_card(card, rows, d, dtype,
                                                        residual):
    """K9's backward (rows in CTAs, dw reduced in CTA order) against the
    plain version; float32 at 1e-5 of each gradient's largest |value|,
    bf16 at K9's bf16 tolerance; run twice, the same bits."""
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd,
                                             rmsnorm_residual_bwd)
    gen = torch.Generator(device=card).manual_seed(rows + d)
    x, r, g, gs = (torch.randn((rows, d), generator=gen, device=card)
                   .to(dtype) for _ in range(4))
    w = 0.1 * torch.randn(d, generator=gen, device=card)

    def run():
        return (rmsnorm_residual_bwd(x, r, w, g, gs) if residual
                else rmsnorm_bwd(x, w, g))

    got = run()
    want = (KR.rmsnorm_residual_bwd_ref(x, r, w, g, gs) if residual
            else KR.rmsnorm_bwd_ref(x, w, g))
    again = run()
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, c)
        if dtype == torch.float32:
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
        else:
            torch.testing.assert_close(a.float(), b.float(), rtol=1e-2,
                                       atol=1e-2)


@pytest.mark.cuda
def test_kernels_without_a_backward_raise_under_grad_on_card(card):
    """K6 and K7 raise under autograd on the card, and run without; K10,
    which has its backward kernel now, runs under autograd through its
    ``autograd.Function``, forward and backward kernel."""
    a = torch.rand((4, 3, 5), device=card) + 2.0
    leaf = a.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="item 11b"):
        KO.tridiag(leaf, a, a, a)
    q = torch.rand((2, 8, 12), device=card).requires_grad_()
    with pytest.raises(RuntimeError, match="item 11b"):
        KO.fvt_flux(q, q.detach(), halo=3)
    states = torch.randn((3, 1, 2, 4, 4), device=card, requires_grad=True)
    decay = torch.rand((3, 1, 2), device=card)
    KL.reset_launches()
    KO.ssm_state_scan(states, decay).sum().backward()
    torch.cuda.synchronize()
    assert KL.LAUNCHES["ssm_state_scan"] == 1
    assert KL.LAUNCHES["ssm_state_scan_bwd"] == 1
    assert states.grad is not None
    with torch.no_grad():
        KO.ssm_state_scan(states, decay)
        KO.tridiag(leaf, a, a, a)


@pytest.mark.cuda
@pytest.mark.parametrize("nc,B,H,N,P", [(16, 2, 8, 64, 64), (3, 1, 3, 5, 7),
                                        (1, 2, 4, 8, 8), (4, 1, 2, 65, 70)])
def test_ssm_state_scan_backward_matches_plain_version_on_card(card, nc, B,
                                                               H, N, P):
    """K10's backward against its plain version: d states bit for bit (a
    rounded twice, ``--fmad=false``, as the plain version), d decay within
    1e-5 of its largest |value| (summed in float64 in another order); two
    runs give the same bits.  The shapes: Zamba2's heads, a ragged N P (35:
    no float4 loads, a CTA's last threads idle), one chunk, and N P past a
    CTA's 4096 chains (two passes)."""
    from repro_torch.kernels.ssm_scan import ssm_state_scan_bwd
    gen = torch.Generator(device=card).manual_seed(nc + N * P)
    states = torch.randn((nc, B, H, N, P), generator=gen, device=card)
    decay = 1.0 - torch.rand((nc, B, H), generator=gen, device=card)
    g = torch.randn((nc, B, H, N, P), generator=gen, device=card)
    out = KO.ssm_state_scan(states, decay)
    KL.reset_launches()
    got = ssm_state_scan_bwd(g, out, decay)
    again = ssm_state_scan_bwd(g, out, decay)
    want = KR.ssm_state_scan_bwd_ref(g, out, decay)
    torch.cuda.synchronize()
    assert KL.LAUNCHES["ssm_state_scan_bwd"] == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[0], want[0])
    scale = max(want[1].abs().max().item(), 1e-30)
    assert (got[1] - want[1]).abs().max().item() <= 1e-5 * scale
    if nc == 1:
        assert not got[0].any() and not got[1].any()
    with pytest.raises(ValueError, match="contiguous"):
        ssm_state_scan_bwd(g.transpose(3, 4).contiguous().transpose(3, 4),
                           out, decay)


@pytest.mark.cuda
def test_zamba2_training_step_on_card_launches_k10(card):
    """A Zamba2 smoke-width training step (float32 masters, bf16 compute,
    grad_accum 2) on the card: K10 launched forward (with the
    recomputation) and backward once a Mamba-2 layer a microbatch, the
    loss finite; one float32 loss and backward through the kernels within
    1e-5 (loss) and 1e-4 of each gradient's max of the plain path."""
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (TrainConfig, init_state,
                                              make_train_step)

    cfg = TC.smoke_config("zamba2_7b")
    model = TM.init_params(TM.Transformer(cfg, dtype=torch.float32,
                                          device=card), seed=0)
    model.requires_grad_(True)
    gen = torch.Generator(device=card).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, 256), generator=gen,
                           device=card)
    labels = torch.randint(0, cfg.vocab, (4, 256), generator=gen,
                           device=card)
    out = {}
    for backend in ("cuda", "ref"):
        model.zero_grad(set_to_none=True)
        loss = TM.loss_fn(model, tokens, labels, dtype=torch.float32,
                          backend=backend)
        loss.backward()
        out[backend] = (loss.item(), [p.grad.clone()
                                      for p in model.parameters()])
    (lk, gk), (lr, gr) = out["cuda"], out["ref"]
    assert abs(lk - lr) <= 1e-5 * abs(lr)
    for a, b in zip(gk, gr):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
    state = init_state(cfg, model)
    step = make_train_step(cfg, TrainConfig(
        grad_accum=2, opt=OptConfig(lr=1e-3, warmup=1)))
    KL.reset_launches()
    state, m = step(state, {"tokens": tokens, "labels": labels})
    torch.cuda.synchronize()
    n_mamba = sum(b == "mamba2" for b in cfg.pattern) * cfg.n_groups
    assert KL.LAUNCHES["ssm_state_scan_bwd"] == 2 * n_mamba
    assert KL.LAUNCHES["ssm_state_scan"] >= 2 * n_mamba
    assert torch.isfinite(m["loss"]) and m["step"] == 1


@pytest.mark.cuda
def test_granite_training_step_on_card_matches_plain_path(card):
    """One loss and backward of 2 Granite-8B layers at full width (float32
    masters and compute, 2 x 256 tokens) through the kernels (K8 and K9
    forward and backward) and through the plain versions: the loss within
    1e-5 relative, every gradient within 1e-4 of its largest |value|; then
    a train step (grad_accum 2) moves every parameter."""
    import dataclasses

    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (TrainConfig, init_state,
                                              make_train_step)

    cfg = dataclasses.replace(TC.get_config("granite_8b"), n_layers=2)
    model = TM.init_params(TM.Transformer(cfg, dtype=torch.float32,
                                          device=card), seed=0)
    model.requires_grad_(True)
    gen = torch.Generator(device=card).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (2, 256), generator=gen,
                           device=card)
    labels = torch.randint(0, cfg.vocab, (2, 256), generator=gen,
                           device=card)
    out = {}
    for backend in ("cuda", "ref"):
        model.zero_grad(set_to_none=True)
        KL.reset_launches()
        loss = TM.loss_fn(model, tokens, labels, dtype=torch.float32,
                          backend=backend)
        loss.backward()
        torch.cuda.synchronize()
        assert (KL.LAUNCHES["flash_attention_bwd"] > 0) == (backend == "cuda")
        assert (KL.LAUNCHES["rmsnorm_residual_bwd"] > 0) == (backend ==
                                                             "cuda")
        out[backend] = (loss.item(), [p.grad.clone()
                                      for p in model.parameters()])
    (lk, gk), (lr, gr) = out["cuda"], out["ref"]
    assert abs(lk - lr) <= 1e-5 * abs(lr)
    for a, b in zip(gk, gr):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
    before = [p.detach().clone() for p in model.parameters()]
    state = init_state(cfg, model)
    step = make_train_step(cfg, TrainConfig(
        grad_accum=2, opt=OptConfig(lr=1e-3, warmup=1)))
    state, m = step(state, {"tokens": tokens, "labels": labels})
    assert torch.isfinite(m["loss"]) and m["step"] == 1
    assert all(not torch.equal(a, p) for a, p in
               zip(before, model.parameters()))
