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

Tests marked ``cuda`` need a card and skip without one.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.backend import TuningCache, set_default_cache
from repro_torch.core.backend import cuda as C
from repro_torch.core.hardware import Hardware, register_hardware
from repro_torch.core.stencil import (Assign, Computation, DomainSpec,
                                      FieldAccess, Interval, Schedule,
                                      Stencil)
from repro_torch.core.stencil import ir
from repro_torch.fv3 import dyncore as TD
from repro_torch.fv3 import state as TSt
from repro_torch.fv3 import stencils as TS
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


class _StreamEvaluator:
    """Vectorised torch reading of the kernels' instruction stream."""

    def __init__(self, slots, params, consts):
        self.slots = slots          # slot -> (T, K, Jp, Ip) tensor
        self.params = params        # f32 values in parameter order
        self.consts = torch.tensor(consts or [0.0], dtype=torch.float32)

    def load(self, slot, ks, js, is_):
        arr = self.slots[slot]
        return arr[:, ks.clamp(0, arr.shape[-3] - 1), js, is_]

    def run(self, prog, pc, end, ks, js, is_):
        stk, found = [], []
        f32 = torch.float32
        while pc < end:
            op = prog[pc]
            pc += 1
            if op == C.OP_LOAD:
                s, di, dj, dk = prog[pc:pc + 4]
                pc += 4
                stk.append(self.load(s, ks + dk, js + dj, is_ + di))
            elif op == C.OP_CONST:
                stk.append(self.consts[prog[pc]])
                pc += 1
            elif op == C.OP_PARAM:
                stk.append(torch.tensor(self.params[prog[pc]], dtype=f32))
                pc += 1
            elif op == C.OP_FOUND:
                stk.append(found[prog[pc]])
                pc += 1
            elif op == C.OP_SEARCH:
                coord, lo, hi, nf = prog[pc:pc + 4]
                pc += 4
                target = stk.pop()
                lvl = torch.full(target.shape, lo, dtype=torch.int64)
                for layer in range(lo + 1, hi):
                    c = self.load(coord, torch.tensor(layer), js, is_)
                    lvl = torch.where(c <= target, layer, lvl)
                found = []
                for _ in range(nf):
                    s, di, dj, dk = prog[pc:pc + 4]
                    pc += 4
                    arr = self.slots[s]
                    win = arr[:, :, (js + dj)[0], (is_ + di)[0]]
                    win = win.expand(lvl.shape[:1] + win.shape[1:2]
                                     + lvl.shape[2:])
                    idx = (lvl + dk).clamp(0, arr.shape[-3] - 1)
                    found.append(torch.gather(win, 1, idx))
            elif op in UNARY:
                x = stk.pop()
                stk.append({"neg": torch.neg, "sqrt": torch.sqrt,
                            "abs": torch.abs, "exp": torch.exp,
                            "log": torch.log, "sign": torch.sign,
                            "floor": torch.floor}[UNARY[op]](x))
            elif op == C.OP_WHERE:
                b, a, c = stk.pop(), stk.pop(), stk.pop()
                stk.append(torch.where(c != 0, a, b))
            else:
                b, a = stk.pop(), stk.pop()
                if op in BINARY:
                    r = {"+": a + b, "-": a - b, "*": a * b, "/": a / b,
                         "<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b,
                         "==": a == b, "!=": a != b}[BINARY[op]]
                else:
                    r = {C.OP_MIN: torch.minimum, C.OP_MAX: torch.maximum,
                         C.OP_POW: torch.pow}[op](a, b)
                stk.append(r.to(f32))
        assert len(stk) == 1
        return stk[0]

    def statement(self, prog, rec, ks):
        tgt, klo, khi, j0, j1, i0, i1, b, e = rec
        js = torch.arange(j0, j1)[None, :, None]
        is_ = torch.arange(i0, i1)[None, None, :]
        val = self.run(prog, b, e, ks[:, None, None], js, is_)
        out = self.slots[tgt]
        k0, k1 = int(ks[0]), int(ks[-1]) + 1
        out[:, k0:k1, j0:j1, i0:i1] = val.expand(
            out.shape[0], k1 - k0, j1 - j0, i1 - i0)

    def launch(self, p):
        n = p.prog[0]
        recs = [p.prog[1 + C.REC_INTS * q: 1 + C.REC_INTS * (q + 1)]
                for q in range(n)]
        if p.kind == "horizontal":
            (rec,) = recs
            if rec[2] > rec[1] and rec[4] > rec[3] and rec[6] > rec[5]:
                self.statement(p.prog, rec, torch.arange(rec[1], rec[2]))
            return
        for step in range(p.hi - p.lo):
            k = p.lo + step if p.forward else p.hi - 1 - step
            for rec in recs:
                if rec[1] <= k < rec[2] and rec[4] > rec[3] and rec[6] > rec[5]:
                    self.statement(p.prog, rec, torch.tensor([k]))


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
    n = {name: len(C.CudaStencil(getattr(TS, name), DOM).programs)
         for name in NAMES}
    # one K1 launch per PARALLEL statement, one K2 per solver computation
    assert n["fx_ppm"] == 7 and n["edge_flux"] == 3
    assert n["riem_coeffs"] == 12 and n["tridiag_solve"] == 2
    assert n["column_total"] == 2 and n["interface_interp"] == 1
    kinds = {p.kind for p in C.CudaStencil(TS.tridiag_solve, DOM).programs}
    assert kinds == {"column"}
    (search,) = C.CudaStencil(TS.interface_interp, DOM).programs
    assert search.kind == "horizontal" and search.has_search
    assert max(p.stack for name in NAMES
               for p in C.CudaStencil(getattr(TS, name), DOM).programs) \
        <= C.STACK_MAX


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
    for _ in range(C.STACK_MAX):
        e = q + e * q
    deep = _stencil([Computation(ir.PARALLEL, (Assign("out", e),))],
                    ("q", "out"))
    with pytest.raises(ValueError, match="stack"):
        C.encode_stencil(deep, DOM)
    far = _stencil([Computation(ir.PARALLEL, (
        Assign("out", FieldAccess("q", (DOM.halo, 0, 0))),))], ("q", "out"))
    with pytest.raises(ValueError, match="outside the allocation"):
        C.encode_stencil(far, DOM)


def test_constants_fold_in_double_precision():
    (p,) = C.CudaStencil(TS.al_x, DOM).programs
    assert p.consts == [7.0 / 12.0, 1.0 / 12.0]
    assert C.BINARY_OPS["/"] not in p.prog[1 + C.REC_INTS:]


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
