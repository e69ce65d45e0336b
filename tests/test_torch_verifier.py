"""The port's static verifier (``repro_torch.core.analysis``) against the
reference's.

Every seeded IR mutation of the reference's ``tests/test_verifier.py`` is
applied to the same small program built in each package; both verifiers
must reject it with the same violations (analysis kind, stencil, field,
offset and message).  The unmutated programs and the dycore at every opt
level verify clean, and a violation is attributed to the pass that made it.
"""

import dataclasses
import types

import pytest

import repro.core as R
import repro.core.stencil as RSt
import repro.core.stencil.ir as RIR
from repro.core.analysis import resolve_verify_mode as r_resolve_verify_mode

import repro_torch.core as T
import repro_torch.core.stencil as TSt
import repro_torch.core.stencil.ir as TIR
from repro_torch.core import (FunctionRule, TuningCache, VerificationError,
                              compile_program, optimize_program,
                              register_rule, set_default_cache)
from repro_torch.core.analysis import resolve_verify_mode
from repro_torch.core.stencil import Field
from repro_torch.fv3 import dyncore as TD


@pytest.fixture(autouse=True, scope="module")
def _own_tuning_cache(tmp_path_factory):
    """The port's tuning cache of this file: a throwaway file, never the
    working tree's ``.repro_cache/torch_tuning.json``."""
    set_default_cache(TuningCache(
        tmp_path_factory.mktemp("torch_tuning") / "torch_tuning.json"))
    yield
    set_default_cache(None)


def lap(q: Field, lp: Field):
    with computation(PARALLEL), interval(...):
        lp = q[1, 0, 0] + q[-1, 0, 0] + q[0, 1, 0] + q[0, -1, 0] - 4.0 * q


def diff(lp: Field, out: Field):
    with computation(PARALLEL), interval(...):
        out = lp[1, 0, 0] - 2.0 * lp + lp[-1, 0, 0]


def cumsum(a: Field, x: Field):
    with computation(FORWARD):
        with interval(0, 1):
            x = a
        with interval(1, None):
            x = a + 0.5 * x[0, 0, -1]


def _package(core, stencil, ir):
    """One package's names, with the three stencils above parsed by its own
    frontend."""
    return types.SimpleNamespace(
        core=core, st=stencil, ir=ir,
        lap=stencil.gtstencil(lap), diff=stencil.gtstencil(diff),
        cumsum=stencil.gtstencil(cumsum))


PACKAGES = {"reference": _package(R, RSt, RIR),
            "port": _package(T, TSt, TIR)}


def clean_program(pk, nk: int = 4):
    dom = pk.st.DomainSpec(ni=8, nj=8, nk=nk, halo=3)
    p = pk.core.StencilProgram("toy", dom)
    p.declare("q")
    p.declare("lp", transient=True)
    p.declare("out")
    p.add(pk.lap, {"q": "q", "lp": "lp"})
    p.add(pk.diff, {"lp": "lp", "out": "out"})
    p.propagate_extents()
    return p


def solver_program(pk, nk: int = 8):
    dom = pk.st.DomainSpec(ni=8, nj=8, nk=nk, halo=3)
    p = pk.core.StencilProgram("march", dom)
    p.declare("a")
    p.declare("x")
    node = p.add(pk.cumsum, {"a": "a", "x": "x"})
    node.schedule = pk.st.Schedule(block_k=nk // 2, k_as_grid=False,
                                   carry_storage="vmem")
    p.propagate_extents()
    return p


def _replace_stmt(pk, node, ci, si, **changes):
    st = node.stencil
    comps = list(st.computations)
    stmts = list(comps[ci].statements)
    stmts[si] = dataclasses.replace(stmts[si], **changes)
    comps[ci] = pk.ir.Computation(comps[ci].direction, tuple(stmts))
    node.stencil = dataclasses.replace(st, computations=tuple(comps))


# -- the mutations: each returns the mutated program ------------------------

def m_dropped_extent(pk):
    p = clean_program(pk)
    assert p.all_nodes()[0].extend == (1, 0)
    p.all_nodes()[0].extend = (0, 0)
    return p


def m_offset_widened_past_halo(pk):
    p = clean_program(pk)
    wide = pk.ir.FieldAccess("lp", (p.dom.halo + 1, 0, 0))
    _replace_stmt(pk, p.all_nodes()[1], 0, 0, value=wide)
    return p


def m_fused_write_then_offset_read(pk):
    ir = pk.ir
    dom = pk.st.DomainSpec(ni=8, nj=8, nk=4, halo=3)
    p = pk.core.StencilProgram("racy", dom)
    p.declare("q")
    p.declare("f", transient=True)
    p.declare("g")
    st = ir.Stencil(
        name="fused",
        computations=(ir.Computation(ir.Direction.PARALLEL, (
            ir.Assign("f", ir.FieldAccess("q", (0, 0, 0)), ir.Interval(),
                      None),
            ir.Assign("g", ir.FieldAccess("f", (1, 0, 0)), ir.Interval(),
                      None),
        )),),
        fields=("q", "f", "g"), outputs=("f", "g"))
    p.add(st, {n: n for n in st.fields})
    p.propagate_extents()
    return p


def m_marching_carry_horizontal_offset(pk):
    p = solver_program(pk)
    node = p.all_nodes()[0]
    carried = pk.ir.FieldAccess("x", (1, 0, -1))
    val = node.stencil.computations[0].statements[1].value
    _replace_stmt(pk, node, 0, 1,
                  value=val.substitute("x", lambda off: carried))
    return p


def m_marching_deep_k_read(pk):
    p = solver_program(pk)
    _replace_stmt(pk, p.all_nodes()[0], 0, 1,
                  value=pk.ir.FieldAccess("a", (0, 0, -2)))
    return p


def m_read_of_undeclared_name(pk):
    p = clean_program(pk)
    _replace_stmt(pk, p.all_nodes()[1], 0, 0,
                  value=pk.ir.FieldAccess("ghost", (0, 0, 0)))
    return p


def m_temp_read_before_write(pk):
    ir = pk.ir
    dom = pk.st.DomainSpec(ni=8, nj=8, nk=4, halo=3)
    p = pk.core.StencilProgram("t", dom)
    p.declare("q")
    p.declare("out")
    st = ir.Stencil(
        name="scratch",
        computations=(ir.Computation(ir.Direction.PARALLEL, (
            ir.Assign("out", ir.FieldAccess("tmp", (0, 0, 0)),
                      ir.Interval(), None),
            ir.Assign("tmp", ir.FieldAccess("q", (0, 0, 0)), ir.Interval(),
                      None),
        )),),
        fields=("q", "out"), outputs=("out",))
    p.add(st, {"q": "q", "out": "out"})
    p.propagate_extents()
    return p


def m_flipped_interface_staggering(pk):
    p = clean_program(pk)
    p.fields["q"] = dataclasses.replace(p.fields["q"], interface=True)
    return p


def m_k_offset_outside_column(pk):
    p = clean_program(pk)
    _replace_stmt(pk, p.all_nodes()[1], 0, 0,
                  value=pk.ir.FieldAccess("lp", (0, 0, -1)))
    return p


def m_nested_level_search(pk):
    ir = pk.ir
    p = clean_program(pk)
    inner = ir.LevelSearch("q", ir.Const(1.0), ir.FoundLevel("q"), (0, 0),
                           (1, 0))
    outer = ir.LevelSearch("lp", ir.Const(1.0), inner, (0, 0), (1, 0))
    _replace_stmt(pk, p.all_nodes()[1], 0, 0, value=outer)
    return p


def m_found_level_outside_search(pk):
    p = clean_program(pk)
    _replace_stmt(pk, p.all_nodes()[1], 0, 0,
                  value=pk.ir.FoundLevel("lp"))
    return p


def m_at_found_past_column_end(pk):
    ir = pk.ir
    p = clean_program(pk)
    search = ir.LevelSearch("lp", ir.Const(1.0), ir.FoundLevel("lp", dk=+1),
                            (0, 0), (1, 0))
    _replace_stmt(pk, p.all_nodes()[1], 0, 0, value=search)
    return p


MUTATIONS = {  # mutation -> the analysis that must reject it
    m_dropped_extent: "halo",
    m_offset_widened_past_halo: "halo",
    m_fused_write_then_offset_read: "race",
    m_marching_carry_horizontal_offset: "race",
    m_marching_deep_k_read: "race",
    m_read_of_undeclared_name: "wellformed",
    m_temp_read_before_write: "wellformed",
    m_flipped_interface_staggering: "wellformed",
    m_k_offset_outside_column: "wellformed",
    m_nested_level_search: "wellformed",
    m_found_level_outside_search: "wellformed",
    m_at_found_past_column_end: "wellformed",
}


def _violations(pk, program):
    return sorted(((v.analysis, v.stencil, v.field, v.offset, v.message)
                   for v in pk.core.verify_program(program)), key=repr)


@pytest.mark.parametrize("mutation", list(MUTATIONS),
                         ids=[m.__name__[2:] for m in MUTATIONS])
def test_mutation_rejected_alike_in_both_packages(mutation):
    ref = _violations(PACKAGES["reference"], mutation(PACKAGES["reference"]))
    got = _violations(PACKAGES["port"], mutation(PACKAGES["port"]))
    assert got == ref
    assert MUTATIONS[mutation] in {v[0] for v in got}


@pytest.mark.parametrize("build", [clean_program, solver_program])
def test_clean_programs_verify_in_both_packages(build):
    for pk in PACKAGES.values():
        assert pk.core.verify_program(build(pk)) == []


def test_lints_agree():
    out = {}
    for name, pk in PACKAGES.items():
        p = clean_program(pk)
        p.declare("q")
        out[name] = sorted((v.field, v.message)
                           for v in pk.core.check_lints(p))
    assert out["port"] == out["reference"]
    assert any("shadowed declare" in m for _, m in out["port"])


def test_violation_attributed_to_responsible_pass():
    def break_extent(program, ctx):
        program.all_nodes()[0].extend = (0, 0)
        return 1

    register_rule(FunctionRule("_test_break_extent", break_extent),
                  overwrite=True)
    with pytest.raises(VerificationError) as ei:
        optimize_program(clean_program(PACKAGES["port"]),
                         passes=("_test_break_extent",), verify="passes")
    assert ei.value.pass_name == "_test_break_extent"
    assert all(v.pass_name == "_test_break_extent"
               for v in ei.value.violations)
    broken = clean_program(PACKAGES["port"])
    broken.all_nodes()[0].extend = (0, 0)
    with pytest.raises(VerificationError) as ei:
        optimize_program(broken, opt_level=1, verify="passes")
    assert ei.value.pass_name is None


def test_verify_mode_resolves_as_the_reference(monkeypatch):
    for mode in ("off", "passes", "full"):
        assert resolve_verify_mode(mode) == r_resolve_verify_mode(mode)
    monkeypatch.setenv("REPRO_VERIFY", "off")
    assert resolve_verify_mode(None) == r_resolve_verify_mode(None) == "off"
    monkeypatch.delenv("REPRO_VERIFY")
    assert resolve_verify_mode(None) == r_resolve_verify_mode(None) \
        == "passes"  # under pytest
    with pytest.raises(ValueError):
        resolve_verify_mode("loud")


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("opt_level", [0, 1, 2, 3, 4])
def test_dycore_clean_under_full_verification(backend, opt_level):
    cfg = TD.FV3Config(npx=8, nk=4, halo=6)
    for p in TD._build_programs(cfg, cfg.seq_dom()):
        fn = compile_program(p, backend, opt_level=opt_level, verify="full",
                             device="cpu")
        assert fn.verify_mode == "full"
        if opt_level:
            assert fn.opt_report.total_verify_violations == 0
