"""IR well-formedness: declaration, dataflow-order, K-extent and
LevelSearch structural checks (the verifier's first analysis).

Checks, per graph node:

 * every name a statement reads is a signature field or a temporary some
   *earlier* statement wrote (temporary read-before-write reads
   uninitialized/zero scratch — defined in one backend, garbage in another);
 * every signature field is declared in the program with the same K
   staggering the stencil expects;
 * interface/center K-extent consistency: a statement targeting an
   ``nk_t``-level field iterates rows ``[lo, hi)`` of that extent, so a read
   at K offset ``dk`` touches rows ``[lo+dk, hi+dk)`` of the read field —
   which must stay inside that field's own allocation (``nk`` center,
   ``nk+1`` interface).  Out-of-range rows are silently edge-clamped by the
   lowerings, i.e. they produce *wrong values*, not crashes;
 * interval bases are well-formed and statement intervals are non-empty on
   this domain (empty is only a lint — see :mod:`.lints`);
 * LevelSearch invariants: no nested searches, ``FoundLevel`` only inside a
   search body, the coordinate is a readable name, resolved source-layer
   bounds are non-empty and inside the coordinate column, and every
   found-level read ``s* + dk`` stays inside the read field's column.
"""

from __future__ import annotations

from ..errors import Violation
from ..stencil.ir import Direction, Stencil
from .common import (
    expr_reads,
    found_levels_outside_search,
    iter_statements,
    k_extent,
    resolve_interval,
    search_found_levels,
    searches_in,
)


def _check_stencil(st: Stencil, nk: int, *, program: str | None = None,
                   node: str | None = None) -> list[Violation]:
    out: list[Violation] = []

    def bad(msg: str, stmt=None, field=None, offset=None) -> None:
        out.append(Violation(
            "wellformed", msg, program=program, node=node, stencil=st.name,
            statement=None if stmt is None else repr(stmt),
            field=field, offset=offset,
            loc=None if stmt is None else stmt.loc))

    defined: set[str] = set(st.fields)
    for _, comp, s in iter_statements(st):
        # a sequential computation's marching-carry read (dk == previous
        # level) may target a name a textually-later boundary-interval
        # statement initializes — the march interleaves statements per
        # level, so that is not a read of uninitialized scratch
        prev = {Direction.FORWARD: -1, Direction.BACKWARD: 1}.get(
            comp.direction, None)
        comp_writes = {s2.target for s2 in comp.statements}
        # --- declaration / write-first order ---------------------------
        for r in expr_reads(s.value):
            if prev is not None and r.dk == prev and r.name in comp_writes:
                continue
            if r.name not in defined:
                if r.name == s.target or any(
                        s2.target == r.name
                        for _, _, s2 in iter_statements(st)):
                    bad(f"temporary {r.name!r} is read before any statement "
                        "writes it (uninitialized scratch)", s,
                        field=r.name, offset=(r.di, r.dj, r.dk))
                else:
                    bad(f"read of undeclared name {r.name!r} (not a "
                        "signature field and never written)", s,
                        field=r.name, offset=(r.di, r.dj, r.dk))
        # --- interval sanity -------------------------------------------
        for base, off in (s.interval.start, s.interval.end):
            if base not in (0, 1):
                bad(f"malformed interval base {base!r} (must be 0=top or "
                    "1=bottom)", s)
        # --- K-extent consistency --------------------------------------
        nk_t = k_extent(st, s.target, nk)
        lo, hi = resolve_interval(s.interval, nk_t)
        if hi > lo:
            for r in expr_reads(s.value):
                if r.absolute_k or r.name not in defined:
                    continue
                nk_f = k_extent(st, r.name, nk)
                if lo + r.dk < 0 or hi + r.dk > nk_f:
                    bad(f"K read of {r.name!r} at offset {r.dk:+d} reaches "
                        f"rows [{lo + r.dk}, {hi + r.dk}) outside its "
                        f"{nk_f}-level column (target {s.target!r} iterates "
                        f"[{lo}, {hi}) of {nk_t} levels) — the lowering "
                        "would edge-clamp these rows", s,
                        field=r.name, offset=(r.di, r.dj, r.dk))
        # --- LevelSearch invariants ------------------------------------
        for fl in found_levels_outside_search(s.value):
            bad(f"at_found({fl.name!r}) outside an index_search body", s,
                field=fl.name)
        searches = list(searches_in(s.value))
        nested = [se for se, depth in searches if depth > 0]
        for se in nested:
            bad("nested index_search is unsupported (inner search "
                f"over {se.coord!r})", s, field=se.coord)
        for se, _depth in [] if nested else searches:
            if se.coord not in defined:
                bad(f"index_search coordinate {se.coord!r} is undeclared "
                    "and never written", s, field=se.coord)
                continue
            slo = max(0, se.lo[0] * nk + se.lo[1])
            shi = se.hi[0] * nk + se.hi[1]
            nk_c = k_extent(st, se.coord, nk)
            if shi <= slo:
                bad(f"index_search over {se.coord!r} has empty source-layer "
                    f"range [{slo}, {shi}) on a {nk}-level domain", s,
                    field=se.coord)
            elif shi > nk_c:
                bad(f"index_search over {se.coord!r} walks layers "
                    f"[{slo}, {shi}) past its {nk_c}-level column", s,
                    field=se.coord)
            for fl in search_found_levels(se):
                if fl.name not in defined:
                    continue  # reported by the declaration check above
                nk_f = k_extent(st, fl.name, nk)
                if slo + fl.dk < 0 or (shi - 1) + fl.dk >= nk_f:
                    bad(f"at_found({fl.name!r}, dk={fl.dk:+d}) can read "
                        f"level {(shi - 1) + fl.dk} outside its "
                        f"{nk_f}-level column (search layers "
                        f"[{slo}, {shi}))", s, field=fl.name,
                        offset=(fl.di, fl.dj, fl.dk))
        defined.add(s.target)
    # --- signature sanity ----------------------------------------------
    for o in st.outputs:
        if o not in st.fields:
            bad(f"declared output {o!r} is not a signature field")
    return out


def check_wellformed(program) -> list[Violation]:
    """Run the well-formedness analysis over every node of a
    :class:`~repro_torch.core.graph.StencilProgram`."""
    out: list[Violation] = []
    nk = program.dom.nk
    for node in program.all_nodes():
        st = node.stencil
        for f in st.fields:
            decl = program.fields.get(f)
            if decl is None:
                out.append(Violation(
                    "wellformed",
                    f"field {f!r} is not declared in the program",
                    program=program.name, node=node.label, stencil=st.name,
                    field=f))
            elif decl.interface != (f in st.interface_fields):
                want = "interface" if f in st.interface_fields else "center"
                have = "interface" if decl.interface else "center"
                out.append(Violation(
                    "wellformed",
                    f"field {f!r}: stencil expects a {want} (K-staggering) "
                    f"field but the program declares {have}",
                    program=program.name, node=node.label, stencil=st.name,
                    field=f))
        out.extend(_check_stencil(st, nk, program=program.name,
                                  node=node.label))
    return out
