"""Intra-kernel race detection (the verifier's second analysis).

A fused kernel executes its statements over one parallel iteration space.
Three defect classes are flagged — exactly the classes the pass-side
legality predicates (``can_otf_fuse``/``can_subgraph_fuse``/
``solver_k_blockable``) are supposed to guard against, re-derived here from
the raw IR with no shared code:

 1. **Horizontal write→read races**: a statement reads a program field at a
    nonzero horizontal offset after an earlier statement in the same kernel
    wrote it.  Neighboring grid points update that field in the same
    parallel sweep, so the offset read observes a mix of old and new values
    depending on block shape and execution order.

 2. **Uninlinable offset temporary reads**: a read of a kernel-local
    temporary at a nonzero horizontal offset when the temporary's
    definition cannot be replicated at that offset (multiple definitions,
    region/interval-restricted, sequential-carried, or containing a
    ``LevelSearch`` — a search walks absolute coordinate columns and is not
    a pure shift).

 3. **K-blocked marching boundary races**: a node whose schedule requests
    the K-blocked marching lowering (sequential ``block_k`` < nk dividing
    nk) must satisfy the single-level-carry contract — one marching
    direction, K reads only at the current or marching-previous level, the
    previous-level (carry) reads horizontal-offset-free and never of a
    field a later computation writes, no interface fields, no level search.
    The carry contract is also what keeps *member-chunk carry planes*
    independent: a chunked ensemble lowering stacks C member columns into
    one scratch carry, and any horizontal or deeper-K reach would bleed
    across member planes at chunk boundaries.
"""

from __future__ import annotations

from ..errors import Violation
from ..stencil.ir import Direction, Stencil
from .common import expandable_temps, expr_reads, iter_statements


def _node_schedule_requests_kblock(node, nk: int) -> bool:
    sched = node.schedule
    if sched is None or sched.k_as_grid:
        return False
    bk = sched.block_k
    return bool(bk) and bk < nk and nk % bk == 0


def _check_marching(st: Stencil, *, program, node) -> list[Violation]:
    """Independent re-derivation of the K-blocked marching contract."""
    out: list[Violation] = []

    def bad(msg: str, stmt=None, field=None, offset=None) -> None:
        out.append(Violation(
            "race", msg, program=program, node=node, stencil=st.name,
            statement=None if stmt is None else repr(stmt), field=field,
            offset=offset, loc=None if stmt is None else stmt.loc))

    dirs = {c.direction for c in st.computations
            if c.direction is not Direction.PARALLEL}
    if len(dirs) != 1:
        bad("K-blocked schedule on a stencil with "
            f"{len(dirs)} sequential directions (the blocked march runs "
            "one direction with a one-level carry)")
        return out
    prev = -1 if Direction.FORWARD in dirs else 1
    if st.interface_fields:
        bad("K-blocked schedule on a stencil with interface fields "
            f"{tuple(st.interface_fields)!r} (nk+1 rows cannot co-tile "
            "with nk-row blocks)")
    # fields written strictly after each computation
    later: list[set[str]] = []
    suffix: set[str] = set()
    for c in reversed(st.computations):
        later.append(set(suffix))
        suffix |= {s.target for s in c.statements}
    later.reverse()
    for ci, comp, s in iter_statements(st):
        for r in expr_reads(s.value):
            if r.search is not None or r.absolute_k:
                bad("K-blocked schedule on a stencil containing a level "
                    "search (the search walks whole coordinate columns "
                    "across block boundaries)", s, field=r.name)
                continue
            if comp.direction is Direction.PARALLEL:
                if r.dk != 0:
                    bad(f"K-offset read of {r.name!r} at {r.dk:+d} in a "
                        "PARALLEL computation under a K-blocked marching "
                        "schedule crosses the block boundary", s,
                        field=r.name, offset=(r.di, r.dj, r.dk))
            elif r.dk == prev:
                if (r.di, r.dj) != (0, 0):
                    bad(f"marching-carry read of {r.name!r} at horizontal "
                        f"offset {(r.di, r.dj)} — the one-level carry "
                        "plane holds only the zero-offset column (and, "
                        "chunk-batched, would bleed across member carry "
                        "planes)", s, field=r.name,
                        offset=(r.di, r.dj, r.dk))
                if r.name in later[ci]:
                    bad(f"marching-carry read of {r.name!r}, which a later "
                        "computation overwrites — the interleaved march's "
                        "carry already holds the updated level, not the "
                        "pre-sweep value reference semantics require", s,
                        field=r.name, offset=(r.di, r.dj, r.dk))
            elif r.dk != 0:
                bad(f"K read of {r.name!r} at {r.dk:+d} reaches beyond the "
                    "marching-previous level: the K-blocked schedule "
                    "carries exactly one level across block boundaries", s,
                    field=r.name, offset=(r.di, r.dj, r.dk))
    return out


def check_races(program) -> list[Violation]:
    """Run intra-kernel race detection over every node of a program."""
    out: list[Violation] = []
    nk = program.dom.nk
    for node in program.all_nodes():
        st = node.stencil
        expandable = expandable_temps(st)
        temps = {s.target for c in st.computations for s in c.statements
                 if s.target not in st.fields}
        written_so_far: dict[str, int] = {}
        for idx, (ci, comp, s) in enumerate(iter_statements(st)):
            for r in expr_reads(s.value):
                if (r.di, r.dj) == (0, 0):
                    continue
                if r.name in st.fields:
                    if r.name in written_so_far:
                        out.append(Violation(
                            "race",
                            f"reads {r.name!r} at horizontal offset "
                            f"{(r.di, r.dj)} after an earlier statement in "
                            "the same kernel wrote it — neighboring points "
                            "race on old vs. new values in one parallel "
                            "sweep",
                            program=program.name, node=node.label,
                            stencil=st.name, statement=repr(s),
                            field=r.name, offset=(r.di, r.dj, r.dk),
                            loc=s.loc))
                elif r.name in temps and r.name not in expandable:
                    out.append(Violation(
                        "race",
                        f"reads temporary {r.name!r} at horizontal offset "
                        f"{(r.di, r.dj)} but its definition cannot be "
                        "inlined at that offset (multiple/partial/"
                        "region-restricted/sequential definitions or a "
                        "level search)",
                        program=program.name, node=node.label,
                        stencil=st.name, statement=repr(s),
                        field=r.name, offset=(r.di, r.dj, r.dk), loc=s.loc))
            written_so_far.setdefault(s.target, idx)
        if node.stencil.is_vertical_solver() and \
                _node_schedule_requests_kblock(node, nk):
            out.extend(_check_marching(st, program=program.name,
                                       node=node.label))
    return out
