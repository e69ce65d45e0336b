"""Independent IR walkers shared by the three verifier analyses.

Everything here re-derives facts from the raw expression trees and
statement lists — deliberately *not* reusing ``Stencil.extents()``,
``accesses()`` folding, ``can_otf_fuse``/``can_subgraph_fuse`` or
``solver_k_blockable``: the whole point of the verifier is to catch bugs in
those pass-side predicates, so it must not share their code.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

from ..stencil.ir import (
    Assign,
    Computation,
    Direction,
    Expr,
    FieldAccess,
    FoundLevel,
    Interval,
    LevelSearch,
    Stencil,
)


@dataclasses.dataclass(frozen=True)
class Read:
    """One field read found by the independent expression walker.

    ``absolute_k`` marks reads whose vertical position is an absolute level
    (a :class:`LevelSearch` coordinate column or a :class:`FoundLevel`
    access), not an offset from the iteration point — K-bounds rules differ
    for those.  ``search`` points at the enclosing ``LevelSearch`` (if any).
    """

    name: str
    di: int
    dj: int
    dk: int
    absolute_k: bool = False
    search: LevelSearch | None = None

    @property
    def horizontal(self) -> tuple[int, int]:
        return (self.di, self.dj)


def expr_reads(e: Expr, search: LevelSearch | None = None) -> Iterator[Read]:
    """Yield every field read of ``e``, including search coordinates and
    found-level accesses (which ``Expr.accesses()`` folds to zero-K)."""
    if isinstance(e, FieldAccess):
        di, dj, dk = e.offset
        yield Read(e.name, di, dj, dk, search=search)
        return
    if isinstance(e, FoundLevel):
        yield Read(e.name, e.di, e.dj, e.dk, absolute_k=True, search=search)
        return
    if isinstance(e, LevelSearch):
        # the search bisects the whole coordinate column [lo, hi)
        yield Read(e.coord, 0, 0, 0, absolute_k=True, search=e)
        yield from expr_reads(e.target, search=e)
        yield from expr_reads(e.body, search=e)
        return
    for c in e.children():
        yield from expr_reads(c, search=search)


def searches_in(e: Expr) -> Iterator[tuple[LevelSearch, int]]:
    """Yield ``(search, nesting_depth)`` for every LevelSearch in ``e``
    (depth > 0 means an illegal nested search)."""
    def walk(x: Expr, depth: int) -> Iterator[tuple[LevelSearch, int]]:
        if isinstance(x, LevelSearch):
            yield (x, depth)
            yield from walk(x.target, depth + 1)
            yield from walk(x.body, depth + 1)
            return
        for c in x.children():
            yield from walk(c, depth)
    yield from walk(e, 0)


def search_found_levels(se: LevelSearch) -> list[FoundLevel]:
    """Distinct FoundLevel accesses of a search body — an independent walk
    (``LevelSearch.found_levels`` raises on malformed nested searches; the
    verifier must diagnose malformed IR, never crash on it)."""
    out: list[FoundLevel] = []

    def walk(e: Expr) -> None:
        if isinstance(e, FoundLevel):
            if e not in out:
                out.append(e)
            return
        for c in e.children():
            walk(c)

    walk(se.body)
    return out


def found_levels_outside_search(e: Expr) -> Iterator[FoundLevel]:
    """FoundLevel accesses not enclosed by any LevelSearch (illegal)."""
    if isinstance(e, FoundLevel):
        yield e
        return
    if isinstance(e, LevelSearch):
        # target is evaluated *outside* the found-level binding
        yield from found_levels_outside_search(e.target)
        return
    for c in e.children():
        yield from found_levels_outside_search(c)


def iter_statements(st: Stencil) -> Iterator[tuple[int, Computation, Assign]]:
    """Statements in execution (textual) order with their computation index."""
    for ci, c in enumerate(st.computations):
        for s in c.statements:
            yield ci, c, s


def resolve_interval(iv: Interval, n: int) -> tuple[int, int]:
    """Independent interval resolution (mirrors the lowering convention:
    ``(base, offset)`` against an ``n``-level column, clamped)."""
    lo = iv.start[0] * n + iv.start[1]
    hi = iv.end[0] * n + iv.end[1]
    return max(0, lo), min(n, hi)


def k_extent(st: Stencil, name: str, nk: int) -> int:
    """Allocated K levels of ``name``: nk+1 for interface fields/temps."""
    return nk + 1 if name in st.interface_fields else nk


def expandable_temps(st: Stencil) -> set[str]:
    """Temporaries whose offset reads a backend can inline OTF-style
    (re-derived independently of the backends' offset-temporary inlining):
    a single region-free full-interval PARALLEL definition, no level search,
    and a field-level expansion that reads only fields the stencil never
    overwrites (reads through other expandable temps fold transitively)."""
    temps = {s.target for c in st.computations for s in c.statements
             if s.target not in st.fields}
    written_fields = {s.target for c in st.computations for s in c.statements
                      if s.target in st.fields}
    n_defs: dict[str, int] = {}
    defs: dict[str, Assign] = {}
    seq_defined: set[str] = set()
    for ci, c, s in iter_statements(st):
        if s.target in temps:
            n_defs[s.target] = n_defs.get(s.target, 0) + 1
            defs[s.target] = s
            if c.direction is not Direction.PARALLEL:
                seq_defined.add(s.target)
    full = Interval()
    memo: dict[str, bool] = {}

    def ok(t: str, stack: frozenset) -> bool:
        # DAG-aware: a temp read twice along different operands (the shape
        # cross-computation CSE creates) is fine; only a def that reaches
        # *itself* is a genuine cycle.  With single defs, reaching any
        # ancestor of the current path implies membership in that cycle, so
        # memoizing the False is sound for every entry path.
        if t in memo:
            return memo[t]
        if t in stack:
            memo[t] = False
            return False
        s = defs.get(t)
        if (s is None or n_defs[t] != 1 or s.region is not None
                or s.interval != full or t in seq_defined):
            memo[t] = False
            return False
        good = True
        for r in expr_reads(s.value):
            if r.search is not None or r.absolute_k:
                good = False
                break
            if r.name in temps:
                if not ok(r.name, stack | {t}):
                    good = False
                    break
            elif r.name in written_fields:
                good = False
                break
        memo[t] = good
        return good

    return {t for t in defs if ok(t, frozenset())}


def stencil_field_reach(st: Stencil) -> dict[str, tuple[int, int]]:
    """Per-*field* horizontal read radius ``(ri, rj)`` with temporary reads
    folded transitively through their definitions — the verifier's own
    version of the transparent extent inference (no shared code with
    ``Stencil.extents``)."""
    temps = {s.target for c in st.computations for s in c.statements
             if s.target not in st.fields}
    # field-level (name, di, dj) reach of each temporary, in statement order
    temp_reach: dict[str, set[tuple[str, int, int]]] = {}
    out: dict[str, list[int]] = {}

    def record(name: str, di: int, dj: int) -> None:
        e = out.setdefault(name, [0, 0])
        e[0] = max(e[0], abs(di))
        e[1] = max(e[1], abs(dj))

    for _, _, s in iter_statements(st):
        reach: set[tuple[str, int, int]] = set()
        for r in expr_reads(s.value):
            if r.name in temp_reach:
                for f, di, dj in temp_reach[r.name]:
                    record(f, r.di + di, r.dj + dj)
                    reach.add((f, r.di + di, r.dj + dj))
            else:
                record(r.name, r.di, r.dj)
                reach.add((r.name, r.di, r.dj))
        if s.target in temps:
            temp_reach[s.target] = temp_reach.get(s.target, set()) | reach
    return {k: (v[0], v[1]) for k, v in out.items() if k not in temps}


def stencil_output_reach(st: Stencil) -> dict[str, dict[str, tuple[int, int]]]:
    """Per-*output-field* horizontal read radius: ``{w: {f: (ri, rj)}}``,
    temporary reads folded transitively as in :func:`stencil_field_reach`.

    The halo dataflow needs the per-output split: a fused kernel inherits
    the widest member extent, but statements whose targets nothing
    downstream observes beyond the interior (a ghost-band write of a final
    output, say) only demand their reads valid at the *target's* required
    radius — charging every read the full node extent would flag reads
    that feed dead ghost writes."""
    temps = {s.target for c in st.computations for s in c.statements
             if s.target not in st.fields}
    temp_reach: dict[str, set[tuple[str, int, int]]] = {}
    out: dict[str, dict[str, list[int]]] = {}

    for _, _, s in iter_statements(st):
        reach: set[tuple[str, int, int]] = set()
        for r in expr_reads(s.value):
            if r.name in temp_reach:
                for f, di, dj in temp_reach[r.name]:
                    reach.add((f, r.di + di, r.dj + dj))
            else:
                reach.add((r.name, r.di, r.dj))
        if s.target in temps:
            temp_reach[s.target] = temp_reach.get(s.target, set()) | reach
        else:
            per = out.setdefault(s.target, {})
            for f, di, dj in reach:
                e = per.setdefault(f, [0, 0])
                e[0] = max(e[0], abs(di))
                e[1] = max(e[1], abs(dj))
    return {w: {f: (v[0], v[1]) for f, v in per.items() if f not in temps}
            for w, per in out.items()}
