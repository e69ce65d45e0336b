"""Stencil intermediate representation.

The IR mirrors the paper's GT4Py "Optimization IR": a stencil is a list of
*computations* (PARALLEL / FORWARD / BACKWARD), each holding *statements*
restricted to a vertical ``interval`` and optionally predicated on a
``horizontal`` region.  All field accesses carry relative (di, dj, dk)
offsets; buffer extents are inferred, never declared (paper §III-A).

Expressions are a small algebra closed under substitution-with-offset, which
is the primitive that makes on-the-fly (OTF) map fusion a pure IR rewrite
(paper §VI-B): inlining a producer into a consumer access at offset ``o``
shifts every access of the producer expression by ``o``.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Callable, Mapping, Sequence

from ..errors import FusionLegalityError, SourceLocation

Offset = tuple[int, int, int]

# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


class Expr:
    """Base class for stencil expressions (immutable)."""

    # -- operator sugar -----------------------------------------------------
    def _bin(self, op: str, other: Any, swap: bool = False) -> "BinOp":
        other = as_expr(other)
        a, b = (other, self) if swap else (self, other)
        return BinOp(op, a, b)

    def __add__(self, o):  # noqa: D105
        return self._bin("+", o)

    def __radd__(self, o):
        return self._bin("+", o, swap=True)

    def __sub__(self, o):
        return self._bin("-", o)

    def __rsub__(self, o):
        return self._bin("-", o, swap=True)

    def __mul__(self, o):
        return self._bin("*", o)

    def __rmul__(self, o):
        return self._bin("*", o, swap=True)

    def __truediv__(self, o):
        return self._bin("/", o)

    def __rtruediv__(self, o):
        return self._bin("/", o, swap=True)

    def __pow__(self, o):
        return Pow(self, as_expr(o))

    def __rpow__(self, o):
        return Pow(as_expr(o), self)

    def __neg__(self):
        return UnaryOp("neg", self)

    def __lt__(self, o):
        return self._bin("<", o)

    def __le__(self, o):
        return self._bin("<=", o)

    def __gt__(self, o):
        return self._bin(">", o)

    def __ge__(self, o):
        return self._bin(">=", o)

    # ``==`` kept as structural equality for hashing in sets; use eq() helper
    # for elementwise comparison inside stencils.

    # -- analysis ------------------------------------------------------------
    def accesses(self) -> list["FieldAccess"]:
        out: list[FieldAccess] = []
        self._collect(out)
        return out

    def _collect(self, out: list["FieldAccess"]) -> None:
        for c in self.children():
            c._collect(out)

    def children(self) -> Sequence["Expr"]:
        return ()

    def shift(self, off: Offset) -> "Expr":
        """Return this expression with every field access shifted by ``off``."""
        return self.map_children(lambda c: c.shift(off))

    def substitute(self, name: str, fn: Callable[[Offset], "Expr"]) -> "Expr":
        """Replace accesses to field ``name`` via ``fn(offset) -> Expr``."""
        return self.map_children(lambda c: c.substitute(name, fn))

    def map_children(self, f: Callable[["Expr"], "Expr"]) -> "Expr":
        return self


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    value: float | int | bool

    def __repr__(self):
        return f"{self.value}"


@dataclasses.dataclass(frozen=True)
class ParamRef(Expr):
    """Reference to a scalar runtime parameter (e.g. ``dt``)."""

    name: str

    def __repr__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class FieldAccess(Expr):
    name: str
    offset: Offset = (0, 0, 0)

    def _collect(self, out):
        out.append(self)

    def shift(self, off: Offset) -> "FieldAccess":
        o = tuple(a + b for a, b in zip(self.offset, off))
        return FieldAccess(self.name, o)  # type: ignore[arg-type]

    def substitute(self, name, fn):
        if self.name == name:
            return fn(self.offset)
        return self

    def __repr__(self):
        i, j, k = self.offset
        return f"{self.name}[{i},{j},{k}]"


@dataclasses.dataclass(frozen=True)
class BinOp(Expr):
    op: str
    a: Expr
    b: Expr

    def children(self):
        return (self.a, self.b)

    def map_children(self, f):
        return BinOp(self.op, f(self.a), f(self.b))

    def __repr__(self):
        return f"({self.a} {self.op} {self.b})"


@dataclasses.dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # neg, sqrt, abs, exp, log, sin, cos, floor
    a: Expr

    def children(self):
        return (self.a,)

    def map_children(self, f):
        return UnaryOp(self.op, f(self.a))

    def __repr__(self):
        return f"{self.op}({self.a})"


@dataclasses.dataclass(frozen=True)
class Pow(Expr):
    """Kept distinct from BinOp so the Smagorinsky strength-reduction pass
    (paper §VI-C.1) can pattern-match it."""

    a: Expr
    b: Expr

    def children(self):
        return (self.a, self.b)

    def map_children(self, f):
        return Pow(f(self.a), f(self.b))

    def __repr__(self):
        return f"({self.a} ** {self.b})"


@dataclasses.dataclass(frozen=True)
class Where(Expr):
    cond: Expr
    a: Expr
    b: Expr

    def children(self):
        return (self.cond, self.a, self.b)

    def map_children(self, f):
        return Where(f(self.cond), f(self.a), f(self.b))

    def __repr__(self):
        return f"where({self.cond}, {self.a}, {self.b})"


@dataclasses.dataclass(frozen=True)
class Min(Expr):
    a: Expr
    b: Expr

    def children(self):
        return (self.a, self.b)

    def map_children(self, f):
        return Min(f(self.a), f(self.b))


@dataclasses.dataclass(frozen=True)
class Max(Expr):
    a: Expr
    b: Expr

    def children(self):
        return (self.a, self.b)

    def map_children(self, f):
        return Max(f(self.a), f(self.b))


@dataclasses.dataclass(frozen=True)
class FoundLevel(Expr):
    """Access ``name`` at the K level selected by the *enclosing*
    :class:`LevelSearch`, plus a static offset ``dk`` (horizontal offsets
    stay static as everywhere else in the IR).  Only legal inside a
    ``LevelSearch`` body."""

    name: str
    dk: int = 0
    di: int = 0
    dj: int = 0

    def _collect(self, out):
        # report a zero-K access so halo/extent inference and read-set
        # analysis see the field; the vertical reach is the search's whole
        # column, which the schedule rules handle via has_level_search()
        out.append(FieldAccess(self.name, (self.di, self.dj, 0)))

    def shift(self, off: Offset) -> "FoundLevel":
        di, dj, dk = off
        if dk != 0:
            raise ValueError(
                "cannot K-shift a FoundLevel access: the searched level is "
                "absolute, not relative to the iteration point")
        return FoundLevel(self.name, self.dk, self.di + di, self.dj + dj)

    def substitute(self, name, fn):
        if self.name == name:
            raise FusionLegalityError(
                f"cannot substitute field {name!r} read through a level "
                "search; inline fusion across a LevelSearch is illegal")
        return self

    def __repr__(self):
        h = f",{self.di},{self.dj}" if (self.di or self.dj) else ""
        return f"{self.name}[@found{self.dk:+d}{h}]"


@dataclasses.dataclass(frozen=True)
class LevelSearch(Expr):
    """Bounded monotone K-level search — the DSL's ``index_search`` (the
    sequential-iteration construct production-scale vertical remapping
    needs; GT4Py grew a ``while`` for exactly this loop).

    Over source layers ``s`` in ``[lo, hi)`` (``(base, offset)`` bounds in
    the :class:`Interval` convention, resolved against the *center* level
    count ``nk``), select the bracketing layer of ``target`` in the
    monotonically non-decreasing column ``coord``::

        s* = lo + clamp(#{t in (lo, hi): coord[t] <= target}, 0, hi-lo-1)

    i.e. the largest in-range layer whose lower coordinate does not exceed
    the target, with the first and last layers as catch-alls (ties and
    float drift at the column ends extrapolate linearly instead of falling
    out of every mask).  The expression's value is ``body`` with every
    :class:`FoundLevel` access resolved at ``s*`` — e.g. linear
    interpolation within the bracketing layer.

    Backends lower the search to *real loops* — bisection in the plain
    torch lowering, a marching loop in the CUDA kernels — so the IR
    and trace stay O(1) in ``nk`` instead of the O(nk²) static-offset
    unrolling the construct replaces.
    """

    coord: str
    target: Expr
    body: Expr
    lo: tuple[int, int] = (0, 0)
    hi: tuple[int, int] = (1, 0)

    def children(self):
        return (self.target, self.body)

    def map_children(self, f):
        return LevelSearch(self.coord, f(self.target), f(self.body),
                           self.lo, self.hi)

    def _collect(self, out):
        out.append(FieldAccess(self.coord, (0, 0, 0)))
        self.target._collect(out)
        self.body._collect(out)

    def shift(self, off: Offset) -> "Expr":
        if off == (0, 0, 0):
            return self
        # K shifts are meaningless (the search walks absolute levels) and
        # horizontal shifts are unrepresentable: the coordinate column has
        # no offset slot, so shifting target/body while the search brackets
        # against the unshifted column would silently mix positions.  The
        # fusion/inlining paths all refuse searches before shifting.
        raise ValueError(
            "cannot shift a LevelSearch: the searched coordinate column "
            "cannot carry an offset")

    def substitute(self, name, fn):
        if name == self.coord:
            raise FusionLegalityError(
                f"cannot substitute search coordinate {name!r}; inline "
                "fusion across a LevelSearch is illegal")
        return self.map_children(lambda c: c.substitute(name, fn))

    def resolve_bounds(self, nk: int) -> tuple[int, int]:
        lo = self.lo[0] * nk + self.lo[1]
        hi = self.hi[0] * nk + self.hi[1]
        return max(0, lo), hi

    def found_levels(self) -> list[FoundLevel]:
        """Distinct FoundLevel accesses of the body, in first-use order."""
        out: list[FoundLevel] = []

        def walk(e: Expr) -> None:
            if isinstance(e, FoundLevel) and e not in out:
                out.append(e)
            if isinstance(e, LevelSearch) and e is not self:
                raise ValueError("nested LevelSearch is unsupported")
            for c in e.children():
                walk(c)

        walk(self.body)
        return out

    def __repr__(self):
        return (f"search({self.coord}[{self.lo}:{self.hi}] <= "
                f"{self.target}: {self.body})")


def expr_contains_level_search(e: Expr) -> bool:
    if isinstance(e, (LevelSearch, FoundLevel)):
        return True
    return any(expr_contains_level_search(c) for c in e.children())


def expr_size(e: Expr) -> int:
    """IR node count of an expression tree (LevelSearch counts its target
    and body once — the whole point of the construct is that this stays
    O(1) in nk)."""
    return 1 + sum(expr_size(c) for c in e.children())


def as_expr(v: Any) -> Expr:
    if isinstance(v, Expr):
        return v
    if isinstance(v, (int, float, bool)):
        return Const(v)
    raise TypeError(f"cannot lift {type(v)} into stencil IR")


# convenience functional forms usable inside stencil definitions
def sqrt(x):
    return UnaryOp("sqrt", as_expr(x))


def exp(x):
    return UnaryOp("exp", as_expr(x))


def log(x):
    return UnaryOp("log", as_expr(x))


def absolute(x):
    return UnaryOp("abs", as_expr(x))


def sign(x):
    return UnaryOp("sign", as_expr(x))


def floor(x):
    return UnaryOp("floor", as_expr(x))


def minimum(a, b):
    return Min(as_expr(a), as_expr(b))


def maximum(a, b):
    return Max(as_expr(a), as_expr(b))


def where(c, a, b):
    return Where(as_expr(c), as_expr(a), as_expr(b))


def eq(a, b):
    return BinOp("==", as_expr(a), as_expr(b))


def _search_bound(v: int | None, default: tuple[int, int]) -> tuple[int, int]:
    if v is None:
        return default
    return (1, v) if v < 0 else (0, v)


def _contains_search(e: Expr) -> bool:
    if isinstance(e, LevelSearch):
        return True
    return any(_contains_search(c) for c in e.children())


def index_search(coord: str | FieldAccess, target: Any, body: Any,
                 lo: int | None = None, hi: int | None = None) -> LevelSearch:
    """Functional builder for :class:`LevelSearch`.

    ``coord`` is the field searched along K; ``lo``/``hi`` bound the source
    layers with the :func:`interval` convention (negative = from the
    bottom; defaults cover all ``nk`` layers).  Inside ``body`` use
    :func:`at_found` to read fields at the selected layer.
    """
    if isinstance(coord, FieldAccess):
        if coord.offset != (0, 0, 0):
            raise ValueError("search coordinate must be an unoffset field")
        coord = coord.name
    target, body = as_expr(target), as_expr(body)
    # reject nesting at construction so every backend agrees: the plain
    # lowering would otherwise silently bind outer at_found accesses to the
    # inner search's level while the kernel encoder errors
    if _contains_search(target) or _contains_search(body):
        raise ValueError("nested index_search is unsupported")
    return LevelSearch(coord, target, body,
                       _search_bound(lo, (0, 0)), _search_bound(hi, (1, 0)))


def at_found(field: str | FieldAccess, dk: int = 0) -> FoundLevel:
    """Read ``field`` at the level found by the enclosing search, plus a
    static K offset ``dk`` (``at_found(pe, 1)`` = the layer's upper
    interface)."""
    if isinstance(field, FieldAccess):
        if field.offset[2] != 0:
            raise ValueError("at_found takes its K offset as `dk`")
        return FoundLevel(field.name, dk, field.offset[0], field.offset[1])
    return FoundLevel(field, dk)


# ---------------------------------------------------------------------------
# Statements / computations / stencils
# ---------------------------------------------------------------------------


class Direction(enum.Enum):
    PARALLEL = "parallel"
    FORWARD = "forward"
    BACKWARD = "backward"


PARALLEL = Direction.PARALLEL
FORWARD = Direction.FORWARD
BACKWARD = Direction.BACKWARD


@dataclasses.dataclass(frozen=True)
class Interval:
    """Vertical interval [start, end) with FORTRAN-esque end-relative indices.

    ``start``/``end`` are ``(base, offset)`` where base is 0 (domain top) or
    1 (domain bottom, i.e. K).  ``interval(...)`` == full column.
    """

    start: tuple[int, int] = (0, 0)
    end: tuple[int, int] = (1, 0)

    def resolve(self, nk: int) -> tuple[int, int]:
        lo = self.start[0] * nk + self.start[1]
        hi = self.end[0] * nk + self.end[1]
        return max(0, lo), min(nk, hi)

    def __repr__(self):
        return f"interval[{self.start}:{self.end}]"


def interval(lo: int | None = None, hi: int | None = None) -> Interval:
    """interval() -> full; interval(a, b) with negative = from-bottom."""
    if lo is None and hi is None:
        return Interval()
    start = (1, lo) if (lo is not None and lo < 0) else (0, lo or 0)
    if hi is None:
        end = (1, 0)
    elif hi < 0:
        end = (1, hi)
    else:
        end = (0, hi)
    return Interval(start, end)


@dataclasses.dataclass(frozen=True)
class Region:
    """Horizontal region restriction (paper §IV-B).

    Bounds are (base, offset) pairs per side; base 0 = domain start,
    base 1 = domain end.  ``None`` means unbounded on that side.
    """

    i_lo: tuple[int, int] | None = None
    i_hi: tuple[int, int] | None = None
    j_lo: tuple[int, int] | None = None
    j_hi: tuple[int, int] | None = None

    def resolve(self, ni: int, nj: int) -> tuple[int, int, int, int]:
        def r(b, default):
            if b is None:
                return default
            return b[0] * (ni if b in (self.i_lo, self.i_hi) else ni) + b[1]

        ilo = self.i_lo[0] * ni + self.i_lo[1] if self.i_lo else 0
        ihi = self.i_hi[0] * ni + self.i_hi[1] if self.i_hi else ni
        jlo = self.j_lo[0] * nj + self.j_lo[1] if self.j_lo else 0
        jhi = self.j_hi[0] * nj + self.j_hi[1] if self.j_hi else nj
        return ilo, ihi, jlo, jhi


def region(i: slice | int | None = None, j: slice | int | None = None) -> Region:
    """region(i=slice(0,1)) etc.; ints index a single row/column; negative
    values are end-relative (like the paper's ``region[:, j_start]``)."""

    def side(v):
        if v is None:
            return None, None
        if isinstance(v, int):
            lo = (1, v) if v < 0 else (0, v)
            hi = (1, v + 1) if v + 1 <= 0 else ((1, 0) if v == -1 else (0, v + 1))
            return lo, hi
        lo = None if v.start is None else ((1, v.start) if v.start < 0 else (0, v.start))
        hi = None if v.stop is None else ((1, v.stop) if v.stop < 0 else (0, v.stop))
        return lo, hi

    ilo, ihi = side(i)
    jlo, jhi = side(j)
    return Region(ilo, ihi, jlo, jhi)


@dataclasses.dataclass(frozen=True)
class Assign:
    target: str
    value: Expr
    interval: Interval = dataclasses.field(default_factory=Interval)
    region: Region | None = None
    #: source location of the user statement (frontend-captured); excluded
    #: from equality/repr so stencil fingerprints and motif sharing are
    #: unaffected by where a stencil was defined
    loc: SourceLocation | None = dataclasses.field(
        default=None, compare=False)

    def __repr__(self):
        r = f" @{self.region}" if self.region else ""
        return f"{self.target} = {self.value} {self.interval}{r}"


@dataclasses.dataclass(frozen=True)
class Computation:
    direction: Direction
    statements: tuple[Assign, ...]

    def written(self) -> list[str]:
        seen: list[str] = []
        for s in self.statements:
            if s.target not in seen:
                seen.append(s.target)
        return seen

    def read(self) -> dict[str, set[Offset]]:
        out: dict[str, set[Offset]] = {}
        for s in self.statements:
            for a in s.value.accesses():
                out.setdefault(a.name, set()).add(a.offset)
            if s.region is not None:
                pass
        return out


@dataclasses.dataclass
class Stencil:
    """A named stencil function: computations + field/param signature.

    ``interface_fields`` names the K-interface (vertically staggered)
    quantities among ``fields`` *and* temporaries: they carry ``nk + 1``
    levels instead of ``nk``.  Statements targeting an interface field
    resolve their vertical interval against ``nk + 1`` (so
    ``interval(1, None)`` covers levels ``1..nk`` inclusive), exactly the
    GT4Py staggered-dimension semantics the vertical remap needs.
    """

    name: str
    computations: tuple[Computation, ...]
    fields: tuple[str, ...]  # input and inout fields, in signature order
    outputs: tuple[str, ...]  # subset of fields written (or new temporaries)
    params: tuple[str, ...] = ()
    interface_fields: tuple[str, ...] = ()

    # -- analysis ------------------------------------------------------------
    def written(self) -> list[str]:
        out: list[str] = []
        for c in self.computations:
            for w in c.written():
                if w not in out:
                    out.append(w)
        return out

    def read_fields(self) -> list[str]:
        out: list[str] = []
        written: set[str] = set()
        for c in self.computations:
            for s in c.statements:
                for a in s.value.accesses():
                    # a read of a value written earlier in this stencil is
                    # internal dataflow, not an external read — unless offset
                    # is nonzero horizontally (halo of own output).
                    if a.name not in written or a.offset != (0, 0, 0):
                        if a.name not in out:
                            out.append(a.name)
                written.add(s.target)
        return [f for f in out if f in self.fields]

    def temporaries(self) -> list[str]:
        return [w for w in self.written() if w not in self.fields]

    def extents(self) -> dict[str, tuple[int, int, int, int, int, int]]:
        """Per-field halo extent (ilo,ihi,jlo,jhi,klo,khi) inferred from
        accesses — the paper's transparent buffer-size inference.

        Temporary reads are folded *transitively* through their definitions:
        a read of temporary ``t`` at offset ``o`` reaches every field ``t``'s
        definition touches at ``o`` plus that access's own offset (PPM's
        ``br[-1]`` whose definition reads ``q[1]`` is a ``q[0]`` reach, and
        after fusion compounds can exceed any single direct offset).  Without
        the folding, fused stencils under-report their halo requirement and
        read outside the allocation.
        """
        ext: dict[str, list[int]] = {}
        temps = set(self.temporaries())
        # (source field, field-level offset) pairs per temporary, folded in
        # statement order
        temp_src: dict[str, set[tuple[str, Offset]]] = {}

        def record(name: str, off: Offset) -> None:
            e = ext.setdefault(name, [0, 0, 0, 0, 0, 0])
            di, dj, dk = off
            e[0] = min(e[0], di)
            e[1] = max(e[1], di)
            e[2] = min(e[2], dj)
            e[3] = max(e[3], dj)
            e[4] = min(e[4], dk)
            e[5] = max(e[5], dk)

        for c in self.computations:
            for s in c.statements:
                reach: set[tuple[str, Offset]] = set()
                for a in s.value.accesses():
                    if a.name in temp_src:
                        for f, o in temp_src[a.name]:
                            comp = tuple(x + y for x, y
                                         in zip(a.offset, o))
                            record(f, comp)  # type: ignore[arg-type]
                            reach.add((f, comp))  # type: ignore[arg-type]
                    else:
                        # plain field, or a temp read before its definition
                        record(a.name, a.offset)
                        reach.add((a.name, a.offset))
                if s.target in temps:
                    temp_src[s.target] = temp_src.get(s.target, set()) | reach
        return {k: tuple(v) for k, v in ext.items()}  # type: ignore[return-value]

    def max_halo(self) -> int:
        h = 0
        for e in self.extents().values():
            h = max(h, abs(e[0]), e[1], abs(e[2]), e[3])
        return h

    def has_k_offsets(self) -> bool:
        for e in self.extents().values():
            if e[4] != 0 or e[5] != 0:
                return True
        return False

    def has_level_search(self) -> bool:
        """True if any statement contains a :class:`LevelSearch` — such
        statements read whole coordinate columns, so the stencil only gets
        whole-K blocks (same rule as K offsets / interface fields)."""
        return any(expr_contains_level_search(s.value)
                   for c in self.computations for s in c.statements)

    def count_level_searches(self) -> int:
        n = 0

        def walk(e: Expr) -> None:
            nonlocal n
            if isinstance(e, LevelSearch):
                n += 1
            for c in e.children():
                walk(c)

        for c in self.computations:
            for s in c.statements:
                walk(s.value)
        return n

    def ir_size(self) -> int:
        """Total IR node count (statements + expression nodes) — the
        quantity the sequential-K construct keeps O(1) per statement where
        static-offset unrolling was O(nk) per level."""
        return sum(1 + expr_size(s.value)
                   for c in self.computations for s in c.statements)

    # -- vertical staggering --------------------------------------------------
    def is_interface(self, name: str) -> bool:
        return name in self.interface_fields

    def k_extent_of(self, name: str, nk: int) -> int:
        """Allocated K levels of ``name`` on an nk-level domain."""
        return nk + 1 if name in self.interface_fields else nk

    def has_interface_fields(self) -> bool:
        return bool(self.interface_fields)

    def is_vertical_solver(self) -> bool:
        return any(c.direction is not Direction.PARALLEL for c in self.computations)

    def n_statements(self) -> int:
        return sum(len(c.statements) for c in self.computations)

    def flops(self) -> int:
        """Static FLOP count per grid point (Pow counted via cost table)."""
        total = 0

        def walk(e: Expr) -> None:
            nonlocal total
            if isinstance(e, BinOp):
                total += 1
            elif isinstance(e, (Min, Max, Where)):
                total += 1
            elif isinstance(e, Pow):
                total += 10  # general pow cost before strength reduction
            elif isinstance(e, UnaryOp):
                total += {"sqrt": 4, "exp": 8, "log": 8}.get(e.op, 1)
            elif isinstance(e, LevelSearch):
                # static charge for the search control flow; the
                # nk-dependent marching cost is priced by the perf model
                # (perfmodel.node_flops), which knows the domain
                total += 16
            for c in e.children():
                walk(c)

        for c in self.computations:
            for s in c.statements:
                walk(s.value)
        return total

    def __repr__(self):
        lines = [f"stencil {self.name}({', '.join(self.fields)}):"]
        for c in self.computations:
            lines.append(f"  computation({c.direction.name}):")
            for s in c.statements:
                lines.append(f"    {s}")
        return "\n".join(lines)
