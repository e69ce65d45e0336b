"""opt_level=4 stencil-IR pattern rewrites.

Two rewrites greedy fusion cannot express, both value-preserving by the
same argument that makes fusion value-preserving: every backend lowers a
run of PARALLEL computations by executing their statements *flat, in
order* (the CUDA backend launches one kernel per PARALLEL statement in
order; the plain torch lowering and the column kernel walk computations
sequentially), so rewrites that only re-group statements or name repeated
subexpressions leave the per-point FP operation sequence intact.

 * :class:`StencilCombine` — the xdsl ``stencil-combine`` motif: merge
   adjacent same-direction PARALLEL sibling computations of one stencil
   into a single computation.  After ``greedy_fuse`` builds a fused kernel
   out of N nodes, the fused stencil still carries N computation blocks;
   combining them gives later rewrites (CSE below) one scope to work in
   and shrinks the IR the backends re-traverse.
 * :class:`CrossComputationCSE` — hoist a subexpression recomputed by
   several statements (the shared flux/divergence factors of ``c_sw`` /
   ``d_sw``, duplicated further by OTF inlining) into one stencil
   temporary, read back at the center point.
"""

from __future__ import annotations

import dataclasses

from ..graph import Node, StencilProgram
from ..stencil.ir import (
    Assign,
    BinOp,
    Computation,
    Direction,
    Expr,
    FieldAccess,
    Interval,
    Max,
    Min,
    Pow,
    Stencil,
    UnaryOp,
    Where,
    expr_contains_level_search,
    expr_size,
)
from ..stencil.schedule import heuristic_schedule, vmem_footprint
from .base import Match, PassContext, RewriteRule, register_rule

#: expression kinds worth naming — compound arithmetic, not leaves
_COMPOUND = (BinOp, UnaryOp, Pow, Min, Max, Where)


def expr_flops(e: Expr) -> int:
    """Static FLOP count of one expression — :meth:`Stencil.flops` cost
    table applied to a subtree."""
    total = 0
    if isinstance(e, BinOp):
        total += 1
    elif isinstance(e, (Min, Max, Where)):
        total += 1
    elif isinstance(e, Pow):
        total += 10
    elif isinstance(e, UnaryOp):
        total += {"sqrt": 4, "exp": 8, "log": 8}.get(e.op, 1)
    return total + sum(expr_flops(c) for c in e.children())


def count_occurrences(e: Expr, sub: Expr) -> int:
    """Occurrences of ``sub`` in ``e``, outermost-first (an occurrence's
    interior is not re-scanned — mirrors :func:`replace_subexpr`)."""
    if e == sub:
        return 1
    return sum(count_occurrences(c, sub) for c in e.children())


def replace_subexpr(e: Expr, sub: Expr, repl: Expr) -> Expr:
    """Replace every outermost occurrence of ``sub`` in ``e`` with ``repl``."""
    if e == sub:
        return repl
    return e.map_children(lambda c: replace_subexpr(c, sub, repl))


class StencilCombine(RewriteRule):
    """Merge the first adjacent pair of PARALLEL computations of a stencil
    into one computation (statement order preserved).

    Termination measure: every application strictly decreases the stencil's
    computation count, so the fixpoint is reached when no stencil has two
    adjacent PARALLEL blocks left.
    """

    name = "stencil_combine"

    def match(self, program: StencilProgram, node: Node,
              ctx: PassContext) -> Match | None:
        comps = node.stencil.computations
        for i in range(len(comps) - 1):
            if (comps[i].direction is Direction.PARALLEL
                    and comps[i + 1].direction is Direction.PARALLEL):
                state = next(s for s in program.states if node in s.nodes)
                return Match(rule=self.name, state=state, nodes=(node,),
                             detail=f"computations {i}+{i + 1} of "
                                    f"{node.stencil.name}",
                             payload=i)
        return None

    def apply(self, program: StencilProgram, match: Match,
              ctx: PassContext) -> StencilProgram:
        node = match.nodes[0]
        i = match.payload
        comps = node.stencil.computations
        merged = Computation(Direction.PARALLEL,
                             comps[i].statements + comps[i + 1].statements)
        node.stencil = dataclasses.replace(
            node.stencil,
            computations=comps[:i] + (merged,) + comps[i + 2:])
        return program


def _fresh_temp(st: Stencil) -> str:
    """A stencil-temporary name free in ``st``'s namespace."""
    used = set(st.fields) | set(st.written())
    for c in st.computations:
        for s in c.statements:
            for a in s.value.accesses():
                used.add(a.name)
    n = 0
    while f"__cse{n}" in used:
        n += 1
    return f"__cse{n}"


class CrossComputationCSE(RewriteRule):
    """Hoist a repeated subexpression into a stencil temporary.

    Only full-column, region-free statements of PARALLEL computations with
    center (non-interface) targets are eligible sites — exactly the shape
    of the existing stencil-temporary idiom, so every backend's temp path
    (temporaries of the kernels' field table, plain tensors in torch) lowers the hoisted
    definition, and the replacement read is the trivially-legal
    ``temp[0,0,0]``.  Between the first and last replaced site no statement
    may overwrite a field the subexpression reads (else the occurrences
    denote different values and the rewrite is unsound).

    Termination measure: the gate requires ``(occurrences-1) * flops > 0``
    and each application removes exactly that many FLOPs from the stencil,
    so total program FLOPs strictly decrease.
    """

    name = "cross_cse"

    #: hoisting below this tree size never pays for the temp traffic
    min_size = 3

    def match(self, program: StencilProgram, node: Node,
              ctx: PassContext) -> Match | None:
        st = node.stencil
        # flat statement list with (comp idx, stmt idx) and eligibility
        flat: list[tuple[int, int, Assign, bool]] = []
        for ci, c in enumerate(st.computations):
            for si, s in enumerate(c.statements):
                ok = (c.direction is Direction.PARALLEL
                      and s.region is None
                      and s.interval == Interval()
                      and not st.is_interface(s.target)
                      and not expr_contains_level_search(s.value))
                flat.append((ci, si, s, ok))
        if not any(ok for *_, ok in flat):
            return None

        # enumerate compound subexpressions of eligible statements
        candidates: dict[Expr, list[int]] = {}  # expr -> flat idxs (w/ dups)

        def collect(e: Expr, idx: int) -> None:
            if (isinstance(e, _COMPOUND) and expr_size(e) >= self.min_size
                    and not expr_contains_level_search(e)
                    and e.accesses()):
                candidates.setdefault(e, []).append(idx)
            for c in e.children():
                collect(c, idx)

        for idx, (_, _, s, ok) in enumerate(flat):
            if ok:
                collect(s.value, idx)

        best = None  # (-benefit, first idx, repr) -> (expr, idxs)
        for e, idxs in candidates.items():
            if len(idxs) < 2:
                continue
            benefit = (len(idxs) - 1) * expr_flops(e)
            if benefit <= 0:
                continue
            reads = {a.name for a in e.accesses()}
            # every statement from the first occurrence up to (excluding)
            # the last must leave the read set untouched
            lo, hi = idxs[0], idxs[-1]
            if any(flat[i][2].target in reads for i in range(lo, hi)):
                continue
            key = (-benefit, idxs[0], repr(e))
            if best is None or key < best[0]:
                best = (key, e, tuple(idxs))
        if best is None:
            return None
        _, e, idxs = best
        state = next(s for s in program.states if node in s.nodes)
        return Match(rule=self.name, state=state, nodes=(node,),
                     detail=f"{len(idxs)}x {expr_flops(e)}-flop subexpr in "
                            f"{st.name}",
                     payload=(e, idxs, flat[idxs[0]][:2]))

    def gate(self, program: StencilProgram, match: Match,
             ctx: PassContext) -> bool:
        # benefit > 0 was already established by match(); check the hoisted
        # temp still fits fast memory under the schedule the node will
        # actually lower with
        node = match.nodes[0]
        rewritten = self._rewrite(node.stencil, match)
        hw = ctx.hw()
        shape = program.node_dom(node).shape()
        sched = node.schedule or heuristic_schedule(rewritten, shape, hw=hw)
        return vmem_footprint(rewritten, sched, shape) <= hw.vmem_bytes

    def _rewrite(self, st: Stencil, match: Match) -> Stencil:
        e, idxs, (def_ci, def_si) = match.payload
        temp = _fresh_temp(st)
        read = FieldAccess(temp, (0, 0, 0))
        occ = set(idxs)
        comps: list[Computation] = []
        flat_idx = 0
        for ci, c in enumerate(st.computations):
            stmts: list[Assign] = []
            for si, s in enumerate(c.statements):
                if ci == def_ci and si == def_si:
                    stmts.append(Assign(temp, e, Interval(), loc=s.loc))
                if flat_idx in occ:
                    stmts.append(Assign(s.target,
                                        replace_subexpr(s.value, e, read),
                                        s.interval, s.region, loc=s.loc))
                else:
                    stmts.append(s)
                flat_idx += 1
            comps.append(Computation(c.direction, tuple(stmts)))
        return dataclasses.replace(st, computations=tuple(comps))

    def apply(self, program: StencilProgram, match: Match,
              ctx: PassContext) -> StencilProgram:
        node = match.nodes[0]
        node.stencil = self._rewrite(node.stencil, match)
        return program


register_rule(StencilCombine())
register_rule(CrossComputationCSE())
