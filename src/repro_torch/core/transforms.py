"""Data-centric graph transformations (paper §VI-A, §VI-B, §VI-C.1).

 * :func:`strength_reduce_pow` — the Smagorinsky-diffusion case study:
   ``x ** n`` (small integer) → multiplication chains, ``x ** 0.5`` → sqrt.
 * :func:`otf_fuse` — on-the-fly map fusion: inline a producer stencil into a
   consumer, recomputing the producer at each offset the consumer reads
   (trades memory traffic for recompute).
 * :func:`subgraph_fuse` — subgraph fusion: merge stencils sharing an
   iteration space into one kernel; internal transients become kernel-local.
 * :func:`prune_transients` — remove dead transient writes.

All transforms are *pure graph rewrites*: user code (the stencil definitions)
is never touched, matching the paper's headline claim ("all performance
engineering was accomplished without modifying the user code").
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

from .errors import FusionLegalityError
from .graph import Node, State, StencilProgram
from .stencil.ir import (
    Assign,
    BinOp,
    Computation,
    Const,
    Direction,
    Expr,
    FieldAccess,
    Pow,
    Stencil,
    UnaryOp,
    expr_contains_level_search,
)


# ---------------------------------------------------------------------------
# Strength reduction (paper §VI-C.1)
# ---------------------------------------------------------------------------


def _reduce_pow(e: Expr) -> Expr:
    e = e.map_children(_reduce_pow)
    if not isinstance(e, Pow):
        return e
    base, expo = e.a, e.b
    if isinstance(expo, Const):
        v = expo.value
        if v == 0.5:
            return UnaryOp("sqrt", base)
        if v == -0.5:
            return BinOp("/", Const(1.0), UnaryOp("sqrt", base))
        if isinstance(v, (int, float)) and float(v).is_integer() and 1 <= abs(v) <= 4:
            n = int(abs(v))
            out: Expr = base
            for _ in range(n - 1):
                out = BinOp("*", out, base)
            if v < 0:
                out = BinOp("/", Const(1.0), out)
            return out
    return e


def strength_reduce_pow(stencil: Stencil) -> Stencil:
    comps = tuple(
        Computation(c.direction, tuple(
            Assign(s.target, _reduce_pow(s.value), s.interval, s.region,
                   loc=s.loc)
            for s in c.statements))
        for c in stencil.computations)
    return dataclasses.replace(stencil, computations=comps)


def strength_reduce_program(program: StencilProgram) -> int:
    """Apply pow strength reduction across the program; returns #rewrites."""
    n = 0
    for node in program.all_nodes():
        before = node.stencil.flops()
        node.stencil = strength_reduce_pow(node.stencil)
        if node.stencil.flops() != before:
            n += 1
    return n


# ---------------------------------------------------------------------------
# On-the-fly (OTF) map fusion
# ---------------------------------------------------------------------------


def can_otf_fuse(producer: Node, consumer: Node) -> bool:
    """Producer must be a pure PARALLEL stencil with single full-interval,
    region-free definitions of the fields the consumer reads."""
    if producer.stencil.is_vertical_solver():
        return False
    shared = set(producer.writes()) & set(consumer.reads())
    if not shared:
        return False
    # interface (nk+1) and center (nk) fields never co-tile in K: inlining
    # an interface-extent definition into a center-extent statement (or vice
    # versa) would re-evaluate it over the wrong vertical iteration space
    if shared & set(producer.stencil.interface_fields):
        return False
    if shared & set(consumer.stencil.interface_fields):
        return False
    # a consumer that overwrites a shared field would have its later reads
    # of that field substituted with the *producer's* stale value instead of
    # its own update (f = f*2; h = f+1 must see the doubled f)
    if shared & set(consumer.stencil.written()):
        return False
    for c in producer.stencil.computations:
        for s in c.statements:
            if s.target in shared and (s.region is not None):
                return False
    # every shared field must have exactly one defining statement whose RHS
    # reads only *fields* (a chain through producer temporaries would need
    # transitive inlining — SGF handles those instead), and none of those
    # fields may be overwritten by the consumer: the inlined recompute would
    # otherwise observe the consumer's updated values instead of the inputs
    # the producer originally read (e.g. vorticity inlined into wind_update,
    # which updates u/v in place).
    temps = set(producer.stencil.temporaries())
    cons_written = set(consumer.stencil.written())
    for f in shared:
        defs = [s for c in producer.stencil.computations
                for s in c.statements if s.target == f]
        if len(defs) != 1:
            return False
        if expr_contains_level_search(defs[0].value):
            # a level search walks absolute coordinate levels: replicating
            # it at consumer offsets (the OTF substitution) is not a pure
            # shift — SGF can still merge the pair into one kernel
            return False
        for a in defs[0].value.accesses():
            if a.offset[2] != 0 or a.name in temps:
                return False
            if a.name in cons_written:
                return False
    for c in consumer.stencil.computations:
        for s in c.statements:
            if not expr_contains_level_search(s.value):
                continue
            # the substitution rewrites FieldAccess nodes only; a shared
            # field read as a search coordinate or through at_found would
            # silently keep its pre-fusion meaning
            if shared & {a.name for a in s.value.accesses()}:
                return False
    return True


def otf_fuse(program: StencilProgram, state: State, producer: Node,
             consumer: Node) -> Node:
    """Inline ``producer`` into ``consumer`` (paper's OTF: replicate the
    producer computation for each input offset of the consumer)."""
    assert can_otf_fuse(producer, consumer)
    shared = set(producer.writes()) & set(consumer.reads())
    defs = {s.target: s.value
            for c in producer.stencil.computations
            for s in c.statements if s.target in shared}

    def subst_stmt(stmt: Assign) -> Assign:
        v = stmt.value
        for f, rhs in defs.items():
            try:
                v = v.substitute(f, lambda off, rhs=rhs: rhs.shift(off))
            except FusionLegalityError as e:
                raise e.with_context(stencil=consumer.stencil.name,
                                     statement=repr(stmt), loc=stmt.loc)
        return Assign(stmt.target, v, stmt.interval, stmt.region,
                      loc=stmt.loc)

    new_comps = tuple(
        Computation(c.direction, tuple(subst_stmt(s) for s in c.statements))
        for c in consumer.stencil.computations)
    # recompute field signature over the union, then drop dead inputs
    union = tuple(dict.fromkeys(
        tuple(consumer.stencil.fields) + tuple(producer.stencil.fields)))
    params = tuple(dict.fromkeys(consumer.stencil.params + producer.stencil.params))
    iface = tuple(dict.fromkeys(consumer.stencil.interface_fields
                                + producer.stencil.interface_fields))
    new_stencil = dataclasses.replace(
        consumer.stencil, computations=new_comps, fields=union, params=params,
        interface_fields=iface,
        name=f"{producer.stencil.name}+{consumer.stencil.name}")
    still = set(new_stencil.read_fields()) | \
        {w for w in new_stencil.written() if w in union}
    fields = tuple(f for f in union if f in still)
    new_stencil = dataclasses.replace(new_stencil, fields=fields)
    consumer.stencil = new_stencil
    consumer.label = f"{new_stencil.name}#{consumer.label.split('#')[-1]}"

    # if the producer's outputs are now dead transients, drop the producer
    idx = state.nodes.index(producer)
    sidx = program.states.index(state)
    dead = all(program.field_dead_after(sidx, idx, f) or f in shared
               for f in producer.writes())
    other_readers = False
    for s2 in program.states:
        for n2 in s2.nodes:
            if n2 is producer or n2 is consumer:
                continue
            if set(producer.writes()) & set(n2.reads()):
                other_readers = True
    if (not other_readers
            and all(program.fields[f].transient for f in producer.writes())):
        state.nodes.remove(producer)
    return consumer


# ---------------------------------------------------------------------------
# Subgraph fusion (SGF)
# ---------------------------------------------------------------------------


def can_subgraph_fuse(nodes: list[Node], halo: int | None = None) -> bool:
    if len(nodes) < 2:
        return False
    # members are raised to the max extend (computing extra halo cells is
    # safe: same stencil → same values as the neighbor would exchange),
    # provided the allocation halo still covers reads at that extend
    ei = max(n.extend[0] for n in nodes)
    ej = max(n.extend[1] for n in nodes)
    if halo is not None:
        for n in nodes:
            if max(ei, ej) + n.stencil.max_halo() > halo:
                return False
    # a later node must not read an earlier node's output at a *horizontal*
    # offset (that needs redundant-compute handling → OTF instead)
    written: set[str] = set()
    for n in nodes:
        for c in n.stencil.computations:
            for s in c.statements:
                for a in s.value.accesses():
                    if a.name in written and (a.offset[0] != 0 or a.offset[1] != 0):
                        return False
        written |= set(n.writes())
    return True


def subgraph_fuse(program: StencilProgram, state: State,
                  nodes: list[Node]) -> Node:
    """Merge ``nodes`` (in program order) into a single multi-computation
    stencil; intermediate transients read only inside become kernel-local."""
    assert can_subgraph_fuse(nodes)
    comps: list[Computation] = []
    fields: list[str] = []
    params: list[str] = []
    iface: list[str] = []
    for n in nodes:
        comps.extend(n.stencil.computations)
        for f in n.stencil.fields:
            if f not in fields:
                fields.append(f)
        for p in n.stencil.params:
            if p not in params:
                params.append(p)
        for f in n.stencil.interface_fields:
            if f not in iface:
                iface.append(f)
    name = "&".join(dict.fromkeys(n.stencil.name for n in nodes))
    fused_st = Stencil(name=name, computations=tuple(comps),
                       fields=tuple(fields),
                       outputs=tuple(f for f in fields),
                       params=tuple(params),
                       interface_fields=tuple(iface))

    # internal transients: written by the fused stencil and read nowhere else
    sidx = program.states.index(state)
    last_idx = state.nodes.index(nodes[-1])
    internal = []
    for f in fused_st.written():
        if f in program.fields and program.fields[f].transient:
            if program.field_dead_after(sidx, last_idx, f):
                internal.append(f)
    # internal fields are removed from the signature → they become stencil
    # temporaries, which the kernels keep out of the program's fields
    if internal:
        fused_st = dataclasses.replace(
            fused_st,
            fields=tuple(f for f in fused_st.fields if f not in internal),
            outputs=tuple(f for f in fused_st.outputs if f not in internal))

    first = min(state.nodes.index(n) for n in nodes)
    # members are raised to the max extend (see can_subgraph_fuse: computing
    # extra halo cells reproduces what the neighbor would have exchanged)
    extend = (max(n.extend[0] for n in nodes),
              max(n.extend[1] for n in nodes))
    node = Node(label=f"{name}#f{first}", stencil=fused_st,
                extend=extend, schedule=nodes[0].schedule)
    for n in nodes:
        state.nodes.remove(n)
    state.nodes.insert(first, node)
    return node


# ---------------------------------------------------------------------------
# Transient pruning
# ---------------------------------------------------------------------------


def prune_transients(program: StencilProgram) -> int:
    """Remove nodes whose only writes are never-read transients."""
    removed = 0
    for sidx, state in enumerate(program.states):
        for node in list(state.nodes):
            idx = state.nodes.index(node)
            if node.writes() and all(
                    program.fields[f].transient
                    and program.field_dead_after(sidx, idx, f)
                    for f in node.writes()):
                state.nodes.remove(node)
                removed += 1
    return removed
