"""Stencil program graph — the SDFG-lite data-centric IR (paper §III-B).

A :class:`StencilProgram` is a state machine: a list of :class:`State`s
executed in order, each holding stencil nodes whose data movement is explicit
(every node declares the program fields it reads/writes and at which halo
extents).  Transient fields (paper's removable containers) are marked so
transformations can prune or localize them.

Nodes store stencils already *renamed into program-field namespace*, which
makes graph transformations (fusion, inlining) direct IR rewrites.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Mapping

import torch

from .stencil.domain import DomainSpec
from .stencil.schedule import Schedule
from .stencil.ir import (Assign, Computation, Expr, FieldAccess, FoundLevel,
                         LevelSearch, ParamRef, Stencil)


def rename_stencil(st: Stencil, field_map: Mapping[str, str],
                   param_map: Mapping[str, str] | None = None,
                   temp_prefix: str = "") -> Stencil:
    """Rename fields/params/temporaries of a stencil (pure)."""
    param_map = dict(param_map or {})
    tmap = {t: f"{temp_prefix}{t}" for t in st.temporaries()} if temp_prefix else {}

    def mapname(n: str) -> str:
        if n in field_map:
            return field_map[n]
        if n in tmap:
            return tmap[n]
        return n

    def map_expr(e: Expr) -> Expr:
        if isinstance(e, FieldAccess):
            return FieldAccess(mapname(e.name), e.offset)
        if isinstance(e, ParamRef):
            return ParamRef(param_map.get(e.name, e.name))
        if isinstance(e, LevelSearch):
            # the coordinate and every level-found access carry field names
            # outside the FieldAccess tree — they rename too, or fused /
            # program-renamed searches would walk the wrong columns
            return LevelSearch(mapname(e.coord), map_expr(e.target),
                               map_expr(e.body), e.lo, e.hi)
        if isinstance(e, FoundLevel):
            return FoundLevel(mapname(e.name), e.dk, e.di, e.dj)
        return e.map_children(map_expr)

    comps = tuple(
        Computation(c.direction, tuple(
            Assign(mapname(s.target), map_expr(s.value), s.interval, s.region,
                   loc=s.loc)
            for s in c.statements))
        for c in st.computations)
    return Stencil(
        name=st.name,
        computations=comps,
        fields=tuple(mapname(f) for f in st.fields),
        outputs=tuple(mapname(o) for o in st.outputs),
        params=tuple(param_map.get(p, p) for p in st.params),
        interface_fields=tuple(mapname(f) for f in st.interface_fields),
    )


@dataclasses.dataclass
class FieldDecl:
    name: str
    dtype: Any = torch.float32
    transient: bool = False  # removable container (paper Fig. 4)
    interface: bool = False  # K-interface field: nk+1 allocated levels


@dataclasses.dataclass
class Node:
    """A stencil invocation; ``stencil`` uses program field names."""

    label: str          # unique instance label, e.g. "fvt.flux_x#3"
    stencil: Stencil    # renamed into program namespace
    extend: tuple[int, int] = (0, 0)
    schedule: Schedule | None = None
    # params bound to program-level parameter names happen via rename

    @property
    def base_name(self) -> str:
        """Motif label used by transfer tuning (paper §VI-B: 'stencils in FV3
        are named; a configuration is sufficiently described by labels')."""
        return self.stencil.name

    def reads(self) -> list[str]:
        return self.stencil.read_fields()

    def writes(self) -> list[str]:
        return [w for w in self.stencil.written() if w in self.stencil.fields]


@dataclasses.dataclass
class State:
    name: str
    nodes: list[Node] = dataclasses.field(default_factory=list)


class StencilProgram:
    def __init__(self, name: str, dom: DomainSpec):
        self.name = name
        self.dom = dom
        self.states: list[State] = [State("s0")]
        self.fields: dict[str, FieldDecl] = {}
        self.params: list[str] = []
        self._counter = 0
        #: set by :meth:`propagate_extents`; the halo-sufficiency analysis
        #: only audits writer extents once they have been assigned
        self.extents_propagated = False
        #: redeclared field names (shadowed declares), for the
        #: shadowed-declare lint
        self.redeclared: list[str] = []

    # -- construction --------------------------------------------------------
    def declare(self, name: str, dtype=torch.float32, transient: bool = False,
                interface: bool = False) -> str:
        if name in self.fields and name not in self.redeclared:
            self.redeclared.append(name)
        self.fields[name] = FieldDecl(name, dtype, transient, interface)
        return name

    def new_state(self, name: str | None = None) -> State:
        s = State(name or f"s{len(self.states)}")
        self.states.append(s)
        return s

    def add(self, stencil: Stencil, bindings: Mapping[str, str],
            params: Mapping[str, str] | None = None,
            extend: tuple[int, int] = (0, 0),
            state: State | None = None,
            schedule: Schedule | None = None) -> Node:
        self._counter += 1
        renamed = rename_stencil(stencil, bindings, params,
                                 temp_prefix=f"__t{self._counter}_")
        iface = set(renamed.interface_fields)
        for f in renamed.fields:
            if f not in self.fields:
                raise KeyError(f"field {f!r} not declared in program {self.name}")
            if self.fields[f].interface != (f in iface):
                want = "interface" if f in iface else "center"
                raise ValueError(
                    f"field {f!r}: stencil {stencil.name!r} expects a {want} "
                    f"field but program {self.name!r} declares the opposite "
                    "K staggering")
        for p in renamed.params:
            if p not in self.params:
                self.params.append(p)
        node = Node(label=f"{stencil.name}#{self._counter}", stencil=renamed,
                    extend=extend, schedule=schedule)
        (state or self.states[-1]).nodes.append(node)
        return node

    def copy(self) -> "StencilProgram":
        """Deep-copy the graph (states/nodes/field decls); stencil IR inside
        nodes is copied too, so transformation passes never alias the
        original.  ``dom`` is immutable and shared."""
        q = StencilProgram(self.name, self.dom)
        q.states = copy.deepcopy(self.states)
        q.fields = {k: dataclasses.replace(v) for k, v in self.fields.items()}
        q.params = list(self.params)
        q._counter = self._counter
        q.extents_propagated = self.extents_propagated
        q.redeclared = list(self.redeclared)
        return q

    # -- queries ---------------------------------------------------------------
    def all_nodes(self) -> list[Node]:
        return [n for s in self.states for n in s.nodes]

    def ir_node_count(self) -> int:
        """Total stencil-IR node count of the program (statements +
        expression nodes) — the trace-size proxy the nk sweep and the
        sequential-K acceptance criterion track."""
        return sum(n.stencil.ir_size() for n in self.all_nodes())

    def node_dom(self, node: Node) -> DomainSpec:
        return dataclasses.replace(self.dom, extend=node.extend)

    def consumers(self, state: State, field: str, after: int) -> list[Node]:
        return [n for n in state.nodes[after + 1:] if field in n.reads()]

    def field_dead_after(self, state_idx: int, node_idx: int, field: str) -> bool:
        """True if a transient field is never read after this point."""
        if not self.fields[field].transient:
            return False
        st = self.states[state_idx]
        for n in st.nodes[node_idx + 1:]:
            if field in n.reads():
                return False
        for s in self.states[state_idx + 1:]:
            for n in s.nodes:
                if field in n.reads():
                    return False
        return True

    # -- extent inference (GT4Py's transparent halo/extent analysis) ----------
    def propagate_extents(
            self, seed: Mapping[str, tuple[int, int]] | None = None) -> None:
        """Walk nodes in reverse program order; each node's compute domain is
        extended so every downstream read (at any offset) sees computed data.
        This is the paper's 'buffer sizes ... transparently defined by
        inferring halo regions and extents from usage' (§III-A).

        ``seed`` pre-loads external extent requirements on program outputs —
        fields a *later program* will read at an offset without an
        intervening halo exchange.  The recompute-vs-exchange rewrite uses it
        to widen a producer's compute rim in place of the exchange.
        """
        self.extents_propagated = True
        required: dict[str, tuple[int, int]] = dict(seed or {})
        nodes = [(s, n) for s in self.states for n in s.nodes]
        for state, node in reversed(nodes):
            ei, ej = 0, 0
            for w in node.writes():
                r = required.get(w, (0, 0))
                ei, ej = max(ei, r[0]), max(ej, r[1])
            node.extend = (ei, ej)
            ext = node.stencil.extents()
            for w in node.writes():
                # requirement satisfied by this writer
                required.pop(w, None)
            for f, e in ext.items():
                if f not in self.fields:
                    continue  # stencil temporary
                di = max(abs(e[0]), abs(e[1]))
                dj = max(abs(e[2]), abs(e[3]))
                cur = required.get(f, (0, 0))
                required[f] = (max(cur[0], ei + di), max(cur[1], ej + dj))
            h = self.dom.halo
            if ei + node.stencil.max_halo() > h or ej + node.stencil.max_halo() > h:
                raise ValueError(
                    f"node {node.label}: extent {(ei, ej)} + stencil halo "
                    f"{node.stencil.max_halo()} exceeds allocation halo {h}; "
                    "a halo exchange is required before this node")

    # -- execution ---------------------------------------------------------------
    def compile(self, backend: str = "cuda", *, hardware=None,
                schedule_overrides=None, opt_level: int = 0,
                n_members: int | None = None, batch: str = "vmap",
                verify: str | None = None, device=None) -> Callable:
        """Compile the whole program into one callable
        ``fn(fields: dict, params: dict) -> dict`` (live fields threaded).

        Thin wrapper over :func:`repro_torch.core.backend.compile_program`:
        ``hardware`` names the preset the optimizer tunes for, ``opt_level``
        selects the optimization ladder (:mod:`repro_torch.core.passes`)
        applied to a clone of this program, and ``n_members``/``batch``
        thread the ensemble axis through every node.
        """
        from .backend import compile_program

        return compile_program(self, backend, hardware=hardware,
                               schedule_overrides=schedule_overrides,
                               opt_level=opt_level, n_members=n_members,
                               batch=batch, verify=verify, device=device)

    def __repr__(self):
        lines = [f"program {self.name}: {len(self.all_nodes())} nodes, "
                 f"{len(self.states)} states"]
        for s in self.states:
            lines.append(f" state {s.name}:")
            for n in s.nodes:
                lines.append(f"   {n.label}: reads={n.reads()} writes={n.writes()}")
        return "\n".join(lines)
