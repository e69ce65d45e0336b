"""The four original pipeline passes, re-expressed as rewrite rules.

These are *aggregate* rules: each :meth:`run` is the whole-program logic
that lived in ``repro_torch.core.passes`` since the pass manager landed, moved
here verbatim.  They keep their monolithic structure deliberately — the
greedy fusion search already embeds its own cost-gated fixpoint (trial
fusion + revert per candidate), and re-expressing it as single-application
match/apply would re-run the full candidate enumeration per accepted fusion
for no behavioral difference.  The opt-level-4 rewrites
(:mod:`repro_torch.core.rewrite.stencil_rules`) use the genuine pattern protocol.
"""

from __future__ import annotations

from ..graph import Node, State, StencilProgram
from ..hardware import Hardware
from ..stencil.schedule import heuristic_schedule, vmem_footprint
from ..transfer_tuning import otf_candidates, sgf_candidates, state_cost
from ..transforms import (
    can_subgraph_fuse,
    otf_fuse,
    prune_transients,
    strength_reduce_program,
    subgraph_fuse,
)
from .base import PassContext, RewriteRule, register_rule


class PruneTransients(RewriteRule):
    """Remove nodes whose outputs are all dead transient containers."""

    name = "prune_transients"
    aggregate = True

    def run(self, program: StencilProgram, ctx: PassContext) -> int:
        return prune_transients(program)


class StrengthReduce(RewriteRule):
    """Algebraic strength reduction inside every stencil body."""

    name = "strength_reduce"
    aggregate = True

    def run(self, program: StencilProgram, ctx: PassContext) -> int:
        return strength_reduce_program(program)


def _fused_schedule(program: StencilProgram, node: Node, hw: Hardware):
    """The schedule the fused node will actually lower with: its own if one
    survived fusion, else the hardware heuristic (which acceptance assigns,
    so the footprint check below and the emitted kernel always agree)."""
    shape = program.node_dom(node).shape()
    return node.schedule or heuristic_schedule(node.stencil, shape, hw=hw)


def _fused_fits(program: StencilProgram, node: Node, hw: Hardware) -> bool:
    """A fused kernel is feasible only if (a) its compounded read reach plus
    its write extent stays inside the allocation halo (inlined producers
    stack their offsets onto the consumer's), and (b) its working set under
    the schedule it will lower with fits fast memory."""
    if (max(node.extend) + node.stencil.max_halo() > program.dom.halo):
        return False
    shape = program.node_dom(node).shape()
    sched = _fused_schedule(program, node, hw)
    return vmem_footprint(node.stencil, sched, shape) <= hw.vmem_bytes


def _greedy_otf(program: StencilProgram, state: State, hw: Hardware) -> int:
    """Repeatedly inline the most-profitable producer/consumer pair until the
    model stops predicting wins (paper's OTF hierarchy level).

    Trial fusions are reverted cheaply: ``otf_fuse`` mutates only the
    consumer node (stencil/label) and the state's node list, so a shallow
    snapshot suffices — no graph deepcopy per candidate.
    """
    n = 0
    while True:
        before = state_cost(program, state, hw)
        best = None  # (benefit, producer, consumer)
        for prod, cons in otf_candidates(state):
            snapshot = (list(state.nodes), cons.stencil, cons.label)
            fused = otf_fuse(program, state, prod, cons)
            after = state_cost(program, state, hw)
            if (after < before and _fused_fits(program, fused, hw)
                    and (best is None or before - after > best[0])):
                best = (before - after, prod, cons)
            state.nodes, cons.stencil, cons.label = snapshot
        if best is None:
            return n
        fused = otf_fuse(program, state, best[1], best[2])
        fused.schedule = _fused_schedule(program, fused, hw)
        n += 1


def _greedy_sgf(program: StencilProgram, state: State, hw: Hardware,
                max_len: int = 6) -> int:
    """Greedily merge the most-profitable connected run into one kernel until
    no candidate improves the model (paper's SGF hierarchy level).

    ``subgraph_fuse`` never mutates member nodes (it builds a fresh fused
    node), so reverting a trial is just restoring the node list.
    """
    n = 0
    while True:
        before = state_cost(program, state, hw)
        best = None  # (benefit, member nodes)
        for nodes in sgf_candidates(state, max_len=max_len):
            if not can_subgraph_fuse(nodes, halo=program.dom.halo):
                continue
            snapshot = list(state.nodes)
            fused = subgraph_fuse(program, state, list(nodes))
            after = state_cost(program, state, hw)
            if (after < before and _fused_fits(program, fused, hw)
                    and (best is None or before - after > best[0])):
                best = (before - after, list(nodes))
            state.nodes = snapshot
        if best is None:
            return n
        fused = subgraph_fuse(program, state, best[1])
        fused.schedule = _fused_schedule(program, fused, hw)
        n += 1


class GreedyFuse(RewriteRule):
    """Cost-model-guided fusion: OTF first, then SGF on the OTF-optimized
    graph (the paper's transformation hierarchy), per state."""

    name = "greedy_fuse"
    aggregate = True

    def run(self, program: StencilProgram, ctx: PassContext) -> int:
        hw = ctx.hw()
        n = 0
        for state in program.states:
            n += _greedy_otf(program, state, hw)
            n += _greedy_sgf(program, state, hw)
        return n


class TuneSchedules(RewriteRule):
    """Per-motif schedule assignment through the persistent tuning cache:
    each distinct (stencil, domain) is searched once per machine; identical
    motif instances (FVT's repeated chains) share the cached result.

    Every node is (re-)tuned — including fused nodes that carry the
    feasibility heuristic from ``greedy_fuse``.  To pin a schedule against
    the tuner, pass ``schedule_overrides`` to ``compile_program``; those
    override node schedules at lowering time.
    """

    name = "tune_schedules"
    aggregate = True

    def run(self, program: StencilProgram, ctx: PassContext) -> int:
        from ..autotune import tune_stencil

        hw = ctx.hw()
        n = 0
        for node in program.all_nodes():
            dom = program.node_dom(node)
            results = tune_stencil(node.stencil, dom, hw=hw,
                                   backend=ctx.backend,
                                   n_members=ctx.n_members,
                                   member_chunk=ctx.member_chunk,
                                   cache=ctx.cache)
            if results and results[0].cost != float("inf"):
                node.schedule = results[0].schedule
                n += 1
        return n


register_rule(PruneTransients())
register_rule(StrengthReduce())
register_rule(GreedyFuse())
register_rule(TuneSchedules())
