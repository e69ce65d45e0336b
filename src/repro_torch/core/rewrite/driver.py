"""Fixpoint driver for pattern rewrite rules.

Deterministic application order: rules in the order listed, nodes in program
order (states in list order, nodes within each state in list order); the
first gated match is applied, then the scan restarts from the first rule —
so a higher-priority rule enabled by a rewrite always fires before a
lower-priority one continues.  The loop ends when a full scan finds no
gated match.

Termination is the responsibility of each rule's cost gate (a strictly
improving monotone measure); :data:`MAX_APPLICATIONS` is a backstop that
turns a non-monotone gate (e.g. two rules that undo each other) into a
loud :class:`RuntimeError` instead of a hang.
"""

from __future__ import annotations

import time
from typing import Sequence

from ..graph import StencilProgram
from .base import Match, PassContext, RewriteRule, RewriteTraceEntry

#: hard cap on rule applications per ``run_fixpoint`` call — far above any
#: legitimate pipeline (the full dycore applies tens of rewrites); hitting
#: it means a gate is not enforcing a monotone measure
MAX_APPLICATIONS = 10_000


def find_match(program: StencilProgram, rules: Sequence[RewriteRule],
               ctx: PassContext) -> Match | None:
    """First gated match in (rule, state, node) scan order, or ``None``."""
    for rule in rules:
        for state in program.states:
            # snapshot: rules may mutate node lists while we probe
            for node in list(state.nodes):
                m = rule.match(program, node, ctx)
                if m is not None and rule.gate(program, m, ctx):
                    return m
    return None


def run_fixpoint(program: StencilProgram, rules: Sequence[RewriteRule],
                 ctx: PassContext, *,
                 stage: str = "", trace: list[RewriteTraceEntry] | None = None,
                 rule_counts: dict[str, int] | None = None,
                 verify=None, verify_seconds: list[float] | None = None,
                 max_applications: int = MAX_APPLICATIONS) -> int:
    """Apply ``rules`` to ``program`` until no gated match remains.

    Mutates ``program`` in place; returns the number of applications.
    ``trace``/``rule_counts`` accumulate :class:`RewriteTraceEntry` records
    and per-rule counts for the pipeline report.  When ``verify`` is given
    (the :func:`repro_torch.core.analysis.verify_program` callable), the program
    is re-verified after *every* application with the trace entry's
    attribution string as ``pass_name`` — a violation therefore names the
    individual rule application that introduced it.
    """
    by_name = {r.name: r for r in rules}
    n = 0
    while True:
        m = find_match(program, rules, ctx)
        if m is None:
            return n
        if n >= max_applications:
            raise RuntimeError(
                f"rewrite fixpoint exceeded {max_applications} applications "
                f"in stage {stage or '<anonymous>'!r} (last match: rule "
                f"{m.rule!r} on {', '.join(nd.label for nd in m.nodes)}); "
                "a rule gate is not enforcing a strictly-improving measure")
        by_name[m.rule].apply(program, m, ctx)
        n += 1
        seq = len(trace) if trace is not None else n - 1
        entry = RewriteTraceEntry(
            seq=seq, rule=m.rule, stage=stage, state=m.state.name,
            nodes=tuple(nd.label for nd in m.nodes), detail=m.detail)
        if trace is not None:
            trace.append(entry)
        if rule_counts is not None:
            rule_counts[m.rule] = rule_counts.get(m.rule, 0) + 1
        if verify is not None:
            t0 = time.perf_counter()
            verify(program, pass_name=entry.attribution,
                   raise_on_violation=True)
            if verify_seconds is not None:
                verify_seconds[0] += time.perf_counter() - t0
