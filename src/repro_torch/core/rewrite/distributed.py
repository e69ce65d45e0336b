"""Recompute-vs-exchange: trade redundant rim compute for exchange rounds.

The distributed acoustic substep exchanges ``delpc`` between ``c_sw`` and
``d_sw`` because the Smagorinsky stencil reads it at a one-cell offset.
The exchange is tiny (one scalar field, a one-cell ring) but still pays
the full fixed round structure of the halo exchanger every substep.  The
alternative production FV3 uses on its C-grid quantities: compute ``delpc``
on a one-cell-wider rim from the *already exchanged* inputs and skip the
exchange — the rim values equal the neighbor's interior values because
they are the same stencil applied to identical (freshly exchanged) inputs,
so the result is bit-identical, not an approximation.  The exception is a
cube corner, where three tiles meet: a tile's diagonal ghost cell there
has no neighbor interior, the exchange fills it from ghost rows as they
were, and the recomputed rim need not equal it, so cells a step reaches
from it may differ.

:class:`RecomputeVsExchange` expresses the trade as a rewrite rule: the
match anchors on the producer whose output needs widening, the gate
compares the modeled cost of the extra rim compute against the modeled
cost of the exchange it replaces, and apply re-runs extent propagation
with the rim requirement seeded (:meth:`StencilProgram.propagate_extents`
``seed=``).  ``fv3.dyncore.make_step_distributed`` drives it at
``opt_level >= 4`` and drops the per-substep exchange when it applied.
"""

from __future__ import annotations

import dataclasses

from ..graph import Node, StencilProgram
from ..transfer_tuning import LAUNCH_OVERHEAD, state_cost
from .base import Match, PassContext, RewriteRule, register_rule


@dataclasses.dataclass(frozen=True)
class ExchangeModel:
    """Modeled cost of the halo exchange a widened rim would replace.

    ``n_rounds`` exchange rounds (each a launch), moving ``ring_bytes``
    total per direction over the inter-device link (the device
    interconnect when the mesh spans devices; ``hw.link_bw == 0`` falls
    back to device-memory bandwidth — the single-process case where
    "links" are memory copies)."""

    n_rounds: int
    ring_bytes: int

    def seconds(self, hw) -> float:
        bw = hw.link_bw or hw.hbm_bw
        return self.n_rounds * LAUNCH_OVERHEAD + self.ring_bytes / bw


class RecomputeVsExchange(RewriteRule):
    """Widen producers' compute rims so a downstream offset read no longer
    needs its own halo exchange.

    Parameterized by ``required`` — the post-program extent requirement the
    skipped exchange would have satisfied (e.g. ``{"delpc": (1, 1)}``) —
    and the :class:`ExchangeModel` of that exchange.  One application
    widens the whole program (extent propagation is global); the fixpoint
    terminates because the match only fires while some producer's extent is
    still below the requirement.
    """

    name = "recompute_vs_exchange"

    def __init__(self, required: dict[str, tuple[int, int]],
                 exchange: ExchangeModel):
        self.required = dict(required)
        self.exchange = exchange

    def _deficit(self, node: Node) -> bool:
        for f in node.writes():
            req = self.required.get(f)
            if req and (node.extend[0] < req[0] or node.extend[1] < req[1]):
                return True
        return False

    def match(self, program: StencilProgram, node: Node,
              ctx: PassContext) -> Match | None:
        if not self._deficit(node):
            return None
        state = next(s for s in program.states if node in s.nodes)
        reqs = ", ".join(f"{f}@{e}" for f, e in sorted(self.required.items()))
        return Match(rule=self.name, state=state, nodes=(node,),
                     detail=f"widen rim for {reqs} in place of "
                            f"{self.exchange.n_rounds}-round exchange")

    def gate(self, program: StencilProgram, match: Match,
             ctx: PassContext) -> bool:
        """Accept only when the modeled extra rim compute is cheaper than
        the modeled exchange — and the wider rim still fits the halo."""
        hw = ctx.hw()
        trial = program.copy()
        try:
            trial.propagate_extents(seed=self.required)
        except ValueError:
            return False  # rim + stencil reach would exceed the allocation
        before = sum(state_cost(program, s, hw) for s in program.states)
        after = sum(state_cost(trial, s, hw) for s in trial.states)
        return after - before < self.exchange.seconds(hw)

    def apply(self, program: StencilProgram, match: Match,
              ctx: PassContext) -> StencilProgram:
        program.propagate_extents(seed=self.required)
        return program


def widen_for_exchange(program: StencilProgram,
                       required: dict[str, tuple[int, int]],
                       exchange: ExchangeModel,
                       ctx: PassContext) -> int:
    """Drive :class:`RecomputeVsExchange` on ``program`` (in place); returns
    the number of applications (0 = exchange stays, the gate declined or
    the extents were already wide enough)."""
    rule = RecomputeVsExchange(required, exchange)
    return rule.run(program, ctx)


# a registry entry for introspection/docs; pipelines construct their own
# parameterized instances via `widen_for_exchange`
register_rule(RecomputeVsExchange({}, ExchangeModel(0, 0)))
