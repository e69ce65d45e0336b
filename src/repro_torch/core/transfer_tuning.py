"""Transfer tuning (paper §VI-B — the novel contribution).

Phase 1: divide the program into *cutout* subgraphs (we use states, as the
paper does for FVT's 127 states), exhaustively tune each cutout over fusion
configurations (weakly-connected subsets with ≥2 nodes), and keep the top-M
configurations per transformation as *patterns* — described purely by the
stencil labels involved and the transformation applied ("since stencils in
FV3 are named, a configuration is sufficiently described by a set of labels
of the candidates and which transformations were applied").

Phase 2: scan the target graph for label matches and apply a pattern only
where it also improves the local performance model — with the paper's
pruning: first match per pattern per state, most-improving pattern first.

The scoring objective is pluggable (analytical model and/or wall-clock), the
hierarchy is the paper's: OTF first, then SGF on the OTF-optimized graph.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
from typing import Callable

from .graph import Node, State, StencilProgram
from .hardware import Hardware, resolve_hardware
from .perfmodel import node_bound_seconds
from .transforms import (
    can_otf_fuse,
    can_subgraph_fuse,
    otf_fuse,
    subgraph_fuse,
)

LAUNCH_OVERHEAD = 1.5e-6


@dataclasses.dataclass(frozen=True)
class Pattern:
    kind: str               # "otf" | "sgf"
    labels: tuple[str, ...]  # base stencil names, in dataflow order
    benefit: float           # modeled seconds saved on the source cutout

    def describe(self) -> str:
        return f"{self.kind}({' -> '.join(self.labels)}) Δ={self.benefit * 1e6:.2f}us"

    def to_dict(self) -> dict:
        return {"kind": self.kind, "labels": list(self.labels),
                "benefit": self.benefit}

    @classmethod
    def from_dict(cls, d: dict) -> "Pattern":
        return cls(d["kind"], tuple(d["labels"]), d["benefit"])


def state_cost(program: StencilProgram, state: State,
               hw: Hardware | str | None = None) -> float:
    hw = resolve_hardware(hw)
    return sum(node_bound_seconds(program, n, hw) + LAUNCH_OVERHEAD
               for n in state.nodes)


def _clone_cutout(program: StencilProgram, state: State
                  ) -> tuple[StencilProgram, State]:
    cut = StencilProgram(f"{program.name}/cutout", program.dom)
    cut.fields = dict(program.fields)
    cut.params = list(program.params)
    new_state = State(state.name, [copy.deepcopy(n) for n in state.nodes])
    cut.states = [new_state]
    return cut, new_state


def otf_candidates(state: State) -> list[tuple[Node, Node]]:
    """All (producer, consumer) pairs OTF fusion could inline in ``state``.

    Beyond the pairwise :func:`can_otf_fuse` rules, inlining moves the
    producer's computation to the consumer's position in program order, so
    no intervening node may overwrite either the producer's inputs or the
    shared fields themselves (e.g. Courant numbers computed from the
    pre-update winds must not be recomputed after ``wind_update``).
    """
    out = []
    for i, prod in enumerate(state.nodes):
        for j in range(i + 1, len(state.nodes)):
            cons = state.nodes[j]
            shared = set(prod.writes()) & set(cons.reads())
            if not shared or not can_otf_fuse(prod, cons):
                continue
            def_reads = {a.name for c in prod.stencil.computations
                         for s in c.statements if s.target in shared
                         for a in s.value.accesses()}
            if any((def_reads | shared) & set(mid.writes())
                   for mid in state.nodes[i + 1:j]):
                continue
            out.append((prod, cons))
    return out


def sgf_candidates(state: State, max_len: int = 4) -> list[list[Node]]:
    """Weakly-connected consecutive runs with ≥2 nodes (paper: 'weakly
    connected subgraphs of the state with at least two maps')."""
    out = []
    n = len(state.nodes)
    for lo in range(n):
        for hi in range(lo + 2, min(n, lo + max_len) + 1):
            nodes = state.nodes[lo:hi]
            # weak connectivity: consecutive nodes share a field
            connected = all(
                (set(a.reads()) | set(a.writes())) &
                (set(b.reads()) | set(b.writes()))
                for a, b in zip(nodes, nodes[1:]))
            if connected and can_subgraph_fuse(nodes):
                out.append(nodes)
    return out


@dataclasses.dataclass
class Phase1Result:
    patterns: list[Pattern]
    n_configs: int          # total configurations evaluated (paper: 1,272)
    from_cache: bool = False


def _cutout_key(program: StencilProgram, kind: str, top_m: int,
                hw: Hardware) -> str:
    """Cache key for a phase-1 search: the cutout graphs are fully described
    by their node stencil fingerprints in program order plus the domain."""
    from .backend.cache import COST_MODEL_VERSION, make_key, stencil_fingerprint

    states = [[stencil_fingerprint(n.stencil) for n in s.nodes]
              for s in program.states]
    return make_key("tune_cutouts", COST_MODEL_VERSION, states, program.dom,
                    kind, top_m, hw.name)


def tune_cutouts(program: StencilProgram, *, kind: str, top_m: int = 2,
                 hw: Hardware | str | None = None,
                 measure: Callable[[StencilProgram], float] | None = None,
                 cache=None) -> Phase1Result:
    """Phase 1 over every state of ``program`` for one transformation kind.

    Model-driven searches are memoized in the persistent tuning cache (the
    paper's 1,272-configuration FVT sweep runs once per machine, not once
    per process); wall-clock objectives are never cached.
    """
    from .backend.cache import default_cache

    hw = resolve_hardware(hw)
    use_cache = None if measure is not None else (
        cache if cache is not None else default_cache())
    key = None
    if use_cache is not None:
        key = _cutout_key(program, kind, top_m, hw)
        hit = use_cache.get(key)
        if hit is not None:
            return Phase1Result([Pattern.from_dict(p) for p in hit["patterns"]],
                                hit["n_configs"], from_cache=True)
    patterns: list[Pattern] = []
    n_configs = 0
    for state in program.states:
        base_cost = state_cost(program, state, hw)
        scored: list[Pattern] = []
        if kind == "otf":
            for prod, cons in otf_candidates(state):
                n_configs += 1
                cut, cst = _clone_cutout(program, state)
                p2 = next(n for n in cst.nodes if n.label == prod.label)
                c2 = next(n for n in cst.nodes if n.label == cons.label)
                otf_fuse(cut, cst, p2, c2)
                cost = (measure(cut) if measure else state_cost(cut, cst, hw))
                if cost < base_cost:
                    scored.append(Pattern("otf",
                                          (prod.base_name, cons.base_name),
                                          base_cost - cost))
        elif kind == "sgf":
            for nodes in sgf_candidates(state):
                n_configs += 1
                cut, cst = _clone_cutout(program, state)
                members = [n for n in cst.nodes
                           if n.label in {m.label for m in nodes}]
                subgraph_fuse(cut, cst, members)
                cost = (measure(cut) if measure else state_cost(cut, cst, hw))
                if cost < base_cost:
                    scored.append(Pattern("sgf",
                                          tuple(n.base_name for n in nodes),
                                          base_cost - cost))
        else:
            raise ValueError(kind)
        scored.sort(key=lambda p: -p.benefit)
        patterns.extend(scored[:top_m])
    # dedupe by label signature, keep best benefit
    best: dict[tuple, Pattern] = {}
    for p in patterns:
        k = (p.kind, p.labels)
        if k not in best or p.benefit > best[k].benefit:
            best[k] = p
    result = Phase1Result(sorted(best.values(), key=lambda p: -p.benefit),
                          n_configs)
    if use_cache is not None:
        use_cache.put(key, {"patterns": [p.to_dict() for p in result.patterns],
                            "n_configs": result.n_configs})
    return result


@dataclasses.dataclass
class TransferResult:
    applied: list[tuple[str, str]]  # (state name, pattern description)
    n_otf: int
    n_sgf: int


def transfer(program: StencilProgram, patterns: list[Pattern], *,
             hw: Hardware | str | None = None) -> TransferResult:
    """Phase 2: apply matching patterns across the whole program where the
    local model improves (paper: 20 OTF + 583 SGF transferred to FV3)."""
    hw = resolve_hardware(hw)
    applied: list[tuple[str, str]] = []
    n_otf = n_sgf = 0
    for state in program.states:
        for pat in patterns:  # most-improving first (sorted by phase 1)
            # first match per pattern per state (paper's pruning)
            match = _find_match(state, pat)
            if match is None:
                continue
            before = state_cost(program, state, hw)
            snapshot = copy.deepcopy(state.nodes)
            try:
                if pat.kind == "otf":
                    otf_fuse(program, state, match[0], match[1])
                else:
                    subgraph_fuse(program, state, list(match))
            except AssertionError:
                state.nodes = snapshot
                continue
            after = state_cost(program, state, hw)
            if after < before:
                applied.append((state.name, pat.describe()))
                if pat.kind == "otf":
                    n_otf += 1
                else:
                    n_sgf += 1
            else:
                state.nodes = snapshot  # revert: no local improvement
    return TransferResult(applied, n_otf, n_sgf)


def _find_match(state: State, pat: Pattern):
    if pat.kind == "otf":
        for prod, cons in otf_candidates(state):
            if (prod.base_name, cons.base_name) == pat.labels:
                return (prod, cons)
        return None
    L = len(pat.labels)
    for lo in range(len(state.nodes) - L + 1):
        nodes = state.nodes[lo:lo + L]
        if tuple(n.base_name for n in nodes) == pat.labels and \
                can_subgraph_fuse(nodes):
            return tuple(nodes)
    return None


def transfer_tune(source: StencilProgram, target: StencilProgram, *,
                  top_m: int = 2, hw: Hardware | str | None = None,
                  cache=None,
                  ) -> tuple[Phase1Result, Phase1Result, TransferResult]:
    """The paper's full hierarchical pipeline: tune OTF on the source, apply;
    tune SGF on the OTF-optimized source; transfer both to the target."""
    hw = resolve_hardware(hw)
    otf_res = tune_cutouts(source, kind="otf", top_m=top_m, hw=hw, cache=cache)
    transfer(source, otf_res.patterns, hw=hw)      # optimize the source itself
    sgf_res = tune_cutouts(source, kind="sgf", top_m=1, hw=hw, cache=cache)
    result = transfer(target, otf_res.patterns + sgf_res.patterns, hw=hw)
    return otf_res, sgf_res, result
