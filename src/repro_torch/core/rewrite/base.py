"""Rewrite-engine foundation: rules, matches, contexts, reports.

The pass manager (:mod:`repro_torch.core.passes`) used to be four hard-coded
monolithic passes.  This package re-expresses it as a **pattern-based
rewrite engine** in the DaCe-transformation / Devito-rewrite mold:

 * a :class:`RewriteRule` carries ``match(program, node, ctx) -> Match |
   None``, ``apply(program, match, ctx)`` and a cost-model ``gate`` — the
   same accept-only-modeled-wins discipline ``greedy_fuse`` always had;
 * the fixpoint driver (:mod:`repro_torch.core.rewrite.driver`) scans rules over
   nodes in deterministic program order, applies the first gated match and
   repeats until quiescent, recording one :class:`RewriteTraceEntry` per
   application so the static verifier can attribute a violation to the
   individual rule application that introduced it;
 * pipelines (:mod:`repro_torch.core.rewrite.pipeline`) assemble rules into the
   named ``opt_level`` presets, with per-stage :class:`PassStats` and
   per-rule counts in the :class:`PipelineReport`.

The four legacy passes are rules on this engine (aggregate rules that run
their existing whole-program logic — bit-preserving by construction); the
``opt_level=4`` stencil rewrites (cross-computation CSE, stencil-combine,
recompute-vs-exchange) are genuine match/apply/gate pattern rules.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from ..graph import Node, State, StencilProgram
from ..hardware import Hardware, resolve_hardware

PassFn = Callable[[StencilProgram, "PassContext"], int]


@dataclasses.dataclass
class PassContext:
    """Everything a rule may consult: the compilation target, the ensemble
    width the program will be batched over (launch-overhead amortization in
    the schedule tuner's cost model) and the persistent tuning cache
    (``None`` → the process default)."""

    backend: str = "cuda"
    hardware: Hardware | str | None = None
    cache: object | None = None
    n_members: int = 1
    #: inner chunk width of a hybrid member-chunked lowering (0 = unchunked);
    #: the schedule tuner prices C-member-wide VMEM blocks when set
    member_chunk: int = 0

    def hw(self) -> Hardware:
        return resolve_hardware(self.hardware)


@dataclasses.dataclass
class PassStats:
    """Per-stage statistics of one pipeline run (one entry per stage in
    :attr:`PipelineReport.passes`; for fixpoint stages ``rewrites`` counts
    individual rule applications)."""

    name: str
    rewrites: int
    seconds: float
    #: wall time of the post-stage/post-application verifier runs (0 when
    #: verification is off)
    verify_seconds: float = 0.0
    #: violations the verifier attributed to this stage (always 0 on a
    #: successful pipeline — violations raise; kept for bench reporting)
    verify_violations: int = 0


@dataclasses.dataclass(frozen=True)
class RewriteTraceEntry:
    """One rule application, in pipeline order.

    ``seq`` numbers applications across the whole pipeline run; the static
    verifier's post-application check uses ``"{stage}/{rule}#{seq}"`` as the
    violation's ``pass_name``, so a diagnostic points at the *individual*
    application that broke the invariant, not just the pass."""

    seq: int
    rule: str
    stage: str
    state: str
    nodes: tuple[str, ...]
    detail: str = ""

    @property
    def attribution(self) -> str:
        return f"{self.stage}/{self.rule}#{self.seq}"


@dataclasses.dataclass
class PipelineReport:
    """Observable result of one :func:`~repro_torch.core.passes.optimize_program`
    run: per-stage stats (``passes``), per-rule application counts
    (``rules``) and the full rewrite trace."""

    opt_level: int
    backend: str
    hardware: str
    passes: list[PassStats] = dataclasses.field(default_factory=list)
    kernels_before: int = 0
    kernels_after: int = 0
    hbm_bytes_before: int = 0
    hbm_bytes_after: int = 0
    #: effective verification mode ("off" | "passes" | "full") and the wall
    #: time spent verifying the *input* program (per-stage times live in
    #: :class:`PassStats`)
    verify_mode: str = "off"
    input_verify_seconds: float = 0.0
    #: per-rule application counts across all stages
    rules: dict[str, int] = dataclasses.field(default_factory=dict)
    #: one entry per rule application, in order
    rewrite_trace: list[RewriteTraceEntry] = dataclasses.field(
        default_factory=list)
    #: pipeline name when an explicit Pipeline drove the run ("" for the
    #: opt_level presets)
    pipeline: str = ""
    #: nodes whose schedule K-blocks a vertical solver that the CUDA
    #: backend's K4 refused for its carry and copy tables, run whole-column
    #: on K2 instead (set by ``compile_program``)
    kblocked_on_column: int = 0

    @property
    def total_rewrites(self) -> int:
        return sum(p.rewrites for p in self.passes)

    @property
    def total_seconds(self) -> float:
        return sum(p.seconds for p in self.passes)

    def summary(self) -> str:
        lines = [f"opt_level={self.opt_level} [{self.backend}/{self.hardware}]"
                 f": kernels {self.kernels_before} -> {self.kernels_after}, "
                 f"modeled HBM bytes {self.hbm_bytes_before} -> "
                 f"{self.hbm_bytes_after}"]
        for p in self.passes:
            lines.append(f"  {p.name:20s} rewrites={p.rewrites:4d} "
                         f"{p.seconds * 1e3:8.2f} ms")
        if self.verify_mode != "off":
            lines.append(f"  verifier ({self.verify_mode}): 0 violations, "
                         f"{self.total_verify_seconds * 1e3:.2f} ms total")
        if self.kblocked_on_column:
            lines.append(f"  K-blocked solvers on K2 (K4's tables full): "
                         f"{self.kblocked_on_column}")
        return "\n".join(lines)

    @property
    def total_verify_seconds(self) -> float:
        return self.input_verify_seconds + \
            sum(p.verify_seconds for p in self.passes)

    @property
    def total_verify_violations(self) -> int:
        return sum(p.verify_violations for p in self.passes)

    def as_dict(self) -> dict:
        return {
            "opt_level": self.opt_level,
            "backend": self.backend,
            "hardware": self.hardware,
            "kernels_before": self.kernels_before,
            "kernels_after": self.kernels_after,
            "hbm_bytes_before": self.hbm_bytes_before,
            "hbm_bytes_after": self.hbm_bytes_after,
            "verify_mode": self.verify_mode,
            "input_verify_seconds": self.input_verify_seconds,
            "passes": [dataclasses.asdict(p) for p in self.passes],
            "rules": dict(self.rules),
            "rewrite_trace": [dataclasses.asdict(t)
                              for t in self.rewrite_trace],
            "kblocked_on_column": self.kblocked_on_column,
        }


@dataclasses.dataclass
class Match:
    """A site one rule application would rewrite.

    ``nodes`` are the graph nodes the rewrite touches (in ``state``);
    ``payload`` carries rule-private match data from :meth:`RewriteRule.
    match` to :meth:`RewriteRule.apply` (an expression, a computation
    index, …) so apply never re-searches."""

    rule: str
    state: State
    nodes: tuple[Node, ...]
    detail: str = ""
    payload: Any = None


class RewriteRule:
    """One declarative graph/IR rewrite.

    Pattern rules implement the protocol proper:

     * ``match(program, node, ctx)`` — return a :class:`Match` anchored at
       ``node`` (or ``None``);
     * ``gate(program, match, ctx)`` — the cost-model acceptance check; the
       driver only applies gated matches.  Every gate must enforce a
       *monotone measure* (modeled cost, flop count, computation count …
       strictly improving) — that is what makes the fixpoint driver
       terminate without an iteration budget;
     * ``apply(program, match, ctx)`` — perform the rewrite in place and
       return the program.

    Aggregate rules (the four legacy passes) instead override :meth:`run`
    with their existing whole-program logic; the driver runs them once per
    stage.  Both kinds share the registry, the per-rule stats and the
    rewrite trace.
    """

    #: registry name; also the per-rule key in ``PipelineReport.rules``
    name: str = "rewrite_rule"

    def match(self, program: StencilProgram, node: Node,
              ctx: PassContext) -> Match | None:
        return None

    def gate(self, program: StencilProgram, match: Match,
             ctx: PassContext) -> bool:
        return True

    def apply(self, program: StencilProgram, match: Match,
              ctx: PassContext) -> StencilProgram:
        raise NotImplementedError

    # -- aggregate interface -------------------------------------------------
    #: True when ``run`` implements the whole rewrite (legacy passes);
    #: pattern rules leave this False and are driven by the fixpoint loop
    aggregate: bool = False

    def run(self, program: StencilProgram, ctx: PassContext) -> int:
        """Drive *this rule alone* to fixpoint; returns #applications.
        Convenience for callers outside a pipeline (and the default body of
        aggregate rules that are really one-shot)."""
        from .driver import run_fixpoint

        return run_fixpoint(program, (self,), ctx)

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class FunctionRule(RewriteRule):
    """Adapter for legacy ``fn(program, ctx) -> n_rewrites`` passes — the
    ``register_pass`` compatibility path."""

    aggregate = True

    def __init__(self, name: str, fn: PassFn):
        self.name = name
        self.fn = fn

    def run(self, program: StencilProgram, ctx: PassContext) -> int:
        return self.fn(program, ctx)


# ---------------------------------------------------------------------------
# Rule registry
# ---------------------------------------------------------------------------

_RULES: dict[str, RewriteRule] = {}


def register_rule(rule: RewriteRule, *, overwrite: bool = False) -> RewriteRule:
    """Register a rule instance under ``rule.name`` (usable by name in
    ``optimize_program(passes=...)`` and custom pipelines)."""
    if rule.name in _RULES and not overwrite:
        raise ValueError(f"rewrite rule {rule.name!r} already registered")
    _RULES[rule.name] = rule
    return rule


def available_rules() -> list[str]:
    return sorted(_RULES)


def get_rule(name: str) -> RewriteRule:
    try:
        return _RULES[name]
    except KeyError:
        raise KeyError(f"unknown pass {name!r}; registered: "
                       f"{', '.join(available_rules())}") from None


def timed(fn, *args):
    """(result, seconds) of one call — shared stats helper."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0
