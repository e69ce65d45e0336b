"""Typed optimization pipelines and the ``opt_level`` presets.

A :class:`Pipeline` is a tuple of :class:`Stage`s; each stage either runs
its rules' whole-program ``run()`` once (aggregate stages — the legacy
passes) or drives them through the pattern fixpoint loop
(:func:`~repro_torch.core.rewrite.driver.run_fixpoint`), with per-application
verification and trace entries.  The ``opt_level=0..4`` ladder is just a
set of named preset pipelines over the rule registry:

 * ``opt_level=0`` — no transformation (the debuggable 1:1 lowering);
 * ``opt_level=1`` — ``prune_transients`` + ``strength_reduce``;
 * ``opt_level=2`` — plus ``greedy_fuse`` (cost-gated OTF + subgraph
   fusion);
 * ``opt_level=3`` — plus ``tune_schedules`` (transfer-tuned schedules via
   the persistent cache);
 * ``opt_level=4`` — plus the pattern rewrites fusion cannot express,
   *before* schedule tuning (they change the stencil bodies tuning prices):
   ``stencil_combine`` then ``cross_cse``.  Both are value-preserving, so
   levels 2–4 all produce bit-identical results.  (The third level-4
   rewrite, recompute-vs-exchange, needs the distributed step's exchange
   context and is driven by ``fv3.dyncore.make_step_distributed``.)
"""

from __future__ import annotations

import dataclasses
import time

from ..graph import StencilProgram
from ..hardware import Hardware, resolve_hardware
from ..perfmodel import program_bytes
from .base import (
    PassContext,
    PipelineReport,
    PassStats,
    RewriteRule,
    get_rule,
)
from .driver import run_fixpoint

#: ladder per opt level; each level's passes appear (in order) in every
#: higher level (paper Table III's cumulative rungs) — level 4 inserts its
#: pattern rewrites before schedule tuning, so containment is subsequence,
#: not prefix
OPT_LADDERS: dict[int, tuple[str, ...]] = {
    0: (),
    1: ("prune_transients", "strength_reduce"),
    2: ("prune_transients", "strength_reduce", "greedy_fuse"),
    3: ("prune_transients", "strength_reduce", "greedy_fuse",
        "tune_schedules"),
    4: ("prune_transients", "strength_reduce", "greedy_fuse",
        "stencil_combine", "cross_cse", "tune_schedules"),
}

MAX_OPT_LEVEL = max(OPT_LADDERS)


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline step: a named group of rules.

    ``fixpoint=True`` drives the rules jointly through the pattern fixpoint
    loop (per-application trace/verify); ``False`` runs each rule's
    ``run()`` once, in order — the right mode for the aggregate legacy
    passes, whose run() embeds its own cost-gated iteration."""

    name: str
    rules: tuple[RewriteRule, ...]
    fixpoint: bool = False


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """An ordered, typed optimization pipeline (replaces the stringly
    ``OPT_LADDERS`` tuples as the driving structure; those remain as the
    preset *names*)."""

    stages: tuple[Stage, ...]
    name: str = ""

    @classmethod
    def from_names(cls, names: tuple[str, ...] | list[str],
                   name: str = "") -> "Pipeline":
        """One stage per registered rule name — pattern rules get fixpoint
        stages, aggregate rules run-once stages."""
        stages = []
        for n in names:
            rule = get_rule(n)
            stages.append(Stage(n, (rule,), fixpoint=not rule.aggregate))
        return cls(tuple(stages), name=name)

    def rule_names(self) -> tuple[str, ...]:
        return tuple(r.name for st in self.stages for r in st.rules)


def pipeline_for_level(opt_level: int) -> Pipeline:
    return Pipeline.from_names(ladder_for(opt_level),
                               name=f"opt{min(opt_level, MAX_OPT_LEVEL)}")


def ladder_for(opt_level: int) -> tuple[str, ...]:
    if opt_level < 0:
        raise ValueError(f"opt_level must be >= 0, got {opt_level}")
    return OPT_LADDERS[min(opt_level, MAX_OPT_LEVEL)]


def optimize_program(program: StencilProgram, *, opt_level: int = 3,
                     backend: str = "cuda",
                     hardware: Hardware | str | None = None,
                     cache=None,
                     passes: tuple[str, ...] | None = None,
                     pipeline: Pipeline | None = None,
                     inplace: bool = False,
                     n_members: int = 1,
                     member_chunk: int = 0,
                     verify: str = "off",
                     ) -> tuple[StencilProgram, PipelineReport]:
    """Run an optimization pipeline over a clone of ``program``; returns
    ``(optimized, report)``.

    The pipeline is selected by precedence: an explicit ``pipeline``
    (typed :class:`Pipeline`), else a ``passes`` tuple of registered rule
    names, else the ``opt_level`` preset.  The clone preserves the caller's
    graph: `compile_program` can be invoked repeatedly at different opt
    levels on the same program object.

    ``verify="passes"``/``"full"`` runs the independent static verifier
    (:mod:`repro_torch.core.analysis`) on the input program and again after every
    stage — and, for fixpoint stages, after every individual rule
    application.  Because the input must be clean before any stage runs, a
    violation found later is attributed to what introduced it: the raised
    :class:`~repro_torch.core.errors.VerificationError` carries ``pass_name`` —
    the bare stage name for aggregate stages, or the rewrite-trace
    attribution ``"{stage}/{rule}#{seq}"`` naming the exact application for
    pattern stages — plus the structured diagnostics; per-stage verifier
    wall time is recorded in the report's :class:`PassStats`.
    """
    do_verify = verify in ("passes", "full")
    if do_verify:
        from ..analysis import verify_program
    elif verify != "off":
        raise ValueError(f"verify={verify!r} invalid; expected "
                         "'off', 'passes' or 'full'")
    hw = resolve_hardware(hardware)
    if pipeline is None:
        if passes is not None:
            pipeline = Pipeline.from_names(tuple(passes))
        else:
            pipeline = pipeline_for_level(opt_level)
    prog = program if inplace else program.copy()
    report = PipelineReport(
        opt_level=opt_level, backend=backend, hardware=hw.name,
        kernels_before=len(prog.all_nodes()),
        hbm_bytes_before=program_bytes(prog), verify_mode=verify,
        pipeline=pipeline.name)
    ctx = PassContext(backend=backend, hardware=hw, cache=cache,
                      n_members=max(1, n_members),
                      member_chunk=max(0, member_chunk))
    if do_verify:
        # input program first: every stage then starts from a verified
        # graph, which is what makes per-stage attribution sound
        t0 = time.perf_counter()
        verify_program(prog, raise_on_violation=True)
        report.input_verify_seconds = time.perf_counter() - t0
    for stage in pipeline.stages:
        t0 = time.perf_counter()
        if stage.fixpoint:
            vsec = [0.0]
            rewrites = run_fixpoint(
                prog, stage.rules, ctx, stage=stage.name,
                trace=report.rewrite_trace, rule_counts=report.rules,
                verify=verify_program if do_verify else None,
                verify_seconds=vsec)
            stats = PassStats(stage.name, rewrites,
                              time.perf_counter() - t0 - vsec[0],
                              verify_seconds=vsec[0])
        else:
            rewrites = 0
            for rule in stage.rules:
                n = rule.run(prog, ctx)
                rewrites += n
                report.rules[rule.name] = report.rules.get(rule.name, 0) + n
            stats = PassStats(stage.name, rewrites, time.perf_counter() - t0)
            if do_verify:
                t1 = time.perf_counter()
                stats.verify_violations = len(
                    verify_program(prog, pass_name=stage.name,
                                   raise_on_violation=True))
                stats.verify_seconds = time.perf_counter() - t1
        report.passes.append(stats)
    report.kernels_after = len(prog.all_nodes())
    report.hbm_bytes_after = program_bytes(prog)
    return prog, report
