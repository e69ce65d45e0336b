"""Pattern-based rewrite engine for stencil programs (paper §V–VI).

Public surface of the redesigned pass-manager API:

 * :class:`RewriteRule` / :class:`Match` — the rewrite protocol
   (``match``/``gate``/``apply``) plus aggregate ``run()`` rules;
 * :func:`register_rule` / :func:`get_rule` / :func:`available_rules` —
   the typed rule registry;
 * :class:`Pipeline` / :class:`Stage` — typed pipelines; ``opt_level``
   presets via :func:`pipeline_for_level` / :data:`OPT_LADDERS`;
 * :func:`optimize_program` — the driver (also re-exported from
   :mod:`repro_torch.core.passes`);
 * :func:`run_fixpoint` — the deterministic fixpoint loop with
   per-application rewrite trace and verifier attribution.

The reference's third level-4 rewrite, recompute-vs-exchange
(``rewrite/distributed.py``), needs the distributed step's exchange
context and comes with it.
"""

from .base import (
    FunctionRule,
    Match,
    PassContext,
    PassStats,
    PipelineReport,
    RewriteRule,
    RewriteTraceEntry,
    available_rules,
    get_rule,
    register_rule,
)
from .driver import MAX_APPLICATIONS, find_match, run_fixpoint
from . import legacy as _legacy  # noqa: F401  (registers the four passes)
from . import stencil_rules as _stencil_rules  # noqa: F401  (opt-4 rules)
from .stencil_rules import CrossComputationCSE, StencilCombine
from .legacy import GreedyFuse, PruneTransients, StrengthReduce, TuneSchedules
from .pipeline import (
    MAX_OPT_LEVEL,
    OPT_LADDERS,
    Pipeline,
    Stage,
    ladder_for,
    optimize_program,
    pipeline_for_level,
)

__all__ = [
    "CrossComputationCSE",
    "FunctionRule",
    "GreedyFuse",
    "MAX_APPLICATIONS",
    "MAX_OPT_LEVEL",
    "Match",
    "OPT_LADDERS",
    "PassContext",
    "PassStats",
    "Pipeline",
    "PipelineReport",
    "PruneTransients",
    "RewriteRule",
    "RewriteTraceEntry",
    "Stage",
    "StencilCombine",
    "StrengthReduce",
    "TuneSchedules",
    "available_rules",
    "find_match",
    "get_rule",
    "ladder_for",
    "optimize_program",
    "pipeline_for_level",
    "register_rule",
    "run_fixpoint",
]
