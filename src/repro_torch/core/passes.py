"""The pass-manager surface over :mod:`repro_torch.core.rewrite` (paper
§V–VI).

The optimizer is a pattern-based rewrite engine: rules
(:class:`~repro_torch.core.rewrite.RewriteRule`) in a typed registry,
composed into typed :class:`~repro_torch.core.rewrite.Pipeline` objects and
driven by :func:`~repro_torch.core.rewrite.optimize_program`.  This module
re-exports that surface under the names the reference package's
``repro.core.passes`` gives it.  The reference's deprecated string-based
shims (``register_pass``, ``get_pass``, ``available_passes``) are not
ported: register a :class:`~repro_torch.core.rewrite.FunctionRule` with
:func:`~repro_torch.core.rewrite.register_rule` instead.
"""

from __future__ import annotations

from .rewrite import (  # noqa: F401  (re-exported surface)
    MAX_OPT_LEVEL,
    OPT_LADDERS,
    FunctionRule,
    PassContext,
    PassStats,
    Pipeline,
    PipelineReport,
    available_rules,
    get_rule,
    ladder_for,
    optimize_program,
    register_rule,
)
