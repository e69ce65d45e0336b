"""Independent static verifier over the stencil IR and program graph.

Three analyses (paper-adjacent: the MLIR/DaCe idiom of validating the IR
after every transformation), sharing **no code** with the pass-side
legality predicates they audit:

 * :func:`check_wellformed` — declaration/dataflow-order/K-extent/
   LevelSearch structural invariants;
 * :func:`check_races` — intra-kernel write→offset-read races, uninlinable
   offset temporaries, K-blocked marching boundary contract;
 * :func:`check_halo` — transitive read-extent dataflow against declared
   halo width and exchange placement (stale-halo reads).

:func:`verify_program` runs all three; ``compile_program(...,
verify="passes"|"full")`` wires it between optimization passes with
per-pass violation attribution.  :func:`lint_program` adds the advisory
lints (dead writes, unused fields, shadowed declares).
"""

from ..errors import (AnalysisError, FusionLegalityError, SourceLocation,
                      VerificationError, Violation)
from .halo import check_halo
from .lints import check_lints
from .races import check_races
from .verifier import (ANALYSES, VERIFY_MODES, lint_program,
                       resolve_verify_mode, verify_program)
from .wellformed import check_wellformed

__all__ = [
    "ANALYSES",
    "AnalysisError",
    "FusionLegalityError",
    "SourceLocation",
    "VERIFY_MODES",
    "VerificationError",
    "Violation",
    "check_halo",
    "check_lints",
    "check_races",
    "check_wellformed",
    "lint_program",
    "resolve_verify_mode",
    "verify_program",
]
