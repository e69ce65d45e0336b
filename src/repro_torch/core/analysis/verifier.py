"""Verifier driver: run the three analyses over a program.

``verify_program`` is the single entry point the pass manager and
``compile_program`` call; ``resolve_verify_mode`` implements the
``verify="off"|"passes"|"full"`` knob with its environment defaults
(``REPRO_VERIFY`` overrides; under pytest/CI the default is ``"passes"``).
"""

from __future__ import annotations

import os

from ..errors import VerificationError, Violation
from .halo import check_halo
from .lints import check_lints
from .races import check_races
from .wellformed import check_wellformed

VERIFY_MODES = ("off", "passes", "full")

#: analysis name -> checker, in report order
ANALYSES = {
    "wellformed": check_wellformed,
    "race": check_races,
    "halo": check_halo,
}


def resolve_verify_mode(verify: str | None = None) -> str:
    """Resolve the effective verification mode.

    Explicit ``verify`` wins; else the ``REPRO_VERIFY`` environment
    variable; else ``"passes"`` when running under pytest or CI (cheap
    safety net for every test compile), ``"off"`` otherwise (production
    compiles pay nothing unless asked).
    """
    mode = verify
    if mode is None:
        mode = os.environ.get("REPRO_VERIFY") or None
    if mode is None:
        if os.environ.get("PYTEST_CURRENT_TEST") or os.environ.get("CI"):
            mode = "passes"
        else:
            mode = "off"
    if mode not in VERIFY_MODES:
        raise ValueError(
            f"verify={mode!r} invalid; expected one of {VERIFY_MODES}")
    return mode


def verify_program(program, *, pass_name: str | None = None,
                   raise_on_violation: bool = False) -> list[Violation]:
    """Run well-formedness, race and halo analyses over ``program``.

    Returns the violations (tagged with ``pass_name`` when given — the
    optimization pass being audited); with ``raise_on_violation`` raises a
    :class:`~repro_torch.core.errors.VerificationError` instead of returning a
    non-empty list.
    """
    violations: list[Violation] = []
    for check in ANALYSES.values():
        violations.extend(check(program))
    if pass_name is not None and violations:
        import dataclasses

        violations = [dataclasses.replace(v, pass_name=pass_name)
                      for v in violations]
    if violations and raise_on_violation:
        raise VerificationError(violations, pass_name=pass_name)
    return violations


def lint_program(program) -> list[Violation]:
    """All three analyses plus the advisory lints (the lint entry point)."""
    return verify_program(program) + check_lints(program)
