"""Shared typed errors and diagnostics for static analysis.

This module is deliberately dependency-free (no IR imports): it sits below
``core.stencil.ir`` so both the IR's own legality errors and the independent
verifier of the reference package can raise/carry the same types
without an import cycle.

``Violation`` is the verifier's diagnostic record: one concrete defect, with
enough context (program, node, stencil, statement, field, offset, source
location, responsible pass) to point at user code instead of IR reprs.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SourceLocation:
    """file:line of the user statement a piece of IR came from (captured by
    the ``@gtstencil`` frontend; ``None`` on programmatically built IR)."""

    file: str
    line: int

    def __str__(self) -> str:
        return f"{self.file}:{self.line}"


class AnalysisError(Exception):
    """Base of every typed legality/verification error.

    Carries optional context attributes so call sites close to the user
    (transforms, the pass manager) can enrich an error raised deep inside
    the IR with the stencil/statement it concerns.
    """

    def __init__(self, message: str, *, stencil: str | None = None,
                 statement: str | None = None,
                 loc: SourceLocation | None = None):
        super().__init__(message)
        self.message = message
        self.stencil = stencil
        self.statement = statement
        self.loc = loc

    def with_context(self, *, stencil: str | None = None,
                     statement: str | None = None,
                     loc: SourceLocation | None = None) -> "AnalysisError":
        """Fill in missing context (never overwrites existing context)."""
        self.stencil = self.stencil or stencil
        self.statement = self.statement or statement
        self.loc = self.loc or loc
        return self

    def __str__(self) -> str:
        parts = [self.message]
        if self.stencil:
            parts.append(f"[stencil {self.stencil!r}]")
        if self.statement:
            parts.append(f"[in: {self.statement}]")
        if self.loc:
            parts.append(f"({self.loc})")
        return " ".join(parts)


class FusionLegalityError(AnalysisError, ValueError):
    """An IR rewrite (inline substitution, shift) would be semantically
    wrong — e.g. fusion across a :class:`~repro_torch.core.stencil.ir.LevelSearch`.

    Subclasses ``ValueError`` so pre-existing callers that guard rewrites
    with ``except ValueError`` keep working.
    """


@dataclasses.dataclass(frozen=True)
class Violation:
    """One defect found by the static verifier."""

    analysis: str                 # "wellformed" | "race" | "halo" | "lint"
    message: str
    program: str | None = None
    node: str | None = None       # graph node label, e.g. "fx_ppm#3"
    stencil: str | None = None
    statement: str | None = None  # offending Assign repr
    field: str | None = None
    offset: tuple[int, int, int] | None = None
    loc: SourceLocation | None = None
    pass_name: str | None = None  # optimization pass that introduced it

    def format(self) -> str:
        where = []
        if self.program:
            where.append(f"program {self.program!r}")
        if self.node:
            where.append(f"node {self.node!r}")
        elif self.stencil:
            where.append(f"stencil {self.stencil!r}")
        head = f"[{self.analysis}] " + (", ".join(where) + ": " if where else "")
        msg = head + self.message
        if self.statement:
            msg += f"\n    in: {self.statement}"
        if self.loc:
            msg += f"  ({self.loc})"
        if self.pass_name:
            msg += f"\n    introduced by pass: {self.pass_name}"
        return msg

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["loc"] = str(self.loc) if self.loc else None
        return d


class VerificationError(AnalysisError):
    """The verifier found violations; raised by ``verify="passes"/"full"``
    compilation.  ``violations`` holds the structured diagnostics and
    ``pass_name`` the optimization pass they are attributed to (``None``
    when the *input* program is already broken)."""

    def __init__(self, violations: list[Violation],
                 pass_name: str | None = None):
        self.violations = list(violations)
        self.pass_name = pass_name
        n = len(self.violations)
        src = f" after pass {pass_name!r}" if pass_name else ""
        body = "\n".join("  - " + v.format().replace("\n", "\n    ")
                         for v in self.violations)
        super().__init__(
            f"{n} verifier violation{'s' if n != 1 else ''}{src}:\n{body}")
