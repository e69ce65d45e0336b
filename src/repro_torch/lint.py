"""Static-analysis CLI: ``python -m repro_torch.lint [target ...]``.

Runs the three verifier analyses (well-formedness, intra-kernel races,
halo sufficiency — :mod:`repro_torch.core.analysis`) plus the advisory lints
(dead writes, unused fields, shadowed declares, empty intervals) over one
or more stencil programs.

Targets:

 * ``fv3`` (default) — the four FV3 dycore programs (acoustic c_sw /
   d_sw, tracer transport, vertical remap) on a small sequential domain,
   plus the four overlap-split strip clones of c_sw (rebased regions);
 * ``pkg.mod`` — import the module and scan its globals for
   :class:`StencilProgram` instances;
 * ``pkg.mod:attr`` — a specific attribute: a program, a zero-argument
   callable returning one, or an iterable of programs.

``--opt-level N`` pushes each program through the automatic optimization
ladder with between-pass verification, so a violation is attributed to
the responsible pass.  Exit status is 1 iff any *verifier* violation is
found; lints are advisory unless ``--strict``.
"""

from __future__ import annotations

import argparse
import importlib
import sys

from .core.analysis import VerificationError, check_lints, verify_program
from .core.graph import StencilProgram
from .core.passes import optimize_program


def _fv3_programs() -> list[tuple[str, StencilProgram]]:
    from .core.stencil.domain import DomainSpec
    from .fv3.dyncore import FV3Config, _build_programs
    from .fv3.overlap import _strip_program

    cfg = FV3Config(npx=24, nk=8, halo=6)
    dom = cfg.seq_dom()
    progs = [(p.name, p) for p in _build_programs(cfg, dom)]
    # overlap strip clones of the acoustic program: halo sufficiency must
    # hold on the rebased-region strip domains too
    csw = progs[0][1]
    h, ni, nj, nk = dom.halo, dom.ni, dom.nj, dom.nk
    for tag, sdom, (oi, oj) in [
        ("W", DomainSpec(ni=h, nj=nj, nk=nk, halo=h), (0, 0)),
        ("E", DomainSpec(ni=h, nj=nj, nk=nk, halo=h), (ni - h, 0)),
        ("S", DomainSpec(ni=ni, nj=h, nk=nk, halo=h), (0, 0)),
        ("N", DomainSpec(ni=ni, nj=h, nk=nk, halo=h), (0, nj - h)),
    ]:
        sp = _strip_program(csw, sdom, oi, oj, tag)
        progs.append((sp.name, sp))
    return progs


def _resolve_target(spec: str) -> list[tuple[str, StencilProgram]]:
    if spec == "fv3":
        return _fv3_programs()
    mod_name, _, attr = spec.partition(":")
    mod = importlib.import_module(mod_name)
    if attr:
        obj = getattr(mod, attr)
        if not isinstance(obj, StencilProgram) and callable(obj):
            obj = obj()
        progs = list(obj) if isinstance(obj, (list, tuple)) else [obj]
    else:
        progs = [v for v in vars(mod).values()
                 if isinstance(v, StencilProgram)]
        if not progs:
            raise SystemExit(
                f"repro_torch.lint: no StencilProgram instances found at "
                f"module level in {mod_name!r}; use {mod_name}:<attr> to "
                "name a program or a factory")
    for p in progs:
        if not isinstance(p, StencilProgram):
            raise SystemExit(
                f"repro_torch.lint: target {spec!r} yielded "
                f"{type(p).__name__}, expected StencilProgram")
    return [(f"{spec.split(':')[0]}:{p.name}", p) for p in progs]


def main(argv: list[str] | None = None, *, hardware=None) -> int:
    """The CLI; ``hardware`` is the preset the optimization ladder tunes
    for (``None``: the backend's, h100 for ``cuda``) — a caller's choice,
    not an option of the command line, whose options are the reference's
    lint's."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="Static verifier + lints for stencil programs.")
    ap.add_argument("targets", nargs="*", default=["fv3"],
                    help="'fv3' (default), 'pkg.mod' or 'pkg.mod:attr'")
    ap.add_argument("--opt-level", type=int, default=0, choices=range(4),
                    help="run the optimization ladder with between-pass "
                         "verification (violations attributed to passes)")
    ap.add_argument("--backend", default="cuda",
                    help="backend the optimization ladder targets")
    ap.add_argument("--strict", action="store_true",
                    help="advisory lints also set a failing exit status")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="only print the summary line")
    args = ap.parse_args(argv)

    pairs: list[tuple[str, StencilProgram]] = []
    for t in args.targets or ["fv3"]:
        pairs.extend(_resolve_target(t))

    n_violations = n_lints = 0
    for label, prog in pairs:
        try:
            opt, _rep = optimize_program(
                prog, opt_level=args.opt_level, backend=args.backend,
                hardware=hardware, verify="passes")
        except VerificationError as e:
            violations, lints = list(e.violations), check_lints(prog)
        else:
            # optimize_program already verified the input and every pass
            # output; re-running on the final program only re-confirms it
            violations, lints = verify_program(opt), check_lints(opt)
        n_violations += len(violations)
        n_lints += len(lints)
        if not args.quiet:
            for v in violations + lints:
                print(v.format())
        status = ("OK" if not (violations or lints) else
                  f"{len(violations)} violation(s), {len(lints)} lint(s)")
        print(f"[{label}] {status}")

    print(f"repro_torch.lint: {len(pairs)} program(s), {n_violations} "
          f"violation(s), {n_lints} lint(s)")
    if n_violations or (args.strict and n_lints):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
