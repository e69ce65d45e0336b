"""Program lints — suspicious-but-not-miscompiling patterns.

These are collectable via :func:`check_lints` (the reference package's
``python -m repro.lint`` CLI reports them) but never fail compilation: they flag dead or
misleading IR, not wrong answers.

 * **dead-write**: a statement writes a temporary no later statement reads,
   or a node writes a transient program field nothing downstream reads;
 * **unused-field**: a signature field the stencil neither reads nor
   writes, or a declared program field no node touches;
 * **shadowed-declare**: ``program.declare`` overwrote an existing field
   declaration (the second declare silently wins);
 * **transient-read-before-write**: a transient program field is consumed
   before any node writes it (the runtime auto-allocates zeros — legal,
   but usually a forgotten producer);
 * **empty-interval**: a statement whose vertical interval resolves empty
   on this domain (dead code at this nk).
"""

from __future__ import annotations

from ..errors import Violation
from .common import expr_reads, iter_statements, k_extent, resolve_interval


def check_lints(program) -> list[Violation]:
    out: list[Violation] = []
    nk = program.dom.nk

    def lint(msg, *, node=None, stencil=None, stmt=None, field=None):
        out.append(Violation(
            "lint", msg, program=program.name, node=node, stencil=stencil,
            statement=None if stmt is None else repr(stmt), field=field,
            loc=None if stmt is None else stmt.loc))

    for name in program.redeclared:
        lint(f"shadowed declare: field {name!r} was declared more than "
             "once; the last declaration silently wins", field=name)

    touched: set[str] = set()
    written_program: set[str] = set()
    nodes = [n for s in program.states for n in s.nodes]
    for ni, node in enumerate(nodes):
        st = node.stencil
        # --- per-stencil: dead temporary writes / unused fields --------
        stmts = list(iter_statements(st))
        read_names = [set() for _ in stmts]
        for i, (_, _, s) in enumerate(stmts):
            read_names[i] = {r.name for r in expr_reads(s.value)}
        all_reads = set().union(*read_names) if read_names else set()
        for i, (_, _, s) in enumerate(stmts):
            if s.target in st.fields:
                continue
            later = set().union(*read_names[i + 1:]) if i + 1 < len(stmts) \
                else set()
            if s.target not in later:
                lint(f"dead write: temporary {s.target!r} is never read "
                     "after this statement", node=node.label,
                     stencil=st.name, stmt=s, field=s.target)
        writes = {s.target for _, _, s in stmts if s.target in st.fields}
        for f in st.fields:
            if f not in all_reads and f not in writes:
                lint(f"unused field: {f!r} is in the stencil signature but "
                     "never read or written", node=node.label,
                     stencil=st.name, field=f)
        # --- empty intervals -------------------------------------------
        for _, _, s in stmts:
            lo, hi = resolve_interval(s.interval, k_extent(st, s.target, nk))
            if hi <= lo:
                lint(f"empty interval: statement targets no K levels on a "
                     f"{nk}-level domain (dead code)", node=node.label,
                     stencil=st.name, stmt=s, field=s.target)
        # --- program-level transient dataflow --------------------------
        # a field is *consumed* when some statement reads it before any
        # statement of this stencil writes it (reads after an in-stencil
        # write are internal dataflow, not inputs)
        consumed: set[str] = set()
        seen_writes: set[str] = set()
        for _, _, s in stmts:
            for r in expr_reads(s.value):
                if r.name in st.fields and r.name not in seen_writes:
                    consumed.add(r.name)
            seen_writes.add(s.target)
        for f in st.fields:
            decl = program.fields.get(f)
            if (decl is not None and decl.transient
                    and f in consumed and f not in written_program
                    and f not in touched):
                lint(f"transient {f!r} is read before any node writes it "
                     "(auto-allocated as zeros — forgotten producer?)",
                     node=node.label, stencil=st.name, field=f)
            touched.add(f)
        written_program |= writes
        # --- dead transient node outputs -------------------------------
        for f in writes:
            decl = program.fields.get(f)
            if decl is None or not decl.transient:
                continue
            read_later = any(f in {r.name for _, _, s2 in
                                   iter_statements(m.stencil)
                                   for r in expr_reads(s2.value)}
                             for m in nodes[ni + 1:])
            if not read_later and f not in {r.name for _, _, s2 in stmts
                                            for r in expr_reads(s2.value)}:
                lint(f"dead write: transient {f!r} is written here but "
                     "never read by any later node", node=node.label,
                     stencil=st.name, field=f)
    for f, decl in program.fields.items():
        if f not in touched:
            lint(f"unused field: {f!r} is declared but no node touches it",
                 field=f)
    return out
