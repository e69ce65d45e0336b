"""Halo-sufficiency dataflow (the verifier's third analysis).

The orchestration contract (see ``repro/fv3/dyncore.py``): every program
*input* is freshly halo-exchanged at program entry, and every node computes
its outputs on an extended window ``node.extend`` wide enough that all
downstream reads (at any horizontal offset) observe computed data — no
exchanges happen *inside* a program.  This analysis re-derives the
requirement with its own reverse dataflow walk (no shared code with
``StencilProgram.propagate_extents``) and flags:

 * **stale-halo reads**: a node reads a field at radius ``r`` beyond what
   the nearest upstream writer computed (``writer.extend``) — the ghost
   cells hold pre-exchange garbage;
 * **insufficient allocation halo**: a node's extended compute window plus
   its own read reach exceeds the declared halo width, so reads (or the
   extended writes themselves) fall outside the allocation — a halo
   exchange (or a wider halo) is required before that node;
 * the same checks on overlap-split interior/strip programs
   (:mod:`repro_torch.fv3.overlap` builds them per strip; each strip program is
   verified like any other, against its own strip domain).

Transitive reach matters: after fusion a consumer's read offsets compound
with inlined producer offsets, so the per-field reach is folded through
temporary definitions (see :func:`..analysis.common.stencil_field_reach`).

Requirements propagate upstream *per output field*: each read is charged
the radius its own target is needed at downstream (plus the read offset),
not the node's whole extended window — a fused kernel inherits the widest
member extent, and reads feeding dead ghost-band writes of an
interior-only output would otherwise be flagged as stale.  The allocation
check, in contrast, does use the full extent: the lowered kernel really
evaluates every statement on the extended window, so every read really
indexes that far.
"""

from __future__ import annotations

from ..errors import Violation
from .common import stencil_field_reach, stencil_output_reach


def check_halo(program) -> list[Violation]:
    out: list[Violation] = []
    halo = program.dom.halo
    nodes = [n for s in program.states for n in s.nodes]
    # required[f] = (ri, rj): the horizontal radius downstream readers need
    # valid beyond their interior — satisfied by the nearest upstream
    # writer's extended window, else by the program-entry halo exchange
    required: dict[str, tuple[int, int, str]] = {}
    for node in reversed(nodes):
        ei, ej = node.extend
        reach = stencil_field_reach(node.stencil)
        oreach = stencil_output_reach(node.stencil)
        writes = {s.target for c in node.stencil.computations
                  for s in c.statements if s.target in node.stencil.fields}
        # this node is the nearest writer for everything downstream needed;
        # outputs nothing downstream reads are still observed at radius 0
        # (the interior is the program's visible result)
        need: dict[str, tuple[int, int]] = {w: (0, 0) for w in writes}
        for w in writes:
            got = required.pop(w, None)
            if got is None:
                continue
            ri, rj, reader = got
            need[w] = (ri, rj)
            if not program.extents_propagated:
                # without assigned extents (propagate_extents never ran)
                # writer windows are meaningless — only the allocation-halo
                # and input-radius checks below apply
                continue
            if ri > ei or rj > ej:
                out.append(Violation(
                    "halo",
                    f"stale-halo read: node {reader!r} reads {w!r} at "
                    f"radius {(ri, rj)} beyond this writer's computed "
                    f"extent {(ei, ej)} — the ghost cells it observes were "
                    "never recomputed (a halo exchange between the two "
                    "nodes, or a larger write extent, is required)",
                    program=program.name, node=node.label,
                    stencil=node.stencil.name, field=w, offset=(ri, rj, 0)))
        # reads propagate upstream at the radius their target is needed
        # at, plus their own offset
        for w, per in oreach.items():
            wi, wj = need.get(w, (0, 0))
            for f, (ri, rj) in per.items():
                if f not in program.fields:
                    continue
                cur = required.get(f)
                cand = (wi + ri, wj + rj)
                if cur is None or cand[0] > cur[0] or cand[1] > cur[1]:
                    best = cand if cur is None else (max(cand[0], cur[0]),
                                                     max(cand[1], cur[1]))
                    required[f] = (best[0], best[1], node.label)
        # the extended window itself (plus reads on it) must fit the
        # allocation halo
        max_reach_i = max([r[0] for r in reach.values()], default=0)
        max_reach_j = max([r[1] for r in reach.values()], default=0)
        if ei + max_reach_i > halo or ej + max_reach_j > halo:
            out.append(Violation(
                "halo",
                f"compute extent {(ei, ej)} + read reach "
                f"{(max_reach_i, max_reach_j)} exceeds the allocation halo "
                f"{halo}: reads fall outside the array (a halo exchange "
                "before this node, or a wider halo, is required)",
                program=program.name, node=node.label,
                stencil=node.stencil.name))
    # whatever requirement survives the walk is served by program inputs,
    # which the orchestration contract exchanges at program entry: their
    # ghost cells are valid to the declared halo width, no further
    for f, (ri, rj, reader) in required.items():
        if ri > halo or rj > halo:
            out.append(Violation(
                "halo",
                f"node {reader!r} reads program input {f!r} at radius "
                f"{(ri, rj)} but the declared halo is only {halo} ghost "
                "cells wide — even a fresh exchange cannot satisfy the "
                "read",
                program=program.name, node=reader, field=f,
                offset=(ri, rj, 0)))
    return out
