"""Halo/compute overlap by domain splitting (paper §IV-C latency hiding).

When a stencil program reads the *exchanged* fields, every output point —
the deep interior that never reads a ghost cell included — waits for the
exchange.  This module breaks that false dependence as production FV3
does, by splitting each exchanged program's domain:

 * the **full local domain** is computed from the *pre-exchange* fields.
   Every program validates ``node extent + stencil reach <= halo``
   (``propagate_extents``), so outputs at distance >= halo from the
   interior boundary never read a ghost cell and are exact; on the card
   this run shares the device with the exchange, which runs on a second
   stream;
 * four **edge strips** of width ``halo`` are recomputed *after* the
   exchange from slabs of the fresh fields, and stitched over the stale
   band.  Horizontal regions are translated into strip-local coordinates so
   the paper's edge stencils (§IV-B) fire at the same physical columns.

The stitched result equals running the program on the exchanged fields over
the whole interior; ghost cells of the outputs are stale, which is the
existing contract — every consumer re-exchanges before reading halos.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Mapping

import torch

from ..core.backend import compile_program
from ..core.graph import StencilProgram
from ..core.stencil.domain import DomainSpec
from ..core.stencil.ir import Assign, Computation, Region


def _translate_bound(b: tuple[int, int] | None, n_global: int,
                     origin: int) -> tuple[int, int] | None:
    """Rebase a region bound (base, offset) from the tile-local interior onto
    a strip whose interior starts at ``origin``; out-of-strip absolutes
    resolve to empty masks naturally."""
    if b is None:
        return None
    return (0, b[0] * n_global + b[1] - origin)


def _translate_region(r: Region, ni_g: int, nj_g: int,
                      oi: int, oj: int) -> Region:
    return Region(
        i_lo=_translate_bound(r.i_lo, ni_g, oi),
        i_hi=_translate_bound(r.i_hi, ni_g, oi),
        j_lo=_translate_bound(r.j_lo, nj_g, oj),
        j_hi=_translate_bound(r.j_hi, nj_g, oj),
    )


def _strip_program(program: StencilProgram, dom: DomainSpec,
                   oi: int, oj: int, tag: str) -> StencilProgram:
    """Clone ``program`` onto a strip domain with regions rebased."""
    q = StencilProgram(f"{program.name}/{tag}", dom)
    q.fields = {k: dataclasses.replace(v) for k, v in program.fields.items()}
    q.params = list(program.params)
    q.states = copy.deepcopy(program.states)
    q.extents_propagated = program.extents_propagated
    ni_g, nj_g = program.dom.ni, program.dom.nj
    for n in q.all_nodes():
        comps = tuple(
            Computation(c.direction, tuple(
                Assign(s.target, s.value, s.interval,
                       None if s.region is None else
                       _translate_region(s.region, ni_g, nj_g, oi, oj),
                       loc=s.loc)
                for s in c.statements))
            for c in n.stencil.computations)
        n.stencil = dataclasses.replace(n.stencil, computations=comps)
    return q


def written_fields(program: StencilProgram) -> tuple[str, ...]:
    """Non-transient program fields some node writes — the externally
    visible outputs the stitched runner must return."""
    out: list[str] = []
    for n in program.all_nodes():
        for f in n.writes():
            decl = program.fields.get(f)
            if decl is not None and not decl.transient and f not in out:
                out.append(f)
    return tuple(out)


def _fresh_beside(stale: Mapping, exchange: Callable, streams: dict
                  ) -> tuple:
    """Start ``exchange()`` so that work queued after it overlaps it: on a
    CUDA device it runs on a second stream (``streams`` keeps one per
    device), its inputs and outputs marked for the stream that uses them
    next; elsewhere it runs first.  Returns the exchanged mapping and a
    function that makes the current stream wait for it."""
    dev = next(iter(stale.values())).device
    if dev.type != "cuda":
        return exchange(), lambda: None
    main = torch.cuda.current_stream(dev)
    side = streams.get(dev)
    if side is None:
        side = streams[dev] = torch.cuda.Stream(dev)
    side.wait_stream(main)
    for v in stale.values():
        v.record_stream(side)
    with torch.cuda.stream(side):
        fresh = exchange()
        done = torch.cuda.Event()
        done.record(side)
    for v in fresh.values():
        v.record_stream(main)
    return fresh, lambda: main.wait_event(done)


def make_overlapped_runner(program: StencilProgram, *,
                           backend: str = "cuda", hardware=None,
                           opt_level: int = 0,
                           verify: str | None = None,
                           device: "torch.device | str | None" = None
                           ) -> Callable | None:
    """Compile ``program`` into ``fn(stale, fresh, params) -> outputs``.

    ``stale`` are the pre-exchange fields (the interior run), ``fresh`` the
    post-exchange fields (the edge strips) — or a zero-argument callable
    that performs the exchange and returns them: the runner then starts it
    before the interior run, on a second CUDA stream on the card, and runs
    the strips once it is done.  Fields may carry leading (rank, member)
    dims.  Returns ``None`` when the local interior is too small to hold a
    strip-free core (``n <= 2*halo``) — callers then exchange before they
    compute.
    """
    dom = program.dom
    ni, nj, h, nk = dom.ni, dom.nj, dom.halo, dom.nk
    if ni <= 2 * h or nj <= 2 * h:
        return None

    full_run = compile_program(program, backend, hardware=hardware,
                               opt_level=opt_level, verify=verify,
                               device=device)
    outputs = written_fields(program)

    # (tag, strip dom, interior origin (oi, oj), input slab, src, dst):
    # ``src`` selects the strip runner's write window in slab coordinates,
    # ``dst`` the same cells in full-array coordinates; a leading ``...``
    # lets rank and member axes ride through
    E, W = Ellipsis, slice(None)
    specs = [
        ("W", DomainSpec(ni=h, nj=nj, nk=nk, halo=h), (0, 0),
         (E, W, W, slice(0, 3 * h)),
         (E, W, slice(h, h + nj), slice(h, 2 * h)),
         (E, W, slice(h, h + nj), slice(h, 2 * h))),
        ("E", DomainSpec(ni=h, nj=nj, nk=nk, halo=h), (ni - h, 0),
         (E, W, W, slice(ni - h, ni + 2 * h)),
         (E, W, slice(h, h + nj), slice(h, 2 * h)),
         (E, W, slice(h, h + nj), slice(ni, ni + h))),
        ("S", DomainSpec(ni=ni, nj=h, nk=nk, halo=h), (0, 0),
         (E, W, slice(0, 3 * h), W),
         (E, W, slice(h, 2 * h), slice(h, h + ni)),
         (E, W, slice(h, 2 * h), slice(h, h + ni))),
        ("N", DomainSpec(ni=ni, nj=h, nk=nk, halo=h), (0, nj - h),
         (E, W, slice(nj - h, nj + 2 * h), W),
         (E, W, slice(h, 2 * h), slice(h, h + ni)),
         (E, W, slice(nj, nj + h), slice(h, h + ni))),
    ]
    # strips compile at most at level 1 (prune + strength-reduce, the
    # bit-affecting prefix of the ladder): fusion trials and per-strip
    # schedule tuning buy nothing on an h-wide recompute band, and levels
    # 2-4 preserve values, so strip and full-domain outputs stay aligned
    # across the stitch seam at every opt_level
    strip_level = min(opt_level, 1)
    strips = []
    for tag, sdom, (oi, oj), slab, src, dst in specs:
        sp = _strip_program(program, sdom, oi, oj, tag)
        run = compile_program(sp, backend, hardware=hardware,
                              opt_level=strip_level, verify=verify,
                              device=device)
        strips.append((run, slab, src, dst))

    streams: dict = {}

    def runner(stale: Mapping, fresh, params: Mapping | None = None) -> dict:
        wait = None
        if callable(fresh):
            fresh, wait = _fresh_beside(stale, fresh, streams)
        # interior: the full domain from the pre-exchange fields, no
        # dependence on the exchange
        out = full_run(dict(stale), params)
        stitched = {k: out[k] for k in outputs}
        if wait is not None:
            wait()
        for run, slab, src, dst in strips:
            # the kernels take contiguous fields
            so = run({f: v[slab].contiguous() for f, v in fresh.items()},
                     params)
            for k in outputs:
                # the full run's outputs are its own (written fields are
                # cloned), so the seam is stitched in place
                stitched[k][dst] = so[k][src]
        return stitched

    runner.outputs = outputs
    runner.full_run = full_run
    runner.n_strips = len(strips)
    return runner
