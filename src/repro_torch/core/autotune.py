"""Local stencil autotuning (paper §VI-A: 'initial heuristics').

Searches the feasible schedule space of one stencil under a hardware
descriptor (TPU lane/VMEM rules or GPU warp/shared-memory rules — see
:mod:`repro_torch.core.stencil.schedule`).  The objective is pluggable: the
analytical memory-bound model by default, optionally combined with
wall-clock measurement of the compiled callable — the same interface the
paper's tuner uses on Piz Daint.  The model, the rules and the search are
the reference package's, unchanged, so both packages tune the same program
to the same schedules for every hardware preset.

Model-driven searches are memoized in the persistent tuning cache keyed by
(stencil fingerprint, domain, backend, hardware), so re-tuning the same
stencil across runs is a disk read, not a search.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from .hardware import Hardware, resolve_hardware
from .stencil.domain import DomainSpec
from .stencil.ir import Stencil
from .stencil.schedule import (Schedule, kblocked_applies,
                               solver_carried_fields, vmem_footprint)


def model_cost(stencil: Stencil, sched: Schedule, dom: DomainSpec,
               hw: Hardware | str | None = None, dtype_bytes: int = 4,
               n_members: int = 1, member_chunk: int = 0) -> float:
    """Analytical cost of one stencil launch under a schedule.

    bytes/bw plus structural penalties:
      * K-slab grids re-stage the halo of every block boundary (negligible
        unless blocks are tiny) — modeled as per-block fixed overhead;
      * vertical solvers with 'vmem' carries re-read each written field once
        per level (the §VI-A.2(3) transform removes exactly this);
      * 'split' region kernels add a launch overhead per region but shrink
        the predicated volume.

    ``n_members=M`` prices the ensemble-batched kernel: data volume and
    per-grid-step pipeline terms scale by M, but the per-launch
    overhead is paid ONCE — the member grid axis amortizes it across
    members (M per-member dispatches would pay it M times).  With
    ``member_chunk=0`` per-member VMEM feasibility is unchanged (each
    invocation holds one member's blocks), so the infeasibility checks
    ignore M.

    ``member_chunk=C`` prices the hybrid chunk loop
    (``batch="vmap:C,grid"``): the sequential member dimension walks
    ceil(M/C) chunk steps instead of M — every per-grid-step pipeline term
    shrinks by C — but each invocation now holds C members' blocks, so the
    VMEM feasibility checks scale by C.  Data-traffic terms are unchanged
    (total bytes moved do not depend on the chunking).  That tension —
    fewer sequential steps vs a C× wider working set — is exactly what
    :func:`tune_member_chunk` optimizes over.
    """
    hw = resolve_hardware(hw)
    M = max(1, n_members)
    C = min(member_chunk, M) if member_chunk > 0 else 0
    # sequential member steps the launch structure actually walks
    m_steps = -(-M // C) if C else M
    nk, nj, ni = dom.nk, dom.nj, dom.ni
    # per-member iteration volume × members: every data-traffic term below
    # scales with M, every *feasibility* check stays per-member
    vol = M * nk * (nj + 2 * dom.extend[1]) * (ni + 2 * dom.extend[0])
    n_fields = len(stencil.fields)
    data = n_fields * vol * dtype_bytes
    t = data / hw.hbm_bw

    launch_overhead = 1e-6  # per kernel launch / grid step pipeline fill
    if stencil.is_vertical_solver():
        if vmem_footprint(stencil, sched, (nk, nj, ni), dtype_bytes,
                          member_chunk=C) > hw.vmem_bytes:
            # whole-column blocks stop fitting at production depths
            # (nk ~ 80 on large tiles) — or the requested member chunk
            # widens them past VMEM; the K-blocked marching schedules
            # below (or a narrower chunk) are then the only finite options
            return float("inf")
        if kblocked_applies(stencil, sched, nk):
            bk = sched.block_k
            # K-blocked marching: one sequential grid step per block and
            # member chunk (pipeline fill each, single launch) plus the
            # carry planes staged through scratch at every block boundary
            # (total carry traffic is per member — chunking doesn't move
            # fewer bytes, it just stages C members per grid step)
            n_blocks = max(1, nk // bk)
            plane = (nj + 2 * dom.extend[1]) * (ni + 2 * dom.extend[0])
            carry_bytes = (len(solver_carried_fields(stencil))
                           * plane * dtype_bytes)
            t += launch_overhead * (1 + 0.05 * (n_blocks * m_steps - 1))
            t += 2 * M * (n_blocks - 1) * carry_bytes / hw.hbm_bw
        else:
            if sched.carry_storage == "vmem":
                # re-read previously written levels from VMEM→VREG each
                # step: extra traffic ≈ one written-field plane per level
                extra = len(stencil.written()) * vol * dtype_bytes
                t += 0.25 * extra / hw.hbm_bw
            t += launch_overhead * (1 + 0.05 * (m_steps - 1))
    else:
        bk = sched.block_k or nk
        n_blocks = max(1, nk // bk)
        if hw.kind == "gpu":
            # thread-block grid: blocks along all three tile dims
            bi = sched.block_i or ni
            bj = sched.block_j or nj
            n_blocks *= max(1, ni // bi) * max(1, nj // bj)
        t += launch_overhead * (1 + 0.05 * (n_blocks * m_steps - 1))
        if vmem_footprint(stencil, sched, (nk, nj, ni), dtype_bytes,
                          member_chunk=C) > hw.vmem_bytes:
            return float("inf")
    has_regions = any(s.region is not None
                      for c in stencil.computations for s in c.statements)
    if has_regions:
        n_region_stmts = sum(1 for c in stencil.computations
                             for s in c.statements if s.region is not None)
        if sched.region_strategy == "predicated":
            # full-domain predicated evaluation of each region statement
            t += n_region_stmts * vol * dtype_bytes / hw.hbm_bw
        else:
            # split kernels touch only the region bbox (~1 row/col) + launch
            t += n_region_stmts * (launch_overhead
                                   + (vol / max(ni, nj)) * dtype_bytes / hw.hbm_bw)
    return t


def _sync(fields) -> None:
    """Wait for the card when the fields lie on one: PyTorch returns before
    the device finishes, so a host clock without it times the enqueue."""
    if any(isinstance(x, torch.Tensor) and x.is_cuda
           for x in fields.values()):
        torch.cuda.synchronize()


def wallclock(fn: Callable, fields, params, *, iters: int = 3) -> float:
    """Median seconds of ``fn(fields, params)`` after one warm-up call."""
    fn(fields, params)  # build + warm
    _sync(fields)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(fields, params)
        _sync(fields)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@dataclasses.dataclass
class TuneResult:
    schedule: Schedule
    cost: float
    n_evaluated: int
    from_cache: bool = False


def tune_stencil(stencil: Stencil, dom: DomainSpec, *,
                 hw: Hardware | str | None = None,
                 backend: str = "cuda",
                 measure: Callable[[Schedule], float] | None = None,
                 top_m: int = 1,
                 n_members: int = 1,
                 member_chunk: int = 0,
                 cache=None) -> list[TuneResult]:
    """Exhaustive search over feasible schedules; returns top-M by cost.

    The schedule space is the ``backend``'s (a registered backend may
    override ``feasible_schedules`` with target-specific rules) under the
    tiling constraints of ``hw``.  Pure model-driven searches (no
    ``measure``) hit the persistent tuning cache: the second identical
    call — even in a fresh process — skips the search.  Wall-clock
    objectives are machine-state-dependent and are never cached.

    ``n_members`` enters the cost model (launch amortization across the
    ensemble axis) and the cache key — per-member legality and VMEM are
    M-independent, but the relative weight of per-launch overhead is not,
    so a schedule tuned for M=1 is not automatically the M=8 winner.
    ``member_chunk=C`` tunes for the hybrid chunk loop: VMEM feasibility
    prices C-member blocks, so the schedule winner can differ between an
    unchunked and a chunked lowering of the same stencil.
    """
    from .backend import get_backend
    from .backend.cache import COST_MODEL_VERSION, default_cache, make_key

    be = get_backend(backend)
    hw = resolve_hardware(hw)
    use_cache = None if measure is not None else (
        cache if cache is not None else default_cache())
    key = None
    if use_cache is not None:
        key = make_key("tune_stencil", COST_MODEL_VERSION, stencil, dom,
                       be.name, hw.name, top_m, n_members, member_chunk)
        hit = use_cache.get(key)
        if hit is not None:
            return [TuneResult(Schedule.from_dict(r["schedule"]), r["cost"],
                               r["n_evaluated"], from_cache=True)
                    for r in hit]
    results = []
    for sched in be.feasible_schedules(stencil, (dom.nk, dom.nj, dom.ni),
                                       hardware=hw):
        c = model_cost(stencil, sched, dom, hw, n_members=n_members,
                       member_chunk=member_chunk)
        if measure is not None and c != float("inf"):
            c = measure(sched)
        results.append(TuneResult(sched, c, 0))
    results.sort(key=lambda r: r.cost)
    n = len(results)
    out = results[:top_m]
    for r in out:
        r.n_evaluated = n
    if use_cache is not None:
        use_cache.put(key, [{"schedule": r.schedule.to_dict(), "cost": r.cost,
                             "n_evaluated": r.n_evaluated} for r in out])
    return out


def chunk_candidates(n_members: int) -> list[int]:
    """Candidate inner chunk widths for ``batch="vmap:auto"``: powers of two
    up to M, plus M itself (a single chunk — the plain unchunked batch)."""
    out, c = [], 1
    while c < n_members:
        out.append(c)
        c *= 2
    out.append(n_members)
    return out


def tune_member_chunk(stencil: Stencil, dom: DomainSpec, *,
                      hw: Hardware | str | None = None,
                      backend: str = "cuda",
                      n_members: int,
                      candidates: list[int] | None = None,
                      cache=None) -> int:
    """Resolve ``batch="vmap:auto"`` for one stencil: the chunk width C
    minimizing the best-schedule model cost at ``member_chunk=C``.

    Returns C in [1, M]; C == M means one chunk, i.e. the plain unchunked
    inner batch.  Ties break toward the *smallest* C — the cost model does
    not see the memory-streaming benefit of a narrow live working set, so
    when chunk widths price identically the streaming-friendlier one wins.
    Results persist in the tuning cache under :data:`COST_MODEL_VERSION`.
    """
    from .backend.cache import COST_MODEL_VERSION, default_cache, make_key

    hw = resolve_hardware(hw)
    use_cache = cache if cache is not None else default_cache()
    key = make_key("tune_member_chunk", COST_MODEL_VERSION, stencil, dom,
                   backend, hw.name, n_members,
                   candidates if candidates is not None else "pow2")
    hit = use_cache.get(key)
    if hit is not None:
        return int(hit)
    best_c, best = n_members, float("inf")
    for C in (candidates or chunk_candidates(n_members)):
        res = tune_stencil(stencil, dom, hw=hw, backend=backend,
                           n_members=n_members, member_chunk=C, cache=cache)
        cost = res[0].cost if res else float("inf")
        if cost < best:
            best_c, best = C, cost
    use_cache.put(key, best_c)
    return best_c


def tune_program_chunk(program, *, backend: str = "cuda",
                       hw: Hardware | str | None = None,
                       n_members: int,
                       candidates: list[int] | None = None,
                       cache=None) -> int:
    """Resolve ``batch="vmap:auto"`` for a whole program: one shared chunk
    width C minimizing the summed best-schedule model cost of every node at
    ``member_chunk=C``.  A program-level chunk loop runs ALL kernels on one
    chunk before the next (chunk locality), so the width is a program
    decision, not per-stencil.  Same tie-breaking and caching as
    :func:`tune_member_chunk`.
    """
    from .backend.cache import COST_MODEL_VERSION, default_cache, make_key

    hw = resolve_hardware(hw)
    use_cache = cache if cache is not None else default_cache()
    nodes = [(n.stencil, program.node_dom(n))
             for s in program.states for n in s.nodes]
    key = make_key("tune_program_chunk", COST_MODEL_VERSION,
                   [st for st, _ in nodes], [d for _, d in nodes],
                   backend, hw.name, n_members,
                   candidates if candidates is not None else "pow2")
    hit = use_cache.get(key)
    if hit is not None:
        return int(hit)
    best_c, best = n_members, float("inf")
    for C in (candidates or chunk_candidates(n_members)):
        total = 0.0
        for st, d in nodes:
            res = tune_stencil(st, d, hw=hw, backend=backend,
                               n_members=n_members, member_chunk=C,
                               cache=cache)
            total += res[0].cost if res else float("inf")
        if total < best:
            best_c, best = C, total
    use_cache.put(key, best_c)
    return best_c
