"""Stencil schedules — the tunable hardware-mapping attributes (paper §V-A).

This slice of the port runs at opt level 0, so it keeps only the schedule
record, the untuned default and the predicates the default needs; the
feasibility enumeration and heuristics come with the optimizer.

A :class:`Schedule` captures, per stencil node, the knobs the paper
enumerates for its ``StencilComputation`` library nodes: tiling and tile
sizes, map-vs-loop per dimension, the local storage of loop carries and the
horizontal-region strategy.  The CUDA kernels of this slice read none of
them (one thread per point or per column), and no backend takes a schedule
yet: the record and its default are kept as data for the slice that tunes.
"""

from __future__ import annotations

import dataclasses

from ..hardware import Hardware, resolve_hardware
from .ir import Direction, Stencil, expr_contains_level_search


@dataclasses.dataclass(frozen=True)
class Schedule:
    # tile sizes; 0 means "whole extent".  For vertical solvers a nonzero
    # ``block_k`` (with ``k_as_grid=False``) selects the K-blocked marching
    # schedule: the K grid dimension is *sequential* (TPU grids iterate in
    # order), each invocation marches ``block_k`` levels in VMEM and the
    # loop carry crosses block boundaries through persistent scratch —
    # production-depth columns (nk ~ 80) fit VMEM without giving up the
    # sequential solve.
    block_i: int = 0
    block_j: int = 0
    block_k: int = 8
    # map-vs-loop: True → dimension is a parallel grid dim
    k_as_grid: bool = True  # horizontal stencils only
    # local storage for vertical-solver carries: "vreg" | "vmem"
    carry_storage: str = "vreg"
    # horizontal regions: "predicated" | "split"
    region_strategy: str = "predicated"
    # unit-stride dimension; "I" is the paper's (FORTRAN-layout) choice
    unit_stride: str = "I"


def solver_carried_fields(stencil: Stencil) -> list[str]:
    """Fields (written *or* input) read at the marching-previous level
    inside a sequential computation — the values a K-blocked schedule must
    carry across block boundaries in scratch."""
    out: list[str] = []
    for c in stencil.computations:
        if c.direction is Direction.PARALLEL:
            continue
        prev = -1 if c.direction is Direction.FORWARD else 1
        for s in c.statements:
            for a in s.value.accesses():
                if a.offset[2] == prev and a.name not in out:
                    out.append(a.name)
    return out


def solver_k_blockable(stencil: Stencil) -> bool:
    """True when a vertical solver admits the K-blocked marching schedule.

    The blocked lowering marches all levels in one direction with a
    single-level carry, so it requires:

     * exactly one sequential direction (a FORWARD+BACKWARD stencil like
       the Thomas algorithm needs two passes over the column — it keeps
       whole-column blocks);
     * no interface fields (nk+1 rows cannot co-tile with nk-row centers);
     * every K read either at the current level or at the marching-previous
       level with zero horizontal offset (deeper or offset reads would
       reach outside the block and its one-level carry);
     * no marching-previous read of a field a *later* computation writes —
       reference semantics run each computation as a separate full K
       sweep, so such a read must observe the later computation's
       pre-sweep values, which the per-level interleaved march cannot
       provide (its carry already holds the updated level);
     * no :class:`~repro.core.stencil.ir.LevelSearch` (the search reads
       whole coordinate columns).
    """
    dirs = {c.direction for c in stencil.computations
            if c.direction is not Direction.PARALLEL}
    if len(dirs) != 1 or stencil.has_interface_fields():
        return False
    prev = -1 if Direction.FORWARD in dirs else 1
    # fields written strictly after each computation, in program order
    later_written: list[set[str]] = []
    suffix: set[str] = set()
    for c in reversed(stencil.computations):
        later_written.append(set(suffix))
        suffix |= set(c.written())
    later_written.reverse()
    for i, c in enumerate(stencil.computations):
        for s in c.statements:
            if expr_contains_level_search(s.value):
                return False
            for a in s.value.accesses():
                dk = a.offset[2]
                if c.direction is Direction.PARALLEL:
                    if dk != 0:
                        return False
                elif dk == prev:
                    if a.offset[0] != 0 or a.offset[1] != 0:
                        return False
                    if a.name in later_written[i]:
                        return False
                elif dk != 0:
                    return False
    return True


def kblocked_applies(stencil: Stencil, sched: Schedule, nk: int, *,
                     scratch: bool = True) -> bool:
    """THE K-blocked dispatch predicate — the single definition shared by
    the lowering (``compile_pallas``, which passes its backend's scratch
    capability), the footprint model (:func:`vmem_footprint`) and the cost
    model (``model_cost``), so the model never prices a blocked kernel the
    lowering would decline in favor of whole-column (or vice versa)."""
    return (scratch and bool(sched.block_k) and sched.block_k < nk
            and nk % sched.block_k == 0 and solver_k_blockable(stencil))


def vmem_footprint(stencil: Stencil, sched: Schedule, dom_shape,
                   dtype_bytes: int = 4, member_chunk: int = 0) -> int:
    """Bytes of fast on-chip memory one kernel invocation touches under this
    schedule (VMEM block on TPU; shared-memory tile on GPU).  The byte
    count itself is hardware-independent; callers compare it against
    ``hw.vmem_bytes``.  K-interface buffers carry one extra level
    (they only ever appear in whole-K blocks — interface and center fields
    never co-tile in K).  K-blocked vertical solvers hold ``block_k`` rows
    per field plus one carry plane per loop-carried field.

    ``member_chunk=C`` prices a chunk-batched invocation
    (``batch="vmap:C,grid"``): every block and carry buffer gains a leading
    C-member extent, so the footprint scales by C — the feasibility limit
    on how wide the inner batch of the hybrid chunk loop can go."""
    nk, nj, ni = dom_shape
    mult = max(1, member_chunk)
    bi = sched.block_i or ni
    bj = sched.block_j or nj
    vertical = stencil.is_vertical_solver()
    if vertical:
        whole_k = not kblocked_applies(stencil, sched, nk)
        bk = nk if whole_k else sched.block_k
    else:
        whole_k = (not sched.k_as_grid or stencil.has_interface_fields()
                   or stencil.has_level_search())
        bk = nk if whole_k else (sched.block_k or nk)
    total = 0
    for name in tuple(stencil.fields) + tuple(stencil.temporaries()):
        k_size = bk + 1 if (whole_k and stencil.is_interface(name)) else bk
        total += mult * bi * bj * k_size * dtype_bytes
    if vertical and not whole_k:
        total += (mult * len(solver_carried_fields(stencil))
                  * bi * bj * dtype_bytes)
    return total


def default_schedule(stencil: Stencil, dom_shape, dtype_bytes: int = 4,
                     hw: Hardware | str | None = None) -> Schedule:
    """The backend's default before any tuning (paper's 'Default' row in
    Table III): untransformed storage choices (memory-backed carries,
    predicated regions) on the largest tile the hardware's feasibility
    rules allow — whole-domain blocks on TPU, a warp-aligned tile that
    fits shared memory on GPU (whole-domain blocks are never GPU-feasible,
    so defaulting to them would contradict ``feasible_schedules``)."""
    hw = resolve_hardware(hw)
    vertical = stencil.is_vertical_solver()
    whole_k = (vertical or stencil.has_interface_fields()
               or stencil.has_level_search())
    if hw.kind == "gpu":
        nk, nj, ni = dom_shape
        bi = min(ni, 4 * hw.lane)
        bj = 8
        while (vmem_footprint(stencil,
                              Schedule(block_i=bi, block_j=bj,
                                       block_k=0 if whole_k else 1,
                                       k_as_grid=not vertical),
                              dom_shape, dtype_bytes) > hw.vmem_bytes
               and bj > 1):
            bj //= 2
        return Schedule(block_i=bi, block_j=bj,
                        block_k=0 if whole_k else 1,
                        k_as_grid=not vertical,
                        carry_storage="vmem", region_strategy="predicated")
    return Schedule(block_i=0, block_j=0, block_k=0,
                    k_as_grid=not vertical,
                    carry_storage="vmem", region_strategy="predicated")
