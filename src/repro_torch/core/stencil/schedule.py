"""Stencil schedules — the tunable hardware-mapping attributes (paper §V-A).

A :class:`Schedule` captures, per stencil node, exactly the knobs the paper
enumerates for its ``StencilComputation`` library nodes:

 * iteration order (which dimension is unit-stride → TPU lane dim),
 * tiling and tile sizes in each dimension,
 * map-vs-loop per dimension (parallel grid dim vs in-kernel loop),
 * local-storage kind for loop carries (re-read VMEM vs VREG carry),
 * horizontal-region strategy (predicated full-domain map vs split kernels).

Validity rules (the paper generates "a list of feasible options") are
*hardware-parameterized*: every enumeration takes a
:class:`~repro_torch.core.hardware.Hardware` descriptor instead of reading
module-level constants.  On TPU, vertical solvers cannot map K to the
grid; blocks must fit VMEM; the lane dim should be a multiple of 128 and the
sublane of 8 for f32.  On GPU the block is a thread-block tile: the
unit-stride extent aligns to the warp width and the per-block working set
must fit shared memory, which favors small IJ tiles with K as grid or loop.

The rules are the reference package's, unchanged, for every preset — the
H100 takes the GPU rules, which keep vertical solvers whole-column, so
only a TPU preset offers the K-blocked marching schedules that the CUDA
backend runs on its K-blocked solver kernel.  Of a schedule, the CUDA
backend honours ``block_k`` of vertical solvers (see
:mod:`repro_torch.core.backend.cuda`); tile sizes and region strategies
feed the cost model only.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator

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

    def describe(self) -> str:
        return (f"bi={self.block_i or 'full'},bj={self.block_j or 'full'},"
                f"bk={self.block_k or 'full'},kgrid={self.k_as_grid},"
                f"carry={self.carry_storage},region={self.region_strategy}")

    def to_dict(self) -> dict:
        """JSON-serializable form (persistent tuning-cache payload)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Schedule":
        return cls(**d)


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


def _feasible_tpu(stencil: Stencil, dom_shape, dtype_bytes: int,
                  hw: Hardware) -> Iterator[Schedule]:
    nk, nj, ni = dom_shape
    vertical = stencil.is_vertical_solver()
    has_regions = any(s.region is not None
                      for c in stencil.computations for s in c.statements)
    lane, sublane = hw.lane, hw.sublane
    # interface fields (nk+1 levels) never co-tile with centers in K: any
    # K slab of mixed extents would misalign block boundaries, so interface
    # stencils only get whole-column blocks (same rule as K offsets below);
    # level-search stencils read whole coordinate columns, same rule
    if vertical:
        # whole-column, plus K-blocked marching slabs where the solver
        # admits them (single direction, one-level carries): the K grid
        # dimension is sequential on TPU, the carry crosses block
        # boundaries in scratch — production-depth columns fit VMEM
        k_opts = [0]
        if solver_k_blockable(stencil):
            k_opts += [b for b in (4, 8, 16, 32)
                       if b < nk and nk % b == 0]
        # the vertical lowering holds the full horizontal window per block
        # (halo reads need it) — never offer IJ tiles the kernel generator
        # would silently ignore
        i_opts, j_opts = [0], [0]
    else:
        k_opts = ([0] if (stencil.has_interface_fields()
                          or stencil.has_level_search())
                  else [1, 4, 8, 16, 0])
        i_opts = [0] if ni <= 2 * lane else [0, lane, 2 * lane]
        j_opts = [0, sublane, 4 * sublane, 16 * sublane]
    region_opts = ["predicated", "split"] if has_regions else ["predicated"]
    carry_opts = ["vreg", "vmem"] if vertical else ["vreg"]
    for bi, bj, bk, reg, carry in itertools.product(
            i_opts, j_opts, bk_dedup(k_opts, nk), region_opts, carry_opts):
        if vertical and bk != 0 and carry != "vreg":
            continue  # K-blocked marching always carries in registers
        s = Schedule(block_i=bi, block_j=bj, block_k=bk,
                     k_as_grid=not vertical, carry_storage=carry,
                     region_strategy=reg)
        if vmem_footprint(stencil, s, dom_shape, dtype_bytes) > hw.vmem_bytes:
            continue
        # stencils with k offsets need whole-K blocks (no overlapping blocks
        # across the K grid on TPU)
        if not vertical and stencil.has_k_offsets() and bk != 0:
            continue
        yield s


def _feasible_gpu(stencil: Stencil, dom_shape, dtype_bytes: int,
                  hw: Hardware) -> Iterator[Schedule]:
    """GPU tiling rules: thread-block tiles whose unit-stride extent is a
    warp multiple and whose working set fits shared memory.  Full-domain
    blocks are allowed only when they fit (they essentially never do), so
    the enumeration is dominated by small IJ tiles — the paper's DaCe/GPU
    maps — with K either a grid dimension or an in-kernel loop."""
    nk, nj, ni = dom_shape
    vertical = stencil.is_vertical_solver()
    has_regions = any(s.region is not None
                      for c in stencil.computations for s in c.statements)
    warp = hw.lane
    i_opts = [w for w in (warp, 2 * warp, 4 * warp) if w <= ni] or [ni]
    j_opts = [1, 2, 4, 8]
    # K-offset / interface / level-search stencils need whole-K blocks
    # (same rule as TPU); otherwise small K slabs map to the thread-block z
    # dimension.  Vertical solvers stay whole-column: the K-blocked
    # marching schedule needs a *sequential* grid with persistent scratch,
    # which a parallel thread-block grid cannot provide.
    if (vertical or stencil.has_k_offsets() or stencil.has_interface_fields()
            or stencil.has_level_search()):
        k_opts = [0]
    else:
        k_opts = bk_dedup([1, 2, 4], nk)
    region_opts = ["predicated", "split"] if has_regions else ["predicated"]
    # GPU vertical carries live in registers; the "vmem" variant models
    # spilling the carry to local/shared memory for A/B comparison.
    carry_opts = ["vreg", "vmem"] if vertical else ["vreg"]
    for bi, bj, bk, reg, carry in itertools.product(
            i_opts, j_opts, k_opts, region_opts, carry_opts):
        s = Schedule(block_i=bi, block_j=bj, block_k=bk,
                     k_as_grid=not vertical, carry_storage=carry,
                     region_strategy=reg)
        if vmem_footprint(stencil, s, dom_shape, dtype_bytes) > hw.vmem_bytes:
            continue
        yield s


def bk_dedup(k_opts: list[int], nk: int) -> list[int]:
    """Drop K-block sizes ≥ nk (equivalent to whole-extent 0)."""
    out = []
    for bk in k_opts:
        v = bk if bk < nk else 0
        if v not in out:
            out.append(v)
    return out


def feasible_schedules(stencil: Stencil, dom_shape, dtype_bytes: int = 4,
                       hw: Hardware | str | None = None) -> Iterator[Schedule]:
    """Enumerate valid schedules for a stencil on a local domain (paper §V-A:
    'for each node we generate a list of feasible options'), under the
    tiling rules of ``hw`` (TPU lane/sublane/VMEM vs GPU warp/smem)."""
    hw = resolve_hardware(hw)
    if hw.kind == "gpu":
        yield from _feasible_gpu(stencil, dom_shape, dtype_bytes, hw)
    else:
        yield from _feasible_tpu(stencil, dom_shape, dtype_bytes, hw)


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


def heuristic_schedule(stencil: Stencil, dom_shape, dtype_bytes: int = 4,
                       hw: Hardware | str | None = None) -> Schedule:
    """Initial heuristics (paper §VI-A), per hardware kind.

    TPU: smallest VMEM-fitting K slab for horizontal stencils (maximizes
    grid parallelism while keeping full IJ for halo reuse); full-column
    blocks with VREG carries for vertical solvers.

    GPU: a warp-aligned IJ thread-block tile with a one-level K slab —
    occupancy over reuse, the classic CUDA stencil starting point.
    """
    hw = resolve_hardware(hw)
    nk, nj, ni = dom_shape
    if stencil.is_vertical_solver():
        return Schedule(block_i=0, block_j=0, block_k=0, k_as_grid=False,
                        carry_storage="vreg", region_strategy="predicated")
    # whole-column blocks only for K-offset / interface / level-search
    # stencils (interface and center fields never co-tile in K; searches
    # read whole coordinate columns) — decided BEFORE the GPU branch so the
    # fusion cost model never prices these stencils on a K slab the
    # lowering would silently refuse
    whole_k = (stencil.has_k_offsets() or stencil.has_interface_fields()
               or stencil.has_level_search())
    if hw.kind == "gpu":
        bk = 0 if whole_k else 1
        bi = min(ni, 4 * hw.lane)
        bj = 4
        while (vmem_footprint(stencil, Schedule(block_i=bi, block_j=bj,
                                                block_k=bk), dom_shape,
                              dtype_bytes) > hw.vmem_bytes and bj > 1):
            bj //= 2
        return Schedule(block_i=bi, block_j=bj, block_k=bk, k_as_grid=True,
                        carry_storage="vreg", region_strategy="predicated")
    if whole_k:
        return Schedule(block_i=0, block_j=0, block_k=0, k_as_grid=True,
                        carry_storage="vreg", region_strategy="predicated")
    bk = 1
    while (vmem_footprint(stencil, Schedule(block_k=bk), dom_shape,
                          dtype_bytes) <= hw.vmem_bytes // 2 and bk < nk):
        bk *= 2
    bk = min(bk, nk)
    return Schedule(block_i=0, block_j=0, block_k=bk, k_as_grid=True,
                    carry_storage="vreg", region_strategy="predicated")
