"""The CUDA kernels of the stencil IR: encoder, build and wrappers.

Four hand-written kernels in ``csrc/stencil_kernels.cu`` run every
stencil of the path, fused or not, at every opt level; they port the
reference's Pallas kernels (``src/repro/core/backend/lowering_pallas.py``):

 * ``stencil_parallel_kernel`` (K1, ``_horizontal_kernel``) — a group of
   consecutive PARALLEL statements (:func:`parallel_groups`), one thread
   per ``(tile, K span, j, i)``, each op evaluated for a strip of
   :data:`STRIP` levels of the thread's column;
 * ``stencil_column_kernel`` (K2, ``_vertical_kernel``) — one FORWARD or
   BACKWARD computation, one thread per :data:`COLUMNS` neighbouring
   columns ``(tile, rows j .. j + 3, i)`` marching K, each op decoded once
   for the 4; the marching-previous level of a slot the march writes read
   from the thread's carry (``CARRY``), the reads no store of the march can
   change copied into shared memory a level ahead (``AHEAD``), a binary op
   of two leaves one op (``src2``);
 * ``march_search`` (K3, ``_march_search``) — the ``index_search`` level
   search, a device function the kernels call for the ``SEARCH`` op;
 * ``stencil_kblocked_kernel`` (K4, ``_vertical_kernel_kblocked``) — a
   single-direction solver under a K-blocked schedule: K2's march (the
   same template) over all its statements interleaved per level and all
   ``nk`` levels, the AHEAD copies taken in groups of the slab's
   ``block_k`` levels, at most :data:`KB_DEPTH_MAX` and fewer where two
   groups exceed :data:`KB_SMEM_BUDGET` (:func:`copy_depth`), the records
   decided once a group, and 0 read a level before the first, the
   reference's zeroed carry;
 * their member axis (K5, ``_member_index_map``/``_member_specs``) — an
   ensemble's members in one launch, one member (``"grid"``) or a chunk of
   members (``"vmap:C,grid"``) per thread, with a per-slot member stride
   that is 0 for a field broadcast across members.

The kernels interpret the IR.  This module encodes each statement into a
record (target, levels, box) and a postfix stream of int32 op words with a
float32 constant table (the opcode table below, mirrored in the CUDA
source).  Each op word carries the stack depth before the op and, for a
push or a binary op, the source of its operand (a load, a constant, a
parameter or a stack entry), so the kernels keep the top of the stack in
registers and the rest in shared memory at fixed places.  A launch is a
:class:`Program`: its records run in order at every point; a temporary
that only later records of the launch read, inside its writer's box, stays
on the stack (``Program.kept``) and is never stored or allocated.
``Program.work`` counts what the interpreter executes, and
:data:`LAUNCHES` what the wrappers launched.  A launch's tables (records
and ops, constants, the field table and the parameters) and its stack are
sized by what it holds, in shared memory (:func:`table_words`,
``Program.smem_bytes``); only a launch past a CTA's 227 KB is refused (or
a stencil whose field table passes the 32 KB of kernel parameters that
carry it, ~1,330 fields and temporaries), and a K1 group whose program
passes :data:`K1_PROGRAM_BYTES` is cut (``Encoder.parallel_launches``).

Of a node's schedule the backend honours ``block_k`` of a vertical solver:
whenever ``kblocked_applies(stencil, schedule, nk)`` holds, as it does for
the reference's ``compile_pallas``, the whole stencil is one K4 launch
whose copies run a slab of ``block_k`` levels ahead, or, where K4's carry
and copy tables cannot hold its marching-previous reads, K2's launches,
which compute the same values (``CudaStencil.kblocked_refused``).  Tile sizes,
``k_as_grid``, the carry storage and the region strategy are not read (one
thread per point or group of columns).
Expressions built from constants only are folded in double precision at
encode time, as the plain lowering computes them.

The source builds at first use with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (loaded with :mod:`ctypes`), in
``build/repro_torch/<hash of source and flags>/`` under the repository
(:func:`build_library` builds any named source of ``csrc/`` that way).

A wrapper takes the plain version (:mod:`.lowering_torch`) only for tensors
on the CPU; for CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import math
import os
import shutil
import struct
import subprocess
from pathlib import Path
from typing import Any, Mapping

import torch

from ..stencil.domain import DomainSpec
from ..stencil.ir import (
    Assign,
    BinOp,
    Computation,
    Direction,
    Expr,
    FieldAccess,
    FoundLevel,
    Interval,
    LevelSearch,
    Max,
    Min,
    ParamRef,
    Pow,
    Stencil,
    UnaryOp,
    Where,
    expr_contains_level_search,
)
from ..stencil.schedule import (Schedule, kblocked_applies,
                                solver_k_blockable)
from . import lowering_torch as plain

# -- the kernels' ABI (keep in sync with csrc/stencil_kernels.cu) ------------

REC_INTS = 9

#: an op word is ``src2 << SRC2_SHIFT | src << SRC_SHIFT | op * OPW |
#: depth``: the opcode, the number of values on the stack before the op
#: (known when the stream is encoded; the kernels keep the top of the
#: stack in registers and the entries below it in shared memory, addressed
#: by the depth), where a push or a binary op takes its operand from, and
#: (K2, K4) where a binary op takes its first operand from, so that it
#: pushes f(src2, src) without a push of its own
OPW = 1 << 16
OP_SHIFT = 16
SRC_SHIFT = 22
SRC2_SHIFT = 25
# sources, their operand words right after the op word: LOAD slot di dj
# dk; CONST c; PARAM p; PICK j (a copy of stack entry j); CARRY slot di dj
# dk (K2, K4: a read at the marching-previous level of a slot the march
# writes, taken from the value the thread stored there, kept on chip, and
# from memory where it stored none); AHEAD j (K2, K4: the read of key j of
# the program's ahead table, copied from memory into shared memory while
# the level, in K4 the slab, before ran)
SRC_LOAD, SRC_CONST, SRC_PARAM, SRC_PICK, SRC_CARRY, SRC_AHEAD = \
    1, 2, 3, 4, 5, 6
OP_PUSH = 0     # pushes its source
OP_FLOAD = 1    # slot di dj dk: pushes an at_found read of the search
OP_SEARCH = 2   # coord lo hi: pops the target, selects the level per point
OP_STORE = 3    # slot: pops the value into the slot at the point
OP_KEEP = 4     # the value stays on the stack for later records
OP_DROP = 5     # n: the top replaces the n entries below it
UNARY_OPS = {"neg": 8, "sqrt": 9, "abs": 10, "exp": 11, "log": 12,
             "sign": 13, "floor": 14}
# binary ops compute f(a, b): without a source a is the entry below the
# top and b the top (both popped); with one, a is the top and b the source
BINARY_OPS = {"+": 16, "-": 17, "*": 18, "/": 19, "<": 20, "<=": 21,
              ">": 22, ">=": 23, "==": 24, "!=": 25}
OP_MIN, OP_MAX, OP_POW = 26, 27, 28
# f(b, a): the IR's right operand was evaluated first
OP_RSUB, OP_RDIV, OP_RMIN, OP_RMAX, OP_RPOW = 29, 30, 31, 32, 33
OP_WHERE = 34   # pops b, a, cond
#: the op a binary op becomes when its right operand was evaluated first
REVERSED = {16: 16, 17: OP_RSUB, 18: 18, 19: OP_RDIV, 20: 22, 21: 23,
            22: 20, 23: 21, 24: 24, 25: 25, OP_MIN: OP_RMIN,
            OP_MAX: OP_RMAX, OP_POW: OP_RPOW}
#: operand words of each source and of each op
SRC_OPERANDS = {0: 0, SRC_LOAD: 4, SRC_CONST: 1, SRC_PARAM: 1, SRC_PICK: 1,
                SRC_CARRY: 4, SRC_AHEAD: 1}
OPERANDS = {OP_FLOAD: 4, OP_SEARCH: 3, OP_STORE: 1, OP_DROP: 1}
#: K1 evaluates each op for a strip of this many levels of one column
STRIP = 8
#: threads of a K1 CTA (the kernel's K1_BLOCK)
K1_BLOCK = 128
#: K2 and K4 evaluate each op for this many neighbouring columns (rows j
#: at one i), each marching its own chain (the kernel's K2_COLS)
COLUMNS = 4
#: threads of a K2 or K4 CTA (the kernel's K2_BLOCK)
COLUMN_BLOCK = 128
#: K2 and K4 keep on chip the marching carry of at most this many slots
CARRY_MAX = 8
#: K2 and K4 copy at most this many distinct loads of a level into shared
#: memory ahead of it (``cp.async``)
AHEAD_MAX = 8
#: K4's dynamic shared memory a CTA at most (the tables included), where
#: the copies' depth allows: four CTAs an SM (as many as K2's registers
#: allow) with the 1 KB the card keeps a CTA
KB_SMEM_BUDGET = 55 * 1024
#: K4's copy groups hold at most this many levels: the march, not device
#: memory, bounds it, and deeper groups measured slower on an H100 (their
#: copies issued at once stall the group's first level; ``PERF.md`` §6)
KB_DEPTH_MAX = 4
#: the shared memory a CTA can take on the card (the kernel's SMEM_MAX): a
#: launch whose tables and stack need more is refused
SMEM_MAX = 227 * 1024
#: 8-byte words of the slot table and parameters that the kernels' two
#: instances take as a kernel parameter (TABLE_LARGE: what Hopper's 32 KB
#: of kernel parameters hold beside the header)
TABLE_SMALL, TABLE_LARGE = 256, 4000
#: a K1 launch group whose records, ops and constants take more bytes is
#: cut at a statement boundary: within it the group's tables take no more
#: shared memory than the fixed tables did before (1024 words of program
#: and 256 constants), so no group runs at fewer CTAs an SM than it did
K1_PROGRAM_BYTES = 4 * (1024 + 256)
#: a K1 temporary stays on the stack only while every later record of its
#: launch needs no deeper stack than this (each entry takes 4 KB of a K1
#: CTA's shared memory)
KEEP_STACK = 16


def is_binary(op: int) -> bool:
    return BINARY_OPS["+"] <= op <= OP_RPOW


def stack_effect(op: int, src: int = 0, args=(), src2: int = 0) -> int:
    """Values ``op`` (with sources ``src``, ``src2`` and operands ``args``)
    leaves on the stack minus the values it takes."""
    if op in (OP_PUSH, OP_FLOAD):
        return 1
    if op == OP_DROP:
        return -args[0]
    if is_binary(op):
        return 1 if src2 else 0 if src else -1
    if op in (OP_SEARCH, OP_STORE):
        return -1
    if op == OP_WHERE:
        return -2
    return 0  # unary, KEEP


def decode(prog, pc: int, end: int):
    """The ops of ``prog[pc:end]`` in order: ``(op, depth, src, source
    operands, operands, (src2, its operands))``; the operand words are
    src2's, then src's, then the op's."""
    while pc < end:
        word = prog[pc]
        src2, src = word >> SRC2_SHIFT, (word >> SRC_SHIFT) & 7
        op, depth = (word >> OP_SHIFT) & 63, word & (OPW - 1)
        n2, n = SRC_OPERANDS[src2], SRC_OPERANDS[src]
        m = OPERANDS.get(op, 0)
        pc += 1
        yield (op, depth, src, tuple(prog[pc + n2:pc + n2 + n]),
               tuple(prog[pc + n2 + n:pc + n2 + n + m]),
               (src2, tuple(prog[pc:pc + n2])))
        pc += n2 + n + m


class LaunchHeader(ctypes.Structure):
    """Mirror of ``struct LaunchHeader`` in the CUDA source (the kernels'
    parameter with the launch's table; the loader checks the two sizes
    agree)."""

    _fields_ = [
        ("prog", ctypes.c_void_p),
        ("consts", ctypes.c_void_p),
        ("n_prog", ctypes.c_int),
        ("n_consts", ctypes.c_int),
        ("n_slots", ctypes.c_int),
        ("n_params", ctypes.c_int),
        ("ntile", ctypes.c_int),
        ("jp", ctypes.c_int),
        ("ip", ctypes.c_int),
        ("klo", ctypes.c_int),
        ("khi", ctypes.c_int),
        ("kspan", ctypes.c_int),
        ("depth", ctypes.c_int),
        ("j0", ctypes.c_int),
        ("j1", ctypes.c_int),
        ("i0", ctypes.c_int),
        ("i1", ctypes.c_int),
        ("lo", ctypes.c_int),
        ("hi", ctypes.c_int),
        ("forward", ctypes.c_int),
        ("nmember", ctypes.c_int),
        ("mchunk", ctypes.c_int),
        ("bk", ctypes.c_int),
        ("n_carried", ctypes.c_int),
        ("ahead_begin", ctypes.c_int),
        ("ahead_end", ctypes.c_int),
    ]


def table_words(n_prog: int, n_slots: int, n_params: int,
                n_consts: int) -> tuple[int, int]:
    """The kernels' ``Tables`` layout of a launch, in 4-byte words of
    shared memory: the records and ops at 0, then each slot's pointer and
    member stride (8 bytes each, from an even word), K extent and carry
    index, the parameters and, from an even word, the constants.  Returns
    (the 8-byte words of the kernel parameter's table, pointers to
    parameters; all the words, rounded up to 16 bytes)."""
    ptr = n_prog + (n_prog & 1)
    consts = ptr + 6 * n_slots + n_params + (n_params & 1)
    return (consts - ptr) // 2, -(-(consts + n_consts) // 4) * 4


#: launches of each kernel since the last :func:`reset_launches`; a wrapper
#: adds one where it launches its kernel and nowhere else ("search" counts
#: the K1/K2 launches whose program runs the K3 level search, "member" the
#: K1/K2/K4 launches over more than one member, which take the member axis,
#: K5)
LAUNCHES = {"horizontal": 0, "column": 0, "kblocked": 0, "search": 0,
            "member": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# IR preparation
# ---------------------------------------------------------------------------


def inline_offset_temps(stencil: Stencil) -> Stencil:
    """Replace temporary reads at nonzero offsets with the temporary's
    defining expression shifted by that offset — the reference's
    ``_inline_offset_temps`` (lowering_pallas.py:286), applied to horizontal
    stencils before they are encoded.

    A temporary is computed on the write window only, so a read like PPM's
    ``br[-1, 0, 0]`` has no computed value at the window's edge.  Expandable
    temporaries have a single full-interval, region-free definition whose
    field-level expansion reads only fields the stencil never overwrites;
    zero-offset reads keep using the computed value.
    """
    temps = set(stencil.temporaries())
    if not temps:
        return stencil
    written_fields = {w for w in stencil.written() if w in stencil.fields}
    stmts = [s for c in stencil.computations for s in c.statements]
    n_defs: dict[str, int] = {}
    for s in stmts:
        if s.target in temps:
            n_defs[s.target] = n_defs.get(s.target, 0) + 1
    expansions: dict[str, Expr] = {}
    full = Interval()
    for s in stmts:
        t = s.target
        if (t not in temps or n_defs[t] != 1 or s.region is not None
                or s.interval != full
                or expr_contains_level_search(s.value)):
            continue

        def expand(e: Expr) -> Expr:
            if isinstance(e, FieldAccess) and e.name in expansions:
                return expansions[e.name].shift(e.offset)
            return e.map_children(expand)

        expr = expand(s.value)
        reads = {a.name for a in expr.accesses()}
        if reads & temps or reads & written_fields:
            continue
        expansions[t] = expr

    def rewrite(e: Expr) -> Expr:
        if (isinstance(e, FieldAccess) and e.name in expansions
                and e.offset != (0, 0, 0)):
            return expansions[e.name].shift(e.offset)
        return e.map_children(rewrite)

    comps = tuple(
        Computation(c.direction, tuple(
            Assign(s.target, rewrite(s.value), s.interval, s.region,
                   loc=s.loc)
            for s in c.statements))
        for c in stencil.computations)
    return dataclasses.replace(stencil, computations=comps)


def _walk(e: Expr):
    yield e
    for c in e.children():
        yield from _walk(c)


def _away_reads(st: Assign) -> set[str]:
    """The fields and temporaries ``st`` reads anywhere but at the point it
    writes: at an offset, as a search coordinate or at a found level."""
    out = set()
    for e in _walk(st.value):
        if isinstance(e, FieldAccess) and e.offset != (0, 0, 0):
            out.add(e.name)
        elif isinstance(e, FoundLevel):
            out.add(e.name)
        elif isinstance(e, LevelSearch):
            out.add(e.coord)
    return out


def _check_parallel_hazard(st: Assign) -> None:
    """Every thread of a K1 launch writes the target while it reads: a read
    of the target anywhere but the thread's own point is a race."""
    if st.target in _away_reads(st):
        raise NotImplementedError(
            f"statement {st} reads its own target away from the point "
            "it writes; one launch cannot order those reads")


def parallel_groups(statements) -> list[list[Assign]]:
    """Consecutive PARALLEL statements cut into K1 launches: a thread runs
    a launch's statements in order at its points, so a statement joins the
    open launch unless it reads an earlier member's target away from the
    point, or writes a field or temporary that an earlier member read away
    from the point (either would see another thread mid-launch)."""
    groups: list[list[Assign]] = []
    written: set[str] = set()
    away: set[str] = set()
    for st in statements:
        _check_parallel_hazard(st)
        reads = _away_reads(st)
        if not groups or reads & written or st.target in away:
            groups.append([])
            written, away = set(), set()
        groups[-1].append(st)
        written.add(st.target)
        away |= reads
    return groups


def _check_column_hazard(comp: Computation) -> None:
    """K2 and K4 threads own columns: a read, at a horizontal offset, of a
    field the same computation writes would see a neighbour column
    mid-march.  K4 marches all computations of a stencil as one, so there
    the rule covers every field the stencil writes."""
    written = set(comp.written())
    for st in comp.statements:
        for e in _walk(st.value):
            if isinstance(e, FieldAccess):
                name, di, dj = e.name, e.offset[0], e.offset[1]
            elif isinstance(e, FoundLevel):
                name, di, dj = e.name, e.di, e.dj
            else:
                continue
            if name in written and (di, dj) != (0, 0):
                raise NotImplementedError(
                    f"solver statement {st} reads {name!r} at horizontal "
                    f"offset {(di, dj)} while its computation writes it; "
                    "columns would not be independent")


def march_levels(cwin: torch.Tensor, target: torch.Tensor, lo: int,
                 hi: int) -> torch.Tensor:
    """K3's plain version: per point, the last layer ``s`` in ``(lo, hi)``
    with ``cwin[s] <= target``, else ``lo`` — the reference's marching rule
    (``_march_search``), right on any column (no order assumed; a NaN
    compares false and is never taken).  On a monotone column it picks the
    layer the plain lowering's bisection picks (``bisect_levels``, whose
    signature it shares)."""
    shape = torch.broadcast_shapes(
        target.shape, cwin.shape[:-3] + (1,) + cwin.shape[-2:])
    lvl = torch.full(shape, lo, dtype=torch.int64, device=cwin.device)
    kc = cwin.shape[-3]
    for s in range(lo + 1, hi):
        k = min(max(s, 0), kc - 1)
        lvl = torch.where(cwin[..., k:k + 1, :, :] <= target, s, lvl)
    return lvl


@contextlib.contextmanager
def marching_plain():
    """While the block runs, the plain lowering searches by
    :func:`march_levels` instead of bisection: the plain version of the
    kernels on columns that are not monotone."""
    saved = plain.bisect_levels
    plain.bisect_levels = march_levels
    try:
        yield
    finally:
        plain.bisect_levels = saved


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Program:
    """One launch: the statement records and ops, the constant table, and
    the IR it was encoded from (which the plain version runs)."""

    kind: str                     # "horizontal" (K1) | "column" (K2) |
    #                               "kblocked" (K4)
    ir: Computation               # K1: the launch's PARALLEL statements;
    #                               K4: all statements, interleaved
    prog: list[int]
    consts: list[float]
    stack: int                    # deepest stack the ops reach
    has_search: bool
    klo: int = 0                  # K1: the levels and box of all records
    khi: int = 0
    box: tuple[int, int, int, int] = (0, 0, 0, 0)
    lo: int = 0                   # K2, K4: march
    hi: int = 0
    forward: bool = True
    block_k: int = 0              # K4: slab depth
    carried: tuple[int, ...] = ()  # K2, K4: the slots read through CARRY
    ahead: tuple[int, int] = (0, 0)  # K2, K4: prog[a:b], the keys read
    #                                  through AHEAD, 4 words each
    kept: tuple[str, ...] = ()    # K1: temporaries held on the stack
    #                               and never stored
    n_slots: int = 0              # the stencil's fields and temporaries
    n_params: int = 0             # and parameters, which every launch
    #                               carries in its table

    @property
    def empty(self) -> bool:
        j0, j1, i0, i1 = self.box
        if self.kind in ("column", "kblocked"):
            return self.hi <= self.lo or j1 <= j0 or i1 <= i0
        return self.khi <= self.klo or j1 <= j0 or i1 <= i0

    @property
    def strip(self) -> int:
        """Levels of a column each op is evaluated for at once."""
        return STRIP if self.kind == "horizontal" else 1

    def table_bytes(self) -> int:
        """Shared memory of the launch's tables (:func:`table_words`)."""
        return 4 * table_words(len(self.prog), self.n_slots, self.n_params,
                               len(self.consts))[1]

    def smem_bytes(self, copy_levels: int = 1) -> int:
        """The launch's dynamic shared memory a CTA: its tables, then K1's
        stack of a strip a thread, or K2's and K4's stack, carry, two
        groups of ``copy_levels`` levels of copies and column table."""
        depth = max(1, self.stack)
        if self.kind == "horizontal":
            return self.table_bytes() + 4 * depth * STRIP * K1_BLOCK
        return (self.table_bytes() + 4 * COLUMNS * COLUMN_BLOCK
                * (depth + 2 * len(self.carried)
                   + 2 * copy_levels * len(self.ahead_keys()))
                + 8 * COLUMN_BLOCK * self.n_slots)

    def ahead_keys(self) -> list[tuple[int, int, int, int]]:
        """K2, K4: the ``(slot, di, dj, dk)`` that ``AHEAD j`` reads, by
        j."""
        a, b = self.ahead
        return [tuple(self.prog[x:x + 4]) for x in range(a, b, 4)]

    def records(self) -> list[list[int]]:
        """Per statement: target klo khi j0 j1 i0 i1 op_begin op_end."""
        code = self.prog
        return [code[1 + REC_INTS * q:1 + REC_INTS * (q + 1)]
                for q in range(code[0])]

    def work(self) -> list[tuple[int, int, int, int, int]]:
        """Per statement record: the points it writes per tile (levels x
        rows x columns of its box); the ops, field loads and distinct
        ``(slot, di, dj, dk)`` loads the interpreter executes at one point
        (a level search counts the layers it may march, shared by the
        points of a strip, and its ``at_found`` reads); and 1 if it stores,
        0 if its value stays on the stack."""
        out = []
        for _, klo, khi, j0, j1, i0, i1, pc, end in self.records():
            ops = loads = stores = 0
            keys = set()
            for op, _, src, sargs, args, (src2, s2args) in decode(
                    self.prog, pc, end):
                if op == OP_STORE:
                    stores += 1
                    continue
                ops += 1
                for kind, operand in ((src, sargs), (src2, s2args)):
                    if kind == SRC_AHEAD:
                        operand = self.ahead_keys()[operand[0]]
                    if kind in (SRC_LOAD, SRC_CARRY, SRC_AHEAD):
                        loads += 1
                        keys.add((False,) + operand)
                if op == OP_FLOAD:
                    loads += 1
                    keys.add((True,) + args)
                elif op == OP_SEARCH:
                    loads += math.ceil(max(0, args[2] - args[1] - 1)
                                       / self.strip)
            out.append((max(0, khi - klo) * max(0, j1 - j0)
                        * max(0, i1 - i0), ops, loads, len(keys), stores))
        return out


def prior_reads(stencil: Stencil, nk: int) -> set[str]:
    """The fields ``stencil`` writes of which some read can see the value
    from before the call: a read at a horizontal offset or by a level
    search, or a read at a level that no earlier statement of the call has
    written over the whole window (a write under a region covers nothing).

    Statements run as the plain lowering orders them: each computation in
    turn, a PARALLEL one statement by statement, a solver level by level in
    its marching order, K reads edge-clamped."""
    written = {w for w in stencil.written() if w in stencil.fields}
    done: dict[str, set[int]] = {f: set() for f in written}
    prior: set[str] = set()

    def levels(st: Assign) -> range:
        return range(*st.interval.resolve(
            stencil.k_extent_of(st.target, nk)))

    def run(st: Assign, ks) -> None:
        for e in _walk(st.value):
            if isinstance(e, FoundLevel) and e.name in written:
                prior.add(e.name)
            elif isinstance(e, LevelSearch) and e.coord in written:
                prior.add(e.coord)
            elif isinstance(e, FieldAccess) and e.name in written:
                di, dj, dk = e.offset
                kext = stencil.k_extent_of(e.name, nk)
                if (di, dj) != (0, 0) or any(
                        min(max(k + dk, 0), kext - 1) not in done[e.name]
                        for k in ks):
                    prior.add(e.name)
        if st.target in written and st.region is None:
            done[st.target].update(ks)

    def march(statements, forward: bool, lo: int, hi: int) -> None:
        spans = [levels(st) for st in statements]
        for k in (range(lo, hi) if forward else range(hi - 1, lo - 1, -1)):
            for st, span in zip(statements, spans):
                if k in span:
                    run(st, (k,))

    for c in stencil.computations:
        if c.direction is Direction.PARALLEL:
            for st in c.statements:
                run(st, levels(st))
        else:
            spans = [levels(st) for st in c.statements]
            march(c.statements, c.direction is Direction.FORWARD,
                  min(s.start for s in spans), max(s.stop for s in spans))
    return prior


class KBlockedTablesFull(NotImplementedError):
    """K4 would read a marching-previous level from memory: its carry and
    copy tables (:data:`CARRY_MAX`, :data:`AHEAD_MAX`) cannot hold every
    such read, through which alone it reads the first level's 0."""


def slot_names(stencil: Stencil) -> list[str]:
    """The field table of a launch: the stencil's fields, then its
    temporaries; a LOAD names a field by its index here."""
    return list(stencil.fields) + list(stencil.temporaries())


class Encoder:
    """Encodes the statements of one stencil against its slot table.

    Each statement becomes a record (target, interval, box, op range) and
    postfix ops whose op words carry the stack depth.  A binary op whose
    second operand is a leaf (a load, a constant, a parameter, a found
    value or a kept temporary) takes it as its source instead of a push.
    The encoder orders each operation's operands to keep the stack shallow
    (the deeper one first; a binary op whose right operand went first takes
    its reversed form, computing the same value), and in a K1 launch leaves
    a temporary that only later statements of the launch read, at their
    own points inside its box, on the stack instead of storing it."""

    def __init__(self, stencil: Stencil, dom: DomainSpec):
        self.stencil = stencil
        self.dom = dom
        names = slot_names(stencil)
        self.slots = {n: i for i, n in enumerate(names)}
        self.temps = set(stencil.temporaries())
        self.params = {p: i for i, p in enumerate(stencil.params)}
        h = dom.halo
        self.jp, self.ip = dom.nj + 2 * h, dom.ni + 2 * h
        self._needs: dict[int, int] = {}

    # -- geometry -------------------------------------------------------------
    def window(self) -> tuple[int, int, int, int]:
        jsl, isl = plain.hwindow(self.dom, 0, 0)
        return (jsl.start, jsl.stop, isl.start, isl.stop)

    def box(self, st: Assign) -> tuple[int, int, int, int]:
        """The write window cut to the statement's region (padded coords)."""
        j0, j1, i0, i1 = self.window()
        if st.region is not None:
            ilo, ihi, jlo, jhi = st.region.resolve(self.dom.ni, self.dom.nj)
            h = self.dom.halo
            j0, j1 = max(j0, h + jlo), min(j1, h + jhi)
            i0, i1 = max(i0, h + ilo), min(i1, h + ihi)
        return (j0, j1, i0, i1)

    def levels(self, st: Assign) -> tuple[int, int]:
        return st.interval.resolve(
            self.stencil.k_extent_of(st.target, self.dom.nk))

    def _check_reach(self, name: str, di: int, dj: int) -> None:
        j0, j1, i0, i1 = self.window()
        if j0 + dj < 0 or j1 + dj > self.jp or i0 + di < 0 or i1 + di > self.ip:
            raise ValueError(
                f"{self.stencil.name}: read of {name!r} at offset {(di, dj)} "
                "reaches outside the allocation; widen the halo")

    def _check_temp(self, name: str, di: int, dj: int, what: str) -> None:
        if (di, dj) != (0, 0) and name in self.temps:
            raise NotImplementedError(
                f"{self.stencil.name}: temporary {name!r} is read at "
                f"horizontal offset {(di, dj)}{what}, but a launch computes "
                "it on its own write window only and its definition "
                "cannot be inlined at that offset")

    # -- expressions ------------------------------------------------------------
    @staticmethod
    def _is_leaf(e: Expr) -> bool:
        return isinstance(e, (ParamRef, FieldAccess, FoundLevel)) or \
            plain.fold_const(e) is not None

    def _order(self, a: Expr, b: Expr) -> tuple[bool, int]:
        """Whether to evaluate ``a`` before ``b``, and the stack it takes:
        the second one fuses into the op when it is a leaf, else it is
        pushed above the first."""
        na, nb = self._need(a), self._need(b)
        a_first = max(na, nb + (not self._is_leaf(b)))
        b_first = max(nb, na + (not self._is_leaf(a)))
        return (True, a_first) if a_first <= b_first else (False, b_first)

    def _need(self, e: Expr) -> int:
        """Stack entries that evaluating ``e`` takes, operands ordered as
        :meth:`_expr` orders them."""
        got = self._needs.get(id(e))
        if got is not None:
            return got
        if self._is_leaf(e):
            n = 1
        elif isinstance(e, LevelSearch):
            n = max(self._need(e.target),
                    len(e.found_levels()) + self._need(e.body))
        else:
            ch = e.children()
            if len(ch) == 1:
                n = self._need(ch[0])
            elif len(ch) == 2:
                n = self._order(*ch)[1]
            else:  # where: condition, then a, then b
                n = max(self._need(c) + i for i, c in enumerate(ch))
        self._needs[id(e)] = n
        return n

    def _emit(self, op: int, *operands: int, src: tuple = (0,),
              src2: tuple = (0,)) -> None:
        """One op word (``src``, ``src2``: the sources and their operand
        words), then the op's operands."""
        self._ops += [src2[0] << SRC2_SHIFT | src[0] << SRC_SHIFT
                      | op * OPW | self._sp, *src2[1:], *src[1:], *operands]
        self._sp += stack_effect(op, src[0], operands, src2[0])
        self._max = max(self._max, self._sp)

    def _const(self, v) -> int:
        v = float(v)
        key = struct.pack("<f", v)  # one slot per f32 value (0.0 != -0.0)
        if key not in self._cidx:
            self._cidx[key] = len(self._consts)
            self._consts.append(v)
        return self._cidx[key]

    def _load_key(self, e: FieldAccess) -> tuple[int, int, int, int]:
        di, dj, dk = e.offset
        self._check_reach(e.name, di, dj)
        self._check_temp(e.name, di, dj, "")
        return (self.slots[e.name], di, dj, dk)

    def _source(self, e: Expr, found: dict | None) -> tuple:
        """A leaf as a source: (kind, operand words...)."""
        v = plain.fold_const(e)
        if v is not None:
            return (SRC_CONST, self._const(v))
        if isinstance(e, ParamRef):
            return (SRC_PARAM, self.params[e.name])
        if isinstance(e, FoundLevel):
            if found is None:
                raise TypeError("FoundLevel outside a LevelSearch body")
            return (SRC_PICK, found[e])
        key = self._load_key(e)
        if key in self._held:
            return (SRC_PICK, self._held[key])
        if key[0] in self._carry and key[1:] == (0, 0, self._prev):
            return (SRC_CARRY, *key)
        if key in self._ahead:
            return (SRC_AHEAD, self._ahead[key])
        return (SRC_LOAD, *key)

    def _expr(self, e: Expr, found: dict | None) -> None:
        if self._is_leaf(e):
            self._emit(OP_PUSH, src=self._source(e, found))
        elif isinstance(e, LevelSearch):
            self._search(e)
        elif isinstance(e, (BinOp, Min, Max, Pow)):
            a, b = e.children()
            op = (BINARY_OPS[e.op] if isinstance(e, BinOp) else
                  OP_MIN if isinstance(e, Min) else
                  OP_MAX if isinstance(e, Max) else OP_POW)
            a_first = self._order(a, b)[0]
            first, second = (a, b) if a_first else (b, a)
            op = op if a_first else REVERSED[op]
            if self._pairs and self._is_leaf(first) and self._is_leaf(second):
                self._emit(op, src=self._source(second, found),
                           src2=self._source(first, found))
                return
            self._expr(first, found)
            if self._is_leaf(second):
                self._emit(op, src=self._source(second, found))
            else:
                self._expr(second, found)
                self._emit(op)
        elif isinstance(e, UnaryOp):
            self._expr(e.a, found)
            self._emit(UNARY_OPS[e.op])
        elif isinstance(e, Where):
            for c in e.children():
                self._expr(c, found)
            self._emit(OP_WHERE)
        else:
            raise TypeError(f"cannot encode {e!r}")

    def _search(self, e: LevelSearch) -> None:
        """The target, ``SEARCH`` (which pops it), each ``at_found`` value
        loaded once onto the stack, the body reading them with ``PICK``,
        and ``DROP`` leaving the body's value in their place."""
        self._expr(e.target, None)
        finds = e.found_levels()
        lo, hi = e.resolve_bounds(self.dom.nk)
        self._emit(OP_SEARCH, self.slots[e.coord], lo, hi)
        found = {}
        for fl in finds:
            self._check_reach(fl.name, fl.di, fl.dj)
            self._check_temp(fl.name, fl.di, fl.dj, " by a level search")
            found[fl] = self._sp
            self._emit(OP_FLOAD, self.slots[fl.name], fl.di, fl.dj, fl.dk)
        self._has_search = True
        self._expr(e.body, found)
        if finds:
            self._emit(OP_DROP, len(finds))

    def _statement(self, st: Assign, store: bool) -> list[int]:
        """The ops of one statement, from the current stack depth: the
        value, then its store (``store``) or ``KEEP`` (it stays)."""
        self._ops = []
        self._expr(st.value, None)
        if store:
            self._emit(OP_STORE, self.slots[st.target])
        else:
            self._emit(OP_KEEP)
        return self._ops

    # -- launches -----------------------------------------------------------------
    def _encode(self, statements, keep=frozenset(), carry=(), prev=0,
                ahead=None, pairs=False):
        """Records + ops of ``statements`` (each with its box and interval);
        the statements in ``keep`` (by index) leave their value on the
        stack for the later ones, which read their target with ``PICK``;
        reads of a slot in ``carry`` at ``(0, 0, prev)`` are ``CARRY``, a
        read whose key is in ``ahead`` is ``AHEAD`` of its index, and with
        ``pairs`` a binary op of two leaves takes both from sources."""
        self._consts: list[float] = []
        self._cidx: dict = {}
        self._max = 0
        self._sp = 0
        self._held: dict = {}
        self._carry = frozenset(carry)
        self._prev = prev
        self._ahead = ahead or {}
        self._pairs = pairs
        self._has_search = False
        header = [len(statements)]
        body: list[int] = []
        base = 1 + REC_INTS * len(statements)
        for q, st in enumerate(statements):
            depth = self._sp
            ops = self._statement(st, q not in keep)
            if self._sp != depth + (q in keep):
                raise AssertionError(f"unbalanced stack encoding {st}")
            if q in keep:
                self._held[(self.slots[st.target], 0, 0, 0)] = depth
            begin = base + len(body)
            body += ops
            header += [self.slots[st.target], *self.levels(st),
                       *self.box(st), begin, base + len(body)]
        prog = header + body
        return prog, list(self._consts), self._max, self._has_search

    def _keep(self, group: list[Assign]) -> set[int]:
        """The members of a K1 launch whose value can stay on the stack: a
        temporary defined once in the stencil and read only by later
        members, each inside its box and levels (the group already reads
        it only at the point), while every later member still has room on
        the stack above the kept values."""
        stmts = [s for c in self.stencil.computations for s in c.statements]
        boxes = [self.box(s) for s in group]
        spans = [self.levels(s) for s in group]
        needs = [self._need(s.value) for s in group]

        def reads(s: Assign, t: str) -> bool:
            return t in {x.name for x in s.value.accesses()}

        def inside(q: int, a: int) -> bool:
            (j0, j1, i0, i1), (lo, hi) = boxes[a], spans[a]
            qj0, qj1, qi0, qi1 = boxes[q]
            return (lo <= spans[q][0] and spans[q][1] <= hi and j0 <= qj0
                    and qj1 <= j1 and i0 <= qi0 and qi1 <= i1)

        keep: set[int] = set()
        for a, st in enumerate(group):
            t = st.target
            if t not in self.temps or sum(s.target == t for s in stmts) != 1:
                continue
            readers = [q for q, s in enumerate(group) if reads(s, t)]
            if (readers and min(readers) > a
                    and sum(reads(s, t) for s in stmts) == len(readers)
                    and all(inside(q, a) for q in readers)
                    and all(len(keep) + 1 + needs[q] <= KEEP_STACK
                            for q in range(a + 1, len(group)))):
                keep.add(a)
        return keep

    def parallel(self, group: list[Assign]) -> Program:
        """One K1 launch over consecutive PARALLEL statements (a group of
        :func:`parallel_groups`): the records whose box and levels are not
        empty, in order."""
        live = []
        for st in group:
            (j0, j1, i0, i1), (lo, hi) = self.box(st), self.levels(st)
            if hi > lo and j1 > j0 and i1 > i0:
                live.append(st)
        keep = self._keep(live)
        prog, consts, depth, search = self._encode(live, keep)
        boxes = [self.box(st) for st in live] or [(0, 0, 0, 0)]
        spans = [self.levels(st) for st in live] or [(0, 0)]
        return Program("horizontal", Computation(Direction.PARALLEL,
                                                 tuple(group)),
                       prog, consts, depth, search,
                       klo=min(s[0] for s in spans),
                       khi=max(s[1] for s in spans),
                       box=(min(b[0] for b in boxes), max(b[1] for b in boxes),
                            min(b[2] for b in boxes), max(b[3] for b in boxes)),
                       kept=tuple(live[q].target for q in sorted(keep)),
                       n_slots=len(self.slots), n_params=len(self.params))

    def parallel_launches(self, group: list[Assign]) -> list[Program]:
        """The K1 launches of a group of :func:`parallel_groups`: one,
        unless its records, ops and constants pass
        :data:`K1_PROGRAM_BYTES`; then it is cut at statement boundaries,
        each launch the longest run of the statements left that stays
        within it (a statement alone may pass it).  A temporary that a cut
        separates from a later reader is stored, not kept (:meth:`_keep`
        keeps only what its own launch reads)."""
        def size(p: Program) -> int:
            return 4 * (len(p.prog) + len(p.consts))

        out = []
        rest = list(group)
        while rest:
            p = self.parallel(rest)
            n = len(rest)
            if n > 1 and size(p) > K1_PROGRAM_BYTES:
                lo, hi = 1, n - 1  # the longest prefix that fits
                while lo < hi:
                    mid = (lo + hi + 1) // 2
                    if size(self.parallel(rest[:mid])) <= K1_PROGRAM_BYTES:
                        lo = mid
                    else:
                        hi = mid - 1
                n = lo
                p = self.parallel(rest[:n])
            out.append(p)
            rest = rest[n:]
        return out

    def fits(self, p: Program, copy_levels: int = 1) -> Program:
        """``p``, if the card can launch it: its tables and stack within a
        CTA's :data:`SMEM_MAX` of shared memory (K4 with ``copy_levels``
        levels of copies a group) and its slot table and parameters within
        the kernel parameter (:data:`TABLE_LARGE` words); else a
        ValueError."""
        need = p.smem_bytes(copy_levels)
        words = table_words(len(p.prog), p.n_slots, p.n_params,
                            len(p.consts))[0]
        if need > SMEM_MAX or words > TABLE_LARGE:
            raise ValueError(
                f"{self.stencil.name}: a {p.kind} launch of {p.n_slots} "
                f"fields and temporaries, {p.n_params} parameters, a stack of "
                f"{p.stack} and {len(p.prog)} program words takes {need} "
                f"bytes of shared memory a CTA and {8 * words} bytes of "
                f"kernel parameters: more than the {SMEM_MAX // 1024} KB of "
                f"shared memory (and {8 * TABLE_LARGE} bytes of parameters) "
                "a launch has on the card")
        return p

    def column(self, comp: Computation, kind: str = "column",
               levels: tuple[int, int] | None = None) -> Program:
        """One K2 launch (``kind="column"``; K4's, ``"kblocked"``, over all
        statements of a stencil interleaved): the statements at each level
        of the march.  A slot the statements write and read at the
        marching-previous level (``(0, 0, -1)`` forward, ``(0, 0, 1)``
        backward) is read through ``CARRY`` (the first :data:`CARRY_MAX`
        such slots).  A read that no store of the march can change between
        the start of the level (K4: the slab) before and the read
        (:meth:`_ahead_keys`) is read through ``AHEAD``; the table of their
        keys follows the ops.  A binary op of two leaves takes both from
        sources (``src2``) and pushes its value: one op where a push and
        the op were two."""
        _check_column_hazard(comp)
        forward = comp.direction is Direction.FORWARD
        prev = -1 if forward else 1
        written = set(comp.written())
        carried = []
        for st in comp.statements:
            for a in st.value.accesses():
                slot = self.slots[a.name]
                if (a.name in written and a.offset == (0, 0, prev)
                        and slot not in carried
                        and len(carried) < CARRY_MAX):
                    carried.append(slot)
        keys = self._ahead_keys(comp, carried, prev,
                                first=kind == "kblocked")
        prog, consts, depth, search = self._encode(
            comp.statements, carry=carried, prev=prev,
            ahead={k: j for j, k in enumerate(keys)}, pairs=True)
        begin = len(prog)
        prog = prog + [w for key in keys for w in key]
        bounds = [self.levels(st) for st in comp.statements]
        lo, hi = levels or (min(b[0] for b in bounds),
                            max(b[1] for b in bounds))
        return Program(kind, comp, prog, consts, depth, search,
                       box=self.window(), lo=lo, hi=hi, forward=forward,
                       carried=tuple(carried), ahead=(begin, len(prog)),
                       n_slots=len(self.slots), n_params=len(self.params))

    def _ahead_keys(self, comp: Computation, carried, prev: int,
                    first: bool = False) -> list:
        """The ``(slot, di, dj, dk)`` that K2 may copy into shared memory
        at the start of the level before the one that reads them, and K4
        at any level before it (the first :data:`AHEAD_MAX`, in order of
        first read; with ``first``, K4's, those at the marching-previous
        level first): a field or temporary the statements never write, at
        any offset, and a written one at its own level (``dk = 0``) where
        no statement before the reader, at a level the two share, writes
        it (its other reads see stores of the march the copy would miss,
        or are ``CARRY``).  A store writes the marching level only, so no
        store of the march changes such a read's value before its level.
        Reads inside a level search's body are left to ``LOAD``."""
        written = set(comp.written())
        stmts = comp.statements
        spans = [self.levels(st) for st in stmts]

        def reads(e, inside_search=False):
            if isinstance(e, FieldAccess):
                yield e, inside_search
            for c in e.children():
                yield from reads(c, inside_search
                                 or isinstance(e, LevelSearch))

        keys, unsafe = [], set()
        for q, st in enumerate(stmts):
            for e, in_search in reads(st.value):
                key = (self.slots[e.name], *e.offset)
                if key[0] in carried and e.offset == (0, 0, prev):
                    continue
                safe = not in_search and (e.name not in written or (
                    e.offset == (0, 0, 0) and not any(
                        stmts[w].target == e.name
                        and spans[w][0] < spans[q][1]
                        and spans[q][0] < spans[w][1] for w in range(q))))
                if not safe:
                    unsafe.add(key)
                elif key not in keys:
                    keys.append(key)
        keys = [k for k in keys if k not in unsafe]
        if first:
            keys.sort(key=lambda k: k[3] == 0)
        return keys[:AHEAD_MAX]

    def kblocked(self, block_k: int) -> Program:
        """The whole solver stencil as one K4 launch: K2's program over
        every statement of every computation, interleaved per level in
        marching order over all ``nk`` levels, its copies taken up to a
        slab of ``block_k`` levels at a time (``solver_k_blockable`` must
        hold, and ``block_k | nk``).  Every read at the marching-previous
        level must be ``CARRY`` or ``AHEAD``: at the first level the kernel
        reads 0 there (the reference's zeroed carry) through those two
        only, so a stencil that needs more than :data:`CARRY_MAX` carried
        slots or :data:`AHEAD_MAX` such keys is refused
        (:class:`KBlockedTablesFull`; :func:`encode_stencil` then marches
        it whole-column on K2)."""
        st = self.stencil
        nk = self.dom.nk
        if not (solver_k_blockable(st) and 0 < block_k < nk
                and nk % block_k == 0):
            raise ValueError(f"{st.name}: no K-blocked march with "
                             f"block_k={block_k} at nk={nk}")
        forward = any(c.direction is Direction.FORWARD
                      for c in st.computations)
        march = Computation(Direction.FORWARD if forward
                            else Direction.BACKWARD,
                            tuple(s for c in st.computations
                                  for s in c.statements))
        p = self.column(march, kind="kblocked", levels=(0, nk))
        prev = -1 if forward else 1
        for *_, pc, end in p.records():
            for _, _, src, sargs, _, (src2, s2args) in decode(p.prog, pc,
                                                                end):
                for kind, operand in ((src, sargs), (src2, s2args)):
                    if kind == SRC_LOAD and operand[3] == prev:
                        raise KBlockedTablesFull(
                            f"{st.name}: K4 reads the marching-previous "
                            f"level of slot {operand[0]} from memory; its "
                            f"tables hold {CARRY_MAX} carried slots and "
                            f"{AHEAD_MAX} copied keys")
        p.block_k = block_k
        return p


def copy_depth(p: Program) -> int:
    """Levels of a K4 copy group: the slab (``block_k``) up to
    :data:`KB_DEPTH_MAX`, or as many as two groups of copies fit beside the
    tables, the stack, the carry and the column table within
    :data:`KB_SMEM_BUDGET` (at least 1, K2's depth)."""
    level = COLUMNS * COLUMN_BLOCK * 4  # bytes of one key at one level
    nkey = len(p.ahead_keys())
    depth = min(p.block_k, KB_DEPTH_MAX)
    if nkey == 0:
        return depth
    return max(1, min(depth, (KB_SMEM_BUDGET - p.smem_bytes(0))
                      // (2 * nkey * level)))


def kblocked_wanted(stencil: Stencil, dom: DomainSpec,
                    schedule: Schedule | None) -> bool:
    """Whether ``schedule`` K-blocks the vertical solver ``stencil``
    (``kblocked_applies``, as the reference's ``compile_pallas`` decides):
    then the stencil is one K4 launch, where K4's tables allow."""
    return (stencil.is_vertical_solver() and schedule is not None
            and kblocked_applies(stencil, schedule, dom.nk, scratch=True))


def encode_stencil(stencil: Stencil, dom: DomainSpec,
                   schedule: Schedule | None = None) -> list[Program]:
    """The launches of one stencil call, in order: a vertical solver whose
    ``schedule`` K-blocks it (:func:`kblocked_wanted`) is one K4 launch,
    unless K4's carry and copy tables cannot hold its marching-previous
    reads; otherwise each run of consecutive PARALLEL statements is cut
    into K1 launches by :func:`parallel_groups` (and
    :meth:`Encoder.parallel_launches`), and each FORWARD/BACKWARD
    computation is one K2 launch, which computes what K4 would, bit for
    bit.  Raises ValueError for a launch the card cannot hold
    (:meth:`Encoder.fits`)."""
    enc = Encoder(stencil, dom)
    if kblocked_wanted(stencil, dom, schedule):
        try:
            p = enc.kblocked(schedule.block_k)
            return [enc.fits(p, copy_depth(p))]
        except KBlockedTablesFull:
            pass
    out: list[Program] = []
    run: list[Assign] = []
    for comp in stencil.computations:
        if comp.direction is Direction.PARALLEL:
            run += comp.statements
            continue
        out += [p for g in parallel_groups(run)
                for p in enc.parallel_launches(g)]
        run = []
        out.append(enc.column(comp))
    out += [p for g in parallel_groups(run) for p in enc.parallel_launches(g)]
    return [enc.fits(p) for p in out]


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")


def source_path(name: str = "stencil_kernels") -> Path:
    return Path(__file__).resolve().parents[2] / "csrc" / f"{name}.cu"


def build_root() -> Path:
    """``build/repro_torch`` at the repository root (git-ignored)."""
    return Path(__file__).resolve().parents[4] / "build" / "repro_torch"


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the kernels build with the CUDA toolkit on "
            "the machine that has the card")
    return found


def build_library(name: str = "stencil_kernels") -> Path:
    """Compile ``csrc/<name>.cu`` once per source/flag hash into its own
    directory; the ``nvcc`` output (``-Xptxas -v``: registers, spills) goes
    to ``build.log`` beside the library.  Builds of different sources may
    run at the same time."""
    src = source_path(name)
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_root() / f"{name}-{key}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{name}.{os.getpid()}.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, timeout=900)
    (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


_LIB: ctypes.CDLL | None = None


def bind_library(path: Path | str) -> ctypes.CDLL:
    """Load a build of the kernel source and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    for name in ("launch_stencil_parallel", "launch_stencil_column",
                 "launch_stencil_kblocked"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(LaunchHeader), ctypes.c_char_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.stencil_header_size.argtypes = []
    lib.stencil_header_size.restype = ctypes.c_int
    lib.stencil_table_words.argtypes = [ctypes.c_int] * 4
    lib.stencil_table_words.restype = ctypes.c_int
    lib.stencil_error_string.argtypes = [ctypes.c_int]
    lib.stencil_error_string.restype = ctypes.c_char_p
    lib.stencil_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.stencil_limits.restype = ctypes.c_int
    got = lib.stencil_header_size()
    if got != ctypes.sizeof(LaunchHeader):
        raise RuntimeError(f"LaunchHeader is {got} bytes in the library but "
                           f"{ctypes.sizeof(LaunchHeader)} in cuda.py")
    limits = (ctypes.c_int * 14)()
    lib.stencil_limits(limits)
    want = (REC_INTS, OPW, OP_SHIFT, SRC_SHIFT, SRC2_SHIFT, STRIP, K1_BLOCK,
            CARRY_MAX, AHEAD_MAX, COLUMNS, COLUMN_BLOCK, SMEM_MAX,
            TABLE_SMALL, TABLE_LARGE)
    if tuple(limits) != want:
        raise RuntimeError(f"kernel limits {tuple(limits)} disagree with "
                           f"cuda.py's {want}")
    for counts in ((1, 1, 0, 0), (1024, 64, 16, 256), (7, 3, 5, 1)):
        got = lib.stencil_table_words(*counts)
        if got != table_words(*counts)[1]:
            raise RuntimeError(f"the library lays out the tables of "
                               f"{counts} in {got} words, cuda.py in "
                               f"{table_words(*counts)[1]}")
    return lib


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' shared library."""
    global _LIB
    if _LIB is None:
        _LIB = bind_library(build_library())
    return _LIB


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


#: K1 threads a launch aims at: a thread walks a column's levels in
#: strips, and the column is cut into K spans until the launch has this
#: many threads, enough to fill 132 SMs several times over
K1_THREADS = 1 << 20


def k1_span(p: Program, columns_per_plane: int) -> int:
    """Levels of a column one K1 thread walks: a multiple of the strip."""
    j0, j1, i0, i1 = p.box
    columns = max(1, columns_per_plane * (j1 - j0) * (i1 - i0))
    strips = -(-(p.khi - p.klo) // p.strip)
    cuts = min(strips, max(1, -(-K1_THREADS // columns)))
    return p.strip * -(-strips // cuts)


def _member_stride(name: str, x: torch.Tensor, members: bool) -> int:
    """Elements between members of ``x`` (dim 0 when ``members``; 0 for a
    field broadcast across members), after checking that the rest of ``x``
    is contiguous, as the kernels index it."""
    want = 1
    for d in range(x.dim() - 1, 0 if members else -1, -1):
        if x.shape[d] != 1 and x.stride(d) != want:
            raise ValueError(
                f"field {name!r} must be contiguous"
                + (" within each member" if members else ""))
        want *= x.shape[d]
    return x.stride(0) if members and x.shape[0] > 1 else 0


class CudaStencil:
    """One stencil compiled onto the kernels: ``fn(fields, params) -> dict``
    of the written fields.  Fields are f32 tensors ``(..., K, J, I)``; the
    leading dims (the tile axis) become a launch-grid dimension.

    With ``n_members=M`` the first dim is an ensemble's member axis, of
    extent M (K5): members may lie at any stride, 0 for a field broadcast
    across members, but each member's block must be contiguous.  Each
    thread runs ``member_chunk`` members, which must divide M.

    ``schedule`` is the node's schedule; a vertical solver that it K-blocks
    runs as one K4 launch (``kblocked``)."""

    def __init__(self, stencil: Stencil, dom: DomainSpec, *,
                 schedule: Schedule | None = None,
                 dtype=torch.float32, n_members: int | None = None,
                 member_chunk: int = 1):
        if dtype != torch.float32:
            raise TypeError(f"the stencil kernels take float32, not {dtype}")
        if n_members is not None and (member_chunk < 1
                                      or n_members % member_chunk):
            raise ValueError(f"member_chunk={member_chunk} must divide "
                             f"n_members={n_members} (callers pad the "
                             "member axis)")
        self.dom = dom
        self.n_members = n_members
        self.member_chunk = member_chunk
        # horizontal stencils get the Pallas kernel's offset-temp inlining;
        # solver stencils keep their temporaries in memory, as the
        # reference's vertical kernel does
        self.stencil = (stencil if stencil.is_vertical_solver()
                        else inline_offset_temps(stencil))
        self.written = [w for w in self.stencil.written()
                        if w in self.stencil.fields]
        self.programs = encode_stencil(self.stencil, dom, schedule)
        #: a K-blocked solver that K4's tables refused, marching on K2
        self.kblocked_refused = kblocked_wanted(
            self.stencil, dom, schedule) and not any(
                p.kind == "kblocked" for p in self.programs)
        self.slot_names = slot_names(self.stencil)
        #: each launch's carry index of every slot (-1: not carried), the
        #: part of its table between the field table and the parameters
        self._carry_tables = [
            struct.pack(f"<{len(self.slot_names)}i", *(
                p.carried.index(s) if s in p.carried else -1
                for s in range(len(self.slot_names))))
            for p in self.programs]
        self._uploaded: dict[torch.device, list] = {}
        #: the kernels' plain version on any device: the plain lowering of
        #: the same (inlined) stencil, statement by statement
        self.plain = plain.compile_torch(self.stencil, dom)

    # -- checks ---------------------------------------------------------------
    def _device_of(self, fields: Mapping[str, Any]) -> torch.device:
        st = self.stencil
        lead = None
        device = None
        h = self.dom.halo
        plane = (self.dom.nj + 2 * h, self.dom.ni + 2 * h)
        for f in st.fields:
            if f not in fields:
                raise KeyError(f"{st.name}: missing field {f!r}")
            x = fields[f]
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"{st.name}: field {f!r} is not a tensor")
            want = (st.k_extent_of(f, self.dom.nk),) + plane
            if x.dim() < 3 or tuple(x.shape[-3:]) != want:
                raise ValueError(f"{st.name}: field {f!r} has shape "
                                 f"{tuple(x.shape)}, expected (..., "
                                 f"{want[0]}, {want[1]}, {want[2]})")
            if self.n_members is not None and (
                    x.dim() < 4 or x.shape[0] != self.n_members):
                raise ValueError(f"{st.name}: field {f!r} has shape "
                                 f"{tuple(x.shape)}; its member axis (dim "
                                 f"0) should hold {self.n_members} members")
            if lead is None:
                lead, device = tuple(x.shape[:-3]), x.device
            elif tuple(x.shape[:-3]) != lead or x.device != device:
                raise ValueError(f"{st.name}: fields disagree in leading "
                                 "dims or device")
        return device

    # -- the kernels ----------------------------------------------------------
    def __call__(self, fields: Mapping[str, torch.Tensor],
                 params: Mapping[str, Any] | None = None) -> dict:
        device = self._device_of(fields)
        if device.type == "cpu":
            return self.plain(fields, params)
        if device.type != "cuda":
            raise ValueError(f"{self.stencil.name}: no kernels for "
                             f"device {device}")
        for f in self.stencil.fields:
            if fields[f].dtype != torch.float32:
                raise ValueError(f"{self.stencil.name}: field {f!r} must be "
                                 "float32")
        from ...kernels import library as kernel_library

        env = self._env(fields)
        kernel_library.launch(None, self.launch, None, device.index, env,
                              dict(params or {}), load_library())
        return {w: env[w] for w in self.written}

    def _env(self, fields: Mapping[str, torch.Tensor]) -> dict:
        """The launches' working set, as the plain version's
        (``prepare_env``), except that a temporary every launch keeps on
        the stack is never allocated: its slot points at one element that
        no load or store reaches."""
        kept = {t for p in self.programs for t in p.kept}
        env = {f: fields[f] for f in self.stencil.fields}
        for w in self.stencil.written():
            if w in env:
                env[w] = env[w].clone()
        some = env[self.stencil.fields[0]]
        lead = tuple(some.shape[:-3])
        for t in self.stencil.temporaries():
            shape = (lead + (1, 1, 1) if t in kept else lead +
                     self.dom.padded_shape(self.stencil.is_interface(t)))
            env[t] = (torch.empty if t in kept else torch.zeros)(
                shape, dtype=torch.float32, device=some.device)
        return env

    def _device_programs(self, device: torch.device) -> list:
        progs = self._uploaded.get(device)
        if progs is None:
            progs = [(torch.tensor(p.prog, dtype=torch.int32, device=device),
                      torch.tensor(p.consts or [0.0], dtype=torch.float32,
                                   device=device))
                     for p in self.programs]
            self._uploaded[device] = progs
        return progs

    def launch_args(self, env: Mapping[str, torch.Tensor],
                    params: Mapping[str, Any]) -> LaunchHeader:
        """What every launch of the stencil shares: the member, tile and
        plane extents of the grid in the header, and the field table
        (``ptr``, ``mstride``, ``kext``: pointer, member stride, K extent
        per slot) and the parameters (``params``), packed as the launch's
        table lays them out around each program's carry indices (``head``,
        ``tail``)."""
        members = self.n_members is not None
        tensors = [env[n] for n in self.slot_names]
        some = tensors[0]
        args = LaunchHeader()
        args.ptr = [x.data_ptr() for x in tensors]
        args.mstride = [_member_stride(name, x, members)
                        for name, x in zip(self.slot_names, tensors)]
        args.kext = [x.shape[-3] for x in tensors]
        args.params = [float(params[p]) for p in self.stencil.params]
        n, m = len(tensors), len(args.params)
        args.head = struct.pack(f"<{n}Q{n}q{n}i", *args.ptr, *args.mstride,
                                *args.kext)
        args.tail = struct.pack(f"<{m}f{4 * (m & 1)}x", *args.params)
        args.n_slots, args.n_params = n, m
        args.ntile = math.prod(some.shape[1 if members else 0:-3])
        args.nmember = self.n_members or 1
        args.mchunk = self.member_chunk
        args.jp, args.ip = some.shape[-2], some.shape[-1]
        return args

    def launch(self, env: Mapping[str, torch.Tensor],
               params: Mapping[str, Any], lib: ctypes.CDLL,
               stream: int) -> None:
        """Launch every program of the stencil, in order, on ``stream``."""
        args = self.launch_args(env, params)
        device = env[self.slot_names[0]].device
        for p, (prog, consts), cidx in zip(
                self.programs, self._device_programs(device),
                self._carry_tables):
            if p.empty:
                continue
            args.prog, args.consts = prog.data_ptr(), consts.data_ptr()
            args.n_prog, args.n_consts = len(p.prog), len(p.consts)
            args.j0, args.j1, args.i0, args.i1 = p.box
            args.depth = max(1, p.stack)
            table = args.head + cidx + args.tail
            if p.kind == "horizontal":
                args.klo, args.khi = p.klo, p.khi
                args.kspan = k1_span(p, args.nmember // args.mchunk
                                     * args.ntile)
                rc = lib.launch_stencil_parallel(ctypes.byref(args), table,
                                                 stream)
            else:
                args.lo, args.hi, args.forward = p.lo, p.hi, int(p.forward)
                args.n_carried = len(p.carried)
                args.ahead_begin, args.ahead_end = p.ahead
                args.bk = copy_depth(p) if p.block_k else 1
                launch = (lib.launch_stencil_kblocked if p.kind == "kblocked"
                          else lib.launch_stencil_column)
                rc = launch(ctypes.byref(args), table, stream)
            if rc != 0:
                raise RuntimeError(
                    f"{self.stencil.name}: {p.kind} kernel launch failed: "
                    f"{lib.stencil_error_string(rc).decode()}")
            LAUNCHES[p.kind] += 1
            if p.has_search:
                LAUNCHES["search"] += 1
            if args.nmember > 1:  # the kernels' member axis ran
                LAUNCHES["member"] += 1
