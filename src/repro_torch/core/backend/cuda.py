"""The CUDA kernels of the stencil IR: encoder, build and wrappers.

Three hand-written kernels in ``csrc/stencil_kernels.cu`` run every
stencil of the opt-0 path; they port the reference's Pallas kernels
(``src/repro/core/backend/lowering_pallas.py``):

 * ``stencil_parallel_kernel`` (K1, ``_horizontal_kernel``) — one PARALLEL
   statement, one thread per ``(tile, k, j, i)`` point of its write window;
 * ``stencil_column_kernel`` (K2, ``_vertical_kernel``) — one FORWARD or
   BACKWARD computation, one thread per ``(tile, j, i)`` column marching K;
 * ``march_search`` (K3, ``_march_search``) — the ``index_search`` level
   search, a device function both kernels call for the ``SEARCH`` op;
 * their member axis (K5, ``_member_index_map``/``_member_specs``) — an
   ensemble's members in one launch, one member (``"grid"``) or a chunk of
   members (``"vmap:C,grid"``) per thread, with a per-slot member stride
   that is 0 for a field broadcast across members.

The kernels interpret the IR: this module encodes each statement into a
postfix program of int32 ops with a float32 constant table (see the opcode
table below, mirrored in the CUDA source), and the wrapper launches the
kernels with the program, a field table (pointer and K extent per slot) and
the scalar parameters.  Expressions built from constants only are folded in
double precision at encode time, as the plain lowering computes them.

The source builds at first use with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (loaded with :mod:`ctypes`), in
``build/repro_torch/<hash of source and flags>/`` under the repository
(:func:`build_library` builds any named source of ``csrc/`` that way).

A wrapper takes the plain version (:mod:`.lowering_torch`) only for tensors
on the CPU; for CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

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
from . import lowering_torch as plain

# -- the kernels' ABI (keep in sync with csrc/stencil_kernels.cu) ------------

MAX_SLOTS = 32
MAX_PARAMS = 16
PROG_MAX = 1024
CONST_MAX = 256
STACK_MAX = 16
FOUND_MAX = 8
REC_INTS = 9

OP_LOAD, OP_CONST, OP_PARAM, OP_FOUND, OP_SEARCH = 1, 2, 3, 4, 5
UNARY_OPS = {"neg": 10, "sqrt": 11, "abs": 12, "exp": 13, "log": 14,
             "sign": 15, "floor": 16}
BINARY_OPS = {"+": 20, "-": 21, "*": 22, "/": 23, "<": 24, "<=": 25,
              ">": 26, ">=": 27, "==": 28, "!=": 29}
OP_MIN, OP_MAX, OP_POW = 30, 31, 32
OP_WHERE = 40


class LaunchArgs(ctypes.Structure):
    """Mirror of ``struct LaunchArgs`` in the CUDA source (by-value kernel
    argument; the loader checks the two sizes agree)."""

    _fields_ = [
        ("ptr", ctypes.c_void_p * MAX_SLOTS),
        ("mstride", ctypes.c_longlong * MAX_SLOTS),
        ("kext", ctypes.c_int * MAX_SLOTS),
        ("params", ctypes.c_float * MAX_PARAMS),
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
        ("j0", ctypes.c_int),
        ("j1", ctypes.c_int),
        ("i0", ctypes.c_int),
        ("i1", ctypes.c_int),
        ("lo", ctypes.c_int),
        ("hi", ctypes.c_int),
        ("forward", ctypes.c_int),
        ("nmember", ctypes.c_int),
        ("mchunk", ctypes.c_int),
    ]


#: launches of each kernel since the last :func:`reset_launches`; a wrapper
#: adds one where it launches its kernel and nowhere else ("search" counts
#: the K1/K2 launches whose program runs the K3 level search, "member" the
#: K1/K2 launches over more than one member, which take the member axis, K5)
LAUNCHES = {"horizontal": 0, "column": 0, "search": 0, "member": 0}


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


def _check_parallel_hazard(st: Assign) -> None:
    """One K1 launch writes the target while every thread reads: a read of
    the target anywhere but the thread's own point is a race."""
    for e in _walk(st.value):
        bad = ((isinstance(e, FieldAccess) and e.name == st.target
                and e.offset != (0, 0, 0))
               or (isinstance(e, FoundLevel) and e.name == st.target)
               or (isinstance(e, LevelSearch) and e.coord == st.target))
        if bad:
            raise NotImplementedError(
                f"statement {st} reads its own target away from the point "
                "it writes; one launch cannot order those reads")


def _check_column_hazard(comp: Computation) -> None:
    """K2 threads own columns: a read, at a horizontal offset, of a field
    the same computation writes would see a neighbour column mid-march."""
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


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Program:
    """One launch: the statement records and ops, the constant table, and
    the IR it was encoded from (which the plain version runs)."""

    kind: str                     # "horizontal" (K1) | "column" (K2)
    ir: Assign | Computation
    prog: list[int]
    consts: list[float]
    stack: int                    # deepest stack the ops reach
    has_search: bool
    klo: int = 0                  # K1: interval and box
    khi: int = 0
    box: tuple[int, int, int, int] = (0, 0, 0, 0)
    lo: int = 0                   # K2: march
    hi: int = 0
    forward: bool = True

    @property
    def empty(self) -> bool:
        j0, j1, i0, i1 = self.box
        if self.kind == "column":
            return self.hi <= self.lo or j1 <= j0 or i1 <= i0
        return self.khi <= self.klo or j1 <= j0 or i1 <= i0


def slot_names(stencil: Stencil) -> list[str]:
    """The field table of a launch: the stencil's fields, then its
    temporaries; a LOAD names a field by its index here."""
    return list(stencil.fields) + list(stencil.temporaries())


class Encoder:
    """Encodes the statements of one stencil against its slot table."""

    def __init__(self, stencil: Stencil, dom: DomainSpec):
        self.stencil = stencil
        self.dom = dom
        names = slot_names(stencil)
        if len(names) > MAX_SLOTS:
            raise ValueError(f"{stencil.name}: {len(names)} fields and "
                             f"temporaries exceed the kernels' {MAX_SLOTS}")
        if len(stencil.params) > MAX_PARAMS:
            raise ValueError(f"{stencil.name}: more than {MAX_PARAMS} params")
        self.slots = {n: i for i, n in enumerate(names)}
        self.params = {p: i for i, p in enumerate(stencil.params)}
        h = dom.halo
        self.jp, self.ip = dom.nj + 2 * h, dom.ni + 2 * h

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

    def _check_reach(self, name: str, di: int, dj: int) -> None:
        j0, j1, i0, i1 = self.window()
        if j0 + dj < 0 or j1 + dj > self.jp or i0 + di < 0 or i1 + di > self.ip:
            raise ValueError(
                f"{self.stencil.name}: read of {name!r} at offset {(di, dj)} "
                "reaches outside the allocation; widen the halo")

    # -- expressions ------------------------------------------------------------
    def _push(self) -> None:
        self._sp += 1
        self._max = max(self._max, self._sp)

    def _const(self, v) -> int:
        v = float(v)
        key = struct.pack("<f", v)  # one slot per f32 value (0.0 != -0.0)
        if key not in self._cidx:
            if len(self._consts) >= CONST_MAX:
                raise ValueError(f"{self.stencil.name}: constant table full")
            self._cidx[key] = len(self._consts)
            self._consts.append(v)
        return self._cidx[key]

    def _expr(self, e: Expr, found: dict | None) -> None:
        v = plain.fold_const(e)
        if v is not None:
            self._ops += [OP_CONST, self._const(v)]
            self._push()
            return
        if isinstance(e, ParamRef):
            self._ops += [OP_PARAM, self.params[e.name]]
            self._push()
        elif isinstance(e, FieldAccess):
            di, dj, dk = e.offset
            self._check_reach(e.name, di, dj)
            self._ops += [OP_LOAD, self.slots[e.name], di, dj, dk]
            self._push()
        elif isinstance(e, FoundLevel):
            if found is None:
                raise TypeError("FoundLevel outside a LevelSearch body")
            self._ops += [OP_FOUND, found[e]]
            self._push()
        elif isinstance(e, LevelSearch):
            self._search(e)
        elif isinstance(e, (BinOp, Min, Max, Pow)):
            self._expr(e.children()[0], found)
            self._expr(e.children()[1], found)
            op = (BINARY_OPS[e.op] if isinstance(e, BinOp) else
                  OP_MIN if isinstance(e, Min) else
                  OP_MAX if isinstance(e, Max) else OP_POW)
            self._ops.append(op)
            self._sp -= 1
        elif isinstance(e, UnaryOp):
            self._expr(e.a, found)
            self._ops.append(UNARY_OPS[e.op])
        elif isinstance(e, Where):
            for c in e.children():
                self._expr(c, found)
            self._ops.append(OP_WHERE)
            self._sp -= 2
        else:
            raise TypeError(f"cannot encode {e!r}")

    def _search(self, e: LevelSearch) -> None:
        self._expr(e.target, None)
        finds = e.found_levels()
        if len(finds) > FOUND_MAX:
            raise ValueError(f"{self.stencil.name}: more than {FOUND_MAX} "
                             "at_found reads in one search")
        lo, hi = e.resolve_bounds(self.dom.nk)
        self._ops += [OP_SEARCH, self.slots[e.coord], lo, hi, len(finds)]
        for fl in finds:
            self._check_reach(fl.name, fl.di, fl.dj)
            self._ops += [self.slots[fl.name], fl.di, fl.dj, fl.dk]
        self._sp -= 1  # the target
        self._has_search = True
        self._expr(e.body, {fl: n for n, fl in enumerate(finds)})

    # -- launches -----------------------------------------------------------------
    def _encode(self, statements) -> tuple[list[int], list[float], int, bool]:
        """Records + ops of ``statements`` (each with its box and interval)."""
        self._consts: list[float] = []
        self._cidx: dict = {}
        self._max = 0
        self._has_search = False
        header = [len(statements)]
        body: list[int] = []
        base = 1 + REC_INTS * len(statements)
        for st in statements:
            self._ops: list[int] = []
            self._sp = 0
            self._expr(st.value, None)
            if self._sp != 1:
                raise AssertionError(f"unbalanced stack encoding {st}")
            klo, khi = st.interval.resolve(
                self.stencil.k_extent_of(st.target, self.dom.nk))
            begin = base + len(body)
            body += self._ops
            header += [self.slots[st.target], klo, khi, *self.box(st),
                       begin, base + len(body)]
        if self._max > STACK_MAX:
            raise ValueError(
                f"{self.stencil.name}: expression needs a stack of "
                f"{self._max}, deeper than the kernels' {STACK_MAX}")
        prog = header + body
        if len(prog) > PROG_MAX:
            raise ValueError(f"{self.stencil.name}: program of {len(prog)} "
                             f"ints exceeds the kernels' {PROG_MAX}")
        return prog, list(self._consts), self._max, self._has_search

    def parallel(self, st: Assign) -> Program:
        _check_parallel_hazard(st)
        prog, consts, depth, search = self._encode([st])
        klo, khi = st.interval.resolve(
            self.stencil.k_extent_of(st.target, self.dom.nk))
        return Program("horizontal", st, prog, consts, depth, search,
                       klo=klo, khi=khi, box=self.box(st))

    def column(self, comp: Computation) -> Program:
        _check_column_hazard(comp)
        prog, consts, depth, search = self._encode(comp.statements)
        bounds = [st.interval.resolve(
            self.stencil.k_extent_of(st.target, self.dom.nk))
            for st in comp.statements]
        return Program("column", comp, prog, consts, depth, search,
                       box=self.window(),
                       lo=min(b[0] for b in bounds),
                       hi=max(b[1] for b in bounds),
                       forward=comp.direction is Direction.FORWARD)


def encode_stencil(stencil: Stencil, dom: DomainSpec) -> list[Program]:
    """The launches of one stencil call, in order: each PARALLEL statement
    is one K1 launch, each FORWARD/BACKWARD computation one K2 launch."""
    enc = Encoder(stencil, dom)
    out = []
    for comp in stencil.computations:
        if comp.direction is Direction.PARALLEL:
            out += [enc.parallel(st) for st in comp.statements]
        else:
            out.append(enc.column(comp))
    return out


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
    for name in ("launch_stencil_parallel", "launch_stencil_column"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(LaunchArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.stencil_launch_args_size.argtypes = []
    lib.stencil_launch_args_size.restype = ctypes.c_int
    lib.stencil_error_string.argtypes = [ctypes.c_int]
    lib.stencil_error_string.restype = ctypes.c_char_p
    lib.stencil_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.stencil_limits.restype = ctypes.c_int
    got = lib.stencil_launch_args_size()
    if got != ctypes.sizeof(LaunchArgs):
        raise RuntimeError(f"LaunchArgs is {got} bytes in the library but "
                           f"{ctypes.sizeof(LaunchArgs)} in cuda.py")
    limits = (ctypes.c_int * 7)()
    lib.stencil_limits(limits)
    want = (MAX_SLOTS, MAX_PARAMS, PROG_MAX, CONST_MAX, STACK_MAX, FOUND_MAX,
            REC_INTS)
    if tuple(limits) != want:
        raise RuntimeError(f"kernel limits {tuple(limits)} disagree with "
                           f"cuda.py's {want}")
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
    thread runs ``member_chunk`` members, which must divide M."""

    def __init__(self, stencil: Stencil, dom: DomainSpec, *,
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
        self.programs = encode_stencil(self.stencil, dom)
        self.slot_names = slot_names(self.stencil)
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
        params = dict(params or {})
        env = plain.prepare_env(self.stencil, self.dom, fields,
                                torch.float32)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            self.launch(env, params, load_library(), stream)
        return {w: env[w] for w in self.written}

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
                    params: Mapping[str, Any]) -> LaunchArgs:
        """What every launch of the stencil shares: the field table (pointer,
        member stride, K extent per slot), the parameters, and the member,
        tile and plane extents of the grid."""
        members = self.n_members is not None
        tensors = [env[n] for n in self.slot_names]
        some = tensors[0]
        args = LaunchArgs()
        for s, (name, x) in enumerate(zip(self.slot_names, tensors)):
            args.ptr[s] = x.data_ptr()
            args.mstride[s] = _member_stride(name, x, members)
            args.kext[s] = x.shape[-3]
        for i, p in enumerate(self.stencil.params):
            args.params[i] = float(params[p])
        args.n_slots = len(tensors)
        args.n_params = len(self.stencil.params)
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
        for p, (prog, consts) in zip(self.programs,
                                     self._device_programs(device)):
            if p.empty:
                continue
            args.prog, args.consts = prog.data_ptr(), consts.data_ptr()
            args.n_prog, args.n_consts = len(p.prog), len(p.consts)
            args.j0, args.j1, args.i0, args.i1 = p.box
            if p.kind == "horizontal":
                args.klo, args.khi = p.klo, p.khi
                rc = lib.launch_stencil_parallel(ctypes.byref(args), stream)
            else:
                args.lo, args.hi, args.forward = p.lo, p.hi, int(p.forward)
                rc = lib.launch_stencil_column(ctypes.byref(args), stream)
            if rc != 0:
                raise RuntimeError(
                    f"{self.stencil.name}: {p.kind} kernel launch failed: "
                    f"{lib.stencil_error_string(rc).decode()}")
            LAUNCHES[p.kind] += 1
            if p.has_search:
                LAUNCHES["search"] += 1
            if args.nmember > 1:  # the kernels' member axis ran
                LAUNCHES["member"] += 1
