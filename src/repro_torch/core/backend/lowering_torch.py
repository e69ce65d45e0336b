"""Plain PyTorch lowering of Stencil IR — the oracle backend of the port.

This is the counterpart of the reference's jnp lowering, and it is the
*plain version* every CUDA kernel of :mod:`.cuda` is held against: the
kernel wrappers run it for tensors that lie on the CPU, and the CPU tests
run it against the reference package.

Array convention: fields are stored ``(..., K, J, I)`` — I contiguous, the
paper's FORTRAN layout (§VI-A.3).  Leading dimensions (the cubed-sphere
tile axis) ride through every operation, so one call steps all six tiles.
Horizontal allocations carry ``halo`` ghost cells per side; K is allocated
exactly, ``nk + 1`` levels for K-interface fields.

Semantics follow the jnp oracle statement for statement:

 * PARALLEL statements are evaluated on the (extended) write window over
   their target's resolved interval, then written, masked by their region;
 * K-shifted reads are edge-clamped into the field's K extent (in-range
   reads are plain slices; stencil intervals keep FV3's reads in range);
 * FORWARD/BACKWARD computations loop over K in Python, re-reading earlier
   levels from memory, with per-level reads clamped like
   ``jax.lax.dynamic_index_in_dim``;
 * a :class:`LevelSearch` bisects the coordinate column (O(log nk) gathers).

Updates are in place on tensors the runner owns: written inputs are cloned
first, temporaries are fresh zero tensors.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping

import torch

from ..stencil.domain import DomainSpec
from ..stencil.ir import (
    Assign,
    BinOp,
    Computation,
    Const,
    Direction,
    Expr,
    FieldAccess,
    FoundLevel,
    LevelSearch,
    Max,
    Min,
    ParamRef,
    Pow,
    Region,
    Stencil,
    UnaryOp,
    Where,
)

Value = Any  # a torch.Tensor or a Python scalar

_UNARY_T = {
    "neg": torch.neg,
    "sqrt": torch.sqrt,
    "abs": torch.abs,
    "exp": torch.exp,
    "log": torch.log,
    "sign": torch.sign,
    "floor": torch.floor,
}

_UNARY_S = {
    "neg": lambda x: -x,
    "sqrt": math.sqrt,
    "abs": abs,
    "exp": math.exp,
    "log": math.log,
    "sign": lambda x: float((x > 0) - (x < 0)),
    "floor": math.floor,
}

_BIN = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}


def _is_t(x: Value) -> bool:
    return isinstance(x, torch.Tensor)


def unary(op: str, x: Value) -> Value:
    return _UNARY_T[op](x) if _is_t(x) else _UNARY_S[op](x)


def binary(op: str, a: Value, b: Value) -> Value:
    return _BIN[op](a, b)


def minimum(a: Value, b: Value) -> Value:
    if _is_t(a) and _is_t(b):
        return torch.minimum(a, b)
    if _is_t(a):
        return torch.clamp_max(a, b)
    if _is_t(b):
        return torch.clamp_max(b, a)
    return min(a, b)


def maximum(a: Value, b: Value) -> Value:
    if _is_t(a) and _is_t(b):
        return torch.maximum(a, b)
    if _is_t(a):
        return torch.clamp_min(a, b)
    if _is_t(b):
        return torch.clamp_min(b, a)
    return max(a, b)


def power(a: Value, b: Value) -> Value:
    if _is_t(a) or _is_t(b):
        return torch.pow(a, b)
    return a ** b


def where(c: Value, a: Value, b: Value) -> Value:
    if not _is_t(c):
        return a if c else b
    return torch.where(c, a, b)


def fold_const(e: Expr) -> Value | None:
    """Value of an expression built from constants only (Python floats, in
    double precision like every scalar of this lowering), else None."""
    if isinstance(e, Const):
        return e.value
    if isinstance(e, (FieldAccess, ParamRef, LevelSearch, FoundLevel)):
        return None
    kids = [fold_const(c) for c in e.children()]
    if any(k is None for k in kids):
        return None
    return _apply(e, kids)


def _apply(e: Expr, v: list) -> Value:
    """Apply the operator of ``e`` to its evaluated children ``v``."""
    if isinstance(e, BinOp):
        return binary(e.op, v[0], v[1])
    if isinstance(e, UnaryOp):
        return unary(e.op, v[0])
    if isinstance(e, Pow):
        return power(v[0], v[1])
    if isinstance(e, Where):
        return where(v[0], v[1], v[2])
    if isinstance(e, Min):
        return minimum(v[0], v[1])
    if isinstance(e, Max):
        return maximum(v[0], v[1])
    raise TypeError(f"cannot lower {e!r}")


def evaluate(e: Expr, read: Callable, params: Mapping[str, Any],
             search: Callable | None = None, found=None) -> Value:
    """Evaluate an expression: ``read(name, offset)`` yields field windows,
    ``search(e, ev)`` lowers a :class:`LevelSearch`, ``found`` resolves
    :class:`FoundLevel` accesses inside a search body."""
    def ev(x: Expr, found=found) -> Value:
        return evaluate(x, read, params, search, found)

    if isinstance(e, Const):
        return e.value
    if isinstance(e, ParamRef):
        return params[e.name]
    if isinstance(e, FieldAccess):
        return read(e.name, e.offset)
    if isinstance(e, LevelSearch):
        if search is None:
            raise TypeError("LevelSearch needs whole-column reads")
        return search(e, ev)
    if isinstance(e, FoundLevel):
        if found is None:
            raise TypeError("FoundLevel outside a LevelSearch body")
        return found(e)
    return _apply(e, [ev(c) for c in e.children()])


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------


def hwindow(dom: DomainSpec, di: int, dj: int) -> tuple[slice, slice]:
    """(j, i) slices of the extended write window shifted by an offset."""
    ei, ej = dom.extend
    h = dom.halo
    return (slice(h - ej + dj, h + dom.nj + ej + dj),
            slice(h - ei + di, h + dom.ni + ei + di))


def krows(arr: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows ``lo..hi-1`` of axis -3, edge-clamped into the array's extent."""
    K = arr.shape[-3]
    if 0 <= lo and hi <= K:
        return arr[..., lo:hi, :, :]
    idx = torch.arange(lo, hi, device=arr.device).clamp_(0, K - 1)
    return arr.index_select(-3, idx)


def region_mask(region: Region, dom: DomainSpec,
                device: torch.device) -> torch.Tensor:
    """(nj_w, ni_w) mask of the region within the extended write window."""
    ei, ej = dom.extend
    ilo, ihi, jlo, jhi = region.resolve(dom.ni, dom.nj)
    ii = torch.arange(-ei, dom.ni + ei, device=device)
    jj = torch.arange(-ej, dom.nj + ej, device=device)
    mi = (ii >= ilo) & (ii < ihi)
    mj = (jj >= jlo) & (jj < jhi)
    return mj[:, None] & mi[None, :]


def bisect_levels(cwin: torch.Tensor, target: torch.Tensor, lo: int,
                  hi: int) -> torch.Tensor:
    """Largest layer ``s`` in ``[lo, hi-1]`` with ``s == lo`` or
    ``cwin[s] <= target`` — the LevelSearch selection rule — by bisection
    over a monotone column: ceil(log2(hi - lo)) gathers.

    ``cwin`` is ``(..., K_c, J, I)``; ``target`` broadcasts against its
    planes with a K axis of its own (rows, or 1 per solver level); returns
    int64 layer indices of the broadcast shape."""
    shape = torch.broadcast_shapes(
        target.shape, cwin.shape[:-3] + (1,) + cwin.shape[-2:])
    lo_a = torch.full(shape, lo, dtype=torch.int64, device=cwin.device)
    n = hi - lo
    if n <= 1:
        return lo_a
    hi_a = torch.full(shape, hi - 1, dtype=torch.int64, device=cwin.device)
    kc = cwin.shape[-3]
    cexp = cwin.expand(shape[:-3] + (kc,) + shape[-2:])
    tgt = target.expand(shape)
    for _ in range(int(math.ceil(math.log2(n)))):
        mid = torch.div(lo_a + hi_a + 1, 2, rounding_mode="floor")
        cm = torch.gather(cexp, -3, mid.clamp(0, kc - 1))
        take = cm <= tgt
        lo_a = torch.where(take, mid, lo_a)
        hi_a = torch.where(take, hi_a, mid - 1)
    return lo_a


def make_search(env: Mapping[str, Any], dom: DomainSpec, per_level: bool):
    """Lower a LevelSearch: bisect the coordinate column, then evaluate the
    body with FoundLevel reads gathered at the selected layer (clamped into
    the field's K extent).  ``per_level`` marks solver evaluation, where the
    target is one plane per level."""
    def column(name: str, di: int, dj: int) -> torch.Tensor:
        jsl, isl = hwindow(dom, di, dj)
        return env[name][..., :, jsl, isl]

    def search(e: LevelSearch, ev: Callable) -> Value:
        cwin = column(e.coord, 0, 0)
        target = ev(e.target)
        if not _is_t(target):
            target = torch.tensor(target, dtype=cwin.dtype, device=cwin.device)
        if per_level:
            target = target.unsqueeze(-3)
        lo, hi = e.resolve_bounds(dom.nk)
        idx = bisect_levels(cwin, target, lo, hi)

        def found(fl: FoundLevel) -> torch.Tensor:
            win = column(fl.name, fl.di, fl.dj)
            kf = win.shape[-3]
            win = win.expand(idx.shape[:-3] + (kf,) + idx.shape[-2:])
            v = torch.gather(win, -3, (idx + fl.dk).clamp(0, kf - 1))
            return v.squeeze(-3) if per_level else v

        return ev(e.body, found)

    return search


def _owned(val: Value, tgt: torch.Tensor) -> Value:
    """``val`` detached from ``tgt``'s storage, so writing it cannot
    overlap the window it was read from."""
    if _is_t(val) and val.untyped_storage().data_ptr() == \
            tgt.untyped_storage().data_ptr():
        return val.clone()
    return val


# ---------------------------------------------------------------------------
# computations
# ---------------------------------------------------------------------------


def apply_statement(st: Assign, env: dict, params: Mapping[str, Any],
                    dom: DomainSpec, stencil: Stencil) -> None:
    """One PARALLEL statement over its target's interval: the plain version
    of the horizontal kernel's per-statement launch."""
    # the statement's vertical iteration space is its *target's* K extent:
    # interface targets sweep [0, nk+1), centers [0, nk)
    klo, khi = st.interval.resolve(stencil.k_extent_of(st.target, dom.nk))
    if khi <= klo:
        return

    def read(name: str, off) -> torch.Tensor:
        di, dj, dk = off
        jsl, isl = hwindow(dom, di, dj)
        return krows(env[name][..., :, jsl, isl], klo + dk, khi + dk)

    val = evaluate(st.value, read, params, make_search(env, dom, False))
    tgt = env[st.target]
    jsl, isl = hwindow(dom, 0, 0)
    win = tgt[..., klo:khi, jsl, isl]
    if st.region is not None:
        mask = region_mask(st.region, dom, tgt.device)
        val = torch.where(mask, val, win)
    win[...] = _owned(val, tgt)


def apply_vertical(comp: Computation, env: dict, params: Mapping[str, Any],
                   dom: DomainSpec, stencil: Stencil) -> None:
    """A FORWARD/BACKWARD computation as a loop over K: reads of already
    written levels observe the updates — exact solver semantics.  The plain
    version of the column kernel."""
    bounds = [st.interval.resolve(stencil.k_extent_of(st.target, dom.nk))
              for st in comp.statements]
    lo = min(b[0] for b in bounds)
    hi = max(b[1] for b in bounds)
    forward = comp.direction is Direction.FORWARD
    jsl, isl = hwindow(dom, 0, 0)
    search = make_search(env, dom, True)
    masks = {id(st): region_mask(st.region, dom,
                                 next(iter(env.values())).device)
             for st in comp.statements if st.region is not None}
    for step in range(hi - lo):
        k = lo + step if forward else hi - 1 - step

        def read(name: str, off) -> torch.Tensor:
            di, dj, dk = off
            arr = env[name]
            kk = min(max(k + dk, 0), arr.shape[-3] - 1)
            js, is_ = hwindow(dom, di, dj)
            return arr[..., kk, js, is_]

        for st, (sklo, skhi) in zip(comp.statements, bounds):
            if not sklo <= k < skhi:
                continue
            val = evaluate(st.value, read, params, search)
            tgt = env[st.target]
            plane = tgt[..., k, jsl, isl]
            if st.region is not None:
                val = torch.where(masks[id(st)], val, plane)
            plane[...] = _owned(val, tgt)


def prepare_env(stencil: Stencil, dom: DomainSpec,
                fields: Mapping[str, torch.Tensor], dtype) -> dict:
    """The runner's working set: inputs by reference, written inputs cloned
    (read-modify-write), temporaries as zero tensors of the padded shape
    with the inputs' leading dims."""
    env = {f: fields[f] for f in stencil.fields}
    for w in stencil.written():
        if w in env:
            env[w] = env[w].clone()
    some = env[stencil.fields[0]]
    lead = tuple(some.shape[:-3])
    for t in stencil.temporaries():
        env[t] = torch.zeros(
            lead + dom.padded_shape(stencil.is_interface(t)), dtype=dtype,
            device=some.device)
    return env


def compile_torch(stencil: Stencil, dom: DomainSpec, *,
                  dtype=torch.float32) -> Callable:
    """Compile a stencil into ``fn(fields: dict, params: dict) -> dict``
    returning the written fields.  Runs on whatever device the fields lie
    on; temporaries are allocated internally."""
    written = [w for w in stencil.written() if w in stencil.fields]

    def run(fields: Mapping[str, torch.Tensor],
            params: Mapping[str, Any] | None = None) -> dict:
        params = dict(params or {})
        env = prepare_env(stencil, dom, fields, dtype)
        for comp in stencil.computations:
            if comp.direction is Direction.PARALLEL:
                for st in comp.statements:
                    apply_statement(st, env, params, dom, stencil)
            else:
                apply_vertical(comp, env, params, dom, stencil)
        return {w: env[w] for w in written}

    return run
