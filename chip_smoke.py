#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   two kernel sources of ``src/repro_torch/csrc/`` with ``nvcc``, both at
   once.
2. Kernel phase, at C192 with 80 levels: each kernel against its plain
   PyTorch version on the same inputs on the card — K1 on ``fx_ppm``,
   ``edge_flux`` (regions) and ``riem_coeffs`` (K offsets), K2 on
   ``tridiag_solve`` and ``column_total``, K3 on ``interface_interp``
   (monotone coordinates); K5, the member axis, on ``fx_ppm`` and
   ``tridiag_solve`` at 4 members under ``"grid"`` and ``"vmap:2,grid"``
   with one input broadcast (member stride 0) — with the max error, its
   tolerance, and both times (CUDA events after a warm-up).
3. Standalone phase: ``repro_torch.kernels.ops`` at C192 L80 shapes — K6
   ``tridiag`` on the six tile interiors stacked along J (80, 1152, 192),
   f32 and one f64 check, timed beside ``torch.linalg.solve`` on the same
   systems as dense matrices; K7 ``fvt_flux`` on the six tiles' levels
   stacked along K (480, 204, 204), halo 6.
4. Path phase: ``make_step_sequential(FV3Config(npx=192, nk=80))`` takes 3
   steps on the card from ``init_state(cfg, seed=0)``; step 1 is held
   against the plain ``"torch"`` backend on the card over the interior.
   Prints the step time, the launches of each kernel per step, the peak
   device memory and the relative drift of the total mass, then traces one
   more step with ``torch.profiler`` (device time by kernel, and the idle
   share of the untraced step).
5. Ensemble phase: ``make_step_ensemble`` at C192 L80 from
   ``ensemble_state(cfg, M, seed=0)`` — M = 4 under ``"grid"`` (3 steps),
   M = 6 under ``"vmap:4"`` (padded to 8, 2 chunks; 1 step), M = 4 under
   ``"vmap:2,grid"`` (1 step).  Step 1 must equal M single-member
   sequential steps on the member slices exactly, while the members
   differ; launches per step must be the sequential path's (twice them
   under ``"vmap:4"``).  Prints the step and per-member-step times and
   the peak device memory of each.
6. Prints a ``kernels`` JSON line and, last, the ``ok`` JSON line.

Each path (the sequential step, the ensemble steps, the standalone ops) is
driven with the launch counts set to 0 just before it and read just after.

Any failed check raises, and the script exits nonzero without the result
lines; so does a machine without a CUDA card, or a directory that holds
this script without the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data sheet: device-memory rate and the f32 rate outside the
# tensor cores (the stencils are f32 on CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# the configuration every phase runs: C192 (6 x 192 x 192 columns), 80 levels
C192_L80 = {"npx": 192, "nk": 80}
KERNEL_RTOL = KERNEL_ATOL = 1e-6  # kernel vs plain, per element
F64_RTOL = F64_ATOL = 1e-12       # K6 in float64 vs plain
STEP_ATOL = 1e-5                  # one step vs the plain step, interior
MASS_RTOL = 1e-5                  # relative drift of total mass, 3 steps
SOURCE = "src/repro_torch/csrc/stencil_kernels.cu"
FV3_SOURCE = "src/repro_torch/csrc/fv3_kernels.cu"
PALLAS = "src/repro/core/backend/lowering_pallas.py"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` runs, CUDA events, after warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def expr_ops(e, nk: int) -> int:
    """Arithmetic operations of one evaluation of ``e``; a level search
    counts one comparison per layer it marches."""
    from repro_torch.core.stencil.ir import (Const, FieldAccess, FoundLevel,
                                             LevelSearch, ParamRef)

    n = 0 if isinstance(e, (FieldAccess, FoundLevel, ParamRef, Const)) else 1
    if isinstance(e, LevelSearch):
        lo, hi = e.resolve_bounds(nk)
        n = hi - lo - 1
    return n + sum(expr_ops(c, nk) for c in e.children())


def bound(run, fields) -> tuple[float, str]:
    """Least time for one call of a compiled stencil on this card: each
    input field read once and each output written once over the write
    window, against the operations its statements do there."""
    st, dom = run.stencil, run.dom
    lead = 1
    for d in next(iter(fields.values())).shape[:-3]:
        lead *= d

    def stored(f):
        """Members x tiles of ``f`` held in memory: a field broadcast
        across members (stride 0) is read once."""
        if f not in fields or f in run.written:
            return lead
        x = fields[f]
        n = 1
        for size, stride in zip(x.shape[:-3], x.stride()[:-3]):
            n *= size if stride else 1
        return n

    plane = (dom.nj + 2 * dom.extend[1]) * (dom.ni + 2 * dom.extend[0])
    touched = set(st.read_fields()) | set(run.written)
    nbytes = sum(4 * stored(f) * st.k_extent_of(f, dom.nk) * plane
                 for f in touched)
    nbytes += sum(4 * lead * st.k_extent_of(f, dom.nk) * plane
                  for f in set(run.written) & set(st.read_fields()))
    ops = 0
    for p in run.programs:
        stmts = [p.ir] if p.kind == "horizontal" else p.ir.statements
        for s in stmts:
            klo, khi = s.interval.resolve(st.k_extent_of(s.target, dom.nk))
            ops += expr_ops(s.value, dom.nk) * lead * max(0, khi - klo) * plane
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# input ranges: Courant numbers below 1, a diagonally dominant Thomas solve
RANGES = {"cx": (-0.9, 0.9), "aa": (-0.5, 0.5), "cc": (-0.5, 0.5),
          "bb": (2.0, 3.0)}


def kernel_inputs(stencil, base, dom, rng, device, lead=(6,)):
    """Inputs for one node at its program's shapes: C192 L80 on six tiles
    (``lead`` puts members before them).  Coordinates of the level search
    are monotone columns, and the Thomas solve gets a diagonally dominant
    system."""
    import numpy as np
    import torch

    out = {}
    for f in stencil.fields:
        shape = lead + dom.padded_shape(stencil.is_interface(f))
        lo, hi = RANGES.get(f, (0.5, 1.5))
        a = rng.uniform(lo, hi, shape).astype(np.float32)
        if base == "remap_interp" and f in ("fm", "pe", "pe_ref"):
            a = np.cumsum(a, axis=-3, dtype=np.float32)
        out[f] = torch.from_numpy(a).to(device)
    return out


def kernel_phase(device) -> dict:
    """Each kernel against its plain version at C192 L80."""
    import numpy as np
    import torch

    from repro_torch.core.backend import cuda as C
    from repro_torch.fv3 import dyncore as D

    cfg = D.FV3Config(**C192_L80)
    dom = cfg.seq_dom()
    params = D.default_params(cfg)
    progs = {p.name: p for p in (D.build_csw_program(cfg, dom),
                                 D.build_dsw_program(cfg, dom),
                                 D.build_remap_program(cfg, dom))}
    cases = [("K1", "d_sw", "fx_ppm"), ("K1", "c_sw+riem", "edge_flux"),
             ("K1", "c_sw+riem", "riem_coeffs"),
             ("K2", "c_sw+riem", "tridiag_solve"),
             ("K2", "vertical_remap", "column_total"),
             ("K3", "vertical_remap", "remap_interp")]
    rng = np.random.default_rng(0)
    rows = []
    for kernel, prog_name, base in cases:
        prog = progs[prog_name]
        node = next(n for n in prog.all_nodes() if n.base_name == base)
        ndom = prog.node_dom(node)
        fields = kernel_inputs(node.stencil, base, ndom, rng, device)
        ps = {p: params[p] for p in node.stencil.params}
        run = C.CudaStencil(node.stencil, ndom)
        got = run(fields, ps)
        want = run.plain(fields, ps)
        torch.cuda.synchronize()
        err = 0.0
        for w in run.written:
            if not torch.isfinite(got[w]).all():
                raise RuntimeError(f"{base}: non-finite kernel output {w}")
            err = max(err, (got[w] - want[w]).abs().max().item())
            if not torch.allclose(got[w], want[w], rtol=KERNEL_RTOL,
                                  atol=KERNEL_ATOL):
                raise RuntimeError(f"{kernel} on {base}: {w} disagrees with "
                                   f"the plain version (max abs {err:.3e})")
        del got, want
        ms = cuda_ms(lambda: run(fields, ps), 5)
        plain_ms = cuda_ms(lambda: run.plain(fields, ps), 2)
        b_ms, b_by = bound(run, fields)
        extra = (" (search coordinate monotone: march and bisection pick "
                 "the same layer)" if kernel == "K3" else "")
        print(f"[kernel] {kernel} {base:14s} launches/call="
              f"{sum(not p.empty for p in run.programs)} max_abs_err={err:.3e}"
              f" tol=rtol {KERNEL_RTOL:g} + atol {KERNEL_ATOL:g}{extra} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
              f"({b_by})", flush=True)
        rows.append(dict(kernel=kernel, stencil=base, err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
        del fields
        torch.cuda.empty_cache()
    return rows


def member_phase(device) -> list:
    """K5: the member axis of K1 (``fx_ppm``) and K2 (``tridiag_solve``) at
    C192 L80 on 4 members under "grid" (one member a thread) and
    "vmap:2,grid" (two), the first read-only input broadcast across
    members at member stride 0, against the plain version."""
    import torch

    from repro_torch.core.backend import cuda as C
    from repro_torch.fv3 import dyncore as D

    cfg = D.FV3Config(**C192_L80)
    dom = cfg.seq_dom()
    params = D.default_params(cfg)
    progs = {p.name: p for p in (D.build_csw_program(cfg, dom),
                                 D.build_dsw_program(cfg, dom))}
    M = 4
    gen = torch.Generator(device=device).manual_seed(1)
    rows = []
    for prog_name, base in (("d_sw", "fx_ppm"),
                            ("c_sw+riem", "tridiag_solve")):
        prog = progs[prog_name]
        node = next(n for n in prog.all_nodes() if n.base_name == base)
        ndom = prog.node_dom(node)
        ps = {p: params[p] for p in node.stencil.params}
        for batch, mchunk in (("grid", 1), ("vmap:2,grid", 2)):
            run = C.CudaStencil(node.stencil, ndom, n_members=M,
                                member_chunk=mchunk)
            bcast = next(f for f in run.stencil.fields
                         if f not in run.written)
            fields = {}
            for f in run.stencil.fields:
                lo, hi = RANGES.get(f, (0.5, 1.5))
                lead = (1, 6) if f == bcast else (M, 6)
                shape = lead + ndom.padded_shape(
                    run.stencil.is_interface(f))
                x = torch.rand(shape, generator=gen,
                               device=device) * (hi - lo) + lo
                fields[f] = x.expand((M,) + tuple(x.shape[1:]))
            got = run(fields, ps)
            want = run.plain(fields, ps)
            torch.cuda.synchronize()
            err = 0.0
            for w in run.written:
                if not torch.isfinite(got[w]).all():
                    raise RuntimeError(f"K5 {base}: non-finite output {w}")
                err = max(err, (got[w] - want[w]).abs().max().item())
                if not torch.allclose(got[w], want[w], rtol=KERNEL_RTOL,
                                      atol=KERNEL_ATOL):
                    raise RuntimeError(f"K5 on {base} ({batch}): {w} "
                                       "disagrees with the plain version "
                                       f"(max abs {err:.3e})")
            del got, want
            ms = cuda_ms(lambda: run(fields, ps), 5)
            plain_ms = cuda_ms(lambda: run.plain(fields, ps), 2)
            b_ms, b_by = bound(run, fields)
            print(f"[kernel] K5 {base:14s} M={M} batch={batch:11s} "
                  f"broadcast={bcast} launches/call="
                  f"{sum(not p.empty for p in run.programs)} "
                  f"max_abs_err={err:.3e} tol=rtol {KERNEL_RTOL:g} + atol "
                  f"{KERNEL_ATOL:g} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
            rows.append(dict(kernel="K5", stencil=base, batch=batch, err=err,
                             ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by))
            del fields
        torch.cuda.empty_cache()
    return rows


def standalone_phase(device) -> dict:
    """K6 and K7 through ``repro_torch.kernels.ops`` at C192 L80 shapes:
    the op calls counted, then each kernel against its plain version, and
    K6 against ``torch.linalg.solve`` on the same systems."""
    import torch

    from repro_torch.kernels import library as KL
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as KR

    gen = torch.Generator(device=device).manual_seed(2)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    nk, npx, h = C192_L80["nk"], C192_L80["npx"], 6
    a, b, c, d = (uniform((nk, 6 * npx, npx), lo, hi) for lo, hi in
                  ((0.1, 0.5), (2.0, 3.0), (0.1, 0.5), (-1.0, 1.0)))
    q = uniform((6 * nk, npx + 2 * h, npx + 2 * h), 1.0, 2.0)
    cx = uniform(q.shape, -0.9, 0.9)
    # the path: the op entry points, once each
    torch.cuda.synchronize()
    KL.reset_launches()
    x = ops.tridiag(a, b, c, d)
    f = ops.fvt_flux(q, cx, halo=h)
    torch.cuda.synchronize()
    launches = dict(KL.LAUNCHES)
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a standalone kernel never launched: {launches}")

    def check(name, got, want, rtol, atol):
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{name}: non-finite kernel output")
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            raise RuntimeError(f"{name} disagrees with the plain version "
                               f"(max abs {err:.3e})")
        return err

    err6 = check("K6 tridiag f32", x, KR.tridiag_ref(a, b, c, d),
                 KERNEL_RTOL, KERNEL_ATOL)
    d64 = [t.double() for t in (a, b, c, d)]
    err6_64 = check("K6 tridiag f64", ops.tridiag(*d64),
                    KR.tridiag_ref(*d64), F64_RTOL, F64_ATOL)
    del d64
    err7 = check("K7 fvt_flux", f, KR.fvt_flux_ref(q, cx, halo=h),
                 KERNEL_RTOL, KERNEL_ATOL)
    ms6 = cuda_ms(lambda: ops.tridiag(a, b, c, d), 10)
    plain6 = cuda_ms(lambda: KR.tridiag_ref(a, b, c, d), 2)
    ms7 = cuda_ms(lambda: ops.fvt_flux(q, cx, halo=h), 10)
    plain7 = cuda_ms(lambda: KR.fvt_flux_ref(q, cx, halo=h), 2)
    # bounds: K6 reads a, b, c, d and writes x; 8 flops a point (forward
    # 6, back substitution 2).  K7 reads q, cx and writes fx; 32 flops on
    # each interior point (three interface values, the upwind branch taken,
    # the clip, the product), none on the halo columns.
    t6 = (5 * 4 * a.numel() / HBM_BYTES_PER_S, 8 * a.numel() / F32_OPS_PER_S)
    interior = q.shape[0] * q.shape[1] * (q.shape[2] - 2 * h)
    t7 = (3 * 4 * q.numel() / HBM_BYTES_PER_S, 32 * interior / F32_OPS_PER_S)
    # the library yardstick: one dense batched solve of the same systems,
    # the matrices built outside the timed window
    def by_column(t):
        return t.reshape(nk, -1).t()

    idx = torch.arange(nk, device=device)
    A = torch.zeros((6 * npx * npx, nk, nk), device=device)
    A[:, idx, idx] = by_column(b)
    A[:, idx[1:], idx[:-1]] = by_column(a)[:, 1:]
    A[:, idx[:-1], idx[1:]] = by_column(c)[:, :-1]
    rhs = by_column(d).unsqueeze(-1)
    lib_x = torch.linalg.solve(A, rhs)
    lib_err = (lib_x.squeeze(-1) - by_column(x)).abs().max().item()
    del lib_x
    lib6 = cuda_ms(lambda: torch.linalg.solve(A, rhs), 2)
    del A, rhs
    torch.cuda.empty_cache()
    rows = {}
    for key, name, err, ms, plain_ms, (tb, to), lib in (
            ("K6", f"tridiag {tuple(a.shape)} f32", err6, ms6, plain6, t6,
             lib6),
            ("K7", f"fvt_flux {tuple(q.shape)} halo {h}", err7, ms7, plain7,
             t7, None)):
        b_ms, b_by = 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")
        extra = (f" f64_max_abs_err={err6_64:.3e} (tol {F64_RTOL:g}); "
                 f"torch.linalg.solve library_ms={lib:.4f} (max abs diff "
                 f"to the kernel {lib_err:.3e})" if key == "K6" else "")
        count = launches["tridiag" if key == "K6" else "fvt_flux"]
        print(f"[kernel] {key} {name} launches={count} "
              f"max_abs_err={err:.3e} tol=rtol {KERNEL_RTOL:g} + atol "
              f"{KERNEL_ATOL:g} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}){extra}", flush=True)
        rows[key] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib)
    rows["K6"]["err"] = max(err6, err6_64)
    return {"rows": rows, "launches": launches}


def interior(x, cfg):
    h, n = cfg.halo, cfg.npx
    return x[..., h:h + n, h:h + n]


def trace_step(step, state, step_ms: float) -> None:
    """One more step under ``torch.profiler``: device time by kernel, and the
    device's idle share of an untraced step.  The profiler's host cost
    lengthens the traced step's wall time, so the share is taken against
    ``step_ms``, the median untraced step (steps 2-3): every step launches
    the same kernels on the same shapes, so its device time is the traced
    step's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies, fills): the CPU op that
        # launched a kernel carries the same device time again
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print("[trace] device time: not measured (the profiler recorded no "
              "device events)")
        return
    rows.sort(reverse=True)
    print(f"[trace] device busy in the traced step {busy:.3f} ms; untraced "
          f"step wall (median of steps 2-3) {step_ms:.3f} ms; device idle "
          f"share of the untraced step {1 - busy / step_ms:.4f}")
    for ms, n, key in rows[:8]:
        print(f"[trace]   {ms:10.3f} ms {100 * ms / busy:5.1f}% x{n:5d} "
              f"{key[:70]}")


def path_phase(device) -> dict:
    """Three C192 L80 steps through the kernels; step 1 against the plain
    step on the card."""
    import torch

    from repro_torch.core.backend import cuda as C
    from repro_torch.fv3 import dyncore as D
    from repro_torch.fv3 import state as S

    cfg = D.FV3Config(**C192_L80)
    t0 = time.perf_counter()
    step = D.make_step_sequential(cfg, device=device)
    s0 = S.init_state(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    m0 = S.total_mass(s0, cfg)
    torch.cuda.reset_peak_memory_stats()
    C.reset_launches()
    st, times, s1 = s0, [], None
    for i in range(3):
        t = time.perf_counter()
        st = step(st)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if i == 0:
            s1 = st
    launches = dict(C.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if min(launches[k] for k in ("horizontal", "column", "search")) <= 0:
        raise RuntimeError(f"a kernel of the path never launched: {launches}")
    for k, v in st.items():
        if tuple(v.shape) != tuple(s0[k].shape):
            raise RuntimeError(f"{k}: shape {tuple(v.shape)} after 3 steps")
        if not torch.isfinite(interior(v, cfg)).all():
            raise RuntimeError(f"{k}: non-finite values after 3 steps")
    drift = (S.total_mass(st, cfg) - m0) / m0
    if abs(drift) >= MASS_RTOL:
        raise RuntimeError(f"total mass drifted by {drift:.3e}")
    del st
    plain_step = D.make_step_sequential(cfg, backend="torch", device=device)
    t = time.perf_counter()
    p1 = plain_step(s0)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    errs = {k: (interior(s1[k], cfg) - interior(p1[k], cfg)).abs().max().item()
            for k in s1}
    worst = max(errs.values())
    step_ms = 1e3 * statistics.median(times[1:])
    per_step = {k: v / 3 for k, v in launches.items()}
    print(f"[path] C192 L80, {step.n_kernels} stencil nodes, setup "
          f"{setup_s:.2f} s", flush=True)
    print(f"[path] step ms: {[round(1e3 * t, 3) for t in times]} -> median "
          f"of steps 2-3 = {step_ms:.3f} ms; plain torch step 1 = "
          f"{1e3 * plain_s:.3f} ms")
    print(f"[path] launches per step: {per_step}")
    print(f"[path] step 1 vs plain step, interior max abs err per field: "
          + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
          + f"; tol {STEP_ATOL:g}")
    print(f"[path] peak device memory {peak / 2**30:.3f} GiB; total mass "
          f"drift over 3 steps {drift:.3e} (tol {MASS_RTOL:g})", flush=True)
    if worst >= STEP_ATOL:
        raise RuntimeError(f"step 1 disagrees with the plain step: {errs}")
    del p1, plain_step
    trace_step(step, s1, step_ms)
    return {"launches": launches, "step_ms": step_ms}


ENSEMBLE_CASES = (  # members, batch, steps, launches per step / M=1's
    (4, "grid", 3, 1),
    (4, "vmap:2,grid", 1, 1),
    (6, "vmap:4", 1, 2),
)


def ensemble_phase(device, seq_launches: dict) -> dict:
    """C192 L80 ensemble steps: step 1 of each case against M
    single-member sequential steps on the member slices (exactly equal),
    and its launches per step against the sequential path's."""
    import torch

    from repro_torch.core.backend import cuda as C
    from repro_torch.fv3 import dyncore as D
    from repro_torch.fv3 import state as S

    cfg = D.FV3Config(**C192_L80)
    seq = D.make_step_sequential(cfg, device=device)
    seq_step = {k: v / 3 for k, v in seq_launches.items()}  # 3 steps
    out, ens = {}, None
    for M, batch, n_steps, factor in ENSEMBLE_CASES:
        if ens is None or ens["pt"].shape[0] != M:
            ens = None
            t = time.perf_counter()
            ens = S.ensemble_state(cfg, M, seed=0, device=device)
            print(f"[ensemble] ensemble_state(C192 L80, M={M}) "
                  f"{time.perf_counter() - t:.2f} s", flush=True)
        step = D.make_step_ensemble(cfg, M, batch=batch, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        C.reset_launches()
        st, times, s1 = ens, [], None
        for i in range(n_steps):
            t = time.perf_counter()
            st = step(st)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            if i == 0:
                s1 = st
        launches = dict(C.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        del st
        per_step = {k: v / n_steps for k, v in launches.items()}
        want = {k: factor * seq_step[k]
                for k in ("horizontal", "column", "search")}
        want["member"] = want["horizontal"] + want["column"]
        diffs = dict.fromkeys(s1, 0.0)
        for m in range(M):
            single = seq({k: v[m] for k, v in ens.items()})
            for k, v in single.items():
                diffs[k] = max(diffs[k], (s1[k][m] - v).abs().max().item())
            del single
        spread = max((s1[k][1:] - s1[k][:1]).abs().max().item() for k in s1)
        finite = all(torch.isfinite(interior(v, cfg)).all().item()
                     for v in s1.values())
        step_ms = 1e3 * (statistics.median(times[1:]) if n_steps > 1
                         else times[0])
        which = "median of steps 2-3" if n_steps > 1 else "step 1"
        print(f"[ensemble] M={M} batch={batch}: {step.n_kernels} stencil "
              f"nodes, {step.n_chunks or 1} chunk(s) of "
              f"{step.member_chunk or M}; step ms "
              f"{[round(1e3 * t, 3) for t in times]} -> {which} "
              f"{step_ms:.3f} ms, {step_ms / M:.3f} ms per member-step",
              flush=True)
        print(f"[ensemble] M={M} batch={batch}: launches per step {per_step}"
              f" (sequential path x{factor}: {want})")
        print(f"[ensemble] M={M} batch={batch}: step 1 vs {M} single-member "
              "steps, max abs difference per field over whole arrays: "
              + ", ".join(f"{k}={v:.3e}" for k, v in diffs.items())
              + f"; largest difference between members {spread:.3e}")
        print(f"[ensemble] M={M} batch={batch}: peak device memory "
              f"{peak / 2**30:.3f} GiB", flush=True)
        if any(v != 0.0 for v in diffs.values()) or not finite:
            raise RuntimeError(f"ensemble step ({batch}, M={M}) differs from "
                               f"the single-member steps: {diffs}")
        if per_step != want:
            raise RuntimeError(f"ensemble step ({batch}, M={M}) launches "
                               f"{per_step}, expected {want}")
        if spread <= 0.0:
            raise RuntimeError("the ensemble members do not differ")
        out[(M, batch)] = {"launches": launches, "step_ms": step_ms,
                           "peak": peak}
        del s1, step
        torch.cuda.empty_cache()
    return out


def kernel_records(rows: list, members: list, standalone: dict, path: dict,
                   ensemble: dict) -> list:
    """One record per kernel for the ``kernels`` line: the launches of its
    path (the sequential step for K1-K3, the 3 ensemble steps under "grid"
    for K5, the op calls for K6/K7), the worst error of its checks, and the
    times and bound of its first case (fx_ppm, tridiag_solve,
    interface_interp; fx_ppm under "grid" for K5)."""
    replaces = {"K1": f"{PALLAS}:350", "K2": f"{PALLAS}:486",
                "K3": f"{PALLAS}:99", "K5": f"{PALLAS}:207",
                "K6": "src/repro/kernels/tridiag.py:22",
                "K7": "src/repro/kernels/fvt_flux.py:21"}
    names = {"K1": "stencil_parallel_kernel", "K2": "stencil_column_kernel",
             "K3": "march_search",
             "K5": "member axis of stencil_parallel_kernel and "
                   "stencil_column_kernel",
             "K6": "tridiag_kernel", "K7": "fvt_flux_kernel"}
    counts = {"K1": "horizontal", "K2": "column", "K3": "search"}
    kernels = []
    for k in ("K1", "K2", "K3", "K5"):
        mine = [r for r in rows + members if r["kernel"] == k]
        head = mine[0]
        launches = (ensemble[(4, "grid")]["launches"]["member"] if k == "K5"
                    else path["launches"][counts[k]])
        kernels.append({
            "name": names[k], "route": "cuda", "source": SOURCE,
            "replaces": replaces[k], "launches": launches,
            "max_abs_err": max(r["err"] for r in mine),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None})
    for k, count in (("K6", "tridiag"), ("K7", "fvt_flux")):
        r = standalone["rows"][k]
        kernels.append({
            "name": names[k], "route": "cuda", "source": FV3_SOURCE,
            "replaces": replaces[k],
            "launches": standalone["launches"][count],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    return kernels


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.backend import cuda as C
    from repro_torch.kernels import library as KL

    card = card_line()
    print(f"[card] {card}", flush=True)
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(max_workers=2) as pool:
        libs = list(pool.map(C.build_library,
                             ("stencil_kernels", "fv3_kernels")))
    C.load_library()
    KL.load_library()
    print(f"[build] {time.perf_counter() - t0:.2f} s -> "
          + ", ".join(str(lib.relative_to(ROOT)) for lib in libs),
          flush=True)
    for lib in libs:
        for line in (lib.parent / "build.log").read_text().splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"[build] {lib.stem}: {line.strip()}")
    device = torch.device("cuda")
    rows = kernel_phase(device)
    members = member_phase(device)
    standalone = standalone_phase(device)
    path = path_phase(device)
    ensemble = ensemble_phase(device, path["launches"])
    kernels = kernel_records(rows, members, standalone, path, ensemble)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
