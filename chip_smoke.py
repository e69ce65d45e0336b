#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   stencil kernels from ``src/repro_torch/csrc/`` with ``nvcc``.
2. Kernel phase, at C192 with 80 levels: each kernel against its plain
   PyTorch version on the same inputs on the card — K1 on ``fx_ppm``,
   ``edge_flux`` (regions) and ``riem_coeffs`` (K offsets), K2 on
   ``tridiag_solve`` and ``column_total``, K3 on ``interface_interp``
   (monotone coordinates) — with the max error, its tolerance, and both
   times (CUDA events after a warm-up).
3. Path phase: ``make_step_sequential(FV3Config(npx=192, nk=80))`` takes 3
   steps on the card from ``init_state(cfg, seed=0)``; step 1 is held
   against the plain ``"torch"`` backend on the card over the interior.
   Prints the step time, the launches of each kernel per step, the peak
   device memory and the relative drift of the total mass, then traces one
   more step with ``torch.profiler`` (device time by kernel, and the idle
   share of the untraced step).
4. Prints a ``kernels`` JSON line and, last, the ``ok`` JSON line.

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
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data sheet: device-memory rate and the f32 rate outside the
# tensor cores (the stencils are f32 on CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

KERNEL_RTOL = KERNEL_ATOL = 1e-6  # kernel vs plain, per element
STEP_ATOL = 1e-5                  # one step vs the plain step, interior
MASS_RTOL = 1e-5                  # relative drift of total mass, 3 steps
SOURCE = "src/repro_torch/csrc/stencil_kernels.cu"
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
    plane = (dom.nj + 2 * dom.extend[1]) * (dom.ni + 2 * dom.extend[0])
    touched = set(st.read_fields()) | set(run.written)
    nbytes = sum(4 * lead * st.k_extent_of(f, dom.nk) * plane
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


def kernel_inputs(stencil, base, dom, rng, device):
    """Inputs for one node at its program's shapes: C192 L80 on six tiles.
    Coordinates of the level search are monotone columns, and the Thomas
    solve gets a diagonally dominant system."""
    import numpy as np
    import torch

    ranges = {"cx": (-0.9, 0.9), "aa": (-0.5, 0.5), "cc": (-0.5, 0.5),
              "bb": (2.0, 3.0)}
    out = {}
    for f in stencil.fields:
        shape = (6,) + dom.padded_shape(stencil.is_interface(f))
        lo, hi = ranges.get(f, (0.5, 1.5))
        a = rng.uniform(lo, hi, shape).astype(np.float32)
        if base == "remap_interp" and f in ("fm", "pe", "pe_ref"):
            a = np.cumsum(a, axis=1, dtype=np.float32)
        out[f] = torch.from_numpy(a).to(device)
    return out


def kernel_phase(device) -> dict:
    """Each kernel against its plain version at C192 L80."""
    import numpy as np
    import torch

    from repro_torch.core.backend import cuda as C
    from repro_torch.fv3 import dyncore as D

    cfg = D.FV3Config(npx=192, nk=80)
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

    cfg = D.FV3Config(npx=192, nk=80)
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
    if min(launches.values()) <= 0:
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


def kernel_records(rows: list, path: dict) -> list:
    """One record per kernel for the ``kernels`` line: the launches of the
    path phase, the worst error of its checks, and the times and bound of
    its first case (fx_ppm, tridiag_solve, interface_interp)."""
    replaces = {"K1": f"{PALLAS}:350", "K2": f"{PALLAS}:486",
                "K3": f"{PALLAS}:99"}
    names = {"K1": "stencil_parallel_kernel", "K2": "stencil_column_kernel",
             "K3": "march_search"}
    counts = {"K1": "horizontal", "K2": "column", "K3": "search"}
    kernels = []
    for k in ("K1", "K2", "K3"):
        mine = [r for r in rows if r["kernel"] == k]
        head = mine[0]
        kernels.append({
            "name": names[k], "route": "cuda", "source": SOURCE,
            "replaces": replaces[k],
            "launches": path["launches"][counts[k]],
            "max_abs_err": max(r["err"] for r in mine),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None})
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

    card = card_line()
    print(f"[card] {card}", flush=True)
    t0 = time.perf_counter()
    lib = C.build_library()
    C.load_library()
    print(f"[build] {time.perf_counter() - t0:.2f} s -> "
          f"{lib.relative_to(ROOT)}", flush=True)
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    device = torch.device("cuda")
    rows = kernel_phase(device)
    path = path_phase(device)
    kernels = kernel_records(rows, path)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
