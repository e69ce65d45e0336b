#!/usr/bin/env python3
"""Time the FV3-lite dycore's stencil kernels and steps of two source trees
on one card, interleaved.

    python3 scripts/dycore_ab.py BASE

BASE is the root of another checkout of this repository (for example the
parent commit, unpacked with ``git archive``); "new" is the checkout that
holds this script.  The runs go base, new, new, base, each a fresh process
that puts its tree's ``src`` first on ``sys.path`` and builds its stencil
kernels.  Each run, at C192 L80 on six tiles (``chip_smoke.py``'s inputs,
CUDA events, 10 calls after a warm-up): K1 on ``fx_ppm`` and on d_sw's
opt-3 node ``inner_y_update+al_x+fx_ppm``, K3 on ``interface_interp``, K5
on ``fx_ppm`` at 4 members (``"grid"``), K2 on ``tridiag_solve``, K4 on
d_sw's ``precompute_pe`` at ``block_k`` 16 and 8 and at 4 members
(``"grid"``, ``block_k`` 16), each K4 case beside K2 on the same inputs,
K6 ``tridiag`` at (80, 1152, 192) in float32 and float64, each beside its
bound; then 3 opt-0 and 3 opt-3 steps of ``make_step_sequential`` (median
of steps 2-3, host clock around ``torch.cuda.synchronize()``) and 3 opt-3
steps on the reference's ``"tpu-v5e"`` schedules (K4 on
``precompute_pe``), one more step of each under ``torch.profiler``
(device-busy ms; K1's, K2's and K4's device ms), and step 1 of opt 0
against the plain opt-0 step over the interior.  Prints one ``RESULT``
JSON line per run and a table of the runs side by side.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

from serve_ab import device_ms, interleaved_runs

ROOT = Path(__file__).resolve().parents[1]
GROUPS = (("K1", ("stencil_parallel_kernel",)),
          ("K2", ("stencil_column_kernel",)),
          ("K4", ("stencil_kblocked_kernel",)))
#: the stacked interiors of a C192 L80 step's six tiles, K6's shape
TRIDIAG_SHAPE = (80, 6 * 192, 192)
FUSED = "inner_y_update+al_x+fx_ppm"


def child(src: Path, label: str) -> None:
    """One run: the kernels and steps of the tree whose ``src`` is
    ``src``."""
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as CS
    from repro_torch.core.backend import TuningCache, compile_program
    from repro_torch.core.backend import cuda as C
    from repro_torch.core.backend import set_default_cache
    from repro_torch.core.stencil import Schedule
    from repro_torch.fv3 import dyncore as D
    from repro_torch.fv3 import state as S
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as KR

    t = time.perf_counter()
    C.load_library()
    print(f"[{label}] {src}: stencil kernels built and loaded in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    cache = src.parent / "build" / "repro_torch" / "dycore_ab_tuning.json"
    cache.parent.mkdir(parents=True, exist_ok=True)
    cache.unlink(missing_ok=True)
    set_default_cache(TuningCache(cache))
    device = torch.device("cuda")
    cfg = D.FV3Config(**CS.C192_L80)
    dom = cfg.seq_dom()
    params = D.default_params(cfg)
    dsw = D.build_dsw_program(cfg, dom)
    remap = D.build_remap_program(cfg, dom)
    csw = D.build_csw_program(cfg, dom)
    fused = compile_program(D.build_dsw_program(cfg, dom), "cuda",
                            opt_level=3, device=device).program
    cases = (("K1 fx_ppm", dsw, "fx_ppm", None, 0),
             ("K1 " + FUSED, fused, FUSED, None, 0),
             ("K3 interface_interp", remap, "remap_interp", None, 0),
             ("K5 fx_ppm M=4", dsw, "fx_ppm", 4, 0),
             ("K2 tridiag_solve", csw, "tridiag_solve", None, 0),
             ("K4 precompute_pe bk16", dsw, "precompute_pe", None, 16),
             ("K4 precompute_pe bk8", dsw, "precompute_pe", None, 8),
             ("K4 precompute_pe bk16 M=4", dsw, "precompute_pe", 4, 16))
    rng = np.random.default_rng(0)
    kernels = {}
    for name, prog, base, members, bk in cases:
        node = next(n for n in prog.all_nodes() if n.base_name == base
                    or n.label.split("#")[0] == base)
        ndom = prog.node_dom(node)
        lead = (6,) if members is None else (members, 6)
        fields = CS.kernel_inputs(node.stencil, base, ndom, rng, device,
                                  lead=lead)
        ps = {p: params[p] for p in node.stencil.params}
        sched = Schedule(block_k=bk, k_as_grid=False) if bk else None
        run = C.CudaStencil(node.stencil, ndom, schedule=sched,
                            n_members=members)
        got, want = run(fields, ps), run.plain(fields, ps)
        err = max((got[w] - want[w]).abs().max().item() for w in run.written)
        kernels[name] = {"ms": CS.cuda_ms(lambda: run(fields, ps), 10),
                         "max_abs_err": err}
        if bk:  # K2 on the same inputs, which K4 must equal
            column = C.CudaStencil(node.stencil, ndom, n_members=members)
            k2 = column(fields, ps)
            kernels[name]["vs_K2"] = max((got[w] - k2[w]).abs().max().item()
                                         for w in run.written)
            kernels[name]["K2_ms"] = CS.cuda_ms(lambda: column(fields, ps),
                                                10)
            del k2
        if label.startswith("new"):
            # chip_smoke.bound reads this tree's launch plan
            kernels[name]["bound_ms"] = CS.bound(run, fields)[0]
        del fields, got, want
        torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(2)
    system = [torch.rand(TRIDIAG_SHAPE, generator=gen, device=device)
              * (hi - lo) + lo for lo, hi in ((0.1, 0.5), (2.0, 3.0),
                                              (0.1, 0.5), (-1.0, 1.0))]
    for dtype in (torch.float32, torch.float64):
        xs = [t.to(dtype) for t in system]
        got, want = ops.tridiag(*xs), KR.tridiag_ref(*xs)
        size = torch.finfo(dtype).bits // 8
        kernels[f"K6 tridiag {str(dtype)[6:]}"] = {
            "ms": CS.cuda_ms(lambda: ops.tridiag(*xs), 10),
            "max_abs_err": (got - want).abs().max().item(),
            "bound_ms": 1e3 * 5 * size * got.numel() / CS.HBM_BYTES_PER_S}
        del xs, got, want
    del system
    torch.cuda.empty_cache()
    s0 = S.init_state(cfg, seed=0, device=device)
    steps = {}
    for level, hw in ((0, None), (3, None), (3, "tpu-v5e")):
        step = D.make_step_sequential(cfg, opt_level=level, hardware=hw,
                                      device=device)
        st, times, s1 = s0, [], None
        for i in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            st = step(st)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
            s1 = st if i == 0 else s1
        steps[f"opt{level}" + (f" {hw}" if hw else "")] = {
            "ms": times, "median_ms": statistics.median(times[1:]),
            "device_ms": device_ms(lambda: step(s1), GROUPS)}
        if level == 0:
            want = D.make_step_sequential(cfg, backend="torch", opt_level=0,
                                          device=device)(s0)
            steps["opt0"]["vs_plain"] = {
                k: (CS.interior(s1[k], cfg) - CS.interior(want[k], cfg))
                .abs().max().item() for k in s1}
            del want
        del st, s1, step
        torch.cuda.empty_cache()
    for level in steps.values():
        del level["device_ms"]["largest"]
    print("RESULT " + json.dumps({"run": label, "card": CS.card_line(),
                                  "kernels": kernels, "steps": steps}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", nargs="?", type=Path,
                    help="root of the other checkout")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--label", default="new", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.label)
        return 0
    if args.base is None:
        ap.error("BASE is required")
    import torch

    if not torch.cuda.is_available():
        print("dycore_ab: no CUDA device", file=sys.stderr)
        return 1
    results = interleaved_runs(__file__, args.base)
    if results is None:
        return 1
    names = list(results[0]["kernels"])
    print("kernel ms (K4: K2's ms on the same inputs) (bound ms)")
    for name in names:
        print(f"  {name:38s} " + "  ".join(
            f"{r['run']} {r['kernels'][name]['ms']:.4f}"
            + (f" ({r['kernels'][name]['K2_ms']:.4f})"
               if "K2_ms" in r["kernels"][name] else "") for r in results)
              + f"  ({results[1]['kernels'][name]['bound_ms']:.4f})")
    print("step: median ms / device busy ms (K1, K2, K4 device ms)")
    for step in results[0]["steps"]:
        print(f"  {step}")
        for r in results:
            got = r["steps"][step]
            dev = got["device_ms"]
            print(f"    {r['run']:7} {got['median_ms']:9.3f} / "
                  f"{dev['busy']:9.3f} ({dev['K1']:.3f}, {dev['K2']:.3f}, "
                  f"{dev['K4']:.3f})")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
