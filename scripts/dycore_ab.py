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
on ``fx_ppm`` at 4 members (``"grid"``), K2 on ``tridiag_solve``, each
beside its bound; then 3 opt-0 and 3 opt-3 steps of
``make_step_sequential`` (median of steps 2-3, host clock around
``torch.cuda.synchronize()``), one more step of each under
``torch.profiler`` (device-busy ms, K1's and K2's device ms), and step 1
of opt 0 against the plain opt-0 step over the interior.  Prints one
``RESULT`` JSON line per run and a table of the runs side by side.  Needs
one card.
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
          ("K2", ("stencil_column_kernel",)))
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
    from repro_torch.fv3 import dyncore as D
    from repro_torch.fv3 import state as S

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
    cases = (("K1 fx_ppm", dsw, "fx_ppm", None),
             ("K1 " + FUSED, fused, FUSED, None),
             ("K3 interface_interp", remap, "remap_interp", None),
             ("K5 fx_ppm M=4", dsw, "fx_ppm", 4),
             ("K2 tridiag_solve", csw, "tridiag_solve", None))
    rng = np.random.default_rng(0)
    kernels = {}
    for name, prog, base, members in cases:
        node = next(n for n in prog.all_nodes() if n.base_name == base
                    or n.label.split("#")[0] == base)
        ndom = prog.node_dom(node)
        lead = (6,) if members is None else (members, 6)
        fields = CS.kernel_inputs(node.stencil, base, ndom, rng, device,
                                  lead=lead)
        ps = {p: params[p] for p in node.stencil.params}
        run = C.CudaStencil(node.stencil, ndom, n_members=members)
        got, want = run(fields, ps), run.plain(fields, ps)
        err = max((got[w] - want[w]).abs().max().item() for w in run.written)
        kernels[name] = {"ms": CS.cuda_ms(lambda: run(fields, ps), 10),
                         "max_abs_err": err}
        if label.startswith("new"):
            # chip_smoke.bound reads this tree's launch plan
            kernels[name]["bound_ms"] = CS.bound(run, fields)[0]
        del fields, got, want
        torch.cuda.empty_cache()
    s0 = S.init_state(cfg, seed=0, device=device)
    steps = {}
    for level in (0, 3):
        step = D.make_step_sequential(cfg, opt_level=level, device=device)
        st, times, s1 = s0, [], None
        for i in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            st = step(st)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
            s1 = st if i == 0 else s1
        steps[f"opt{level}"] = {
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
    print("kernel ms (bound ms)")
    for name in names:
        print(f"  {name:38s} " + "  ".join(
            f"{r['run']} {r['kernels'][name]['ms']:.4f}" for r in results)
              + f"  ({results[1]['kernels'][name]['bound_ms']:.4f})")
    print(f"{'run':7} {'opt0 ms':>9} {'busy':>9} {'K1':>9} {'opt3 ms':>9} "
          f"{'busy':>9} {'K1':>9} {'K2':>8}")
    for r in results:
        s0, s3 = r["steps"]["opt0"], r["steps"]["opt3"]
        print(f"{r['run']:7} {s0['median_ms']:9.3f} "
              f"{s0['device_ms']['busy']:9.3f} {s0['device_ms']['K1']:9.3f} "
              f"{s3['median_ms']:9.3f} {s3['device_ms']['busy']:9.3f} "
              f"{s3['device_ms']['K1']:9.3f} {s3['device_ms']['K2']:8.3f}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
