#!/usr/bin/env python3
"""Time the bf16 serving path of two source trees on one card, interleaved.

    python3 scripts/serve_ab.py BASE

BASE is the root of another checkout of this repository (for example the
parent commit, unpacked with ``git archive``); "new" is the checkout that
holds this script.  The runs go base, new, new, base, each a fresh process
that puts its tree's ``src`` first on ``sys.path``, builds its LM kernels
and runs ``chip_smoke.py``'s bf16 serving run for each of
``chip_smoke.SERVE_ARCHS`` (full width and depth, weights from seed 0, 8
prompts of 2048 tokens, caches of 2080): a
warm-up prefill, 3 timed prefills (median; ``nvidia-smi`` samples the SM
clock and the power draw every 20 ms meanwhile), one prefill under
``torch.profiler`` (device ms by kernel group: K8, K9, K10, the cuBLAS
GEMMs and their three largest kernels, the rest), 31 greedy decode steps
(host clock around
``torch.cuda.synchronize()``: median, min, max; the greedy tokens) and one
traced decode step (device-busy ms, and the idle share of the median
step).  Prints one ``RESULT`` JSON line per (run, arch) and a table of the
runs side by side, and fails unless every run of an arch generated the same
tokens.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from datetime import datetime
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ORDER = ("base", "new", "new", "base")


def device_ms(fn, groups) -> dict:
    """Device ms of one call of ``fn`` under ``torch.profiler``, summed by
    ``groups`` of (label, name fragments) as ``chip_smoke.trace_step`` sums
    them, plus ``busy``, the total."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as CS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {label: 0.0 for label, _ in groups}
    split["other"] = split["busy"] = 0.0
    kernels = {label: [] for label in split}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA or (
                e.key in CS.MODEL_RANGES):  # a range's device-side twin
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        label = next((g for g, frags in groups
                      if any(f in e.key.lower() for f in frags)), "other")
        split[label] += us / 1e3
        split["busy"] += us / 1e3
        kernels[label].append((round(us / 1e3, 3), e.count, e.key[:60]))
    split["largest"] = {label: sorted(ks, reverse=True)[:3]
                        for label, ks in kernels.items() if ks}
    return split


def clocks_during(fn) -> dict:
    """Run ``fn`` while ``nvidia-smi`` samples the SM clock (MHz) and the
    power draw (W) every 20 ms; the mean, min and max of the samples taken
    inside the call ("not measured" where nvidia-smi gives none)."""
    none = {"sm_mhz": "not measured", "power_w": "not measured"}
    try:
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        fn()
        return none
    try:
        time.sleep(1.0)  # nvidia-smi's own start-up
        t0 = datetime.now()
        fn()
        t1 = datetime.now()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    samples = []
    for line in out.splitlines():
        try:
            stamp, mhz, watts = (x.strip() for x in line.split(","))
            when = datetime.strptime(stamp, "%Y/%m/%d %H:%M:%S.%f")
            if t0 <= when <= t1:
                samples.append((float(mhz), float(watts)))
        except ValueError:
            continue
    if not samples:
        return none
    mhz, watts = zip(*samples)
    return {"samples": len(samples),
            "sm_mhz": [statistics.mean(mhz), min(mhz), max(mhz)],
            "power_w": [statistics.mean(watts), min(watts), max(watts)]}


def child(src: Path, label: str) -> None:
    """One run: the serving path of the tree whose ``src`` is ``src``."""
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as CS
    from repro_torch import configs as TC
    from repro_torch import models as TM
    from repro_torch.core.backend import cuda as C
    from repro_torch.kernels import library as KL

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    C.build_library("lm_kernels")
    KL.load_lm_library()
    print(f"[{label}] {src}: LM kernels built and loaded in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    device = torch.device("cuda")
    B, S, n, cache = (CS.SERVE[k] for k in ("B", "S", "decode", "cache"))
    for arch in CS.SERVE_ARCHS:
        cfg = TC.get_config(arch)
        model = TM.init_params(TM.Transformer(cfg, dtype=torch.bfloat16,
                                              device=device), seed=0)
        gen = torch.Generator(device=device).manual_seed(4)
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                               device=device)
        logits, caches = TM.prefill(model, tokens, cache_len=cache)
        times = []

        def timed_prefills():
            nonlocal logits, caches
            for _ in range(3):
                logits = caches = None
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, caches = TM.prefill(model, tokens, cache_len=cache)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t))

        clocks = clocks_during(timed_prefills)
        traced = device_ms(
            lambda: TM.prefill(model, tokens, cache_len=cache),
            CS.PREFILL_GROUPS)
        tok = logits.argmax(-1)
        steps, generated = [], [tok.flatten().tolist()]
        for i in range(n):
            t = time.perf_counter()
            step_logits, caches = TM.decode_step(model, tok, caches, S + i)
            tok = step_logits.argmax(-1)
            torch.cuda.synchronize()
            steps.append(1e3 * (time.perf_counter() - t))
            generated.append(tok.flatten().tolist())
        busy = device_ms(lambda: TM.decode_step(model, tok, caches, S + n),
                         ())["busy"]
        print("RESULT " + json.dumps({
            "run": label, "arch": arch, "prefill_ms": times,
            "prefill_median_ms": statistics.median(times),
            "prefill_clocks": clocks,
            "prefill_device_ms": traced, "decode_median_ms":
            statistics.median(steps), "decode_min_ms": min(steps),
            "decode_max_ms": max(steps), "decode_step_busy_ms": busy,
            "decode_idle": 1.0 - busy / statistics.median(steps),
            "tokens": generated}),
            flush=True)
        del model, logits, caches, step_logits, tokens
        torch.cuda.empty_cache()


def interleaved_runs(script: str, base: Path) -> list | None:
    """Run ``script --child SRC --label RUN`` for the trees in
    :data:`ORDER` (``base``, or the checkout that holds this file), each a
    fresh process, echoing its output; the ``RESULT`` JSON objects of all
    runs, or None after a run that failed."""
    roots = {"base": base.resolve(), "new": ROOT}
    results = []
    for i, label in enumerate(ORDER):
        run = f"{label}{i + 1}"
        proc = subprocess.run(
            [sys.executable, script, "--child", str(roots[label] / "src"),
             "--label", run],
            capture_output=True, text=True, timeout=1800)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            print(f"{Path(script).stem}: run {run} failed "
                  f"({proc.returncode})", file=sys.stderr)
            return None
        results += [json.loads(line[len("RESULT "):])
                    for line in proc.stdout.splitlines()
                    if line.startswith("RESULT ")]
    return results


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
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 1
    results = interleaved_runs(__file__, args.base)
    if results is None:
        return 1
    import chip_smoke as CS

    gemm = next(g for g, _ in CS.PREFILL_GROUPS if g.startswith("GEMMs"))
    print(f"{'run':8} {'arch':11} {'prefill ms':>11} {'GEMMs ms':>9} "
          f"{'other ms':>9} {'SM MHz':>7} {'W':>6} {'decode ms':>10} "
          f"{'min':>8} {'max':>8} {'busy ms':>8} {'idle':>6}")
    for r in results:
        d, c = r["prefill_device_ms"], r["prefill_clocks"]
        mhz, watts = (f"{c[k][0]:{w}.0f}" if isinstance(c[k], list)
                      else f"{'n/m':>{w}}"
                      for k, w in (("sm_mhz", 7), ("power_w", 6)))
        print(f"{r['run']:8} {r['arch']:11} {r['prefill_median_ms']:11.3f} "
              f"{d[gemm]:9.3f} {d['other']:9.3f} {mhz} {watts} "
              f"{r['decode_median_ms']:10.3f} {r['decode_min_ms']:8.3f} "
              f"{r['decode_max_ms']:8.3f} {r['decode_step_busy_ms']:8.3f} "
              f"{r['decode_idle']:6.3f}")
    same = True
    for arch in CS.SERVE_ARCHS:
        runs = [r for r in results if r["arch"] == arch]
        equal = all(r["tokens"] == runs[0]["tokens"] for r in runs)
        print(f"{arch}: greedy tokens of the prefill and "
              f"{len(runs[0]['tokens']) - 1} decode steps equal in every "
              f"run: {equal}")
        same &= equal
    return 0 if same else 1


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
