#!/usr/bin/env python3
"""Time K9's call path (RMSNorm at a decode step's 8 rows) in two source
trees on one card, interleaved.

    python3 scripts/k9_ab.py BASE

BASE is the root of another checkout of this repository (for example the
parent commit, unpacked with ``git archive``); "new" is the checkout that
holds this script.  The runs go base, new, new, base, each a fresh process
that puts its tree's ``src`` first on ``sys.path`` and builds its LM
kernels.  Each times, at 8 rows of d 4096 and 3584 in bfloat16 and float32
with a float32 weight: ``ops.rmsnorm``, ``ops.rmsnorm_residual`` and
``F.rms_norm`` a call (CUDA events over back-to-back calls, host included)
and the host µs a call (the wall clock around back-to-back calls, read
before the device is waited for); and, at 8 x 4096 bfloat16, the host µs
of each piece of the tree's ``rmsnorm`` wrapper alone, each the mean of
2000 runs.  The pieces are the tree's own: the parent's wrapper checks its
inputs, allocates the output, calls ``load_lm_library()``, enters a
``torch.cuda.device`` context, builds a ``torch.cuda.Stream`` for
``current_stream`` and calls ``check_launch`` after the ``ctypes`` launch;
the new one checks, allocates, reads the bound library, the current device
and the raw stream, and launches (the LM library bound with the
interpreter lock held), beside a ctypes call of one int that launches
nothing.  Prints one ``RESULT`` JSON line per run
and a table of the runs side by side.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from serve_ab import interleaved_runs

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((8, 4096), (8, 3584))
PIECE_REPS = 2000
WARMUP = 500  # calls before a call is timed


def pieces(x, w) -> dict:
    """The host µs of each piece of this tree's ``rmsnorm`` wrapper on
    ``x``, ``w``, by the tree's layout (:func:`.library.launch` marks the
    new call path)."""
    import torch

    import chip_smoke as CS
    from repro_torch.kernels import library as KL
    from repro_torch.kernels import rmsnorm as RN

    def piece_us(fn) -> float:
        return CS.host_us_per_call(fn, PIECE_REPS)

    o = torch.empty_like(x)
    dt = KL.LM_DTYPES
    args = (x.data_ptr(), w.data_ptr(), o.data_ptr(), dt[x.dtype],
            dt[w.dtype], x.shape[0], x.shape[1], 1e-5)
    lib = KL.load_lm_library()
    idx = x.get_device()
    if hasattr(KL, "launch"):
        stream = torch._C._cuda_getCurrentRawStream(idx)
        return {
            "check": piece_us(lambda: RN._check("rmsnorm", x, None, w)),
            "empty_like": piece_us(lambda: torch.empty_like(x)),
            "library": piece_us(lambda: KL.LM or KL.load_lm_library()),
            "device guard": piece_us(
                lambda: torch._C._cuda_getDevice() != idx),
            "stream": piece_us(
                lambda: torch._C._cuda_getCurrentRawStream(idx)),
            "ctypes launch": piece_us(
                lambda: lib.launch_rmsnorm(*args, stream)),
            # the ctypes call alone, of one argument that launches nothing
            "ctypes call, one int": piece_us(lambda: lib.lm_error_string(0))}

    def guard():
        with torch.cuda.device(x.device):
            pass

    stream = torch.cuda.current_stream(x.device).cuda_stream
    return {
        "check": piece_us(lambda: RN._check("rmsnorm", (x,), w)),
        "empty_like": piece_us(lambda: torch.empty_like(x)),
        "library": piece_us(KL.load_lm_library),
        "device guard": piece_us(guard),
        "stream": piece_us(
            lambda: torch.cuda.current_stream(x.device).cuda_stream),
        "ctypes launch": piece_us(lambda: KL.check_launch(
            lib.lm_error_string, lib.launch_rmsnorm(*args, stream),
            "rmsnorm"))}


def child(src: Path, label: str) -> None:
    """One run: K9's call path in the tree whose ``src`` is ``src``."""
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch
    import torch.nn.functional as F

    import chip_smoke as CS
    from repro_torch.core.backend import cuda as C
    from repro_torch.kernels import library as KL
    from repro_torch.kernels import ops

    t = time.perf_counter()
    C.build_library("lm_kernels")
    KL.load_lm_library()
    print(f"[{label}] {src}: LM kernels built and loaded in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(9)
    result = {"run": label, "calls": {}}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for rows, d in SHAPES:
            x, r = (torch.randn((rows, d), generator=gen,
                                device=device).to(dtype) for _ in range(2))
            w = 0.1 * torch.randn(d, generator=gen, device=device)
            w1 = (1.0 + w).to(dtype)
            calls = {"rmsnorm": lambda: ops.rmsnorm(x, w),
                     "rmsnorm_residual": lambda: ops.rmsnorm_residual(x, r,
                                                                      w),
                     "F.rms_norm": lambda: F.rms_norm(x, (d,), weight=w1,
                                                      eps=1e-5)}
            for key, fn in calls.items():
                for _ in range(WARMUP):
                    fn()
                result["calls"][f"{key} {name} {rows}x{d}"] = {
                    "call_ms": CS.cuda_ms(fn, 200),
                    "host_us": CS.host_us_per_call(fn, 200)}
            if (dtype, d) == (torch.bfloat16, 4096):
                result["pieces"] = pieces(x, w)
    print("RESULT " + json.dumps(result), flush=True)


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
        print("k9_ab: no CUDA device", file=sys.stderr)
        return 1
    results = interleaved_runs(__file__, args.base)
    if results is None:
        return 1
    print("a call: ms (CUDA events, back to back) / host µs")
    for case in results[0]["calls"]:
        print(f"  {case:34s} " + "  ".join(
            f"{r['run']} {r['calls'][case]['call_ms']:.4f} / "
            f"{r['calls'][case]['host_us']:.2f}" for r in results))
    print("rmsnorm bfloat16 8x4096, host µs of each piece of the wrapper")
    for piece in results[0]["pieces"]:
        print(f"  {piece:14s} " + "  ".join(
            f"{r['run']} {r['pieces'][piece]:.3f}" for r in results))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
