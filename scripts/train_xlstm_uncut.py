#!/usr/bin/env python3
"""xLSTM-1.3B's training cell uncut, traced, on one card.

    python3 scripts/train_xlstm_uncut.py

``chip_smoke.py`` trains xLSTM-1.3B cut to one of its 6 pattern groups
and untraced, since the uncut cell takes ~25 minutes on an H100 (a
host-bound step of 2-3 minutes, and its trace).  This runs
``chip_smoke.train_phase`` on ``chip_smoke.TRAIN``'s xLSTM cell at all
48 layers with its fourth step traced: every ``[train]`` line (the host's
time inside the sLSTM mixers in each untraced step among them) and the
traced step's split by kernel group, its ``opt_update`` and
``slstm_scan`` ranges (device and host ms) and the idle share.  Prints
the card's name and power limit first and last.  Needs one card.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke as CS
    from repro_torch.core.backend import cuda as CB
    from repro_torch.kernels import library as KL

    if not torch.cuda.is_available():
        print("train_xlstm_uncut: no CUDA device", file=sys.stderr)
        return 1
    print(f"[card] {CS.card_line()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    CB.build_library("lm_kernels")
    KL.load_lm_library()
    print(f"[build] {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    CS.train_phase(torch.device("cuda"), "xlstm_1p3b",
                   dict(CS.TRAIN["xlstm_1p3b"], layers=48, trace=True))
    print(f"[phase] train xlstm_1p3b {time.perf_counter() - t:.1f} s")
    print(CS.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
