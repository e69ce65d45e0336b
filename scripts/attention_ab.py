#!/usr/bin/env python3
"""Time K8's float32 kernel and the float32 parity prefills of two source
trees on one card, interleaved.

    python3 scripts/attention_ab.py BASE

BASE is the root of another checkout of this repository (for example the
parent commit, unpacked with ``git archive``); "new" is the checkout that
holds this script.  The runs go base, new, new, base, each a fresh process
that puts its tree's ``src`` first on ``sys.path`` and builds its LM
kernels.  Each run: ``flash_attention`` in float32 at
``chip_smoke.FA_SHAPES`` (Granite-8B's and Zamba2-7B's prefill shapes,
softcap 0; CUDA events, 5 calls after a warm-up) beside
``F.scaled_dot_product_attention`` on the same inputs, then for each of
``chip_smoke.SERVE_ARCHS`` the float32 prefill of ``chip_smoke.PARITY``'s
2 prompts of 512 tokens (full width and depth, weights from seed 0; CUDA
events, mean of 3 after a warm-up) with its K8 launches.  Prints one
``RESULT`` JSON line per run and a table of the runs side by side.  Needs
one card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from serve_ab import interleaved_runs

ROOT = Path(__file__).resolve().parents[1]


def child(src: Path, label: str) -> None:
    """One run: K8 float32 and the parity prefills of the tree whose
    ``src`` is ``src``."""
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import torch
    import torch.nn.functional as F

    import chip_smoke as CS
    from repro_torch import configs as TC
    from repro_torch import models as TM
    from repro_torch.core.backend import cuda as C
    from repro_torch.kernels import library as KL
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    C.build_library("lm_kernels")
    KL.load_lm_library()
    print(f"[{label}] {src}: LM kernels built and loaded in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(3)
    out = {"run": label, "k8": {}, "sdpa": {}, "prefill": {}}
    for shape in CS.FA_SHAPES:
        B, S, H, KVH, D = (shape[k] for k in ("B", "S", "H", "KVH", "D"))
        q = torch.randn((B, S, H, D), generator=gen, device=device)
        k, v = (torch.randn((B, S, KVH, D), generator=gen, device=device)
                for _ in range(2))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        out["k8"][D] = CS.cuda_ms(lambda: ops.flash_attention(q, k, v), 5)
        out["sdpa"][D] = CS.cuda_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 5)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    B, S = CS.PARITY["B"], CS.PARITY["S"]
    for arch in CS.SERVE_ARCHS:
        cfg = TC.get_config(arch)
        model = TM.init_params(TM.Transformer(cfg, dtype=torch.float32,
                                              device=device), seed=0)
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                               device=device)
        KL.reset_launches()
        TM.prefill(model, tokens, cache_len=S)
        launches = KL.LAUNCHES["flash_attention"]
        ms = CS.cuda_ms(lambda: TM.prefill(model, tokens, cache_len=S), 3)
        out["prefill"][arch] = {"ms": ms, "k8_launches": launches}
        del model, tokens
        torch.cuda.empty_cache()
    print("RESULT " + json.dumps(out), flush=True)


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
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 1
    results = interleaved_runs(__file__, args.base)
    if results is None:
        return 1
    dims = list(results[0]["k8"])
    archs = list(results[0]["prefill"])
    print(f"{'run':8} " + " ".join(f"{'K8 f32 D=' + d:>13} {'SDPA':>9}"
                                   for d in dims)
          + " " + " ".join(f"{a + ' ms':>16}" for a in archs))
    for r in results:
        print(f"{r['run']:8} "
              + " ".join(f"{r['k8'][d]:13.4f} {r['sdpa'][d]:9.4f}"
                         for d in dims)
              + " " + " ".join(f"{r['prefill'][a]['ms']:16.3f}"
                               for a in archs))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
