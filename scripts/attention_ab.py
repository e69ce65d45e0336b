#!/usr/bin/env python3
"""Time K8's kernels and the float32 parity prefills of two source trees on
one card, interleaved.

    python3 scripts/attention_ab.py BASE

BASE is the root of another checkout of this repository (for example the
parent commit, unpacked with ``git archive``); "new" is the checkout that
holds this script.  The runs go base, new, new, base, each a fresh process
that puts its tree's ``src`` first on ``sys.path`` and builds its LM
kernels.  Each run: ``flash_attention`` in float32 and bfloat16 at
``chip_smoke.FA_SHAPES`` (Granite-8B's and Zamba2-7B's prefill shapes,
softcap 0 and 50, no window; CUDA events, 20 calls after a warm-up, and
a digest of the output's bytes, which must be the same in every run), at
softcap 0 beside ``F.scaled_dot_product_attention`` on the same inputs,
then for each of
``chip_smoke.SERVE_ARCHS`` the float32 prefill of ``chip_smoke.PARITY``'s
2 prompts of 512 tokens (full width and depth, weights from seed 0; CUDA
events, mean of 3 after a warm-up) with its K8 launches.  Prints one
``RESULT`` JSON line per run and a table of the runs side by side.  Needs
one card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

from serve_ab import interleaved_runs

ROOT = Path(__file__).resolve().parents[1]


def child(src: Path, label: str) -> None:
    """One run: K8 in both dtypes and the parity prefills of the tree whose
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
    out = {"run": label, "k8": {}, "sdpa": {}, "digest": {}, "prefill": {}}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for shape in CS.FA_SHAPES:
            B, S, H, KVH, D = (shape[k] for k in ("B", "S", "H", "KVH", "D"))
            q = torch.randn((B, S, H, D), generator=gen,
                            device=device).to(dtype)
            k, v = (torch.randn((B, S, KVH, D), generator=gen,
                                device=device).to(dtype) for _ in range(2))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            for cap in (0.0, 50.0):
                key = f"{name} D={D} cap={cap:g}"
                o = ops.flash_attention(q, k, v, softcap=cap)
                out["digest"][key] = hashlib.sha1(
                    o.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
                out["k8"][key] = CS.cuda_ms(
                    lambda: ops.flash_attention(q, k, v, softcap=cap), 20)
                out["sdpa"][key] = None if cap else CS.cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True), 20)
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
    keys = list(results[0]["k8"])
    archs = list(results[0]["prefill"])
    print(f"{'K8 ms':22} " + " ".join(f"{r['run']:>9}" for r in results))
    for key in keys:
        print(f"{key:22} " + " ".join(f"{r['k8'][key]:9.4f}"
                                      for r in results))
        if results[0]["sdpa"][key] is not None:
            print(f"{'  SDPA':22} " + " ".join(f"{r['sdpa'][key]:9.4f}"
                                              for r in results))
    for a in archs:
        print(f"{a + ' prefill ms':22} "
              + " ".join(f"{r['prefill'][a]['ms']:9.3f}" for r in results))
    same = all(r["digest"] == results[0]["digest"] for r in results)
    print(f"K8's outputs bit for bit the same in every run: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
