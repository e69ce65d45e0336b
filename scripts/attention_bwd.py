#!/usr/bin/env python3
"""K8's backward on one card, in bfloat16 or float32: its time beside
SDPA's backward in the same dtype, and its device time split by kernel.

    python3 scripts/attention_bwd.py [--dtype bfloat16|float32]

At each shape of ``chip_smoke.BWD_FA`` (Granite-8B's prefill, Gemma-2's
window and softcap, the Granite training step's micro-batch), on the forward
kernel's o and lse: the backward (``flash_attention_bwd``; CUDA events, mean
of 5 after a warm-up) with the TFLOP/s of its 5-product count and of the 7
products it runs, beside its bound (bf16: the flops over 989 TFLOP/s;
float32: 3xTF32, three times the flops over 495), SDPA's backward alone
(``torch.autograd.grad`` on a kept forward graph) and SDPA's forward and
backward; then the device ms a call of each of its kernels
(``torch.profiler``: the rows kernel, dK/dV and dQ).  Prints the card's
name and power limit first.  The kernels are held against their plain
version by ``chip_smoke.py``'s backward phase and
``tests/test_torch_cuda.py`` (``-m cuda -k backward``).  Needs one card.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))


def kernel_split(fn, reps: int = 3) -> str:
    """Device ms a call of each CUDA kernel ``fn`` launches, under
    ``torch.profiler`` over ``reps`` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.device_time_total / 1e3 / reps, e.key.split("<")[0]
             .removeprefix("void "))
            for e in prof.key_averages() if e.device_time_total > 0]
    return ", ".join(f"{name} {ms:.4f}" for ms, name in sorted(rows,
                                                              reverse=True))


def time_shape(shape: dict, dtype) -> None:
    import torch
    import torch.nn.functional as F

    import chip_smoke as CS
    from repro_torch.kernels import ref as KR
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)

    B, S, H, KVH, D, window, cap = (shape[k] for k in (
        "B", "S", "H", "KVH", "D", "window", "softcap"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(S + D + H)
    q, do = (torch.randn((B, S, H, D), generator=gen, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((B, S, KVH, D), generator=gen, device=dev)
            .to(dtype) for _ in range(2))
    lse = torch.empty((B, H, S), device=dev)
    o = flash_attention(q, k, v, softcap=cap, window=window, lse=lse)
    label = (f"{str(dtype).removeprefix('torch.')} B={B} S={S} H={H} "
             f"KVH={KVH} D={D} window={window} softcap={cap:g}")

    def backward():
        return flash_attention_bwd(q, k, v, o, lse, do, softcap=cap,
                                   window=window)

    ms = CS.cuda_ms(backward, 5)
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    keep = KR.attention_mask(S, window, dev) if window else None
    dot = do.transpose(1, 2)

    def sdpa_fwd():
        return (F.scaled_dot_product_attention(
            *leaves, is_causal=True, enable_gqa=True) if keep is None
            else F.scaled_dot_product_attention(
                *leaves, attn_mask=keep, enable_gqa=True))

    y = sdpa_fwd()
    bwd_ms = CS.cuda_ms(lambda: torch.autograd.grad(
        y, leaves, dot, retain_graph=True), 5)
    pair_ms = CS.cuda_ms(lambda: torch.autograd.grad(
        sdpa_fwd(), leaves, dot), 5)
    flops = 10 * B * H * D * CS.attention_pairs(S, window)
    # the least time of the 5 products on the tensor cores: bf16 once,
    # float32 as three TF32 products
    t_o = (flops / CS.BF16_OPS_PER_S if dtype == torch.bfloat16
           else 3 * flops / CS.TF32_OPS_PER_S)
    print(f"[time] {label}: backward {ms:.4f} ms ({flops / ms / 1e9:.1f} "
          f"TFLOP/s on 5 products, {1.4 * flops / ms / 1e9:.1f} on the 7 it "
          f"runs), bound {1e3 * t_o:.4f} ms, 7-product floor "
          f"{1.4e3 * t_o:.4f} ms; SDPA backward "
          f"alone {bwd_ms:.4f} ms, SDPA forward + backward {pair_ms:.4f} ms"
          f"{' (the window as a mask, no softcap)' if window else ''}",
          flush=True)
    print(f"[time] {label}: device ms a call by kernel: "
          + kernel_split(backward), flush=True)


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    dtype = getattr(torch, ap.parse_args(argv).dtype)
    if not torch.cuda.is_available():
        print("attention_bwd: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS

    print(f"[card] {CS.card_line()}", flush=True)
    # full float32 products in SDPA's float32 backward, as in chip_smoke.py
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape in CS.BWD_FA:
        time_shape(shape, dtype)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
