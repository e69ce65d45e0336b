"""Serving driver of the PyTorch port: batched prefill, then a greedy
decode loop against the KV caches and recurrent states.

The counterpart of ``examples/serve_lm.py``, with its options, for every
``--arch`` (attention, hybrid, recurrent: the cache follows the block
pattern) at smoke size, with seeded weights.  ``--device`` picks where it
runs (the card by default; ``cpu`` runs the kernels' plain versions);
``--int8`` serves the weights quantized to int8 (``quantized=True``).

Run:  PYTHONPATH=src python examples/torch_serve_lm.py --arch gemma2_2b
"""

import argparse
import time

import torch

from repro_torch.configs import smoke_config
from repro_torch.models import (Transformer, decode_step, init_params,
                                prefill)
from repro_torch.serve import quantize_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2_2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="the card by default; cpu runs the plain versions")
    ap.add_argument("--int8", action="store_true",
                    help="int8 weights (quantized from the float32 ones)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch)
    model = init_params(Transformer(cfg, dtype=torch.float32,
                                    device=args.device), seed=0)
    if args.int8:
        model = quantize_params(model)
    device = model.device
    B, S = args.batch, args.prompt_len
    npre = cfg.n_prefix_embeds
    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (B, S - npre), generator=gen,
                            device=device)
    prefix = (torch.randn((B, npre, cfg.d_model), generator=gen,
                          device=device) if npre else None)

    t0 = time.perf_counter()
    # caches of S + new_tokens slots: decode writes past the prompt
    logits, caches = prefill(model, prompts, prefix_embeds=prefix,
                             cache_len=S + args.new_tokens,
                             quantized=args.int8)
    print(f"prefill: B={B} S={S} in {time.perf_counter() - t0:.2f}s")

    tok = logits.argmax(-1)
    out_tokens = [tok[:, 0]]
    t0 = time.perf_counter()
    for i in range(args.new_tokens - 1):
        logits, caches = decode_step(model, tok, caches, S + i,
                                     quantized=args.int8)
        tok = logits.argmax(-1)
        out_tokens.append(tok[:, 0])
    dt = time.perf_counter() - t0
    gen_tokens = torch.stack(out_tokens, 1).cpu()
    print(f"decoded {args.new_tokens - 1} tokens × {B} seqs in {dt:.2f}s "
          f"({dt / max(args.new_tokens - 1, 1) * 1e3:.0f} ms/token)")
    print("generations:")
    for b in range(B):
        print(f"  seq{b}: {gen_tokens[b].tolist()}")
    return gen_tokens


if __name__ == "__main__":
    main()
