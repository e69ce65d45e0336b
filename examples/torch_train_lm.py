"""End-to-end LM training driver of the PyTorch port: data pipeline →
train step → checkpoint/restart → heartbeat straggler policy, for any
``--arch``.

The counterpart of ``examples/train_lm.py``, with its options, on the
launcher's loop (``repro_torch.launch.train.train``):
smoke-sized by default (the smoke net widened to d_model 128), ``--preset
full`` for the published config; float32 masters from ``init_params``
(seed 0), AdamW or the architecture's optimizer.  The reference's example
asks for ``compute_dtype=float32``, which its train step never reads (it
always computes in bf16, ROADMAP queue 3); the port computes in float32,
as the example asks.
``--device`` picks where it runs (the card by default; ``cpu`` runs the
kernels' plain versions).

Run:  PYTHONPATH=src python examples/torch_train_lm.py --arch granite_8b \\
          --steps 200 --device cpu
"""

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.train import train
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import TrainConfig


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_8b")
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "torch_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="the card by default; cpu runs the plain versions")
    args = ap.parse_args(argv)

    cfg = (get_config if args.preset == "full" else smoke_config)(args.arch)
    # widen the smoke net a bit so there is something to learn
    if args.preset == "smoke":
        cfg = dataclasses.replace(cfg, d_model=128,
                                  d_ff=256 if cfg.d_ff else 0)
    tcfg = TrainConfig(grad_accum=1, compute_dtype=torch.float32,
                       opt=OptConfig(lr=args.lr, warmup=20))
    t0 = time.perf_counter()
    losses = train(cfg, tcfg, steps=args.steps, global_batch=args.batch,
                   seq=args.seq, ckpt=args.ckpt, ckpt_every=args.ckpt_every,
                   device=args.device, log_every=20)
    dt = time.perf_counter() - t0
    if losses:
        print(f"trained {len(losses)} steps in {dt:.1f}s "
              f"({dt / len(losses) * 1e3:.0f} ms/step); "
              f"loss {losses[0]:.3f} → {np.mean(losses[-10:]):.3f}")
    return losses


if __name__ == "__main__":
    main()
