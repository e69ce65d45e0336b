"""Training launcher: data → train loop with checkpoint/restart and the
heartbeat straggler policy, as the reference's ``launch/train.py``, on one
process and one device.

On the card:   python -m repro_torch.launch.train --arch granite_8b
On the CPU:    python -m repro_torch.launch.train --arch granite_8b \\
                   --smoke --device cpu
(``--smoke``: the reference's reduced config of the architecture.)

The reference's flags are kept but ``--model-parallel``, which plans its
(data, model) mesh: the port trains on one process, and multi-card
training is queued (ROADMAP queue 1); with ``WORLD_SIZE`` > 1 the launcher
raises.  A restart finds the latest
checkpoint under ``--ckpt``, restores the model, the optimizer state and
the step, and resumes the data stream there.  The model starts from
``init_params(seed=0)`` in float32 masters and computes in bf16 (the
reference's default); ``--layers`` cuts the depth.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from ..configs import get_config, smoke_config
from ..core.backend.base import resolve_device
from ..data.pipeline import DataConfig, DataIterator
from ..models.transformer import Transformer, count_params
from ..models.weights import init_params
from ..train.checkpoint import (latest_step, restore_checkpoint,
                                save_checkpoint)
from ..train.elastic import HeartbeatMonitor
from ..train.optimizer import OptConfig
from ..train.train_step import TrainConfig, init_state, make_train_step

def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite_8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--heartbeat-timeout", type=float, default=600.0)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    return ap.parse_args(argv)


def train(cfg, tcfg: TrainConfig, *, steps: int, global_batch: int,
          seq: int, ckpt: str, ckpt_every: int,
          heartbeat_timeout: float = 600.0, device=None,
          log_every: int = 10) -> list[float]:
    """Train ``cfg`` from ``init_params(seed=0)`` (float32 masters) for
    ``steps`` steps of ``tcfg`` on the synthetic stream: restores the latest
    checkpoint under ``ckpt`` and resumes the stream at its step, saves
    asynchronously every ``ckpt_every`` steps and at once when the
    heartbeat finds a straggler.  Returns the losses of the steps run."""
    device = resolve_device(device)
    model = init_params(Transformer(cfg, dtype=torch.float32, device=device),
                        seed=0)
    print(f"[launch] arch={cfg.name} params={count_params(model) / 1e6:.1f}M "
          f"device={device}")
    state = init_state(cfg, model)
    step_fn = make_train_step(cfg, tcfg)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq,
                      global_batch=global_batch, seed=0,
                      n_prefix_embeds=cfg.n_prefix_embeds,
                      d_model=cfg.d_model)
    start = 0
    if latest_step(ckpt) is not None:
        state, manifest = restore_checkpoint(ckpt, state)
        start = manifest["step"]
        print(f"[launch] resumed at step {start}")
    it = DataIterator(dcfg, start_step=start, device=device)
    hb = HeartbeatMonitor(timeout_s=heartbeat_timeout)
    losses, pending = [], None
    for i in range(start, steps):
        t0 = time.perf_counter()
        state, m = step_fn(state, next(it))
        loss = float(m["loss"])
        losses.append(loss)
        if not hb.beat(i):
            print(f"[launch] straggler at step {i}: checkpoint")
            save_checkpoint(ckpt, i + 1, state)
        if (i + 1) % log_every == 0 or i + 1 == steps:
            print(f"step {i + 1:5d} loss={loss:.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} "
                  f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")
        if (i + 1) % ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = save_checkpoint(ckpt, i + 1, state, async_mode=True)
    if pending is not None:
        pending.join()
    return losses


def main(argv=None) -> list[float]:
    args = parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError("the port trains on one process and one device; "
                           "multi-card training is queued (ROADMAP queue 1)")
    cfg = (smoke_config if args.smoke else get_config)(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    tcfg = TrainConfig(grad_accum=args.grad_accum,
                       opt=OptConfig(lr=args.lr, warmup=20))
    losses = train(cfg, tcfg, steps=args.steps,
                   global_batch=args.global_batch, seq=args.seq,
                   ckpt=args.ckpt, ckpt_every=args.ckpt_every,
                   heartbeat_timeout=args.heartbeat_timeout,
                   device=args.device)
    print("[launch] done")
    return losses


if __name__ == "__main__":
    main()
