"""Training launcher: mesh -> shardings -> data -> train loop with
checkpoint/restart, the heartbeat straggler policy and elastic
resharding, as the reference's ``launch/train.py``.

On one card:     python -m repro_torch.launch.train --arch granite_8b
Across N cards:  torchrun --nproc-per-node N -m repro_torch.launch.train \\
                     --arch granite_8b --model-parallel M
On the CPU:      python -m repro_torch.launch.train --arch granite_8b \\
                     --smoke --device cpu
                 (under torchrun: N gloo processes on the CPU)
(``--smoke``: the reference's reduced config of the architecture.)

Ranks come from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``): NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``.  With N > 1 the ranks form
a (data, model) mesh, ``elastic.plan_mesh(N, model_parallel=min(M, N))``,
and the parameters, gradients and optimizer state are laid out on it by
the reference's rules (:mod:`..parallel.sharding`); one rank trains
without a mesh.  The model axis only stores: each of its M ranks holds
1/M of every "tp" dimension, gathered at use, and computes the whole of
its data rows, so M > 1 spends M times the compute of M = 1 for the same
throughput (splitting the compute over "model" is queued).  Hence M
defaults to 1, not the reference's 16.  Each rank takes its rows of every batch.  A restart finds
the latest checkpoint under ``--ckpt``, restores it onto the current mesh
(``elastic.reshard_state``: the checkpoint's mesh may differ), prints both
meshes and resumes the data stream there.  Only rank 0 prints steps.  The
model starts from ``init_params(seed=0)`` in float32 masters and computes
in bf16 (the reference's default); ``--layers`` cuts the depth.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch
import torch.distributed as dist

from ..configs import get_config, smoke_config
from ..core.backend.base import resolve_device
from ..data.pipeline import DataConfig, DataIterator
from ..models.transformer import Transformer, count_params
from ..parallel.sharding import dp_axes, init_params, param_shardings
from ..train.checkpoint import latest_step, save_checkpoint
from ..train.elastic import HeartbeatMonitor, plan_mesh, reshard_state
from ..train.optimizer import OptConfig
from ..train.train_step import TrainConfig, init_state, make_train_step
from .mesh import device_mesh


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="granite_8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks on the model axis (storage only: each "
                         "computes its data rows whole)")
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


def build_mesh(model_parallel: int, device: torch.device):
    """The (data, model) mesh of the process group's ranks, None on one."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n == 1:
        return None  # the one-process path
    data, model = plan_mesh(n, model_parallel=min(model_parallel, n))
    return device_mesh((data, model), ("data", "model"),
                       device_type=device.type)


def init_ranks(device) -> torch.device:
    """Join torchrun's process group where ``WORLD_SIZE`` > 1: NCCL on
    ``cuda:LOCAL_RANK``, gloo on the CPU.  Returns this rank's device."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        if "RANK" not in os.environ:
            raise RuntimeError(f"WORLD_SIZE {world} without RANK: launch "
                               "the ranks with torchrun --nproc-per-node "
                               f"{world}")
        cpu = device is not None and torch.device(device).type == "cpu"
        card = {}
        if not cpu:
            card["device_id"] = torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(card["device_id"])
        dist.init_process_group("gloo" if cpu else "nccl",
                                init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=world, **card)
    return resolve_device(device)


def straggled(hb: HeartbeatMonitor, step: int, device) -> bool:
    """The heartbeat's verdict on ``step``, agreed by every rank (a strike
    on any rank is a strike on all: the checkpoint it triggers is a
    collective)."""
    late = not hb.beat(step)
    if not dist.is_initialized():
        return late
    flag = torch.tensor(float(late), device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def _mesh_shape(mesh):
    return None if mesh is None else tuple(mesh.mesh.shape)


def train(cfg, tcfg: TrainConfig, *, steps: int, global_batch: int,
          seq: int, ckpt: str, ckpt_every: int,
          heartbeat_timeout: float = 600.0, device=None,
          log_every: int = 10, model_parallel: int = 1) -> list[float]:
    """Train ``cfg`` from ``init_params(seed=0)`` (float32 masters) for
    ``steps`` steps of ``tcfg`` on the synthetic stream, on this process's
    rank of the process group (:func:`build_mesh`; each rank takes its rows
    of every batch): restores the latest checkpoint under ``ckpt`` onto the
    current mesh and resumes the stream at its step, saves asynchronously
    every ``ckpt_every`` steps and at once when the heartbeat finds a
    straggler.  Returns the losses of the steps run (every rank's: the
    global batch's)."""
    device = resolve_device(device)
    mesh = build_mesh(model_parallel, device)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    model = init_params(Transformer(cfg, dtype=torch.float32,
                                    device="meta" if mesh else device),
                        seed=0, mesh=mesh)
    if lead:
        print(f"[launch] arch={cfg.name} params="
              f"{count_params(model) / 1e6:.1f}M device={device} "
              f"mesh={_mesh_shape(mesh)}")
    state = init_state(cfg, model)
    specs = param_shardings(model, mesh) if mesh is not None else None
    step_fn = make_train_step(cfg, tcfg,
                              dp_axes=dp_axes(mesh) if mesh else ("data",),
                              param_specs=specs)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq,
                      global_batch=global_batch, seed=0,
                      n_prefix_embeds=cfg.n_prefix_embeds,
                      d_model=cfg.d_model)
    meta = {"mesh": _mesh_shape(mesh)}
    start = 0
    if latest_step(ckpt) is not None:
        # elastic restore: onto the CURRENT mesh, whatever mesh wrote it
        state, manifest = reshard_state(ckpt, state, mesh)
        start = manifest["step"]
        if lead:
            print(f"[launch] resumed at step {start} "
                  f"(ckpt mesh={manifest.get('mesh')}, "
                  f"now={_mesh_shape(mesh)})")
    it = DataIterator(dcfg, start_step=start, device=device, mesh=mesh,
                      grad_accum=tcfg.grad_accum)
    hb = HeartbeatMonitor(timeout_s=heartbeat_timeout)
    losses, pending = [], None
    for i in range(start, steps):
        t0 = time.perf_counter()
        state, m = step_fn(state, next(it))
        loss = float(m["loss"])
        losses.append(loss)
        if straggled(hb, i, device):
            if lead:
                print(f"[launch] straggler at step {i}: checkpoint")
            save_checkpoint(ckpt, i + 1, state, meta=meta)
        if lead and ((i + 1) % log_every == 0 or i + 1 == steps):
            print(f"step {i + 1:5d} loss={loss:.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} "
                  f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")
        if (i + 1) % ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = save_checkpoint(ckpt, i + 1, state, async_mode=True,
                                      meta=meta)
    if pending is not None:
        pending.join()
    return losses


def main(argv=None) -> list[float]:
    args = parse_args(argv)
    device = init_ranks(args.device)
    cfg = (smoke_config if args.smoke else get_config)(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    tcfg = TrainConfig(grad_accum=args.grad_accum,
                       opt=OptConfig(lr=args.lr, warmup=20))
    losses = train(cfg, tcfg, steps=args.steps,
                   global_batch=args.global_batch, seq=args.seq,
                   ckpt=args.ckpt, ckpt_every=args.ckpt_every,
                   heartbeat_timeout=args.heartbeat_timeout,
                   device=device, model_parallel=args.model_parallel)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    print("[launch] done")
    return losses


if __name__ == "__main__":
    main()
