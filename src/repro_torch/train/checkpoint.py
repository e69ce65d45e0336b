"""Fault-tolerant checkpointing, as the reference's ``train/checkpoint.py``:

* step-atomic: written to ``step_<n>.tmp/`` and then renamed to
  ``step_%010d``, so a crash mid-write never corrupts the latest
  checkpoint; the last 3 are kept (:func:`_gc_old`);
* ``arrays.npz`` holds the state's leaves as ``leaf_0``, ``leaf_1``, ...
  and ``manifest.json`` the step, the leaf count, the time, the mesh and a
  config fingerprint;
* async mode copies the leaves to the host, then a background thread
  writes them: the train loop never waits on the disk;
* the data pipeline is deterministic in (seed, step), so a restart resumes
  the batch stream at the restored step.

The port's leaf order (its own; the reference's is ``jax.tree.flatten``'s):
a tensor is a leaf; a module's leaves are its parameters in
``named_parameters`` order; a dict's values in sorted key order; a tuple's
or list's in order (a stacked leaf's layers in turn); a Python int or
float is a leaf.  So a port ``TrainState`` is the model's parameters,
then the optimizer state's trees (each in sorted path order) and its
``count``, then the step.  bfloat16 tensors are stored as their uint16
bits.

Across ranks (a state laid out by :mod:`..parallel.sharding`): every rank
calls :func:`save_checkpoint`, which gathers each shard whole on the
calling thread (a collective: in the async writer thread one would hang),
and rank 0 writes; the checkpoint holds whole tensors, whatever the mesh.
:func:`restore_checkpoint` reads them into ``like``'s layout, each rank
keeping its block; with ``shardings`` it first lays ``like`` out on them
(:func:`..train.elastic.reshard_state`).
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..parallel import sharding


def _leaves(tree: Any) -> list:
    if isinstance(tree, (torch.Tensor, int, float)):
        return [tree]
    if isinstance(tree, nn.Module):
        return [p for _, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    raise TypeError(f"no checkpoint leaves in a {type(tree).__name__}")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        t = sharding.full_tensor(x.detach()).to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(x)


def save_checkpoint(ckpt_dir: str | Path, step: int, state: Any,
                    meta: dict | None = None, *, async_mode: bool = False):
    """Save ``state``.  Returns the writing thread if async, else None
    (and None on every rank but 0, which writes)."""
    ckpt_dir = Path(ckpt_dir)
    # the host copies are taken now, whatever the train loop does next
    host = [_host(x) for x in _leaves(state)]
    distributed = dist.is_available() and dist.is_initialized()
    if distributed and dist.get_rank() != 0:
        if not async_mode:
            dist.barrier()
        return None
    ckpt_dir.mkdir(parents=True, exist_ok=True)

    def write():
        tmp = ckpt_dir / f"step_{step:010d}.tmp"
        final = ckpt_dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        np.savez(tmp / "arrays.npz",
                 **{f"leaf_{i}": a for i, a in enumerate(host)})
        manifest = {
            "step": step,
            "n_leaves": len(host),
            "time": time.time(),
            "mesh": (meta or {}).get("mesh"),
            "config_fingerprint": (meta or {}).get("config_fingerprint"),
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)          # atomic publish
        _gc_old(ckpt_dir, keep=3)

    if async_mode:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    if distributed:
        dist.barrier()
    return None


def _gc_old(ckpt_dir: Path, keep: int):
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir()
                   and not p.name.endswith(".tmp"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
                   if p.is_dir() and not p.name.endswith(".tmp"))
    return steps[-1] if steps else None


def _rebuild(like: Any, arrays):
    if isinstance(like, torch.Tensor):
        a = next(arrays)
        if tuple(a.shape) != tuple(like.shape):
            raise ValueError(f"leaf shape {a.shape}, expected "
                             f"{tuple(like.shape)}")
        if sharding.is_dtensor(like):  # this rank's block
            a = a[sharding.local_block(a.shape, like.placements,
                                       like.device_mesh)]
        t = torch.from_numpy(np.array(a))
        if like.dtype == torch.bfloat16:
            t = t.view(torch.int16).view(torch.bfloat16)
        with torch.no_grad():
            sharding.local(like).copy_(t.to(like.dtype))
        return like
    if isinstance(like, (int, float)):
        return type(like)(next(arrays))
    if isinstance(like, nn.Module):
        for p in like.parameters():
            _rebuild(p, arrays)
        return like
    if isinstance(like, dict):
        out = dict(like)
        for k in sorted(like):
            out[k] = _rebuild(like[k], arrays)
        return out
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_rebuild(x, arrays) for x in like])
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, arrays) for x in like)
    raise TypeError(f"cannot restore into a {type(like).__name__}")


def _laid_out(like: Any, shardings: dict) -> Any:
    """``like`` (a model, or a ``TrainState`` of one) with the model's
    parameters laid out by ``shardings`` (name -> NamedSharding) and the
    optimizer state made anew on them; values are left to the restore."""
    from ..models.weights import param_tree
    from .optimizer import AdamWState, opt_init

    model = like if isinstance(like, nn.Module) else like.params
    sharding.shard_model(model, shardings, keep_values=False)
    if model is like:
        return like
    kind = "adamw" if isinstance(like.opt, AdamWState) else "adafactor"
    return like._replace(opt=opt_init(kind, param_tree(model)))


def restore_checkpoint(ckpt_dir: str | Path, like: Any, *,
                       step: int | None = None,
                       shardings: dict | None = None) -> tuple[Any, dict]:
    """Restore into the structure of ``like``: its tensors (a model's
    parameters among them) are overwritten in place, its numbers replaced;
    a shard takes its block of the whole leaf.  ``shardings`` (name ->
    :class:`..parallel.sharding.NamedSharding`, as ``param_shardings``
    gives): lay the model's parameters out on them first (its optimizer
    state follows).  Returns (the restored state, the manifest).  ``step``
    defaults to the latest."""
    if shardings is not None:
        like = _laid_out(like, shardings)
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:010d}"
    manifest = json.loads((d / "manifest.json").read_text())
    data = np.load(d / "arrays.npz")
    n = len(_leaves(like))
    if manifest["n_leaves"] != n:
        raise ValueError(f"checkpoint/model structure mismatch: "
                         f"{manifest['n_leaves']} leaves, expected {n}")
    arrays = (data[f"leaf_{i}"] for i in range(n))
    return _rebuild(like, arrays), manifest
