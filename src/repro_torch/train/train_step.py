"""The training step, as the reference's ``train/train_step.py``:
gradient accumulation over microbatches, then the optimizer update.

Microbatch i takes rows ``[i mb, (i + 1) mb)`` of the batch (the
reference's ``reshape(A, mb, -1)``); each runs :func:`..models.loss_fn`
and its backward, whose gradients the float32 masters accumulate in
float32 (``.grad``).  Then, in this order: divide by A, the optional bf16
gradient compression, the global-norm clip, the optimizer update
(:mod:`.optimizer`, on the reference's stacked view).  Metrics are the
mean ``loss`` of the microbatches, ``grad_norm`` (before the clip) and
``step``.  The update runs inside a ``record_function("opt_update")``
range, so a trace reads its device time.

The port computes in ``TrainConfig.compute_dtype`` (bf16 by default).
The reference never reads it: its ``make_train_step`` calls ``loss_fn``
without ``dtype``, so it always computes in bf16 (ROADMAP queue 3); a
float32 run of the reference is its ``loss_fn(dtype=float32)`` composed
with its clip and update by hand.

The state is updated in place (the masters, moments and gradients of a
float32 Granite-8B cut to 8 layers take ~34 GB): ``train_step`` returns
the same model and optimizer state with the step advanced.

Across ranks (a model laid out by :func:`..parallel.sharding.shard_model`
or ``sharding.init_params(..., mesh=)``): each rank takes its rows of
every microbatch (:func:`..data.pipeline.shard_batch`) and runs the loss
through :class:`..parallel.sharding.Gathered`, which gathers each weight
whole at its use and hands back its gradient summed over the ``dp_axes``
ranks and sliced to the rank's shard; the loss is scaled by 1 / (the dp
ranks), so the shards hold the one-process gradient.  Clip and update
then run on the shards (:mod:`.optimizer`), and the metrics are summed
over the dp ranks: every rank returns the one-process ``loss`` and
``grad_norm``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from ..models import transformer as T
from ..models.config import ArchConfig
from ..models.weights import param_tree
from ..parallel import sharding
from ..parallel.compression import bf16_round_trip
from .optimizer import (OptConfig, clip_by_global_norm, leaves, opt_init,
                        opt_update)


class TrainState(NamedTuple):
    params: Any      # the model (a Transformer of float32 masters)
    opt: Any         # AdamWState or AdafactorState on param_tree(params)
    step: int


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    grad_accum: int = 1
    compute_dtype: Any = torch.bfloat16
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)
    grad_compression: bool = False


def init_state(arch: ArchConfig, model: T.Transformer) -> TrainState:
    """The model's parameters made trainable, and the optimizer state of
    ``arch.optimizer`` at step 0."""
    model.requires_grad_(True)
    return TrainState(model, opt_init(arch.optimizer, param_tree(model)), 0)


def grad_tree(tree: dict) -> dict:
    """The ``.grad`` of each parameter of a :func:`param_tree` (zeros for a
    parameter the loss does not reach, as the reference's gradient is)."""
    def grad(p):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        return p.grad
    return {k: [grad(t) for t in x] if isinstance(x, list) else grad(x)
            for k, x in tree.items()}


def make_train_step(arch: ArchConfig, tcfg: TrainConfig, *,
                    backend: str = "cuda", dp_axes=("data",),
                    param_specs=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.  ``batch``:
    ``{"tokens": (B, S) int, "labels": (B, S) int, optional "prefix":
    (B, npre, d_model)}`` on the model's device; B a multiple of
    ``grad_accum``.  ``backend`` is :func:`..models.loss_fn`'s.

    A model laid out on a mesh takes this rank's rows of the batch;
    ``dp_axes`` are the mesh axes its rows are split over and its
    gradients summed over (those the mesh lacks are left out).  The
    gradients take the parameters' placements; ``param_specs`` (name ->
    :class:`..parallel.sharding.NamedSharding` or placements), where given,
    must be those (the reference constrains its accumulation buffers to
    them)."""
    A = tcfg.grad_accum

    def layout(model):
        """(the mesh, its dp axes, their rank count), or None for a plain
        model."""
        mesh = sharding.model_mesh(model)
        if mesh is None:
            return None
        if param_specs is not None:
            for name, p in model.named_parameters():
                want = getattr(param_specs[name], "placements",
                               param_specs[name])
                if tuple(p.placements) != tuple(want):
                    raise ValueError(f"{name} lies as {p.placements}, "
                                     f"param_specs says {want}")
        dps = tuple(a for a in dp_axes if a in mesh.mesh_dim_names)
        return mesh, dps, math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                                    for a in dps)

    def train_step(state: TrainState, batch: dict):
        model = state.params
        spread = layout(model)
        tokens, labels = batch["tokens"], batch["labels"]
        prefix = batch.get("prefix")
        B = tokens.shape[0]
        if B % A:
            raise ValueError(f"batch {B} is not a multiple of grad_accum {A}")
        mb = B // A
        tree = param_tree(model)
        model.zero_grad(set_to_none=True)
        tot = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(A):
            rows = slice(i * mb, (i + 1) * mb)
            net = model if spread is None else sharding.Gathered(
                model, spread[1])
            loss = T.loss_fn(net, tokens[rows], labels[rows],
                             prefix_embeds=(None if prefix is None
                                            else prefix[rows]),
                             dtype=tcfg.compute_dtype, backend=backend)
            if spread is None:
                loss.backward()
            else:
                loss = loss / spread[2]
                net.backward(loss)
            tot = tot + loss.detach()
        if spread is not None:
            sharding.all_reduce_over(tot, spread[0], spread[1])
        grads = grad_tree(tree)
        with torch.no_grad(), torch.profiler.record_function("opt_update"):
            for g in leaves(grads):
                g.div_(A)
            if tcfg.grad_compression:  # compress_decompress, in place
                for g in leaves(grads):
                    g.copy_(bf16_round_trip(g))
            grads, gnorm = clip_by_global_norm(grads, tcfg.opt.clip_norm)
            opt_update(arch.optimizer, tcfg.opt, tree, grads, state.opt)
        model.zero_grad(set_to_none=True)
        metrics = {"loss": tot / A, "grad_norm": gnorm,
                   "step": state.step + 1}
        return TrainState(model, state.opt, state.step + 1), metrics

    return train_step
