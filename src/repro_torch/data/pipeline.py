"""Deterministic synthetic-text data pipeline, as the reference's
``data/pipeline.py``: a batch is a pure function of (seed, step), drawn
with numpy from ``SeedSequence([seed, step])`` in the reference's order,
so both packages give the same tokens and labels bit for bit, and a
restart resumes the stream at the restored step (no data-state file).
Tokens are per-document Markov chains over a Zipf(1.3) distribution: each
position repeats the previous token with probability 0.3.  A prefix of
``n_prefix_embeds`` embeddings (normal x 0.02, drawn in float64) is
rounded to bf16 as ``jnp.asarray(x, jnp.bfloat16)`` rounds it: through
float32 (:func:`bf16_from_f64`).

Across ranks each rank takes its rows of the global batch
(:func:`shard_batch`): the rows are split over the mesh's dp axes
(``parallel.sharding.batch_sharding``) inside each microbatch, as the
reference's ``reshape(A, mb, -1)`` keeps the split on its second axis,
so microbatch i of every rank is its part of the global microbatch i.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.backend.base import resolve_device
from ..parallel.sharding import batch_sharding


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_prefix_embeds: int = 0
    d_model: int = 0


def bf16_from_f64(x: np.ndarray) -> torch.Tensor:
    """float64 values in bf16 as ``jnp.asarray(x, jnp.bfloat16)`` gives
    them: rounded to float32 and then to bf16, each to nearest even (so a
    value just off a bf16 halfway point that float32 rounds onto it ties
    to even, where one rounding from float64 would not)."""
    return torch.from_numpy(np.asarray(x, dtype=np.float64)
                            .astype(np.float32)).to(torch.bfloat16)


def make_batch(cfg: DataConfig, step: int, *, device=None) -> dict:
    """Batch for ``step``: ``tokens`` and ``labels`` (B, S - npre) int32,
    and ``prefix`` (B, npre, d_model) bf16 where the config has one, on
    ``device`` (the card unless given)."""
    device = resolve_device(device)
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    B = cfg.global_batch
    S = cfg.seq_len - cfg.n_prefix_embeds
    zipf = rng.zipf(1.3, size=(B, S + 1)) % cfg.vocab
    # short-range structure: each position repeats the previous token with
    # probability 0.3 (an easy conditional to learn)
    rep = rng.random((B, S + 1)) < 0.3
    toks = zipf.copy()
    for j in range(1, S + 1):
        toks[:, j] = np.where(rep[:, j], toks[:, j - 1], toks[:, j])
    batch = {
        "tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
        "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)),
    }
    if cfg.n_prefix_embeds:
        batch["prefix"] = bf16_from_f64(
            rng.standard_normal((B, cfg.n_prefix_embeds, cfg.d_model)) * 0.02)
    return {k: v.to(device) for k, v in batch.items()}


def local_rows(mesh, batch: int, grad_accum: int = 1) -> torch.Tensor:
    """The rows of a global batch of ``batch`` rows that this rank takes on
    ``mesh``: in each of the ``grad_accum`` microbatches of mb rows, part
    r of mb / D, where D is the product of the dp axes' sizes and r this
    rank's index over them (the first axis major)."""
    mb, A = batch // grad_accum, grad_accum
    if batch % A:
        raise ValueError(f"batch {batch} is not a multiple of grad_accum {A}")
    names, coord = mesh.mesh_dim_names, mesh.get_coordinate()
    D, r = 1, 0
    for i, p in enumerate(batch_sharding(mesh).placements):
        if p.is_shard():
            D, r = D * mesh.size(i), r * mesh.size(i) + coord[i]
    if mb % D:
        raise ValueError(f"microbatch of {mb} rows does not split over "
                         f"{D} data-parallel ranks ({names})")
    n = mb // D
    return torch.cat([torch.arange(i * mb + r * n, i * mb + (r + 1) * n)
                      for i in range(A)])


def shard_batch(batch: dict, mesh, grad_accum: int = 1) -> dict:
    """This rank's rows of a global batch (:func:`local_rows`); the batch
    itself without a mesh."""
    if mesh is None:
        return batch
    rows = local_rows(mesh, batch["tokens"].shape[0], grad_accum)
    return {k: v[rows.to(v.device)] for k, v in batch.items()}


class DataIterator:
    """Stateful wrapper; ``skip_to(step)`` is O(1) by construction.  With
    a ``mesh``, each batch is this rank's rows (:func:`shard_batch`)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, *,
                 device=None, mesh=None, grad_accum: int = 1):
        self.cfg = cfg
        self.step = start_step
        self.device = device
        self.mesh = mesh
        self.grad_accum = grad_accum

    def skip_to(self, step: int) -> None:
        self.step = step

    def __next__(self) -> dict:
        b = shard_batch(make_batch(self.cfg, self.step, device=self.device),
                        self.mesh, self.grad_accum)
        self.step += 1
        return b

    def __iter__(self):
        return self
