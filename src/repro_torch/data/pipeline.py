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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.backend.base import resolve_device


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


class DataIterator:
    """Stateful wrapper; ``skip_to(step)`` is O(1) by construction."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, *,
                 device=None):
        self.cfg = cfg
        self.step = start_step
        self.device = device

    def skip_to(self, step: int) -> None:
        self.step = step

    def __next__(self) -> dict:
        b = make_batch(self.cfg, self.step, device=self.device)
        self.step += 1
        return b

    def __iter__(self):
        return self
