"""Gradient compression with error feedback, as the reference's
``parallel/compression.py``: gradients rounded to bf16 and back, the
rounding error carried in a float32 residual and added to the next step's
gradient (error feedback keeps SGD unbiased to first order).  Trees are
those of :mod:`..train.optimizer` (path -> tensor or list of per-layer
tensors)."""

from __future__ import annotations

import torch

from ..train.optimizer import Tree, _map


def bf16_round_trip(g: torch.Tensor) -> torch.Tensor:
    """g rounded to bf16 and back to float32."""
    return g.to(torch.bfloat16).to(torch.float32)


def compress_decompress(grads: Tree) -> Tree:
    """Round-trip bf16 (the stateless form of the train step)."""
    return _map(bf16_round_trip, grads)


def compress_with_feedback(grads: Tree, residual: Tree
                           ) -> tuple[Tree, Tree]:
    """Error-feedback form: returns (compressed grads, new residual)."""
    comp, res = {}, {}
    for k, g in grads.items():
        pairs = [_one(a, b) for a, b in zip(g, residual[k])] \
            if isinstance(g, list) else [_one(g, residual[k])]
        comp[k] = [c for c, _ in pairs] if isinstance(g, list) \
            else pairs[0][0]
        res[k] = [r for _, r in pairs] if isinstance(g, list) \
            else pairs[0][1]
    return comp, res


def _one(g: torch.Tensor, r: torch.Tensor):
    corrected = g.float() + r
    q = bf16_round_trip(corrected)
    return q, corrected - q


def init_residual(params: Tree) -> Tree:
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
