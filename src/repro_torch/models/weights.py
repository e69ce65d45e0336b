"""Weights of the port's models: seeded initialisation (the counterpart of
the reference's ``parallel/sharding.init_params``) and loading the
reference's own parameters.

No weights are downloaded: both packages initialise from a seed.  The two
draw different numbers from the same seed (``torch.Generator`` against
``jax.random``), so a comparison between them carries the reference's
parameters over with :func:`load_reference_params`.
"""

from __future__ import annotations

import torch

from .transformer import Transformer, mixer_slots

#: parameters the reference initialises to zero (``init_scale == 0``): the
#: norms' ``w`` of ``(1 + w)``, Mamba-2's gated norm among them
ZERO_INIT = frozenset({"ln1", "ln1_post", "ln2", "ln2_post", "final_norm",
                       "norm_w"})
#: 1-D parameters the reference initialises to one (``init_scale == 1``):
#: Mamba-2's per-head scalars; every other parameter is normal x 0.02
#: (sLSTM's ``r`` among them: its ``ParamDef`` names 0.02)
ONE_INIT = frozenset({"A_log", "D", "dt_bias"})
INIT_SCALE = 0.02


@torch.no_grad()
def init_params(model: Transformer, seed: int = 0) -> Transformer:
    """Fill every parameter from an explicit ``torch.Generator`` seeded with
    ``seed`` on the model's device, by the reference's rule
    (``parallel/sharding.init_params``): zeros where its ``init_scale`` is
    0, ones where it is 1, normal x 0.02 elsewhere, drawn in float32 and
    cast to the parameter's dtype (the reference keeps float32 weights and
    casts at each use)."""
    device = model.device
    if device.type == "meta":
        raise ValueError("a model on the meta device holds no values")
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ZERO_INIT:
            p.zero_()
        elif leaf in ONE_INIT:
            p.fill_(1.0)
        else:
            p.copy_(torch.randn(p.shape, generator=gen, device=device,
                                dtype=torch.float32) * INIT_SCALE)
    return model


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def reference_paths(model: Transformer) -> list[tuple[str, tuple, int]]:
    """Where each parameter of ``model`` lives in the reference's tree
    (``model_pdefs``): (the parameter's name, the leaf's path, the group it
    takes of a leaf stacked over groups, or -1 for an unstacked leaf).
    Layer ``g * n_slots + s`` is group g of slot s (``blocks/<slot>/...``);
    the embedding, final norm, unembedding and the ``shared_attn`` block
    are unstacked."""
    slots = mixer_slots(model.cfg)
    out = []
    for name, _ in model.named_parameters():
        parts = tuple(name.split("."))
        if parts[0] == "layers":
            g, s = divmod(int(parts[1]), len(slots))
            out.append((name, ("blocks", slots[s][0]) + parts[2:], g))
        else:
            out.append((name, parts, -1))
    return out


@torch.no_grad()
def load_reference_params(model: Transformer, tree: dict) -> Transformer:
    """Copy the reference's parameter tree (nested dicts of numpy arrays,
    each slot's leaves stacked over groups, as ``model_pdefs`` lays them
    out, and the unstacked ``shared_attn`` block) into ``model``, each cast
    to its parameter's dtype (:func:`reference_paths`).  Raises on a leaf
    of either side that the other lacks."""
    leaves = dict(_leaves(tree))
    params = dict(model.named_parameters())
    used = set()
    for name, path, g in reference_paths(model):
        if path not in leaves:
            raise ValueError(f"the reference tree has no {'/'.join(path)}")
        used.add(path)
        a = leaves[path] if g < 0 else leaves[path][g]
        a = torch.tensor(a)  # a copy: the reference's arrays are read-only
        p = params[name]
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(a.shape)}, the "
                             f"model's is {tuple(p.shape)}")
        p.copy_(a.to(p.dtype))
    left = sorted("/".join(k) for k in leaves if k not in used)
    if left:
        raise ValueError(f"the model has no place for {left}")
    return model
