"""Weights of the port's models: seeded initialisation (the counterpart of
the reference's ``parallel/sharding.init_params``) and loading the
reference's own parameters.

No weights are downloaded: both packages initialise from a seed.  The two
draw different numbers from the same seed (``torch.Generator`` against
``jax.random``), so a comparison between them carries the reference's
parameters over with :func:`load_reference_params`.

Training (:mod:`..train`): :func:`param_tree` lays the model's parameters
out as the reference's tree with its stacked leaves split per layer (the
optimizer's view); :func:`load_reference_state` carries a reference
``TrainState`` (parameters, AdamW or Adafactor state, step) across, and
:func:`reference_tree` maps the port's gradients and optimizer state back
onto the reference's stacked tree.
"""

from __future__ import annotations

import numpy as np
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
    params = dict(model.named_parameters())
    for name, value in init_values(model, seed, device=device):
        params[name].copy_(value)
    return model


@torch.no_grad()
def init_values(model: Transformer, seed: int = 0, *, device=None):
    """(name, float32 value) of each parameter in ``named_parameters``
    order, drawn as :func:`init_params` draws them on ``device`` (the
    model's by default; the model itself may be on the meta device)."""
    device = model.device if device is None else torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ZERO_INIT:
            yield name, torch.zeros(p.shape, device=device)
        elif leaf in ONE_INIT:
            yield name, torch.ones(p.shape, device=device)
        else:
            yield name, torch.randn(p.shape, generator=gen, device=device,
                                    dtype=torch.float32) * INIT_SCALE


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


def param_tree(model: Transformer) -> dict:
    """The model's parameters as the reference's tree, flat: the leaf's
    path (``"blocks/s0_attn/attn/wq"``) to the parameter, or, for a leaf
    the reference stacks over groups, to the list of the G per-layer
    parameters in group order; in ``named_parameters`` order."""
    params = dict(model.named_parameters())
    G = model.cfg.n_groups
    tree: dict = {}
    for name, path, g in reference_paths(model):
        key = "/".join(path)
        if g < 0:
            tree[key] = params[name]
        else:
            tree.setdefault(key, [None] * G)[g] = params[name]
    return tree


def reference_tree(tree: dict) -> dict:
    """A flat tree of :func:`param_tree`'s layout (parameters, gradients or
    an optimizer state's leaves) as the reference's nested dicts of numpy
    arrays, each list stacked along a new first axis."""
    out: dict = {}
    for key, x in tree.items():
        a = (np.stack([_numpy(t) for t in x]) if isinstance(x, list)
             else _numpy(x))
        node = out
        *head, leaf = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = a
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32 if t.is_floating_point()
                         else t.dtype).numpy()


@torch.no_grad()
def _fill(tree: dict, ref: dict) -> None:
    """Copy the reference's nested tree ``ref`` into a flat tree of the
    port's layout, a list's layers from the stacked leaf's rows."""
    for key, x in tree.items():
        a = ref
        for k in key.split("/"):
            a = a[k]
        a = np.asarray(a)
        for i, t in enumerate(x if isinstance(x, list) else [x]):
            src = a[i] if isinstance(x, list) else a
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{key}: shape {tuple(src.shape)}, the "
                                 f"port's is {tuple(t.shape)}")
            t.copy_(torch.tensor(np.array(src)).to(t.dtype))


def load_reference_state(state, ref_state):
    """Carry the reference's ``TrainState`` (params, AdamW ``m``/``v``/
    ``count`` or Adafactor ``vr``/``vc``/``v``/``count``, ``step``; numpy
    or jax arrays) into the port's ``TrainState`` of the same model and
    optimizer (:func:`..train.train_step.init_state`), in place.  Returns
    the port's state with the reference's step."""
    to_np = lambda tree: {k: (to_np(v) if isinstance(v, dict)
                              else np.asarray(v)) for k, v in tree.items()}
    load_reference_params(state.params, to_np(ref_state.params))
    opt = state.opt
    for field in opt._fields:
        if field == "count":
            opt.count.fill_(int(np.asarray(ref_state.opt.count)))
        else:
            _fill(getattr(opt, field), to_np(getattr(ref_state.opt, field)))
    return type(state)(state.params, opt, int(np.asarray(ref_state.step)))
