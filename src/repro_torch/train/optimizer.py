"""Hand-rolled optimizers, as the reference's ``train/optimizer.py``:
AdamW and Adafactor, and the global-norm clip.

The reference works on its parameter tree, where each slot's block
parameters are stacked over groups into one leaf (``model_pdefs``).  The
port keeps one module per layer, so these functions take the reference's
tree with its stacked leaves split per layer: a dict from the leaf's path
(``"blocks/s0_attn/attn/wq"``) to a tensor, or to a list of the G
per-layer tensors of a stacked leaf (:func:`..models.weights.param_tree`
builds it from a model).  They give the reference's results on its
stacked view:

* AdamW decays every leaf of ``ndim >= 2`` in the reference's tree, so
  every layer's norm weights (a stacked (G, d) leaf) but not
  ``final_norm`` or Zamba2's unstacked ``shared_attn`` norms;
* Adafactor factors a stacked 1-D parameter as a (G, d) matrix: its row
  statistic ``vr`` is one scalar a layer, its column statistic ``vc`` (d,)
  is shared by the slot's layers, and so is the mean of ``vr``; a stacked
  ``>= 2``-D parameter keeps ``vr`` and ``vc`` per layer;
* Adafactor's relative step clip (RMS <= 1) is taken over the whole
  stacked leaf: a slot's layers share one RMS.

The cross-layer reductions are sums over the slot's layers (the clip's
RMS in two passes, the step recomputed in the second), so a slot's masters
are never stacked; only a stacked 1-D leaf (G x d norm weights or Mamba-2
scalars) is.  The functions update the parameters and the state in place
(the reference returns new trees; a float32 model's masters and moments
would not fit twice) and return them.  State leaves follow the
parameters' layout: a list where the reference's state leaf has the layer
axis first (AdamW's ``m``/``v``; Adafactor's ``vr`` and, for ``>= 2``-D
parameters, ``vc``), one tensor where it has none.

On a model laid out over a mesh (:mod:`..parallel.sharding`) the
parameters, gradients and state are ``DTensor`` shards: the state takes
its parameter's placements (``vr`` and ``vc`` those of the dimensions
they keep), every update works on the local shards, and each reduction
the reference takes over a whole tensor (the clip's norm, Adafactor's
row and column means and its RMS) sums the local parts over the ranks
that split the reduced dimensions.  A plain model runs the same code
with no collective, bit for bit as before.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from ..parallel import collectives
from ..parallel.sharding import local, shard_groups, zeros_without

Tree = dict  # path -> tensor, or list of per-layer tensors (stacked leaf)


class AdamWState(NamedTuple):
    m: Tree
    v: Tree
    count: torch.Tensor  # int32, ()


class AdafactorState(NamedTuple):
    vr: Tree     # row stats (for >= 2-D params in the reference's view)
    vc: Tree     # col stats
    v: Tree      # full stats (1-D params)
    count: torch.Tensor


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"           # "adamw" | "adafactor"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100


def leaves(tree: Tree) -> list[torch.Tensor]:
    """Every tensor of a tree, a stacked leaf's layers in order."""
    out = []
    for x in tree.values():
        out.extend(x if isinstance(x, list) else [x])
    return out


def _map(fn, tree: Tree) -> Tree:
    return {k: [fn(t) for t in x] if isinstance(x, list) else fn(x)
            for k, x in tree.items()}


def _count0(tree: Tree) -> torch.Tensor:
    t = local(leaves(tree)[0])
    return torch.zeros((), dtype=torch.int32, device=t.device)


def _lr_at(cfg: OptConfig, count: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(count.float() / max(cfg.warmup, 1), max=1.0)
    return cfg.lr * warm


# -- reductions over a tensor laid out on a mesh ---------------------------------

def _summed(x: torch.Tensor, groups: list) -> torch.Tensor:
    """A local partial sum completed over the ranks of ``groups``."""
    for g in groups:
        dist.all_reduce(x, group=g)
        collectives.record("all-reduce", x)
    return x


def _all_groups(t) -> list:
    """The process groups that split any dimension of ``t``."""
    return [g for d in range(t.ndim) for g in shard_groups(t, d)]


def _mean(x: torch.Tensor, dim: int, like) -> torch.Tensor:
    """``x.mean(dim)`` of the whole tensor, x being the local block of a
    tensor laid out as ``like`` whose dimension ``dim`` (from the end) is
    x's."""
    groups = shard_groups(like, dim)
    if not groups:
        return x.mean(dim=dim)
    return _summed(x.sum(dim=dim), groups) / like.shape[dim]


def _mean_all(x: torch.Tensor, like, rows: int = 1) -> torch.Tensor:
    """``torch.mean(x)`` of the whole tensor, x being the local block of
    ``rows`` tensors laid out as ``like``, stacked."""
    groups = _all_groups(like)
    if not groups:
        return torch.mean(x)
    return _summed(torch.sum(x), groups) / (rows * like.numel())


@torch.no_grad()
def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> tuple[Tree, torch.Tensor]:
    """Scale ``grads`` in place by min(1, max_norm / max(norm, 1e-9)), the
    norm taken over every tensor in float32.  Returns (grads, norm)."""
    gs = leaves(grads)
    # a partial sum for each set of process groups that split a tensor,
    # completed over them once
    parts: dict[tuple, list] = {}
    for g in gs:
        groups = _all_groups(g)
        part = parts.setdefault(tuple(map(id, groups)), [groups, None])
        g32 = local(g).float()
        if part[1] is None:
            part[1] = torch.zeros((), dtype=torch.float32, device=g32.device)
        part[1] = part[1] + torch.sum(g32 * g32)
    total = None
    for groups, part in parts.values():
        part = _summed(part, groups)
        total = part if total is None else total + part
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in map(local, gs):
        g.copy_(g * scale)
    return grads, gn


def adamw_init(params: Tree) -> AdamWState:
    return AdamWState(_map(zeros_without, params),
                      _map(zeros_without, params), _count0(params))


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: Tree, grads: Tree,
                 state: AdamWState) -> tuple[Tree, AdamWState]:
    """One AdamW step, in place: m, v in float32, the bias corrections of
    ``count`` + 1, the warm-up learning rate, decay on the reference's
    ``ndim >= 2`` leaves."""
    count = state.count.add_(1)
    cf = count.float()
    b1c = 1 - torch.pow(cfg.b1, cf)
    b2c = 1 - torch.pow(cfg.b2, cf)
    lr = _lr_at(cfg, count)
    for key, p in params.items():
        stacked = isinstance(p, list)
        layers = zip(p, grads[key], state.m[key], state.v[key]) if stacked \
            else [(p, grads[key], state.m[key], state.v[key])]
        for pl, g, m, v in layers:
            pl, m, v = local(pl), local(m), local(v)
            g32 = local(g).float()
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
            step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            if pl.ndim + stacked >= 2:
                step = step + cfg.weight_decay * pl.float()
            pl.copy_(pl.float() - lr * step)
    return params, AdamWState(state.m, state.v, count)


def adafactor_init(params: Tree) -> AdafactorState:
    dev = local(leaves(params)[0]).device
    empty = lambda: torch.zeros((0,), dtype=torch.float32, device=dev)
    vr, vc, v = {}, {}, {}
    for key, p in params.items():
        if isinstance(p, list) and p[0].ndim >= 2:
            vr[key] = [zeros_without(t, -1) for t in p]
            vc[key] = [zeros_without(t, -2) for t in p]
            v[key] = empty()
        elif isinstance(p, list):  # stacked 1-D: the (G, d) matrix view
            vr[key] = [torch.zeros((), dtype=torch.float32, device=dev)
                       for _ in p]
            vc[key] = zeros_without(p[0])
            v[key] = empty()
        elif p.ndim >= 2:
            vr[key] = zeros_without(p, -1)
            vc[key] = zeros_without(p, -2)
            v[key] = empty()
        else:
            vr[key], vc[key] = empty(), empty()
            v[key] = zeros_without(p)
    return AdafactorState(vr, vc, v, _count0(params))


def _factored(g32, vr, vc, decay, like):
    """The factored second moment's new row and column statistics of a
    ``>= 2``-D g (the reference's ``vr``/``vc`` update), g32 the local
    block of a gradient laid out as ``like`` (a stacked (G, d) view of
    1-D leaves: ``like`` is one of them, and its rows are never split)."""
    g2 = g32 * g32 + 1e-30
    col = g2.mean(dim=-2) if like.ndim == 1 else _mean(g2, -2, like)
    return (decay * vr + (1 - decay) * _mean(g2, -1, like),
            decay * vc + (1 - decay) * col)


def _factored_step(g32, vr, vc, vr_like=None):
    """``vr_like``: the layout ``vr`` is the local block of (None: whole)."""
    vr_mean = (vr.mean(dim=-1, keepdim=True) if vr_like is None
               else _mean(vr, -1, vr_like)[..., None])
    denom = torch.sqrt(vr[..., None] * vc[..., None, :]
                       / torch.clamp(vr_mean[..., None], min=1e-30))
    return g32 / torch.clamp(denom, min=1e-30)


def _apply(cfg, p, step, rms, lr, decays: bool):
    step = step / torch.clamp(rms, min=1.0)
    if decays:
        step = step + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * step)


@torch.no_grad()
def adafactor_update(cfg: OptConfig, params: Tree, grads: Tree,
                     state: AdafactorState
                     ) -> tuple[Tree, AdafactorState]:
    """One Adafactor step, in place, on the reference's stacked view."""
    count = state.count.add_(1)
    decay = 1.0 - count.float() ** -0.8
    lr = _lr_at(cfg, count)
    vr, vc, v = state.vr, state.vc, state.v
    for key, p in params.items():
        g = grads[key]
        if isinstance(p, list) and p[0].ndim >= 2:
            # per layer but the RMS: pass 1 updates the statistics and sums
            # the squares of the steps, pass 2 recomputes and applies them
            total, n = 0.0, 0
            for i, gl in enumerate(g):
                r, c = local(vr[key][i]), local(vc[key][i])
                g32 = local(gl).float()
                nr, nc = _factored(g32, r, c, decay, gl)
                r.copy_(nr)
                c.copy_(nc)
                step = _factored_step(g32, r, c, vr[key][i])
                total = total + _summed(torch.sum(step * step),
                                        _all_groups(gl))
                n += gl.numel()
            rms = torch.sqrt(total / n + 1e-30)
            for i, (pl, gl) in enumerate(zip(p, g)):
                _apply(cfg, local(pl), _factored_step(
                    local(gl).float(), local(vr[key][i]), local(vc[key][i]),
                    vr[key][i]), rms, lr, True)
        elif isinstance(p, list):  # a stacked 1-D leaf as a (G, d) matrix
            g32 = torch.stack([local(gl).float() for gl in g])
            c = local(vc[key])
            nr, nc = _factored(g32, torch.stack(vr[key]), c, decay, g[0])
            for i, t in enumerate(vr[key]):
                t.copy_(nr[i])
            c.copy_(nc)
            step = _factored_step(g32, nr, nc)
            rms = torch.sqrt(_mean_all(step * step, g[0], len(g)) + 1e-30)
            for i, pl in enumerate(p):
                _apply(cfg, local(pl), step[i], rms, lr, True)
        elif p.ndim >= 2:
            g32 = local(g).float()
            r, c = local(vr[key]), local(vc[key])
            nr, nc = _factored(g32, r, c, decay, g)
            r.copy_(nr)
            c.copy_(nc)
            step = _factored_step(g32, nr, nc, vr[key])
            rms = torch.sqrt(_mean_all(step * step, g) + 1e-30)
            _apply(cfg, local(p), step, rms, lr, True)
        else:
            g32 = local(g).float()
            s = local(v[key])
            s.copy_(decay * s + (1 - decay) * (g32 * g32 + 1e-30))
            step = g32 / (torch.sqrt(s) + 1e-30)
            rms = torch.sqrt(_mean_all(step * step, g) + 1e-30)
            _apply(cfg, local(p), step, rms, lr, False)
    return params, AdafactorState(vr, vc, v, count)


def opt_init(kind: str, params: Tree) -> Any:
    return adamw_init(params) if kind == "adamw" else adafactor_init(params)


def opt_update(kind: str, cfg: OptConfig, params: Tree, grads: Tree,
               state) -> tuple[Tree, Any]:
    if kind == "adamw":
        return adamw_update(cfg, params, grads, state)
    return adafactor_update(cfg, params, grads, state)
