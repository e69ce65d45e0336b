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
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

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
    t = leaves(tree)[0]
    return torch.zeros((), dtype=torch.int32, device=t.device)


def _lr_at(cfg: OptConfig, count: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(count.float() / max(cfg.warmup, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> tuple[Tree, torch.Tensor]:
    """Scale ``grads`` in place by min(1, max_norm / max(norm, 1e-9)), the
    norm taken over every tensor in float32.  Returns (grads, norm)."""
    gs = leaves(grads)
    total = torch.zeros((), dtype=torch.float32, device=gs[0].device)
    for g in gs:
        g32 = g.float()
        total = total + torch.sum(g32 * g32)
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in gs:
        g.copy_(g * scale)
    return grads, gn


def adamw_init(params: Tree) -> AdamWState:
    z = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(_map(z, params), _map(z, params), _count0(params))


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
            g32 = g.float()
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
            step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            if pl.ndim + stacked >= 2:
                step = step + cfg.weight_decay * pl.float()
            pl.copy_(pl.float() - lr * step)
    return params, AdamWState(state.m, state.v, count)


def adafactor_init(params: Tree) -> AdafactorState:
    f32 = torch.float32
    dev = leaves(params)[0].device
    empty = lambda: torch.zeros((0,), dtype=f32, device=dev)
    vr, vc, v = {}, {}, {}
    for key, p in params.items():
        if isinstance(p, list) and p[0].ndim >= 2:
            vr[key] = [torch.zeros(t.shape[:-1], dtype=f32, device=dev)
                       for t in p]
            vc[key] = [torch.zeros(t.shape[:-2] + t.shape[-1:], dtype=f32,
                                   device=dev) for t in p]
            v[key] = empty()
        elif isinstance(p, list):  # stacked 1-D: the (G, d) matrix view
            vr[key] = [torch.zeros((), dtype=f32, device=dev) for _ in p]
            vc[key] = torch.zeros(p[0].shape, dtype=f32, device=dev)
            v[key] = empty()
        elif p.ndim >= 2:
            vr[key] = torch.zeros(p.shape[:-1], dtype=f32, device=dev)
            vc[key] = torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=f32,
                                  device=dev)
            v[key] = empty()
        else:
            vr[key], vc[key] = empty(), empty()
            v[key] = torch.zeros(p.shape, dtype=f32, device=dev)
    return AdafactorState(vr, vc, v, _count0(params))


def _factored(g32, vr, vc, decay):
    """The factored second moment's new row and column statistics of a
    ``>= 2``-D g (the reference's ``vr``/``vc`` update)."""
    g2 = g32 * g32 + 1e-30
    return (decay * vr + (1 - decay) * g2.mean(dim=-1),
            decay * vc + (1 - decay) * g2.mean(dim=-2))


def _factored_step(g32, vr, vc):
    denom = torch.sqrt(vr[..., None] * vc[..., None, :]
                       / torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None],
                                     min=1e-30))
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
                nr, nc = _factored(gl.float(), vr[key][i], vc[key][i], decay)
                vr[key][i].copy_(nr)
                vc[key][i].copy_(nc)
                step = _factored_step(gl.float(), vr[key][i], vc[key][i])
                total = total + torch.sum(step * step)
                n += step.numel()
            rms = torch.sqrt(total / n + 1e-30)
            for i, (pl, gl) in enumerate(zip(p, g)):
                _apply(cfg, pl, _factored_step(gl.float(), vr[key][i],
                                               vc[key][i]), rms, lr, True)
        elif isinstance(p, list):  # a stacked 1-D leaf as a (G, d) matrix
            g32 = torch.stack([gl.float() for gl in g])
            nr, nc = _factored(g32, torch.stack(vr[key]), vc[key], decay)
            for i, t in enumerate(vr[key]):
                t.copy_(nr[i])
            vc[key].copy_(nc)
            step = _factored_step(g32, nr, nc)
            rms = torch.sqrt(torch.mean(step * step) + 1e-30)
            for i, pl in enumerate(p):
                _apply(cfg, pl, step[i], rms, lr, True)
        elif p.ndim >= 2:
            g32 = g.float()
            nr, nc = _factored(g32, vr[key], vc[key], decay)
            vr[key].copy_(nr)
            vc[key].copy_(nc)
            step = _factored_step(g32, nr, nc)
            rms = torch.sqrt(torch.mean(step * step) + 1e-30)
            _apply(cfg, p, step, rms, lr, True)
        else:
            g32 = g.float()
            v[key].copy_(decay * v[key] + (1 - decay) * (g32 * g32 + 1e-30))
            step = g32 / (torch.sqrt(v[key]) + 1e-30)
            rms = torch.sqrt(torch.mean(step * step) + 1e-30)
            _apply(cfg, p, step, rms, lr, False)
    return params, AdafactorState(vr, vc, v, count)


def opt_init(kind: str, params: Tree) -> Any:
    return adamw_init(params) if kind == "adamw" else adafactor_init(params)


def opt_update(kind: str, cfg: OptConfig, params: Tree, grads: Tree,
               state) -> tuple[Tree, Any]:
    if kind == "adamw":
        return adamw_update(cfg, params, grads, state)
    return adafactor_update(cfg, params, grads, state)
