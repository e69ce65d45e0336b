"""Logical-axis sharding rules resolved against a device mesh, as the
reference's ``parallel/sharding.py``, and the port's training on them.

Rules (the reference's ``RULES``):
  * "fsdp" -> "data": ZeRO-3 parameter sharding; across pods the
    parameters are replicated and their gradients summed over "pod";
  * "tp"   -> "model": the feature dimension split over the model axis;
  * "layers"/None -> replicated.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions (:mod:`..launch.mesh`); :func:`logical_to_spec`,
:func:`dp_axes` and :func:`param_shardings` read only its axis names, so
they also take any object with ``mesh_dim_names``.  A
spec is the reference's ``PartitionSpec`` as a tuple: for each tensor
dimension the mesh axis it is split over (a tuple of axes for several),
or None; :func:`placements` turns it into ``DTensor`` placements.

The port keeps the reference's logical axes (its ``ParamDef.axes``) in
its own table, :data:`BLOCK_AXES`, :data:`MOE_AXES` and :data:`TOP_AXES`,
keyed by the leaf's path in the reference's tree
(:func:`..models.weights.reference_paths`).  A leaf the reference stacks
over groups has a leading ``"layers"`` axis, which resolves to nothing, so
the port's per-layer tensor takes the leaf's own axes.

Training across ranks (:func:`shard_model`, :class:`Gathered`): the
masters are ``DTensor`` parameters holding this rank's shard (torch.chunk's
split: a dimension of n over k ranks gives ceil(n / k) to the first ones).
A forward sees the model through :class:`Gathered`: the embedding, final
norm and unembedding are gathered whole at their first use in a
micro-batch, each block's weights at each of its applications, inside the
group's checkpoint, so the recomputation gathers them again; every kernel
sees whole plain tensors.  A gathered weight's gradient, summed over all
of its uses in the micro-batch, is summed over the data-parallel axes
(reduce-scatter where the weight is split over one, all-reduce where it is
replicated) and only sliced over the model axis: every model-axis rank
computed the same gradient for its rows.  Serving
(``models.prefill``/``decode_step`` on a sharded model) runs the blocks
through :class:`Gathered` the same way, with no gradient.

Two layouts of activations, as the reference's hillclimb sets them:

  * ``seq_shard`` (:class:`StreamSplit`): between blocks the residual
    stream is this rank's part of the sequence over "model"; each block
    gathers it whole at its entry (:class:`_StreamGather`) and keeps its
    part at its exit (:class:`_StreamPart`), each the other's backward, so
    every model rank computes the same forward and backward and a
    checkpoint keeps 1/tp of its group's input;
  * decode caches split along the sequence (:func:`split_caches`, the
    reference's ``long_ctx``: a batch of fewer rows than data ranks): the
    KV caches split over the data axes, then "model", along their slots
    (:class:`CacheSplit`), every other state replicated.

Every collective issued here is counted in :mod:`.collectives`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from ..kernels.library import is_dtensor
from ..models.layers import TOKEN_SPLIT
from . import collectives

RULES = {
    "fsdp": "data",
    "tp": "model",
    "layers": None,
    None: None,
}

_FT, _TF = ("fsdp", "tp"), ("tp", "fsdp")
#: the reference's ``ParamDef.axes`` of a block's leaves, by path in the
#: block (``models/layers.py:100-106, 256-259``, ``ssm.py:29-35``,
#: ``xlstm.py:29-34, 139-141``, ``transformer.py:98-108``)
BLOCK_AXES = {
    "ln1": (None,), "ln1_post": (None,), "ln2": (None,), "ln2_post": (None,),
    "attn/wq": _FT, "attn/wk": _FT, "attn/wv": _FT, "attn/wo": _TF,
    "attn/bq": ("tp",),
    "ffn/wi": _FT, "ffn/wg": _FT, "ffn/wo": _TF,
    "mamba/w_in": _FT, "mamba/conv_w": (None, "tp"), "mamba/A_log": (None,),
    "mamba/D": (None,), "mamba/dt_bias": (None,), "mamba/norm_w": (None,),
    "mamba/w_out": _TF,
    "mlstm/wq": _FT, "mlstm/wk": _FT, "mlstm/wv": _FT,
    "mlstm/wif": ("fsdp", None), "mlstm/wo": _TF, "mlstm/ogate": _FT,
    "slstm/w_in": _FT, "slstm/r": (None, None, None, None), "slstm/wo": _FT,
}
#: a mixture-of-experts feed-forward's leaves (``layers.py:234-238``)
MOE_AXES = {
    "ffn/router": ("fsdp", None), "ffn/wi": (None, "fsdp", "tp"),
    "ffn/wg": (None, "fsdp", "tp"), "ffn/wo": (None, "tp", "fsdp"),
    "ffn/shared/wi": _FT, "ffn/shared/wg": _FT, "ffn/shared/wo": _TF,
}
#: the unstacked leaves around the blocks (``transformer.py:98-108``)
TOP_AXES = {"embed": _TF, "final_norm": (None,), "unembed": _FT}


def axis_names(mesh) -> tuple[str, ...]:
    if mesh.mesh_dim_names is None:
        raise TypeError("a mesh with named axes")
    return tuple(mesh.mesh_dim_names)


def logical_to_spec(axes: tuple, mesh) -> tuple:
    """The mesh axis of each logical axis, None where the mesh lacks it."""
    names = axis_names(mesh)
    return tuple(RULES.get(a) if RULES.get(a) in names else None
                 for a in axes)


def placements(spec: tuple, mesh) -> tuple:
    """``DTensor`` placements of a spec: ``Shard(d)`` on each mesh axis
    that splits tensor dimension d, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def logical_axes(cfg, path: tuple) -> tuple:
    """The reference's logical axes of the leaf at ``path`` in its tree
    (per layer: a stacked leaf's leading "layers" left out)."""
    if path[0] == "blocks":
        key = "/".join(path[2:])
    elif path[0] == "shared_attn":
        key = "/".join(path[1:])
    else:
        return TOP_AXES["/".join(path)]
    if cfg.moe is not None and key.startswith("ffn/"):
        return MOE_AXES[key]
    return BLOCK_AXES[key]


def param_axes(model) -> dict[str, tuple]:
    """Parameter name -> its logical axes."""
    from ..models.weights import reference_paths

    return {name: logical_axes(model.cfg, path)
            for name, path, _ in reference_paths(model)}


def param_shardings(model, mesh) -> dict[str, NamedSharding]:
    """Parameter name -> its :class:`NamedSharding` on ``mesh``."""
    return {name: NamedSharding(mesh, logical_to_spec(axes, mesh))
            for name, axes in param_axes(model).items()}


def batch_sharding(mesh, *, seq_axis: str | None = None) -> NamedSharding:
    """Sharding of (B, S, ...) activations: the rows over every dp axis;
    for long context (batch 1) the sequence instead."""
    dps = dp_axes(mesh)
    if seq_axis == "seq":
        return NamedSharding(mesh, (None, dps))
    return NamedSharding(mesh, (dps, None))


# -- this rank's block of a tensor -------------------------------------------

def _chunk(n: int, parts: int, i: int) -> tuple[int, int]:
    """(start, length) of part i of n split as torch.chunk splits it."""
    c = -(-n // parts)
    start = min(i * c, n)
    return start, min(c, n - start)


def local_block(shape, place: tuple, mesh) -> tuple[slice, ...]:
    """This rank's index of a tensor of ``shape`` laid out by ``place``
    (a dimension split over several mesh axes is split by each in the
    mesh's order, as ``DTensor`` splits it: the rows of the multi-pod
    mesh's ("pod", "data"))."""
    coord = mesh.get_coordinate()
    index = [slice(0, n) for n in shape]
    for i, p in enumerate(place):
        if p.is_shard():
            s = index[p.dim]
            start, n = _chunk(s.stop - s.start, mesh.size(i), coord[i])
            index[p.dim] = slice(s.start + start, s.start + start + n)
    return tuple(index)


def _dtensor(local: torch.Tensor, mesh, place: tuple, shape) -> Any:
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=shape, stride=stride)


def shard_tensor(whole: torch.Tensor, sharding: NamedSharding):
    """A ``DTensor`` laid out by ``sharding`` holding a copy of this rank's
    block of ``whole``."""
    place = sharding.placements
    index = local_block(whole.shape, place, sharding.mesh)
    return _dtensor(whole[index].clone(), sharding.mesh, place, whole.shape)


def local(t: torch.Tensor) -> torch.Tensor:
    """The shard this rank holds (a plain tensor is its own)."""
    return t.to_local() if is_dtensor(t) else t


def shard_groups(t, dim: int) -> list:
    """The process groups over which tensor dimension ``dim`` of ``t`` is
    split (none for a plain tensor; a mesh axis of one rank splits
    nothing, so a sum over it is left out)."""
    if not is_dtensor(t):
        return []
    dim %= t.ndim
    mesh = t.device_mesh
    return [mesh.get_group(i) for i, p in enumerate(t.placements)
            if p.is_shard() and p.dim == dim and mesh.size(i) > 1]


def zeros_without(t: torch.Tensor, dim: int | None = None) -> torch.Tensor:
    """float32 zeros of ``t``'s shape (with dimension ``dim`` left out), on
    its layout: a shard where ``t`` is one, the dimension's own split
    dropped."""
    from torch.distributed.tensor import Replicate, Shard

    shape = list(t.shape)
    lshape = list(local(t).shape)
    if dim is not None:
        dim %= t.ndim
        del shape[dim], lshape[dim]
    z = torch.zeros(lshape, dtype=torch.float32, device=local(t).device)
    if not is_dtensor(t):
        return z
    place = tuple(
        Replicate() if not p.is_shard() or p.dim == dim
        else Shard(p.dim - 1 if dim is not None and p.dim > dim else p.dim)
        for p in t.placements)
    return _dtensor(z, t.device_mesh, place, shape)


# -- collectives ----------------------------------------------------------------

def _gather_dim(x: torch.Tensor, dim: int, n: int, group, parts: int
                ) -> torch.Tensor:
    """The whole of dimension ``dim`` (n long) from every rank's part.
    The parts are gathered stacked, (parts, ...), and moved into place by
    one reshape: a view where a single rank holds the dimension or every
    dimension before it is 1 long, else one copy of the whole."""
    c = -(-n // parts)
    dim %= x.ndim
    if x.shape[dim] < c:
        pad = list(x.shape)
        pad[dim] = c - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    out = x.new_empty((parts * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    collectives.record("all-gather", out)
    whole = list(x.shape)
    whole[dim] = parts * c
    return out.view((parts,) + tuple(x.shape)).movedim(0, dim).reshape(
        whole).narrow(dim, 0, n)


def _reduce_scatter_dim(x: torch.Tensor, dim: int, group, parts: int,
                        i: int) -> torch.Tensor:
    """Part i of dimension ``dim`` of the sum of ``x`` over the group."""
    n = x.shape[dim]
    c = -(-n // parts)
    x = x.movedim(dim, 0)
    if n < parts * c:
        x = torch.cat([x, x.new_zeros((parts * c - n,) + x.shape[1:])])
    out = x.new_empty((c,) + x.shape[1:])
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    collectives.record("reduce-scatter", out)
    return out[:_chunk(n, parts, i)[1]].movedim(0, dim)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor, gathered from every rank's shard (a collective of
    the mesh: every rank calls it), contiguous as the plain parameter is
    (a matmul of a transposed view may take another kernel, another
    rounding); a plain tensor is returned as it is."""
    if not is_dtensor(t):
        return t
    mesh, x = t.device_mesh, t.to_local()
    for i in reversed(range(len(t.placements))):
        p = t.placements[i]
        if p.is_shard():
            x = _gather_dim(x, p.dim, t.shape[p.dim], mesh.get_group(i),
                            mesh.size(i))
    return x.contiguous()


def reduce_to_shard(g: torch.Tensor, t, dp: tuple[str, ...]) -> torch.Tensor:
    """This rank's shard of the sum of ``g`` (a whole gradient of ``t``)
    over the mesh axes in ``dp``; over the others it is only sliced."""
    mesh = t.device_mesh
    names, coord = mesh.mesh_dim_names, mesh.get_coordinate()
    for i, p in enumerate(t.placements):
        group, parts = mesh.get_group(i), mesh.size(i)
        if names[i] in dp:
            if p.is_shard():
                g = _reduce_scatter_dim(g, p.dim, group, parts, coord[i])
            else:
                g = g.contiguous()
                dist.all_reduce(g, group=group)
                collectives.record("all-reduce", g)
        elif p.is_shard():
            start, n = _chunk(g.shape[p.dim], parts, coord[i])
            g = g.narrow(p.dim, start, n)
    return g.contiguous()


def all_reduce_over(x: torch.Tensor, mesh, axes: tuple[str, ...]
                    ) -> torch.Tensor:
    """``x`` summed over the mesh axes ``axes``, in place."""
    for a in axes:
        dist.all_reduce(x, group=mesh.get_group(a))
        collectives.record("all-reduce", x)
    return x


# -- models on a mesh -----------------------------------------------------------

def _owner(model: nn.Module, name: str) -> tuple[nn.Module, str]:
    *path, leaf = name.split(".")
    mod = model
    for p in path:
        mod = getattr(mod, p)
    return mod, leaf


def shard_model(model: nn.Module, shardings, *,
                values: Iterator[tuple[str, torch.Tensor]] | None = None,
                keep_values: bool = True) -> nn.Module:
    """Lay the model's parameters out by ``shardings`` (name ->
    :class:`NamedSharding`, or a mesh for :func:`param_shardings`'), in
    place: each becomes a ``DTensor`` parameter holding this rank's shard
    of its value (``values``: (name, whole value) in ``named_parameters``
    order, else the parameter's own, gathered where it is a shard on
    another mesh; ``keep_values=False``: uninitialised shards, to be
    restored into).  The shards live on the parameters' device, or the
    mesh's current one for a model on the meta device."""
    if not isinstance(shardings, dict):
        shardings = param_shardings(model, shardings)
    values = iter(values) if values is not None else None
    for name, p in list(model.named_parameters()):
        whole = None
        if values is not None:  # drawn one at a time: never all at once
            drawn, whole = next(values)
            if drawn != name:
                raise ValueError(f"value of {drawn} for parameter {name}")
        elif keep_values and p.device.type != "meta":
            whole = full_tensor(p.detach())
        sh = shardings[name]
        dev = (local(p).device if p.device.type != "meta"
               else _mesh_device(sh.mesh))
        index = local_block(p.shape, sh.placements, sh.mesh)
        lshape = [len(range(*s.indices(n))) for s, n in zip(index, p.shape)]
        x = torch.empty(lshape, dtype=p.dtype, device=dev)
        if whole is not None:  # a copy: a view would keep the whole alive
            x.copy_(whole[index])
        x = _dtensor(x, sh.mesh, sh.placements, p.shape)
        mod, leaf = _owner(model, name)
        mod._parameters[leaf] = nn.Parameter(x, requires_grad=p.requires_grad)
    return model


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def model_mesh(model: nn.Module):
    """The mesh the model's parameters lie on, or None for a plain model."""
    for p in model.parameters():
        if is_dtensor(p):
            return p.device_mesh
    return None


def abstract_params(model, mesh, dtype=torch.float32) -> dict:
    """Parameter name -> a ``DTensor`` on the meta device with the
    parameter's global shape and placements: dry-run inputs, no
    allocation."""
    shapes = {n: p.shape for n, p in model.named_parameters()}
    return {name: abstract_tensor(shapes[name], dtype, sh)
            for name, sh in param_shardings(model, mesh).items()}


def abstract_tensor(shape, dtype, sharding: NamedSharding):
    """A ``DTensor`` of global ``shape`` laid out by ``sharding`` whose
    local shard lies on the meta device: no allocation."""
    place = sharding.placements
    index = local_block(shape, place, sharding.mesh)
    lshape = [len(range(*s.indices(n))) for s, n in zip(index, shape)]
    return _dtensor(torch.empty(lshape, dtype=dtype, device="meta"),
                    sharding.mesh, place, shape)


def abstract_model(model, mesh):
    """``model`` (on the meta device) with each parameter replaced, in
    place, by an abstract ``DTensor`` of its shape, dtype and placements:
    a sharded model that holds no values, for a dry run."""
    params = dict(model.named_parameters())
    for name, sh in param_shardings(model, mesh).items():
        p = params[name]
        mod, leaf = _owner(model, name)
        mod._parameters[leaf] = nn.Parameter(
            abstract_tensor(p.shape, p.dtype, sh), requires_grad=False)
    return model


def init_params(model, seed: int = 0, mesh=None):
    """:func:`..models.weights.init_params`, then laid out on ``mesh``:
    each parameter's value drawn whole in turn on the mesh's device (the
    one-process values) and only this rank's shard kept.  On a mesh the
    model is on the meta device."""
    from ..models.weights import init_params as init_whole
    from ..models.weights import init_values

    if mesh is None:
        return init_whole(model, seed=seed)
    return shard_model(model, param_shardings(model, mesh),
                       values=init_values(model, seed,
                                          device=_mesh_device(mesh)))


# -- the forward of a sharded model ----------------------------------------------

@dataclasses.dataclass(frozen=True)
class TokenSplit:
    """The data-parallel ranks that split a micro-batch's rows, as
    :func:`..data.pipeline.local_rows` splits them (the first axis major),
    for :data:`..models.layers.TOKEN_SPLIT`: ``axes`` are the mesh's dp
    axes of more than one rank, in the mesh's order."""

    mesh: Any
    axes: tuple[str, ...]

    def _dims(self) -> list[int]:
        return [self.mesh.mesh_dim_names.index(a) for a in self.axes]

    @property
    def ranks(self) -> int:
        return math.prod(self.mesh.size(i) for i in self._dims())

    @property
    def index(self) -> int:
        coord, r = self.mesh.get_coordinate(), 0
        for i in self._dims():
            r = r * self.mesh.size(i) + coord[i]
        return r

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (a row for each of this rank's tokens),
        concatenated in the ranks' order (a collective of the ranks)."""
        for i in reversed(self._dims()):
            n = self.mesh.size(i)
            t = _gather_dim(t, 0, n * t.shape[0], self.mesh.get_group(i), n)
        return t


def token_split(mesh, dp: tuple[str, ...]) -> TokenSplit | None:
    """The :class:`TokenSplit` of the dp axes of more than one rank, None
    where one rank holds every row."""
    axes = tuple(a for i, a in enumerate(mesh.mesh_dim_names)
                 if a in dp and mesh.size(i) > 1)
    return TokenSplit(mesh, axes) if axes else None


class _Gather(torch.autograd.Function):
    """A parameter's shard -> the whole parameter; its backward hands the
    whole gradient to the :class:`Gathered` view that made it."""

    @staticmethod
    def forward(ctx, shard, view, param):
        ctx.view, ctx.param = view, param
        return full_tensor(param.detach())

    @staticmethod
    def backward(ctx, grad):
        return ctx.view._reduce(ctx.param, grad), None, None


class _Block:
    """A block of a sharded model run on its weights gathered whole at each
    call."""

    def __init__(self, view: "Gathered", block: nn.Module):
        self.view, self.block = view, block

    def __call__(self, x, **kwargs):
        weights = {n: self.view.gather(p)
                   for n, p in self.block.named_parameters()}
        token = TOKEN_SPLIT.set(self.view.split)
        try:
            return functional_call(self.block, weights, (x,), kwargs)
        finally:
            TOKEN_SPLIT.reset(token)


class Gathered:
    """A sharded model as :func:`..models.transformer.loss_fn` sees it in
    one micro-batch: ``embed``, ``final_norm`` and ``unembed`` gathered at
    their first use and kept for the micro-batch (the tied table's uses in
    the embedding and the unembedding share one gather), every block's
    weights at each call (:meth:`stack`).  Uses are counted while the
    forward runs; the backward of a weight's last use reduces the sum of
    the gradients of all its uses once (:func:`reduce_to_shard`) and
    hands it to the parameter's ``.grad``.  A block runs with
    :data:`..models.layers.TOKEN_SPLIT` set to the ranks that split the
    rows (:class:`TokenSplit`, None where one rank holds them all, or
    with ``rows_split=False``, where every rank runs the same rows, as a
    decode against caches split along the sequence does).  Call
    :meth:`backward` on the loss."""

    _TOP = ("embed", "final_norm", "unembed")

    def __init__(self, model: nn.Module, dp: tuple[str, ...] = ("data",),
                 *, rows_split: bool = True):
        self.model = model
        self.dp = tuple(dp)
        self.split = (token_split(model_mesh(model), self.dp)
                      if rows_split else None)
        self._top: dict[str, torch.Tensor] = {}
        self._uses: dict[int, int] = {}
        self._pending: dict[int, torch.Tensor] = {}
        self.recording = True

    def __getattr__(self, name):
        if name in Gathered._TOP:
            if name not in self._top:
                self._top[name] = self.gather(getattr(self.model, name))
            return self._top[name]
        return getattr(self.model, name)

    def gather(self, p: torch.Tensor) -> torch.Tensor:
        if not is_dtensor(p):
            return p
        if self.recording and torch.is_grad_enabled() and p.requires_grad:
            self._uses[id(p)] = self._uses.get(id(p), 0) + 1
        return _Gather.apply(p.to_local(), self, p)

    def stack(self) -> list:
        return [_Block(self, b) for b in self.model.stack()]

    def _reduce(self, p, grad: torch.Tensor):
        key = id(p)
        acc = self._pending.pop(key, None)
        acc = grad if acc is None else acc + grad
        left = self._uses.get(key, 1) - 1
        self._uses[key] = left
        if left > 0:
            self._pending[key] = acc
            return None
        return reduce_to_shard(acc, p, self.dp)

    def backward(self, loss: torch.Tensor) -> None:
        """``loss.backward()``; no use made during it (the recomputation
        under checkpoint) is counted."""
        self.recording = False
        loss.backward()
        if self._pending:
            raise RuntimeError(f"{len(self._pending)} gathered weights lack "
                               "the gradients of some of their uses")
        self._top.clear()


# -- the residual stream split along the sequence (seq_shard) ------------------

@dataclasses.dataclass(frozen=True)
class StreamSplit:
    """The sequence (dimension 1, n long) of (B, n, d) activations split
    over the mesh's "model" axis as torch.chunk splits it: :meth:`part` is
    this rank's, :meth:`whole` gathers every rank's (an all-gather)."""

    mesh: Any
    n: int

    @property
    def _dim(self) -> int:
        return self.mesh.mesh_dim_names.index("model")

    def part(self, x: torch.Tensor) -> torch.Tensor:
        i = self._dim
        start, n = _chunk(self.n, self.mesh.size(i),
                          self.mesh.get_coordinate()[i])
        return x.narrow(1, start, n).contiguous()

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        i = self._dim
        return _gather_dim(x, 1, self.n, self.mesh.get_group(i),
                           self.mesh.size(i)).contiguous()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole stream at a block's entry (autograd: its part)."""
        return _StreamGather.apply(x, self)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part at a block's exit (autograd: the whole)."""
        return _StreamPart.apply(x, self)


class _StreamGather(torch.autograd.Function):
    """Part -> whole; the backward keeps this rank's part of the gradient,
    which every model rank computed whole and alike."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return split.whole(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.split.part(g), None


class _StreamPart(torch.autograd.Function):
    """Whole -> part; the backward gathers the parts of the gradient."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return split.part(x).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.split.whole(g.contiguous()), None


def stream_split(mesh, n: int) -> StreamSplit | None:
    """The split of an n-long sequence over the "model" axis of ``mesh``,
    None where there is no mesh or the axis has one rank."""
    names = () if mesh is None else mesh.mesh_dim_names
    if "model" not in names or mesh.size(names.index("model")) == 1:
        return None
    return StreamSplit(mesh, n)


# -- decode caches split along the sequence (the reference's long_ctx) ---------

def cache_spec(mesh) -> tuple:
    """A KV cache's (B, S, n_kv_heads, d_head) spec: the slots over the dp
    axes, then "model" (the reference's ``P(None, None, dps + ("model",),
    None, None)`` of its stacked caches)."""
    axes = dp_axes(mesh) + tuple(a for a in ("model",)
                                 if a in axis_names(mesh))
    return (None, axes, None, None)


def split_caches(caches: list, mesh) -> list:
    """A whole prefill's caches (``models.prefill``'s, of a batch every rank
    runs whole) with each KV cache's ``k`` and ``v`` a ``DTensor`` holding
    this rank's slots (:func:`cache_spec`); the int8 scales and every
    other state (Mamba-2's, the xLSTM's) stay whole on every rank."""
    sh = NamedSharding(mesh, cache_spec(mesh))
    return [{k: shard_tensor(t, sh) if k in ("k", "v") else t
             for k, t in c.items()} for c in caches]


@dataclasses.dataclass(frozen=True)
class CacheSplit:
    """This rank's slots ``[start, start + n)`` of a cache of ``total``
    slots split over the mesh dimensions ``dims``, and the sums and maxima
    over those ranks that a decode's softmax and P·V take."""

    mesh: Any
    dims: tuple[int, ...]
    start: int
    total: int

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """``x`` reduced (``"sum"`` or ``"max"``) over the ranks, in
        place."""
        red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        for i in self.dims:
            if self.mesh.size(i) > 1:
                dist.all_reduce(x, op=red, group=self.mesh.get_group(i))
                collectives.record("all-reduce", x)
        return x


def cache_split(t) -> CacheSplit | None:
    """The :class:`CacheSplit` of a cache split along its slots (dimension
    1), None for any other tensor."""
    if not is_dtensor(t):
        return None
    dims = tuple(i for i, p in enumerate(t.placements)
                 if p.is_shard() and p.dim == 1)
    if not dims:
        return None
    s = local_block(t.shape, t.placements, t.device_mesh)[1]
    return CacheSplit(t.device_mesh, dims, s.start, t.shape[1])
