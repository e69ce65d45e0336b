"""int8 weight-only quantization for serving: the counterpart of the
reference's ``repro/serve/quantize.py``.

Symmetric int8 with one float32 scale per row of a parameter's last axis:
``s = max(max |p| over the last axis, 1e-8) / 127`` and ``q = clip(round(p
/ s), -127, 127)`` (round half to even, as ``jnp.round``), taken from the
float32 masters (a bf16 model's weights are already rounded, and would
give other bits).  Which parameters quantize is the reference's rule read
on its stacked tree: it quantizes every leaf with ``ndim >= 2``, and a
block's leaves are stacked over groups, so

  * every block parameter quantizes, whatever its own rank: a 1-D one (a
    norm's ``w``, Mamba-2's ``A_log``, ``D``, ``dt_bias``, ``norm_w``)
    with one scale per layer, a (d_in, d_out) weight with one scale per
    input row;
  * ``embed``, ``unembed`` and the unstacked ``shared_attn`` block's
    parameters quantize where their own rank is >= 2 (the shared block's
    norms stay float32);
  * ``final_norm`` never quantizes.

:func:`quantize_params` returns a :class:`QuantizedModel`: the int8 ``q``,
the float32 ``s`` and the parameters left in float, beside a skeleton
:class:`~repro_torch.models.Transformer` on the ``meta`` device that holds
no values.  :func:`repro_torch.models.forward` (``quantized=True``) runs
each block of the skeleton through ``torch.func.functional_call`` on that
block's weights dequantized just before it (``q.to(bf16) *
s.to(bf16)``, the reference's ``dequantize``, then cast to the dtype the
block keeps the parameter in: the compute dtype, or float32 for the
parameters the port keeps in float32, which widens exactly).  So only the
int8 bytes stay resident, and at most one block's dequantized weights (and
the shared block's, dequantized up front as the reference does) exist at
a time.  On a ``meta`` model :func:`quantize_params` gives the shapes only
(the reference's ``quantized_pdefs``).

On a mesh (:func:`shard_quantized`; :func:`abstract_quantized` for the dry
run, on the meta device): each ``q`` is laid out as its parameter is
(``parallel.sharding.param_shardings``), each ``s`` the same with its last
axis whole (the reference's ``quantized_pdefs``: ``d.axes[:-1] +
(None,)``), each float parameter as itself.  Every rank keeps its blocks;
a block's ``q`` and ``s`` are gathered whole at its use and dequantized as
on one process, so a sharded int8 model computes the unsharded one's bits.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..kernels.library import is_dtensor
from ..models.transformer import Transformer
from ..models.weights import reference_paths
from ..parallel import sharding as SH


def _quantize(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q int8, s float32 of p's shape with a last axis of 1) of p."""
    p = p.float()
    s = torch.clamp(p.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    return torch.clamp(torch.round(p / s), -127, 127).to(torch.int8), s


def _dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The reference's ``dequantize`` of one leaf (each gathered whole where
    it is a shard): a bf16 product."""
    return (SH.full_tensor(q).to(torch.bfloat16)
            * SH.full_tensor(s).to(torch.bfloat16))


def _quantizes(name: str, p: torch.Tensor) -> bool:
    """A block parameter of any rank, any other of rank >= 2 (so never
    ``final_norm``)."""
    return name.startswith("layers.") or p.dim() >= 2


class QuantizedModel:
    """The int8 form of a :class:`~repro_torch.models.Transformer`:
    ``q``/``s`` (parameter name -> int8 values, float32 scales) for the
    parameters that quantize, ``plain`` (name -> float tensor) for the
    rest, and ``skeleton``, the model on the ``meta`` device in the compute
    dtype ``dtype``, whose blocks run on the dequantized weights.  On a
    mesh the tensors are ``DTensor`` shards (:func:`shard_quantized`), and
    ``split`` is the ``parallel.sharding.TokenSplit`` a serving call's MoE
    routes over (:meth:`on_rows`)."""

    def __init__(self, skeleton: Transformer, q: dict, s: dict,
                 plain: dict):
        self.skeleton, self.q, self.s, self.plain = skeleton, q, s, plain
        self.split = None
        self._prefix = {id(m): name for name, m in skeleton.named_modules()}

    @property
    def cfg(self):
        return self.skeleton.cfg

    @property
    def dtype(self) -> torch.dtype:
        return self.skeleton.dtype

    @property
    def device(self) -> torch.device:
        return SH.local(self.q["embed"]).device

    @property
    def mesh(self):
        """The mesh the int8 weights lie on, or None."""
        q = self.q["embed"]
        return q.device_mesh if is_dtensor(q) else None

    @property
    def final_norm(self) -> torch.Tensor:
        return SH.full_tensor(self.plain["final_norm"])

    def with_dtype(self, dtype: torch.dtype) -> QuantizedModel:
        """The same int8 weights computing in ``dtype``."""
        return QuantizedModel(Transformer(self.cfg, dtype=dtype,
                                          device="meta"),
                              self.q, self.s, self.plain)

    def on_rows(self, rows_split: bool = True) -> QuantizedModel:
        """The model a serving call runs: on a mesh, this model with its
        MoE routing over the rows of every data rank (over this rank's
        own where ``rows_split`` is false, as ``sharding.Gathered``);
        off a mesh, the model itself."""
        mesh = self.mesh
        if mesh is None:
            return self
        out = copy.copy(self)
        out.split = (SH.token_split(mesh, SH.dp_axes(mesh)) if rows_split
                     else None)
        return out

    def nbytes(self) -> int:
        """Bytes of every resident tensor (this rank's shards): q, s and
        the float parameters."""
        return sum(SH.local(t).numel() * t.element_size()
                   for d in (self.q, self.s, self.plain) for t in d.values())

    def embed_rows(self, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding's rows of ``tokens``, dequantized (bf16)."""
        return _dequantize(SH.full_tensor(self.q["embed"])[tokens],
                           SH.full_tensor(self.s["embed"])[tokens])

    def unembed_weight(self) -> torch.Tensor:
        """The (d_model, vocab) unembedding, dequantized (bf16)."""
        if self.cfg.tie_embeddings:
            return _dequantize(self.q["embed"], self.s["embed"]).T
        return _dequantize(self.q["unembed"], self.s["unembed"])

    def block_weights(self, block: nn.Module) -> dict:
        """Every parameter of ``block`` (a module of :attr:`skeleton`), by
        its name within the block, dequantized (or taken as it is) and cast
        to the dtype the block keeps it in."""
        prefix = self._prefix[id(block)]
        out = {}
        for name, p in block.named_parameters():
            full = f"{prefix}.{name}"
            w = (_dequantize(self.q[full], self.s[full]) if full in self.q
                 else SH.full_tensor(self.plain[full]))
            out[name] = w.to(p.dtype)
        return out


@torch.no_grad()
def quantize_params(model: Transformer) -> QuantizedModel:
    """The int8 form of ``model`` (its float32 masters, for the reference's
    bits), computing in the model's dtype (another through
    :meth:`QuantizedModel.with_dtype`).  On a ``meta`` model, shapes
    only."""
    skeleton = Transformer(model.cfg, dtype=model.dtype, device="meta")
    q, s, plain = {}, {}, {}
    for name, p in model.named_parameters():
        if _quantizes(name, p):
            q[name], s[name] = _quantize(p)
        else:
            plain[name] = p.detach().clone()
    return QuantizedModel(skeleton, q, s, plain)


def scale_sharding(sh: SH.NamedSharding) -> SH.NamedSharding:
    """An ``s``'s layout: its ``q``'s with the last axis whole."""
    return SH.NamedSharding(sh.mesh, sh.spec[:-1] + (None,))


@torch.no_grad()
def shard_quantized(qmodel: QuantizedModel, mesh) -> QuantizedModel:
    """``qmodel`` (whole, on this rank's device) laid out on ``mesh``: this
    rank's blocks of each ``q`` (its parameter's layout), ``s`` (the same,
    the last axis whole) and float parameter, copied."""
    specs = SH.param_shardings(qmodel.skeleton, mesh)
    return QuantizedModel(
        qmodel.skeleton,
        {n: SH.shard_tensor(t, specs[n]) for n, t in qmodel.q.items()},
        {n: SH.shard_tensor(t, scale_sharding(specs[n]))
         for n, t in qmodel.s.items()},
        {n: SH.shard_tensor(t, specs[n]) for n, t in qmodel.plain.items()})


def abstract_quantized(cfg, mesh, dtype=torch.bfloat16) -> QuantizedModel:
    """The int8 model of ``cfg`` computing in ``dtype`` laid out on
    ``mesh`` as :func:`shard_quantized` lays it out, its shards on the meta
    device (no allocation): the dry run's int8 model."""
    skeleton = Transformer(cfg, dtype=dtype, device="meta")
    specs = SH.param_shardings(skeleton, mesh)
    q, s, plain = {}, {}, {}
    for name, p in skeleton.named_parameters():
        shape, sh = tuple(p.shape), specs[name]
        if _quantizes(name, p):
            q[name] = SH.abstract_tensor(shape, torch.int8, sh)
            s[name] = SH.abstract_tensor(shape[:-1] + (1,), torch.float32,
                                         scale_sharding(sh))
        else:
            plain[name] = SH.abstract_tensor(shape, p.dtype, sh)
    return QuantizedModel(skeleton, q, s, plain)


@torch.no_grad()
def dequantize(qmodel: QuantizedModel) -> Transformer:
    """The model with every weight dequantized up front: a
    :class:`~repro_torch.models.Transformer` in ``qmodel``'s dtype on its
    device, the same function as ``qmodel`` run with ``quantized=True``."""
    model = Transformer(qmodel.cfg, dtype=qmodel.dtype, device=qmodel.device)
    for name, p in model.named_parameters():
        p.copy_(_dequantize(qmodel.q[name], qmodel.s[name])
                if name in qmodel.q else qmodel.plain[name])
    return model


@torch.no_grad()
def quantization_error(model: Transformer) -> float:
    """The reference's sanity metric: the largest round-trip error ``|q s -
    p|`` of a quantized leaf of the reference's tree over that leaf's
    largest ``|p|`` (at least 1e-8).  A block parameter is one group of a
    leaf stacked over groups, so errors and maxima are taken over every
    group of its slot before dividing."""
    params = dict(model.named_parameters())
    worst = {}
    for name, path, _ in reference_paths(model):
        p = params[name]
        if not _quantizes(name, p):
            continue
        q, s = _quantize(p)
        p = p.float()
        err, top = (q.float() * s - p).abs().max(), p.abs().max()
        if path in worst:
            err, top = (torch.maximum(err, worst[path][0]),
                        torch.maximum(top, worst[path][1]))
        worst[path] = (err, top)
    return max([0.0] + [float(err) / float(torch.clamp(top, min=1e-8))
                        for err, top in worst.values()])
