"""Rematerialisation of a training forward: the checkpoint policies of the
reference's ``forward(mode="train")`` and a count of what a forward keeps
for its backward.

``cfg.remat`` (``models/config.py``) names the policy a group of blocks
runs under (:func:`.transformer._train_stack`):

  * ``"block"``: the reference's ``nothing_saveable``.  The group runs
    under ``torch.utils.checkpoint`` and keeps only its input; the backward
    computes the whole group again.
  * ``"dots"``: the reference's ``dots_with_no_batch_dims_saveable``.  The
    outputs of the products without a batch dimension (``aten.mm`` and
    ``aten.addmm``: the projections of x (B, S, d) by a 2-D weight) are kept
    (:func:`dots_policy`), and everything else is computed again: a product
    with a batch dimension (``aten.bmm``: the MoE's experts, the SSD and
    mLSTM einsums, the plain attention), the norms, the activations, and
    what K8 and K9 compute inside their ``autograd.Function``s (the card's
    kernels launch through ``ctypes``, outside the dispatcher).  So are the
    collectives of a sharded model's gathers (``parallel.sharding.Gathered``):
    c10d ops are not products, and every rank issues them again in the same
    order.
  * ``"none"``: no checkpoint.

:class:`SavedBytes` counts the bytes a forward keeps for its backward:
every tensor autograd saves outside a checkpointed region (through
``torch.autograd.graph.saved_tensors_hooks``; a checkpoint's inputs are
saved there), each storage once, parameters left out, and every output
the ``"dots"`` policy keeps inside one (a fresh tensor, its bytes from the
product's local shapes).  It stands in
for XLA's memory analysis, which the reference reads and the port lacks.
"""

from __future__ import annotations

import contextvars
import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

#: the products without a batch dimension whose outputs ``"dots"`` keeps
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

#: the :class:`SavedBytes` counting the forward that runs, or None
COUNTER: contextvars.ContextVar = contextvars.ContextVar("COUNTER",
                                                         default=None)


def dots_policy(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    """Keep the output of ``aten.mm``/``aten.addmm``; compute every other
    op again (c10d's collectives included)."""
    if func in DOTS:
        counter = COUNTER.get()
        if counter is not None and not ctx.is_recompute:
            a, b = args[-2:]  # mm(a, b), addmm(bias, a, b): (n, m), a's dtype
            counter.count(a.shape[0] * b.shape[1] * a.element_size())
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def context_fn(remat: str):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for ``remat``
    (None: plain checkpointing, which keeps nothing inside the region)."""
    if remat == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 dots_policy)
    return None


class SavedBytes:
    """``with SavedBytes() as saved: loss = loss_fn(...)`` counts in
    ``saved.bytes`` the bytes the forward keeps for its backward (see the
    module's doc); ``saved.tensors`` is their number.  Only the forward
    runs inside it: the counted tensors are held until it exits."""

    def __init__(self):
        self._held: dict[int, torch.Tensor] = {}
        self.bytes = self.tensors = 0
        self._hooks = torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                               _unpack)

    def count(self, nbytes: int) -> None:
        """A kept tensor of its own storage (an output the policy keeps)."""
        self.bytes += nbytes
        self.tensors += 1

    def add(self, t) -> None:
        if not isinstance(t, torch.Tensor) or isinstance(t, nn.Parameter):
            return
        if hasattr(t, "to_local"):  # a DTensor: this rank's shard
            t = t.to_local()
        storage = t.untyped_storage()
        key = storage._cdata
        if key not in self._held:  # held: no other storage takes its place
            self._held[key] = t
            self.count(storage.nbytes())

    def _pack(self, t):
        self.add(t)
        return t

    def __enter__(self) -> SavedBytes:
        self._token = COUNTER.set(self)
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self._hooks.__exit__(*exc)
        COUNTER.reset(self._token)
        self._held.clear()


def _unpack(t):
    return t
