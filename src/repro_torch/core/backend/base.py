"""Backend protocol + registry, and where the port's entry points run.

A :class:`Backend` owns one lowering of the stencil IR.  Backends register
by name; everything above this layer (graph compilation, autotuning, the FV3
dycore) resolves backends through :func:`get_backend` and never imports a
lowering module directly.  Hardware left unnamed is the ``"h100"`` preset
(:func:`~repro_torch.core.hardware.resolve_hardware`).

The port's entry points run on the card: :func:`resolve_device` turns
``device=None`` into ``cuda`` and refuses to carry on quietly when there is
no card.  Running on the CPU takes an explicit ``device="cpu"``.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Iterator, Mapping

import torch

from ..hardware import Hardware, resolve_hardware
from ..stencil.domain import DomainSpec
from ..stencil.ir import Stencil
from ..stencil.schedule import Schedule, feasible_schedules

Runner = Callable[[Mapping[str, Any], Mapping[str, Any] | None], dict]


def resolve_device(device: "torch.device | str | None") -> torch.device:
    """``None`` → the current CUDA card, with its index (``cuda:0``), as
    tensors report their device; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Backend(abc.ABC):
    """One lowering target of the stencil IR."""

    #: registry key, e.g. "torch" / "cuda"
    name: str = ""
    #: this backend can place the member axis (and chunk loops) on its
    #: launch grid; without one, every chunk loop is a loop of calls
    member_grid: bool = False

    @abc.abstractmethod
    def compile_stencil(self, stencil: Stencil, dom: DomainSpec, *,
                        schedule: Schedule | None = None,
                        dtype=torch.float32, n_members: int | None = None,
                        member_chunk: int = 1) -> Runner:
        """Lower one stencil into ``fn(fields, params) -> dict`` of the
        written fields.  ``schedule`` is the node's tuned schedule (the
        backend reads what it honours of it).  ``n_members=M``: fields
        carry a leading member axis of extent M, run ``member_chunk``
        members at a time on the launch grid where the backend has one."""

    # -- schedule policy (hardware-parameterized, overridable) ---------------
    def feasible_schedules(self, stencil: Stencil, dom_shape,
                           dtype_bytes: int = 4,
                           hardware: Hardware | str | None = None,
                           ) -> Iterator[Schedule]:
        return feasible_schedules(stencil, dom_shape, dtype_bytes,
                                  hw=resolve_hardware(hardware))

    def __repr__(self):
        return f"<backend {self.name!r}>"


_REGISTRY: dict[str, Backend] = {}


def register_backend(backend: Backend, *, overwrite: bool = False) -> Backend:
    if not backend.name:
        raise ValueError("backend must define a non-empty .name")
    if backend.name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: "str | Backend") -> Backend:
    if isinstance(name, Backend):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(
            f"unknown backend {name!r}; registered: {known}") from None


def available_backends() -> list[str]:
    return sorted(_REGISTRY)
