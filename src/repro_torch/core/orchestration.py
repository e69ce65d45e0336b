"""Orchestration — whole-program compilation (paper §V-B).

``orchestrate`` turns a :class:`StencilProgram` into one callable over all
its stencils (``compile_program``'s runner: the optimization ladder, then
the kernels), and hands any other step function back as it is — PyTorch
runs eagerly, so there is no tracing step to add.

The paper's productivity escape hatches map onto PyTorch directly:
 * constant propagation → a closure over the configuration
   (``bind_constants``);
 * closure resolution   → plain parameter dicts;
 * callbacks (print/plot/debug) → ``Monitor`` hooks, called in the
   order the step emits them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch


@dataclasses.dataclass
class Monitor:
    """Python-side callback registry for orchestrated code."""

    hooks: dict[str, Callable] = dataclasses.field(default_factory=dict)
    enabled: bool = True

    def register(self, name: str, fn: Callable) -> None:
        self.hooks[name] = fn

    def emit(self, name: str, value) -> None:
        """Call hook ``name`` now, in the caller's order, with ``value``
        (a tensor detached from autograd)."""
        if not self.enabled or name not in self.hooks:
            return
        if isinstance(value, torch.Tensor):
            value = value.detach()
        self.hooks[name](value)


def bind_constants(fn: Callable, **consts) -> Callable:
    """Constant propagation: bake configuration values into the step."""
    return functools.partial(fn, **consts)


def orchestrate(program_or_fn, *, backend: str = "cuda", hardware=None,
                donate: bool = True, opt_level: int = 0,
                device: "torch.device | str | None" = None) -> Callable:
    """Compile a StencilProgram into one callable, or return a plain step
    function unchanged.

    ``opt_level`` selects the automatic optimization ladder and
    ``hardware`` the preset it tunes for; ``device`` as in
    ``compile_program`` (``None``: the CUDA card).  ``donate`` is accepted
    for the reference's signature and has no effect yet: the runners copy
    every field they write, so their inputs stay valid either way.
    """
    from .backend import compile_program
    from .graph import StencilProgram

    if isinstance(program_or_fn, StencilProgram):
        return compile_program(program_or_fn, backend, hardware=hardware,
                               opt_level=opt_level, device=device)
    return program_or_fn
