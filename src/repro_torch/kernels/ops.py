"""Public entry points of the standalone FV3 kernels.

``backend="cuda"`` (the default) runs the hand-written kernel on CUDA
tensors and its plain version on CPU tensors; ``backend="ref"`` runs the
plain version on any device, so callers can compare the two in place, as
with the reference's ``repro.kernels.ops``.  The LM harness's kernels
(flash attention, RMSNorm, the SSM state scan) come with its slice.
"""

from __future__ import annotations

import torch

from . import ref
from .fvt_flux import fvt_flux as _fvt_flux_kernel
from .tridiag import tridiag as _tridiag_kernel

_BACKENDS = ("cuda", "ref")


def _check(backend: str) -> None:
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, "
                         f"got {backend!r}")


def tridiag(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
            d: torch.Tensor, *, backend: str = "cuda") -> torch.Tensor:
    """Solve tridiag(a, b, c) x = d for (K, J, I) tensors (K6)."""
    _check(backend)
    if backend == "ref":
        return ref.tridiag_ref(a, b, c, d)
    return _tridiag_kernel(a, b, c, d)


def fvt_flux(q: torch.Tensor, cx: torch.Tensor, *, halo: int,
             backend: str = "cuda") -> torch.Tensor:
    """Fused PPM x-flux on padded (K, J+2h, I+2h) tensors (K7)."""
    _check(backend)
    if backend == "ref":
        return ref.fvt_flux_ref(q, cx, halo=halo)
    return _fvt_flux_kernel(q, cx, halo=halo)
