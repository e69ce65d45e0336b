"""Public entry points of the standalone kernels: the FV3 ones (K6, K7) and
those of the LM serving path (K8 flash attention, K9 RMSNorm, K10 the SSM
state scan).

``backend="cuda"`` (the default) runs the hand-written kernel on CUDA
tensors and its plain version on CPU tensors; ``backend="ref"`` runs the
plain version on any device, so callers can compare the two in place, as
with the reference's ``repro.kernels.ops``.

Under autograd (grad mode on and an input that requires grad),
``backend="cuda"`` runs K8, K9 and K10 through their
``autograd.Function``s (the forward kernel, then the backward kernels; on
CPU tensors the plain forward and backward versions), and
``backend="ref"`` differentiates the plain version with torch's autograd.
K6 and K7 have no backward kernel: on CUDA tensors under autograd they
raise (:func:`.library.refuse_grad`).
"""

from __future__ import annotations

import torch

from . import ref
from .flash_attention import FlashAttention
from .flash_attention import flash_attention as _flash_attention_kernel
from .fvt_flux import fvt_flux as _fvt_flux_kernel
from .rmsnorm import RMSNorm, RMSNormResidual
from .rmsnorm import rmsnorm as _rmsnorm_kernel
from .rmsnorm import rmsnorm_residual as _rmsnorm_residual_kernel
from .ssm_scan import SSMStateScan
from .ssm_scan import ssm_state_scan as _ssm_state_scan_kernel
from .tridiag import tridiag as _tridiag_kernel

_BACKENDS = ("cuda", "ref")


def _needs_grad(*tensors: torch.Tensor) -> bool:
    """Autograd records the call: grad mode on and an input requiring
    grad (what is not a tensor is left to the wrapper's checks)."""
    return torch.is_grad_enabled() and any(
        getattr(t, "requires_grad", False) for t in tensors)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    softcap: float = 0.0, window: int = 0,
                    backend: str = "cuda") -> torch.Tensor:
    """Causal GQA attention of q (B, S, H, D) over k/v (B, S, KVH, D), with
    an optional tanh softcap and sliding window (``window > 0``: the last
    ``window`` keys of each query) (K8)."""
    _check(backend)
    if backend == "ref":
        return ref.flash_attention_ref(q, k, v, softcap=softcap,
                                       window=window)
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, softcap, window)
    return _flash_attention_kernel(q, k, v, softcap=softcap, window=window)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5,
            backend: str = "cuda") -> torch.Tensor:
    """``(1 + w)`` RMSNorm over the last axis, in float32 (K9)."""
    if backend == "cuda":  # first: a decode step makes hundreds of calls
        if _needs_grad(x, w):
            return RMSNorm.apply(x, w, eps)
        return _rmsnorm_kernel(x, w, eps=eps)
    _check(backend)
    return ref.rmsnorm_ref(x, w, eps=eps)


def rmsnorm_residual(x: torch.Tensor, residual: torch.Tensor,
                     w: torch.Tensor, *, eps: float = 1e-5,
                     backend: str = "cuda"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused ``x + residual`` then RMSNorm (K9): (normed, new residual)."""
    if backend == "cuda":
        if _needs_grad(x, residual, w):
            return RMSNormResidual.apply(x, residual, w, eps)
        return _rmsnorm_residual_kernel(x, residual, w, eps=eps)
    _check(backend)
    return ref.rmsnorm_residual_ref(x, residual, w, eps=eps)


def ssm_state_scan(states: torch.Tensor, decay: torch.Tensor, *,
                   backend: str = "cuda") -> torch.Tensor:
    """Exclusive inter-chunk scan ``h <- decay * h + state`` of states
    (nc, B, H, N, P) with decay (nc, B, H), float32 (K10)."""
    _check(backend)
    if backend == "ref":
        return ref.ssm_state_scan_ref(states, decay)
    if _needs_grad(states, decay):
        return SSMStateScan.apply(states, decay)
    return _ssm_state_scan_kernel(states, decay)
