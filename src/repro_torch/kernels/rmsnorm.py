"""K9: RMSNorm with a ``(1 + w)`` scale, and its fused residual add, on the
card.

Replaces the reference's Pallas kernels ``kernels/rmsnorm.py``
(``_kernel``/``rmsnorm_pallas``, ``_kernel_residual``/
``rmsnorm_residual_pallas``): ``rmsnorm_kernel`` in ``csrc/lm_kernels.cu``,
one CTA per row of (rows, d), the sum of squares in float32.  For tensors
on the CPU the wrappers run the plain versions (:func:`..ref.rmsnorm_ref`,
:func:`..ref.rmsnorm_residual_ref`); for CUDA tensors they launch the
kernel or raise.
"""

from __future__ import annotations

import torch

from . import library
from .ref import rmsnorm_ref, rmsnorm_residual_ref


def _check(name: str, xs: tuple, w: torch.Tensor) -> bool:
    """Validate (..., d) activations and a (d,) weight; True when they lie
    on the CPU (the plain version runs), False for the kernel."""
    if not all(isinstance(t, torch.Tensor) for t in xs + (w,)):
        raise TypeError(f"{name} takes torch tensors")
    x = xs[0]
    if x.dim() < 1 or any(t.shape != x.shape for t in xs) \
            or w.shape != x.shape[-1:]:
        raise ValueError(f"{name} takes (..., d) activations of one shape and "
                         f"a (d,) weight, got {[tuple(t.shape) for t in xs]}, "
                         f"{tuple(w.shape)}")
    if any(t.device != x.device or t.dtype != x.dtype for t in xs) \
            or w.device != x.device:
        raise ValueError(f"{name}'s tensors disagree in device or dtype")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in library.LM_DTYPES or w.dtype not in library.LM_DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16, not {x.dtype} "
                         f"with a {w.dtype} weight")
    if x.shape[-1] % 4:
        raise ValueError(f"{name}: d = {x.shape[-1]} is not a multiple of 4")
    if x.numel() // x.shape[-1] >= 2**31:
        raise ValueError(f"{name}: too many rows for the launch grid")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in xs + (w,)):
        raise ValueError(f"{name} takes contiguous, 16-byte aligned tensors")
    return False


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x²) + eps) * (1 + w)`` over the last axis, computed
    in float32, in x's dtype."""
    if _check("rmsnorm", (x,), w):
        return rmsnorm_ref(x, w, eps=eps)
    d = x.shape[-1]
    o = torch.empty_like(x)
    lib = library.load_lm_library()
    with torch.cuda.device(x.device):
        rc = lib.launch_rmsnorm(
            x.data_ptr(), w.data_ptr(), o.data_ptr(),
            library.LM_DTYPES[x.dtype], library.LM_DTYPES[w.dtype],
            x.numel() // d, d, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    library.check_launch(lib.lm_error_string, rc, "rmsnorm")
    library.LAUNCHES["rmsnorm"] += 1
    return o


def rmsnorm_residual(x: torch.Tensor, residual: torch.Tensor, w: torch.Tensor,
                     *, eps: float = 1e-5
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``s = x + residual`` (summed in float32): returns (the RMSNorm of the
    unrounded ``s``, ``s``), both in x's dtype."""
    if _check("rmsnorm_residual", (x, residual), w):
        return rmsnorm_residual_ref(x, residual, w, eps=eps)
    d = x.shape[-1]
    o = torch.empty_like(x)
    ro = torch.empty_like(x)
    lib = library.load_lm_library()
    with torch.cuda.device(x.device):
        rc = lib.launch_rmsnorm_residual(
            x.data_ptr(), residual.data_ptr(), w.data_ptr(), o.data_ptr(),
            ro.data_ptr(), library.LM_DTYPES[x.dtype],
            library.LM_DTYPES[w.dtype], x.numel() // d, d, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    library.check_launch(lib.lm_error_string, rc, "rmsnorm_residual")
    library.LAUNCHES["rmsnorm_residual"] += 1
    return o, ro
