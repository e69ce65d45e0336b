"""K7: the fused PPM x-flux on the card.

Replaces the reference's Pallas kernel ``kernels/fvt_flux.py`` (``_kernel``,
``fvt_flux_pallas``): ``fvt_flux_kernel`` in ``csrc/fv3_kernels.cu``, one
thread per (k, j, i) point of padded (K, J+2h, I+2h) float32 tensors.  For
tensors on the CPU the wrapper runs the plain version
(:func:`..ref.fvt_flux_ref`); for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import library
from .ref import fvt_flux_ref


def fvt_flux(q: torch.Tensor, cx: torch.Tensor, *, halo: int) -> torch.Tensor:
    """Upwind PPM x-flux ``cx * f`` of ``q`` on the interior i of padded
    (K, J+2h, I+2h) tensors, 0 on the halo i.  The interface values reach
    three cells upwind, so ``halo`` must be at least 3."""
    if not (isinstance(q, torch.Tensor) and isinstance(cx, torch.Tensor)):
        raise TypeError("fvt_flux takes torch tensors")
    if q.dim() != 3 or cx.shape != q.shape:
        raise ValueError("fvt_flux takes two (K, J+2h, I+2h) tensors of one "
                         f"shape, got {tuple(q.shape)}, {tuple(cx.shape)}")
    if halo < 3 or q.shape[-1] <= 2 * halo:
        raise ValueError(f"fvt_flux reads three cells upwind: halo={halo} "
                         f"must be >= 3 and leave an interior of "
                         f"{q.shape[-1]} columns")
    if cx.device != q.device or cx.dtype != q.dtype:
        raise ValueError("fvt_flux's tensors disagree in device or dtype")
    if q.device.type == "cpu":
        return fvt_flux_ref(q, cx, halo=halo)
    if q.device.type != "cuda":
        raise ValueError(f"fvt_flux: no kernel for device {q.device}")
    library.refuse_grad("fvt_flux", "item 11b", q, cx)
    if q.dtype != torch.float32:
        raise ValueError(f"fvt_flux takes float32, not {q.dtype}")
    if not (q.is_contiguous() and cx.is_contiguous()):
        raise ValueError("fvt_flux takes contiguous tensors")
    nk, jp, ip = q.shape
    fx = torch.empty_like(q)
    lib = library.FV3 or library.load_library()
    library.launch("fvt_flux", lib.launch_fvt_flux, lib.fv3_error_string,
                   q.get_device(), library.pointer(q), library.pointer(cx), fx.data_ptr(),
                   nk, jp, ip, halo)
    return fx
