"""K6: the batched Thomas (tridiagonal) solve on the card.

Replaces the reference's Pallas kernel ``kernels/tridiag.py`` (``_kernel``,
``tridiag_pallas``): ``tridiag_kernel`` in ``csrc/fv3_kernels.cu``, one
thread per (j, i) column of (K, J, I) tensors, float32 or float64, a warp
of columns a CTA whose forward sweep keeps cp and dp in shared memory
(:func:`plan`).  For tensors on the CPU the wrapper runs the plain version
(:func:`..ref.tridiag_ref`); for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import library
from .ref import tridiag_ref

#: columns (threads) a CTA: a warp (the kernel's K6_TILE)
TILE = 32
#: levels of a, b, c, d a thread keeps in flight (the kernel's K6_RING)
RING = 8
#: dynamic shared memory a CTA may take on the card
SMEM_MAX = 227 * 1024


def plan(nk: int, itemsize: int) -> int:
    """K6's levels whose cp and dp stay in shared memory, for columns of
    ``nk`` levels of ``itemsize`` bytes: all of them while a warp's cp and
    dp and its ring of :data:`RING` levels of a, b, c, d fit
    :data:`SMEM_MAX` (up to nk 892 in float32, 438 in float64); past that
    the deeper levels keep cp in a scratch tensor and dp in x."""
    return min(nk, (SMEM_MAX // (TILE * itemsize) - 4 * RING) // 2)


def tridiag(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
            d: torch.Tensor) -> torch.Tensor:
    """Solve tridiag(a, b, c) x = d for (K, J, I) tensors, batched over the
    (j, i) columns."""
    xs = (a, b, c, d)
    if not all(isinstance(x, torch.Tensor) for x in xs):
        raise TypeError("tridiag takes torch tensors")
    if a.dim() != 3 or any(x.shape != a.shape for x in xs):
        raise ValueError("tridiag takes four (K, J, I) tensors of one shape, "
                         f"got {[tuple(x.shape) for x in xs]}")
    if any(x.device != a.device or x.dtype != a.dtype for x in xs):
        raise ValueError("tridiag's tensors disagree in device or dtype")
    if a.device.type == "cpu":
        return tridiag_ref(a, b, c, d)
    if a.device.type != "cuda":
        raise ValueError(f"tridiag: no kernel for device {a.device}")
    library.refuse_grad("tridiag", "item 11b", a, b, c, d)
    if a.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"tridiag takes float32 or float64, not {a.dtype}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("tridiag takes contiguous tensors")
    nk, nj, ni = a.shape
    levels = plan(nk, a.element_size())
    x = torch.empty_like(a)
    # cp of the levels past the on-chip plan (none at the model's depths)
    cpg = (torch.empty((nk - levels, nj, ni), dtype=a.dtype, device=a.device)
           if levels < nk else None)
    lib = library.FV3 or library.load_library()
    fn = (lib.launch_tridiag_f32 if a.dtype == torch.float32
          else lib.launch_tridiag_f64)
    library.launch("tridiag", fn, lib.fv3_error_string, a.get_device(),
                   library.pointer(a), library.pointer(b), library.pointer(c), library.pointer(d),
                   x.data_ptr(), None if cpg is None else cpg.data_ptr(), nk,
                   nj * ni, levels)
    return x
