"""K9: RMSNorm with a ``(1 + w)`` scale, and its fused residual add, on the
card.

Replaces the reference's Pallas kernels ``kernels/rmsnorm.py``
(``_kernel``/``rmsnorm_pallas``, ``_kernel_residual``/
``rmsnorm_residual_pallas``): ``rmsnorm_kernel`` in ``csrc/lm_kernels.cu``,
one CTA per row of (rows, d), the row held in registers between the sum of
squares (in float32) and the scale at the models' widths (3584, 4096,
7168), read twice at any other d.  For tensors on the CPU the wrappers run
the plain versions (:func:`..ref.rmsnorm_ref`,
:func:`..ref.rmsnorm_residual_ref`); for CUDA tensors they launch the
kernel or raise.

A decode step makes hundreds of calls of a few microseconds of device time
each, so the call path is short: the library is bound once, the launch
goes through :func:`.library.launch` (the caller's raw stream, the device
switched only where it is not current), and :func:`_check` orders its
checks so that an accepted call on the card pays the fewest.
"""

from __future__ import annotations

import torch

from . import library
from .ref import rmsnorm_ref, rmsnorm_residual_ref


def _check(name: str, x, r, w) -> tuple | None:
    """Validate (..., d) activations ``x`` (and ``r``, None for the plain
    norm) and a (d,) weight: None when they lie on the CPU (the plain
    version runs), else what the kernel's launch takes: (the CUDA device's
    index, x's pointer, r's (0 for the plain norm), w's, x's and w's dtype
    codes, rows, d).  Every check runs on every call; a call on the card
    reads devices as indices, each pointer once, and leaves the rest of the
    device checks to the calls that are not."""
    if not (isinstance(x, torch.Tensor) and isinstance(w, torch.Tensor) and (
            r is None or isinstance(r, torch.Tensor))):
        raise TypeError(f"{name} takes torch tensors")
    shape, w_shape = x.shape, w.shape
    if not shape or len(w_shape) != 1 or w_shape[0] != shape[-1] or (
            r is not None and r.shape != shape):
        ts = (x, w) if r is None else (x, r, w)
        raise ValueError(f"{name} takes (..., d) activations of one shape and "
                         f"a (d,) weight, got {[tuple(t.shape) for t in ts]}")
    if x.is_cuda:
        dev = x.get_device()
        if w.get_device() != dev or (r is not None and (
                r.get_device() != dev or r.dtype != x.dtype)):
            raise ValueError(f"{name}'s tensors disagree in device or dtype")
        code, w_code = (library.LM_DTYPES.get(x.dtype),
                        library.LM_DTYPES.get(w.dtype))
        if code is None or w_code is None:
            raise ValueError(f"{name} takes float32 or bfloat16, not "
                             f"{x.dtype} with a {w.dtype} weight")
        d = shape[-1]
        if d % 4:
            raise ValueError(f"{name}: d = {d} is not a multiple of 4")
        rows = x.numel() // d
        if rows >= 2**31:
            raise ValueError(f"{name}: too many rows for the launch grid")
        xp, wp = x.data_ptr(), w.data_ptr()
        rp = 0 if r is None else r.data_ptr()
        if (xp | rp | wp) % 16 or not (x.is_contiguous() and w.is_contiguous()
                                       and (r is None or r.is_contiguous())):
            raise ValueError(f"{name} takes contiguous, 16-byte aligned "
                             "tensors")
        return dev, xp, rp, wp, code, w_code, rows, d
    ts = (x, w) if r is None else (x, r, w)
    if any(t.device != x.device for t in ts) or (r is not None
                                                 and r.dtype != x.dtype):
        raise ValueError(f"{name}'s tensors disagree in device or dtype")
    if x.device.type == "cpu":
        return None
    raise ValueError(f"{name}: no kernel for device {x.device}")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x²) + eps) * (1 + w)`` over the last axis, computed
    in float32, in x's dtype."""
    card = _check("rmsnorm", x, None, w)
    if card is None:
        return rmsnorm_ref(x, w, eps=eps)
    dev, xp, _, wp, code, w_code, rows, d = card
    o = torch.empty_like(x)
    lib = library.LM or library.load_lm_library()
    library.launch("rmsnorm", lib.launch_rmsnorm, lib.lm_error_string, dev,
                   xp, wp, o.data_ptr(), code, w_code, rows, d, eps)
    return o


def rmsnorm_residual(x: torch.Tensor, residual: torch.Tensor, w: torch.Tensor,
                     *, eps: float = 1e-5
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``s = x + residual`` (summed in float32): returns (the RMSNorm of the
    unrounded ``s``, ``s``), both in x's dtype."""
    card = _check("rmsnorm_residual", x, residual, w)
    if card is None:
        return rmsnorm_residual_ref(x, residual, w, eps=eps)
    dev, xp, rp, wp, code, w_code, rows, d = card
    o = torch.empty_like(x)
    ro = torch.empty_like(x)
    lib = library.LM or library.load_lm_library()
    library.launch("rmsnorm_residual", lib.launch_rmsnorm_residual,
                   lib.lm_error_string, dev, xp, rp, wp, o.data_ptr(),
                   ro.data_ptr(), code, w_code, rows, d, eps)
    return o, ro
