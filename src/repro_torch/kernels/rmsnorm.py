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

The backward (:func:`rmsnorm_bwd`, :func:`rmsnorm_residual_bwd`; no TPU
counterpart: the reference differentiates its jnp norm) is
``rmsnorm_bwd_kernel<T, W, residual>`` of ``csrc/lm_kernels.cu``: CTAs
of 256 threads over runs of rows, per row in f32 the sums of s^2 and
g (1 + w) s (one reduction), then dx = rstd (gw - x^ mean(gw x^)) (plus the
gradient of the returned sum in the residual form, for x and residual
alike), each CTA's sums of g x^ per column in shared memory; a second
kernel adds the CTAs' rows of dw in CTA order (no float atomics: the bits
do not depend on scheduling).  Bound by device memory: x, g (r and gs)
read once, dx written once.  :class:`RMSNorm` and
:class:`RMSNormResidual` are the ``torch.autograd.Function``s around the
forward kernel and these.
"""

from __future__ import annotations

import torch

import functools

from . import library
from .ref import (rmsnorm_bwd_ref, rmsnorm_ref, rmsnorm_residual_bwd_ref,
                  rmsnorm_residual_ref)


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
        xp, wp = library.pointer(x), library.pointer(w)
        rp = 0 if r is None else library.pointer(r)
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


@functools.lru_cache(maxsize=None)
def _bwd_ctas(device: int) -> int:
    """The backward's CTAs: 8 of 256 threads on each SM."""
    return 8 * torch.cuda.get_device_properties(device).multi_processor_count


def _bwd(name: str, x, r, w, g, gs, eps: float):
    card = _check(name, x, r, w)
    for t in (g,) if gs is None else (g, gs):
        if not isinstance(t, torch.Tensor) or t.shape != x.shape or (
                t.dtype != x.dtype or t.device != x.device):
            raise ValueError(f"{name} takes gradients of x's shape, dtype "
                             "and device")
    if card is None:
        if r is None:
            return rmsnorm_bwd_ref(x, w, g, eps=eps)
        return rmsnorm_residual_bwd_ref(x, r, w, g, gs, eps=eps)
    dev, xp, rp, wp, code, w_code, rows, d = card
    gp = library.pointer(g)
    gsp = 0 if gs is None else library.pointer(gs)
    if (gp | gsp) % 16 or not (g.is_contiguous()
                               and (gs is None or gs.is_contiguous())):
        raise ValueError(f"{name} takes contiguous, 16-byte aligned "
                         "gradients")
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    n = max(1, min(rows, _bwd_ctas(dev)))
    partial = torch.empty((n, d), dtype=torch.float32, device=x.device)
    lib = library.LM or library.load_lm_library()
    library.launch(name, lib.launch_rmsnorm_bwd, lib.lm_error_string, dev,
                   xp, rp, wp, gp, gsp, dx.data_ptr(), dw.data_ptr(),
                   partial.data_ptr(), code, w_code, rows, d, eps, n)
    return dx, dw


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, *,
                eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients (dx, dw) of :func:`rmsnorm` for the output's gradient
    ``g``: dx in x's dtype, dw in w's."""
    return _bwd("rmsnorm_bwd", x, None, w, g, None, eps)


def rmsnorm_residual_bwd(x: torch.Tensor, residual: torch.Tensor,
                         w: torch.Tensor, g: torch.Tensor,
                         gs: torch.Tensor | None, *, eps: float = 1e-5
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients (dx, dw) of :func:`rmsnorm_residual` for the
    gradients ``g`` of the normed output and ``gs`` of the returned sum
    (None: zero); dx is also the residual's gradient."""
    if gs is None and x.is_cuda:
        gs = torch.zeros_like(x)
    return _bwd("rmsnorm_residual_bwd", x, residual, w, g, gs, eps)


class RMSNorm(torch.autograd.Function):
    """:func:`rmsnorm` with its backward (:func:`rmsnorm_bwd`); saves x and
    w, and the backward recomputes rstd from x."""

    @staticmethod
    def forward(ctx, x, w, eps: float):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm(x, w, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, g.contiguous(), eps=ctx.eps)
        return dx, dw, None


class RMSNormResidual(torch.autograd.Function):
    """:func:`rmsnorm_residual` with its backward
    (:func:`rmsnorm_residual_bwd`); saves x, the residual and w, from which
    the backward forms the unrounded sum again."""

    @staticmethod
    def forward(ctx, x, residual, w, eps: float):
        ctx.save_for_backward(x, residual, w)
        ctx.eps = eps
        return rmsnorm_residual(x, residual, w, eps=eps)

    @staticmethod
    def backward(ctx, g, gs):
        x, residual, w = ctx.saved_tensors
        dx, dw = rmsnorm_residual_bwd(x, residual, w, g.contiguous(),
                                      gs.contiguous(), eps=ctx.eps)
        return dx, dx, dw, None
