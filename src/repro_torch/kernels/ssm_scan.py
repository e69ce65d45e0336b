"""K10: the inter-chunk state scan of Mamba-2's SSD on the card, and its
backward.

Replaces the reference's Pallas kernel ``kernels/ssm_scan.py`` (``_kernel``,
``ssm_state_scan_pallas``): ``ssm_state_scan_kernel`` in
``csrc/lm_kernels.cu``, one thread per (b, h, n, p) chain holding the
running state in a register across the chunks.

The backward (:func:`ssm_state_scan_bwd`; no TPU counterpart: the
reference differentiates its ``lax.scan``) is ``ssm_state_scan_bwd_kernel``
of the same file: one CTA per (b, h) walks the chunks backwards with that
head's N P adjoints in registers, a_c = g_c + decay_c a_{c+1}, writes
d states_c = a_{c+1} and reduces d decay_c = the sum of a_{c+1} out_c in
float64 in one fixed order (no atomics: the same inputs give the same
bits).  :class:`SSMStateScan` is the ``torch.autograd.Function`` around
the forward kernel and this; it saves the forward's output and the decay.

For tensors on the CPU the wrappers run the plain versions
(:func:`..ref.ssm_state_scan_ref`, :func:`..ref.ssm_state_scan_bwd_ref`);
for CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import torch

from . import library
from .ref import ssm_state_scan_bwd_ref, ssm_state_scan_ref


def _check(name: str, states, decay) -> bool:
    """Validate states (nc, B, H, N, P) and decay (nc, B, H), float32 on
    one device: True for CUDA tensors (the kernel runs), False for CPU
    tensors (the plain version runs)."""
    if not (isinstance(states, torch.Tensor)
            and isinstance(decay, torch.Tensor)):
        raise TypeError(f"{name} takes torch tensors")
    if states.dim() != 5 or decay.shape != states.shape[:3]:
        raise ValueError(f"{name} takes states (nc, B, H, N, P) and "
                         f"decay (nc, B, H), got {tuple(states.shape)}, "
                         f"{tuple(decay.shape)}")
    if decay.device != states.device:
        raise ValueError(f"{name}'s tensors disagree in device")
    if states.dtype != torch.float32 or decay.dtype != torch.float32:
        raise ValueError(f"{name} takes float32 states and decay, not "
                         f"{states.dtype} and {decay.dtype}")
    if states.device.type == "cpu":
        return False
    if states.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {states.device}")
    if not (states.is_contiguous() and decay.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    return True


def ssm_state_scan(states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """Exclusive scan of ``h <- decay * h + state`` over the chunk axis of
    states (nc, B, H, N, P) with decay (nc, B, H), both float32: the state
    before each chunk, (nc, B, H, N, P)."""
    if not _check("ssm_state_scan", states, decay):
        return ssm_state_scan_ref(states, decay)
    nc, B, H, N, P = states.shape
    out = torch.empty_like(states)
    lib = library.LM or library.load_lm_library()
    library.launch("ssm_state_scan", lib.launch_ssm_state_scan,
                   lib.lm_error_string, states.get_device(),
                   library.pointer(states), library.pointer(decay), out.data_ptr(), nc,
                   B * H * N * P, B * H, N * P)
    return out


def ssm_state_scan_bwd(g: torch.Tensor, out: torch.Tensor,
                       decay: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients (d states, d decay) of :func:`ssm_state_scan` for the
    gradient ``g`` of its output ``out``, float32, of out's shape and
    decay's."""
    card = _check("ssm_state_scan_bwd", out, decay)
    if not isinstance(g, torch.Tensor) or g.shape != out.shape or (
            g.dtype != out.dtype or g.device != out.device):
        raise ValueError("ssm_state_scan_bwd takes a gradient of out's "
                         "shape, dtype and device")
    if not card:
        return ssm_state_scan_bwd_ref(g, out, decay)
    if not g.is_contiguous():
        raise ValueError("ssm_state_scan_bwd takes contiguous tensors")
    nc, B, H, N, P = out.shape
    ds = torch.empty_like(out)
    dd = torch.empty_like(decay)
    if ds.numel() == 0:
        return ds, dd.zero_()
    lib = library.LM or library.load_lm_library()
    library.launch("ssm_state_scan_bwd", lib.launch_ssm_state_scan_bwd,
                   lib.lm_error_string, out.get_device(), library.pointer(g),
                   library.pointer(out), library.pointer(decay), ds.data_ptr(),
                   dd.data_ptr(), nc, B * H, N * P)
    return ds, dd


class SSMStateScan(torch.autograd.Function):
    """:func:`ssm_state_scan` with its backward
    (:func:`ssm_state_scan_bwd`); saves the output (which Mamba-2 keeps
    for its inter-chunk term anyway) and the decay."""

    @staticmethod
    def forward(ctx, states, decay):
        out = ssm_state_scan(states, decay)
        ctx.save_for_backward(out, decay)
        return out

    @staticmethod
    def backward(ctx, g):
        out, decay = ctx.saved_tensors
        return ssm_state_scan_bwd(g.contiguous(), out, decay)
