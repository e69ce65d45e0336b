"""K10: the inter-chunk state scan of Mamba-2's SSD on the card.

Replaces the reference's Pallas kernel ``kernels/ssm_scan.py`` (``_kernel``,
``ssm_state_scan_pallas``): ``ssm_state_scan_kernel`` in
``csrc/lm_kernels.cu``, one thread per (b, h, n, p) chain holding the
running state in a register across the chunks.  For tensors on the CPU the
wrapper runs the plain version (:func:`..ref.ssm_state_scan_ref`); for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import library
from .ref import ssm_state_scan_ref


def ssm_state_scan(states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """Exclusive scan of ``h <- decay * h + state`` over the chunk axis of
    states (nc, B, H, N, P) with decay (nc, B, H), both float32: the state
    before each chunk, (nc, B, H, N, P)."""
    if not (isinstance(states, torch.Tensor)
            and isinstance(decay, torch.Tensor)):
        raise TypeError("ssm_state_scan takes torch tensors")
    if states.dim() != 5 or decay.shape != states.shape[:3]:
        raise ValueError("ssm_state_scan takes states (nc, B, H, N, P) and "
                         f"decay (nc, B, H), got {tuple(states.shape)}, "
                         f"{tuple(decay.shape)}")
    if decay.device != states.device:
        raise ValueError("ssm_state_scan's tensors disagree in device")
    if states.dtype != torch.float32 or decay.dtype != torch.float32:
        raise ValueError("ssm_state_scan takes float32 states and decay, not "
                         f"{states.dtype} and {decay.dtype}")
    if states.device.type == "cpu":
        return ssm_state_scan_ref(states, decay)
    if states.device.type != "cuda":
        raise ValueError(f"ssm_state_scan: no kernel for device "
                         f"{states.device}")
    library.refuse_grad("ssm_state_scan", "item 12i", states, decay)
    if not (states.is_contiguous() and decay.is_contiguous()):
        raise ValueError("ssm_state_scan takes contiguous tensors")
    nc, B, H, N, P = states.shape
    out = torch.empty_like(states)
    lib = library.LM or library.load_lm_library()
    library.launch("ssm_state_scan", lib.launch_ssm_state_scan,
                   lib.lm_error_string, states.get_device(),
                   states.data_ptr(), decay.data_ptr(), out.data_ptr(), nc,
                   B * H * N * P, B * H, N * P)
    return out
