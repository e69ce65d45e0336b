"""K8: causal flash attention (forward) on the card.

Replaces the reference's Pallas kernel ``kernels/flash_attention.py``
(``_kernel``, ``flash_attention_pallas``) with two kernels of
``csrc/lm_kernels.cu``, chosen by dtype:

 * bfloat16 (the serving path): ``flash_attention_wgmma_kernel``, both
   products on the tensor cores (``wgmma``, f32 accumulation).  One
   persistent CTA per SM, with two consumer warpgroups of 64 query rows and
   a producer warpgroup, walks query tiles of 128 rows in pairs of equal
   work; the producer brings Q, K and V in by TMA (K/V through a 2-stage
   ring synchronised by mbarriers), each key tile's P·V overlaps the next
   tile's Q·Kᵀ and softmax, and O leaves by TMA stores.  The scores are
   scaled after the product and the probabilities rounded to bf16 before
   P·V, as the reference model computes them (``models/layers.py``);
 * float32 (the parity path): ``flash_attention_fwd_kernel``, both
   products on the tensor cores in 3xTF32: each operand is split into a
   TF32 ``hi`` and the TF32 rounding of its remainder ``lo``, and a product
   is ``a_hi b_hi + a_hi b_lo + a_lo b_hi`` (``wgmma`` ``.tf32``, f32
   sums), which keeps the f32 bar.  One CTA per query tile of 64 rows: a
   producer warpgroup loads and splits Q, then K and V (V transposed)
   through a ring of shared-memory slots, and a consumer warpgroup runs the
   products and the online softmax.  q is scaled by 1/sqrt(D) before the
   product, as the Pallas kernel does.

Both read q (B, S, H, D) and k/v (B, S, KVH, D) in place, with query head
h on kv head ``h // (H / KVH)``, keep the online softmax in float32, mask
with -1e30 and clamp l at 1e-20.  With a sliding window (``window > 0``,
Gemma-2's local layers) a query tile walks only the key tiles from the
window's lower edge to its causal frontier, and masks the tiles on both
edges; ``window`` 0, or at least S, runs each kernel's causal instance,
the code of the kernel before the window.  For tensors on the CPU the
wrapper runs the plain version (:func:`..ref.flash_attention_ref`); for
CUDA tensors it launches the kernel of their dtype or raises.  Given an
``lse`` tensor (training), either kernel also writes each row's
log-sum-exp; serving passes none, and the kernels keep their bits.

The backward (:func:`flash_attention_bwd`; no TPU counterpart: the
reference differentiates its jnp attention) is three launches of
``csrc/lm_kernels.cu``, every head width of the forward, no atomics, so
the same inputs give the same bits: first
``flash_attention_bwd_rows_kernel`` (memory-bound, O and dO read once)
writes delta = rowsum(dO O) in float32 and the forward's lse in 64-row
tiles side by side (an lse row of a (b, h) starts at (b H + h) S floats,
and a copy that starts off 16 bytes faults), then dK/dV and dQ, every
product on the tensor cores (``wgmma``, f32 sums), by dtype:

 * bfloat16 (training): ``flash_attention_bwd_wgmma_dkdv_kernel`` and
   ``flash_attention_bwd_wgmma_dq_kernel``, bf16 in, with the forward's
   machinery (TMA tiles in its swizzle, an mbarrier ring, a producer and
   two consumer warpgroups, persistent CTAs over pairs of tiles of equal
   work).  dK/dV: one CTA per 128 keys (64 at D 256) of a (b, kv head),
   the keys as the products' M, walking every query head of the group, so
   the heads sum in registers in one order, each query tile's Q and dO by
   TMA and its lse and delta by one bulk copy of their tile through the
   ring; S^T = K Q^T, dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q
   with P^T and dS^T rounded to bf16 in registers.  dQ: the forward's CTA
   of 128 query rows, S and dP again (7 products where 5 would do, for no
   atomics), dQ += dS K.  dS is rounded to bf16 to enter the tensor cores,
   as FlashAttention 2 and 3 do, and the plain version's bf16 branch
   rounds it too (with P, as the forward rounds P before P V);
 * float32 (the parity step and float32 training):
   ``flash_attention_bwd_tf32_dkdv_kernel`` and
   ``flash_attention_bwd_tf32_dq_kernel``, 3xTF32 as the float32 forward:
   each operand split into a TF32 hi and lo, a product a_hi b_hi + a_hi
   b_lo + a_lo b_hi.  ``.tf32`` ``wgmma`` reads only K-major operands, so
   the B operands of dV += P^T dO, dK += dS^T Q and dQ += dS K are
   transposed copies.  One producer thread loads every operand raw by TMA
   (D in chunks of 32 columns); two consumer warpgroups split them into
   TF32 hi and lo in the form each product reads (an SS product's A
   straight into registers) and share each 64 x 64 tile (dK/dV: one S^T,
   P and dV, the other dP^T, dS and dK; dQ: one S and P, the other dP and
   dS, each half of dQ's columns), passing P and dS through shared memory;
   every product's sum spans at most 4 k8 steps on the tensor cores and is
   added to the running sums in f32 registers, so the tensor cores'
   truncating adds never build up.  dK, dV and dQ leave by TMA stores.
   dK/dV: a CTA per 64 keys of a (b, kv head) (per half
   of the columns at D 256), every query head of the group in order; dQ:
   a CTA per 64 query rows of a (b, h), S and dP again.

Bound: S and dP recomputed and dV, dK, dQ are 5 products, 10 B H D flops a
kept (query, key) pair: 0.695 ms at Granite-8B's (8, 2048, 32/8, 128) over
the 989 TFLOP/s of bf16, 4.167 ms in float32 (3 x over the 495 of TF32).
:class:`FlashAttention` is the ``torch.autograd.Function`` around the
two.
"""

from __future__ import annotations

import torch

from . import library
from .ref import (flash_attention_bwd_ref, flash_attention_fwd_ref,
                  flash_attention_ref)

#: head widths the kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 96, 112, 128, 256)

def check_card_inputs(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> None:
    """The checks the card's kernels need (dtype, head width, the f32
    kernel's 1-D grid of one CTA per 64 query rows of each head, contiguous
    and 16-byte aligned tensors); raises ValueError on what they do not
    take.  Reads only shapes, dtypes and layouts, so it runs on any
    device."""
    D = q.shape[3]
    if q.dtype not in library.LM_DTYPES:
        raise ValueError("flash_attention takes float32 or bfloat16, not "
                         f"{q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {D} not in "
                         f"{HEAD_DIMS}")
    # the bf16 kernel is persistent; the f32 one launches a CTA per query
    # tile of 64 rows of each (b, h)
    tiles = q.shape[0] * q.shape[2] * -(-q.shape[1] // 64)
    if q.dtype == torch.float32 and tiles > 2**31 - 1:
        raise ValueError(f"flash_attention: {tiles} query tiles of 64 rows "
                         "exceed the float32 kernel's launch grid (2^31 - 1)")
    if not all(x.is_contiguous() and library.pointer(x) % 16 == 0
               for x in (q, k, v)):
        raise ValueError("flash_attention takes contiguous, 16-byte aligned "
                         "tensors")


def _check_qkv(name: str, q, k, v, window: int) -> None:
    xs = (q, k, v)
    if not all(isinstance(x, torch.Tensor) for x in xs):
        raise TypeError(f"{name} takes torch tensors")
    if window < 0:
        raise ValueError(f"{name}: window {window} < 0")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name} takes q (B, S, H, D) and k/v "
                         f"(B, S, KVH, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, D) or H % k.shape[2]:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (H must be a multiple of KVH)")
    if any(x.device != q.device or x.dtype != q.dtype for x in xs):
        raise ValueError(f"{name}'s tensors disagree in device or dtype")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {q.device}")


def _check_lse(name: str, lse, q) -> None:
    B, S, H, _ = q.shape
    if (lse.shape != (B, H, S) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"{name} takes a contiguous float32 lse of "
                         f"{(B, H, S)} on q's device, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    softcap: float = 0.0, window: int = 0,
                    lse: torch.Tensor | None = None) -> torch.Tensor:
    """Causal attention of q (B, S, H, D) over k/v (B, S, KVH, D), H a
    multiple of KVH; ``softcap > 0`` caps the scores with
    ``softcap * tanh(s / softcap)``; ``window > 0`` keeps only the keys
    ``k > q - window`` of each query q.  Returns (B, S, H, D) in q's
    dtype.  ``lse`` (B, H, S) float32: filled with each row's log-sum-exp
    of the scores, for the backward."""
    _check_qkv("flash_attention", q, k, v, window)
    if lse is not None:
        _check_lse("flash_attention", lse, q)
    if q.device.type == "cpu":
        if lse is None:
            return flash_attention_ref(q, k, v, softcap=softcap,
                                       window=window)
        o, lse_ref = flash_attention_fwd_ref(q, k, v, softcap=softcap,
                                             window=window)
        lse.copy_(lse_ref)
        return o
    check_card_inputs(q, k, v)
    B, S, H, D = q.shape
    o = torch.empty_like(q)
    lib = library.LM or library.load_lm_library()
    library.launch("flash_attention", lib.launch_flash_attention,
                   lib.lm_error_string, q.get_device(), library.pointer(q),
                   library.pointer(k), library.pointer(v), o.data_ptr(),
                   0 if lse is None else lse.data_ptr(),
                   library.LM_DTYPES[q.dtype], B, S, H, k.shape[2], D,
                   float(softcap), min(int(window), 2**30))
    if 0 < window < S:  # the kernel's window instance
        library.LAUNCHES["flash_attention_window"] += 1
    return o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, softcap: float = 0.0, window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of :func:`flash_attention` for the
    output's gradient ``do``, from its output ``o`` and row log-sum-exp
    ``lse`` (B, H, S) float32, in the inputs' dtypes.  The plain version
    (:func:`..ref.flash_attention_bwd_ref`) for CPU tensors, the backward
    kernels for CUDA tensors."""
    _check_qkv("flash_attention_bwd", q, k, v, window)
    _check_lse("flash_attention_bwd", lse, q)
    if o.shape != q.shape or do.shape != q.shape or any(
            x.dtype != q.dtype or x.device != q.device for x in (o, do)):
        raise ValueError("flash_attention_bwd takes o and do of q's shape, "
                         "dtype and device")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, softcap=softcap,
                                       window=window)
    check_card_inputs(q, k, v)
    if not all(x.is_contiguous() and library.pointer(x) % 16 == 0
               for x in (o, do)):
        raise ValueError("flash_attention_bwd takes contiguous, 16-byte "
                         "aligned tensors")
    B, S, H, D = q.shape
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    # scratch: each 64-row tile's lse and delta = rowsum(dO O) side by side
    delta = torch.empty(2 * B * H * (-(-S // 64) * 64), dtype=torch.float32,
                        device=q.device)
    lib = library.LM or library.load_lm_library()
    library.launch("flash_attention_bwd", lib.launch_flash_attention_bwd,
                   lib.lm_error_string, q.get_device(), library.pointer(q),
                   library.pointer(k), library.pointer(v), library.pointer(o), library.pointer(lse),
                   library.pointer(do), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                   delta.data_ptr(), library.LM_DTYPES[q.dtype], B, S, H,
                   k.shape[2], D, float(softcap), min(int(window), 2**30))
    if 0 < window < S:  # the kernels' window instances
        library.LAUNCHES["flash_attention_bwd_window"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with its backward: the forward runs K8 (the
    plain version on the CPU) and keeps each row's log-sum-exp; the
    backward runs :func:`flash_attention_bwd` on q, k, v, o and lse, saved
    from the forward (recomputed with it under ``torch.utils.checkpoint``)."""

    @staticmethod
    def forward(ctx, q, k, v, softcap: float, window: int):
        B, S, H, _ = q.shape
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        o = flash_attention(q, k, v, softcap=softcap, window=window, lse=lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.softcap, ctx.window = softcap, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         softcap=ctx.softcap,
                                         window=ctx.window)
        return dq, dk, dv, None, None
