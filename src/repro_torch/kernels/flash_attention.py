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
CUDA tensors it launches the kernel of their dtype or raises.
"""

from __future__ import annotations

import torch

from . import library
from .ref import flash_attention_ref

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
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0
               for x in (q, k, v)):
        raise ValueError("flash_attention takes contiguous, 16-byte aligned "
                         "tensors")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """Causal attention of q (B, S, H, D) over k/v (B, S, KVH, D), H a
    multiple of KVH; ``softcap > 0`` caps the scores with
    ``softcap * tanh(s / softcap)``; ``window > 0`` keeps only the keys
    ``k > q - window`` of each query q.  Returns (B, S, H, D) in q's
    dtype."""
    xs = (q, k, v)
    if not all(isinstance(x, torch.Tensor) for x in xs):
        raise TypeError("flash_attention takes torch tensors")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention takes q (B, S, H, D) and k/v "
                         f"(B, S, KVH, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    KVH = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, D) or H % KVH:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (H must be a multiple of KVH)")
    if any(x.device != q.device or x.dtype != q.dtype for x in xs):
        raise ValueError("flash_attention's tensors disagree in device or "
                         "dtype")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, softcap=softcap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    check_card_inputs(q, k, v)
    o = torch.empty_like(q)
    lib = library.LM or library.load_lm_library()
    library.launch("flash_attention", lib.launch_flash_attention,
                   lib.lm_error_string, q.get_device(), q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   library.LM_DTYPES[q.dtype], B, S, H, KVH, D,
                   float(softcap), min(int(window), 2**30))
    if 0 < window < S:  # the kernel's window instance
        library.LAUNCHES["flash_attention_window"] += 1
    return o
