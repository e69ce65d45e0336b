"""Plain PyTorch versions of the standalone kernels — what the CUDA kernels
are held against in the tests and in ``chip_smoke.py``, and what their
wrappers run for tensors on the CPU.  Ported from the reference's
``kernels/ref.py``, with its casts."""

from __future__ import annotations

import math

import torch


def tridiag_ref(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                d: torch.Tensor) -> torch.Tensor:
    """Thomas algorithm over K for every (j, i) column of (K, J, I)
    tensors: solves tridiag(a, b, c) x = d (``a[0]`` and ``c[-1]`` are not
    read)."""
    nk = a.shape[0]
    cp = torch.empty_like(a)
    x = torch.empty_like(a)
    cp[0] = c[0] / b[0]
    x[0] = d[0] / b[0]
    for k in range(1, nk):
        denom = b[k] - a[k] * cp[k - 1]
        cp[k] = c[k] / denom
        x[k] = (d[k] - a[k] * x[k - 1]) / denom
    for k in range(nk - 2, -1, -1):
        x[k] = x[k] - cp[k] * x[k + 1]
    return x


def fvt_flux_ref(q: torch.Tensor, cx: torch.Tensor, *,
                 halo: int) -> torch.Tensor:
    """The unfused ``al_x → fx_ppm`` chain on padded (K, J+2h, I+2h)
    tensors: the upwind PPM flux ``cx * f`` on the interior i, 0 on the
    halo i (every j row is computed)."""
    h = halo
    ni = q.shape[-1] - 2 * h

    def sh(di):
        return q[:, :, h + di:h + di + ni]

    def al(di):
        return (7.0 / 12.0) * (sh(di - 1) + sh(di)) \
            - (1.0 / 12.0) * (sh(di - 2) + sh(di + 1))

    al0, al1 = al(0), al(1)
    q0, qm1 = sh(0), sh(-1)
    bl = al0 - q0
    br = al1 - q0
    b0 = bl + br
    blm1 = al(-1) - qm1
    brm1 = al0 - qm1
    b0m1 = blm1 + brm1
    c = cx[:, :, h:h + ni]
    f = torch.where(c > 0.0,
                    qm1 + (1.0 - c) * (brm1 - c * b0m1),
                    q0 - (1.0 + c) * (bl + c * b0))
    f = torch.minimum(torch.maximum(f, torch.minimum(qm1, q0)),
                      torch.maximum(qm1, q0))
    out = torch.zeros_like(q)
    out[:, :, h:h + ni] = c * f
    return out


def attention_mask(S: int, window: int, device) -> torch.Tensor:
    """(S, S) boolean: key k is visible to query q iff ``k <= q`` and, for
    ``window > 0``, ``k > q - window`` (the reference model's sliding
    window, ``models/layers.py:157-159``)."""
    q = torch.arange(S, device=device)[:, None]
    k = torch.arange(S, device=device)[None, :]
    keep = k <= q
    if window > 0:
        keep &= k > q - window
    return keep


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        softcap: float = 0.0,
                        window: int = 0) -> torch.Tensor:
    """Materialized causal attention; q (B, S, H, D), k/v (B, S, KVH, D).
    Query head h reads kv head ``h // (H / KVH)``; ``window > 0`` keeps
    only the last ``window`` keys of each query (:func:`attention_mask`).
    Scores and the softmax in float32, masked with -1e30 after the softcap;
    the output in q's dtype."""
    S, H, D = q.shape[1], q.shape[2], q.shape[3]
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(attention_mask(S, window, q.device), s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *,
                eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis with a ``(1 + w)`` scale, in float32; the
    output in x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def rmsnorm_residual_ref(x: torch.Tensor, residual: torch.Tensor,
                         w: torch.Tensor, *, eps: float = 1e-5
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``s = x + residual`` summed in float32: returns (the RMSNorm of the
    unrounded ``s``, ``s``), both in x's dtype."""
    s = x.float() + residual.float()
    return rmsnorm_ref(s, w, eps=eps).to(x.dtype), s.to(x.dtype)


def ssm_state_scan_ref(states: torch.Tensor,
                       decay: torch.Tensor) -> torch.Tensor:
    """Exclusive scan of ``h <- decay * h + state`` over the chunk axis:
    states (nc, B, H, N, P), decay (nc, B, H); returns the state before each
    chunk (nc, B, H, N, P), as the reference's ``lax.scan`` emits it."""
    out = torch.empty_like(states)
    h = torch.zeros_like(states[0])
    for c in range(states.shape[0]):
        out[c] = h
        h = h * decay[c][..., None, None] + states[c]
    return out
