"""Plain PyTorch versions of the standalone kernels — what the CUDA kernels
are held against in the tests and in ``chip_smoke.py``, and what their
wrappers run for tensors on the CPU.  Ported from the reference's
``kernels/ref.py``, with its casts; the backward versions of K8 and K9
(``*_bwd_ref``) have no counterpart there: the reference differentiates
its jnp model with XLA."""

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


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in float32, or float64 where it is (a float64 run of a plain
    version is the exact reference of the kernel's float32 one)."""
    return t if t.dtype == torch.float64 else t.float()


def _scores(q: torch.Tensor, k: torch.Tensor, softcap: float,
            window: int) -> torch.Tensor:
    """The masked scores (B, H, S, S) in float32 (float64 for float64
    inputs): q.k / sqrt(D), the softcap, then -1e30 where
    :func:`attention_mask` hides the key."""
    S, H, D = q.shape[1], q.shape[2], q.shape[3]
    k = k.repeat_interleave(H // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", _wide(q), _wide(k)) / math.sqrt(D)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    return torch.where(attention_mask(S, window, q.device), s, -1e30)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        softcap: float = 0.0,
                        window: int = 0) -> torch.Tensor:
    """Materialized causal attention; q (B, S, H, D), k/v (B, S, KVH, D).
    Query head h reads kv head ``h // (H / KVH)``; ``window > 0`` keeps
    only the last ``window`` keys of each query (:func:`attention_mask`).
    Scores and the softmax in float32, masked with -1e30 after the softcap;
    the output in q's dtype."""
    return flash_attention_fwd_ref(q, k, v, softcap=softcap,
                                   window=window)[0]


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, softcap: float = 0.0,
                            window: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_ref` and each row's log-sum-exp of the scores
    (B, H, S) in float32, which the backward reads."""
    s = _scores(q, k, softcap, window)
    v = v.repeat_interleave(q.shape[2] // k.shape[2], dim=2)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, _wide(v)).to(q.dtype)
    return o, torch.logsumexp(s, dim=-1)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            softcap: float = 0.0, window: int = 0,
                            round_ds: bool = True
                            ) -> tuple[torch.Tensor, ...]:
    """The gradients (dq, dk, dv) of :func:`flash_attention_ref` for the
    output's gradient ``do``, from the forward's output ``o`` and row
    log-sum-exp ``lse`` (B, H, S), in float32 (float64 for float64 inputs)
    and then the inputs' dtypes:
    P = exp(s - lse) where the key is visible (0 elsewhere), dP = dO V^T,
    delta = rowsum(dO O), dS = P (dP - delta), times 1 - tanh^2(s/cap)
    under a softcap; dq = dS K / sqrt(D), dk = dS^T Q / sqrt(D) and
    dv = P^T dO, each summed over the query heads of a kv head's group.
    In bfloat16 P is rounded to bf16 before P^T dO, as K8 rounds it before
    P V, and dS (from the unrounded P) to bf16 before dS K and dS^T Q, as
    the backward kernels round it to enter the tensor cores;
    ``round_ds=False`` keeps dS in float32 (the equations without that
    rounding, which the holds of that choice compare against)."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    rep = H // KVH
    scale = 1.0 / math.sqrt(D)
    kr = _wide(k.repeat_interleave(rep, dim=2))
    vr = _wide(v.repeat_interleave(rep, dim=2))
    q32, do32 = _wide(q), _wide(do)
    s = torch.einsum("bqhd,bkhd->bhqk", q32, kr) * scale
    dcap = 1.0
    if softcap > 0.0:
        t = torch.tanh(s / softcap)
        s = softcap * t
        dcap = 1.0 - t * t
    keep = attention_mask(S, window, q.device)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, vr)
    delta = (do32 * _wide(o)).sum(-1).transpose(1, 2)         # (B, H, S)
    ds = p * (dp - delta[..., None]) * dcap
    if q.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
        if round_ds:
            ds = ds.to(torch.bfloat16).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    dk = dk.reshape(B, S, KVH, rep, D).sum(3)
    dv = dv.reshape(B, S, KVH, rep, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def rmsnorm_bwd_ref(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, *,
                    eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients (dx, dw) of :func:`rmsnorm_ref` for the output's
    gradient ``g``, in float32 (float64 for float64 inputs) and then x's
    and w's dtypes: with
    rstd = rsqrt(mean(x^2) + eps), x^ = x rstd and gw = g (1 + w),
    dx = rstd (gw - x^ mean(gw x^)) and dw = the sum over rows of g x^."""
    return _rmsnorm_bwd(_wide(x), w, g, None, eps, x.dtype)


def rmsnorm_residual_bwd_ref(x: torch.Tensor, residual: torch.Tensor,
                             w: torch.Tensor, g: torch.Tensor,
                             gs: torch.Tensor | None, *, eps: float = 1e-5
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients (dx, dw) of :func:`rmsnorm_residual_ref` for the
    gradients ``g`` of the normed output and ``gs`` of the returned sum
    (None: zero): :func:`rmsnorm_bwd_ref` of the unrounded
    s = x + residual, plus ``gs``; dx is also the residual's gradient."""
    return _rmsnorm_bwd(_wide(x) + _wide(residual), w, g, gs, eps, x.dtype)


def _rmsnorm_bwd(s, w, g, gs, eps, dtype):
    d = s.shape[-1]
    rstd = torch.rsqrt((s * s).mean(dim=-1, keepdim=True) + eps)
    xh = s * rstd
    g32 = _wide(g)
    gw = g32 * (1.0 + _wide(w))
    dx = rstd * (gw - xh * (gw * xh).mean(dim=-1, keepdim=True))
    if gs is not None:
        dx = dx + _wide(gs)
    dw = (g32 * xh).reshape(-1, d).sum(0)
    return dx.to(dtype), dw.to(w.dtype)


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


def ssm_state_scan_bwd_ref(g: torch.Tensor, out: torch.Tensor,
                           decay: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients (d states, d decay) of :func:`ssm_state_scan_ref` for
    the gradient ``g`` of its output ``out`` (nc, B, H, N, P), with decay
    (nc, B, H).  out_{c+1} = decay_c out_c + states_c, so the adjoint a_c of
    out_c walks the chunks backwards from a_nc = 0:
    a_c = g_c + decay_c a_{c+1}, d states_c = a_{c+1} and
    d decay_c = the sum over (N, P) of a_{c+1} out_c.  The last chunk's
    are 0: the exclusive scan never reads its state or its decay."""
    ds = torch.empty_like(g)
    dd = torch.empty_like(decay)
    a = torch.zeros_like(g[0])
    for c in range(g.shape[0] - 1, -1, -1):
        ds[c] = a
        dd[c] = (a * out[c]).sum(dim=(-2, -1))
        a = g[c] + decay[c][..., None, None] * a
    return ds, dd
