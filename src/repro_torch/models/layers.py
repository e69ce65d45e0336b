"""Transformer layer primitives of the port: norms, RoPE, GQA attention
(prefill and one-token decode against a KV cache) and the dense MLPs.

Ported from the reference's ``repro/models/layers.py``, which computes all
of it in jnp and names its Pallas kernels as drop-in replacements
(``layers.py:14-15``).  The port puts its kernels there: every RMSNorm of
the model is :func:`repro_torch.kernels.ops.rmsnorm` (K9) and the prefill
attention is :func:`repro_torch.kernels.ops.flash_attention` (K8), the same
function as the reference's query-chunked attention.  The large
products stay ``torch.matmul``, as the reference left them to XLA; decode
attention is plain tensor ops, as the reference computes it outside any
kernel.  Weights have the reference's shapes (``x @ w``).  The reference
keeps every parameter in float32 and casts at each use.  The port stores a
weight that the reference casts to x's dtype (the matmul weights, the
embedding) in the compute dtype, which gives the same bits; a parameter
that the reference reads through ``.astype(float32)`` (the norms' ``w``
here, Mamba-2's ``A_log``, ``D``, ``dt_bias`` and ``norm_w``) stays in
float32 in a model of any dtype (:func:`norm_param`), since a bf16 copy
would round it.

Not ported: ``constrain`` and the sharding annotations (one card), ``moe``
(ROADMAP queue 1 item 12c) and the sliding window of ``local`` layers
(item 12b).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .config import ArchConfig


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Half-split rotary embedding; x (..., S, H, D), positions (..., S).
    Angles in float32; the output in x's dtype."""
    half = x.shape[-1] // 2
    freqs = (1.0 / theta) ** (torch.arange(half, dtype=torch.float32,
                                           device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def empty_param(shape, dtype, device) -> nn.Parameter:
    """Uninitialised; :func:`..weights.init_params` or
    :func:`..weights.load_reference_params` fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def norm_param(d: int, device) -> nn.Parameter:
    """The ``w`` of a ``(1 + w)`` RMSNorm over d: float32 in a model of any
    dtype, as the reference computes ``1 + w.astype(float32)``."""
    return empty_param((d,), torch.float32, device)


def _padded(t: torch.Tensor, n: int) -> torch.Tensor:
    """t (B, S, ...) in the first S of n slots along dim 1, zeros past."""
    out = t.new_zeros((t.shape[0], n) + t.shape[2:])
    out[:, :t.shape[1]] = t
    return out


class Attention(nn.Module):
    """Causal GQA attention with RoPE: query head h reads kv head
    ``h // (n_heads / n_kv_heads)``, as the reference's ``_repeat_kv``."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.wq = empty_param((d, cfg.q_dim), dtype, device)
        self.wk = empty_param((d, cfg.kv_dim), dtype, device)
        self.wv = empty_param((d, cfg.kv_dim), dtype, device)
        self.wo = empty_param((cfg.q_dim, d), dtype, device)
        if cfg.qkv_bias:  # declared, and never added, as in the reference
            self.bq = empty_param((cfg.q_dim,), dtype, device)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        B = x.shape[0]
        q = (x @ self.wq).reshape(B, -1, cfg.n_heads, cfg.d_head)
        k = (x @ self.wk).reshape(B, -1, cfg.n_kv_heads, cfg.d_head)
        v = (x @ self.wv).reshape(B, -1, cfg.n_kv_heads, cfg.d_head)
        return (rope(q, positions, cfg.rope_theta),
                rope(k, positions, cfg.rope_theta), v)

    def prefill(self, x: torch.Tensor, *, cache_len: int | None = None,
                backend: str = "cuda"):
        """Attention over the whole prompt x (B, S, d_model) through K8.
        Returns (output, k, v); k/v (B, S, n_kv_heads, d_head) are the
        prompt's cache, or, with ``cache_len``, a cache of that many slots
        that holds the prompt's first and zeros past them."""
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        q, k, v = self.qkv(x, positions)
        out = ops.flash_attention(q, k, v, softcap=self.cfg.attn_softcap,
                                  backend=backend)
        if cache_len is not None:
            k, v = (_padded(t, cache_len) for t in (k, v))
        return out.reshape(B, S, self.cfg.q_dim) @ self.wo, k, v

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, pos: int) -> torch.Tensor:
        """One token x (B, 1, d_model) at position ``pos`` against a
        (B, S_cache, n_kv_heads, d_head) cache.  Writes the token's k/v into
        slot ``pos`` of the caches in place (the reference returns updated
        copies).  Scores in float32 over the whole cache, slots past
        ``pos`` masked with -1e30; the probabilities cast to x's dtype before
        P·V, as the reference does."""
        cfg = self.cfg
        B = x.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
        q, k, v = self.qkv(x, positions)
        cache_k[:, pos] = k[:, 0]
        cache_v[:, pos] = v[:, 0]
        rep = cfg.n_heads // cfg.n_kv_heads
        qg = q.reshape(B, cfg.n_kv_heads, rep, cfg.d_head)
        scores = torch.einsum("bgrd,bsgd->bgrs", qg.float(),
                              cache_k.float()) * (1.0 / math.sqrt(cfg.d_head))
        scores = softcap(scores, cfg.attn_softcap)
        valid = torch.arange(cache_k.shape[1], device=x.device) <= pos
        scores = torch.where(valid, scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bgrs,bsgd->bgrd", probs, cache_v)
        return out.reshape(B, 1, cfg.q_dim) @ self.wo


class MLP(nn.Module):
    """SwiGLU / GeGLU (gated) or GeLU MLP; GeLU is the tanh form, as
    ``jax.nn.gelu`` computes it by default."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        self.act = cfg.act
        d, f = cfg.d_model, cfg.d_ff
        self.wi = empty_param((d, f), dtype, device)
        if cfg.act in ("swiglu", "geglu"):
            self.wg = empty_param((d, f), dtype, device)
        self.wo = empty_param((f, d), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x @ self.wi
        if self.act == "swiglu":
            h = F.silu(x @ self.wg) * h
        elif self.act == "geglu":
            h = F.gelu(x @ self.wg, approximate="tanh") * h
        else:
            h = F.gelu(h, approximate="tanh")
        return h @ self.wo
