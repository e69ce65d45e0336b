"""Mamba-2 (SSD) mixer of the port: the chunked form for prefill and
training, the one-token recurrence for decode.

Ported from the reference's ``repro/models/ssm.py``, with its parameter
names, shapes and casts.  The reference runs the inter-chunk recurrence
inside its own ``lax.scan`` over chunks (``ssm.py:93-122``).  Of a chunk's
work only ``h_new = h * exp(cum[-1]) + st`` depends on the carried state
``h``: the chunk's own state contribution ``st`` and its decay do not.  So
:meth:`Mamba2.forward` computes every chunk's intra-chunk term, ``st`` and
decay at once, runs the recurrence as one call of
:func:`..kernels.ops.ssm_state_scan` (K10, the reference's Pallas
``ssm_state_scan``, which names this recurrence as its job), and then adds
each chunk's inter-chunk term from the state K10 emits before it: the same
arithmetic, regrouped.  The gated norm is K9 (``ops.rmsnorm`` at eps
1e-6).  Decode is plain tensor ops, as the reference computes it outside
any kernel.

``A_log``, ``D``, ``dt_bias`` and ``norm_w`` are float32 in a model of any
dtype, since the reference reads them through ``.astype(float32)``;
``w_in``, ``conv_w`` and ``w_out`` are in the compute dtype, since the
reference casts them to x's dtype before use.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .config import ArchConfig
from .layers import empty_param, norm_param

#: eps of the gated RMSNorm before ``w_out`` (``ssm.py:127``)
GATED_NORM_EPS = 1e-6


def chunk_len(S: int, chunk: int) -> int:
    """The largest divisor of S that is at most ``chunk`` (the reference's
    rule for ragged prefill lengths)."""
    L = min(chunk, S)
    while S % L:
        L -= 1
    return L


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


class Mamba2(nn.Module):
    """The Mamba-2 mixer of one layer (``mamba2``/``mamba2_decode``)."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        ssm = cfg.ssm
        self.cfg = cfg
        d = cfg.d_model
        self.di, self.H = ssm.d_inner(d), ssm.n_heads(d)
        self.N, self.P, self.chunk = ssm.d_state, ssm.head_dim, ssm.chunk
        f32 = torch.float32
        # order: [z (gate), x, B, C, dt]
        self.w_in = empty_param((d, 2 * self.di + 2 * self.N + self.H), dtype,
                                device)
        self.conv_w = empty_param((ssm.d_conv, self.di + 2 * self.N), dtype,
                                  device)
        self.A_log = empty_param((self.H,), f32, device)
        self.D = empty_param((self.H,), f32, device)
        self.dt_bias = empty_param((self.H,), f32, device)
        self.norm_w = norm_param(self.di, device)
        self.w_out = empty_param((self.di, d), dtype, device)

    def split_in(self, x: torch.Tensor):
        """(z, x, B, C, dt) of the input projection; dt is
        ``softplus(dt + dt_bias)`` in float32."""
        di, N = self.di, self.N
        z, xin, Bc, Cc, dt = torch.split(x @ self.w_in.to(x.dtype),
                                         [di, di, N, N, self.H], dim=-1)
        return z, xin, Bc, Cc, softplus(dt.float() + self.dt_bias)

    def causal_conv(self, seq: torch.Tensor,
                    cache: torch.Tensor | None = None):
        """Causal depthwise conv over (B, S, C) and SiLU; ``cache`` is the
        (B, d_conv - 1, C) tail of the previous tokens (zeros without one).
        A sum of d_conv shifted products in seq's dtype, as the reference
        writes it: in bf16 every product and partial sum rounds.  Returns
        (output, the new tail)."""
        K = self.conv_w.shape[0]
        if cache is None:
            pad = seq.new_zeros((seq.shape[0], K - 1, seq.shape[2]))
        else:
            pad = cache.to(seq.dtype)
        full = torch.cat([pad, seq], dim=1)
        S = seq.shape[1]
        conv_w = self.conv_w.to(seq.dtype)
        out = sum(full[:, i:i + S] * conv_w[i] for i in range(K))
        return F.silu(out), full[:, S:].clone()

    def _gated_out(self, y: torch.Tensor, z: torch.Tensor,
                   backend: str) -> torch.Tensor:
        """``y * silu(z)``, the gated RMSNorm (K9) and ``w_out``."""
        y = ops.rmsnorm(y * F.silu(z), self.norm_w, eps=GATED_NORM_EPS,
                        backend=backend)
        return y @ self.w_out.to(y.dtype)

    def forward(self, x: torch.Tensor, *, return_state: bool = False,
                backend: str = "cuda"):
        """Chunked SSD over x (B, S, d_model).  With ``return_state``,
        returns (output, cache): ``{"conv"}`` the last d_conv - 1 conv inputs
        in x's dtype, ``{"ssm"}`` the final (B, H, N, P) state in float32."""
        B, S, _ = x.shape
        f32 = torch.float32
        z, conv_tail, (xc, dtc, Bv, Cv) = self.chunk_inputs(x)
        # (a) every chunk at once: the intra-chunk term, the chunk's state
        # contribution st and its decay exp(cum[-1]) (a profiler range, so
        # a trace reads its forward's device time)
        with torch.profiler.record_function("ssd_chunks"):
            y, st, chunk_decay, cum = self.ssd_chunks(xc, dtc, Bv, Cv)
        # (b) the inter-chunk recurrence: the state before each chunk (K10)
        prev = ops.ssm_state_scan(st, chunk_decay, backend=backend)
        # (c) C_t . exp(cum_t) . h, then the skip term
        y = y + torch.einsum("bcln,cbhnp->bclhp", Cv.to(f32), prev) \
            * torch.exp(cum)[..., None]
        y = y + xc * self.D[:, None]
        y = y.reshape(B, S, self.di).to(x.dtype)
        out = self._gated_out(y, z, backend)                   # (e)
        if not return_state:
            return out
        # (d) the reference's last h_new
        h_final = prev[-1] * chunk_decay[-1][..., None, None] + st[-1]
        return out, {"conv": conv_tail, "ssm": h_final}

    def chunk_inputs(self, x: torch.Tensor):
        """The opening of :meth:`forward`: ``w_in``, the causal conv and
        the split into chunks of :func:`chunk_len`.  Returns (z, the conv
        tail, (x (B, nc, L, H, P) in float32, dt (B, nc, L, H), B and C
        (B, nc, L, N) in x's dtype)), the last the arguments of
        :meth:`ssd_chunks`."""
        B, S, _ = x.shape
        di, H, N, P = self.di, self.H, self.N, self.P
        L = chunk_len(S, self.chunk)
        nc = S // L
        z, xin, Bc, Cc, dt = self.split_in(x)
        conv_out, conv_tail = self.causal_conv(torch.cat([xin, Bc, Cc], -1))
        xin, Bc, Cc = torch.split(conv_out, [di, N, N], dim=-1)
        return z, conv_tail, (xin.reshape(B, nc, L, H, P).to(torch.float32),
                              dt.reshape(B, nc, L, H),
                              Bc.reshape(B, nc, L, N),
                              Cc.reshape(B, nc, L, N))

    def ssd_chunks(self, xc: torch.Tensor, dtc: torch.Tensor,
                   Bv: torch.Tensor, Cv: torch.Tensor):
        """(a) of :meth:`forward`, for every chunk at once: x (B, nc, L, H,
        P) in float32, dt (B, nc, L, H), B and C (B, nc, L, N) in x's dtype.
        Returns the intra-chunk output term (B, nc, L, H, P), each chunk's
        state contribution ``st`` (nc, B, H, N, P) and decay
        ``exp(cum[-1])`` (nc, B, H), contiguous for K10, and ``cum``, the
        cumulative ``dt * A`` within each chunk (B, nc, L, H)."""
        L = xc.shape[2]
        f32 = torch.float32
        A = -torch.exp(self.A_log)                             # (H,) f32
        cum = torch.cumsum(dtc * A, dim=2)
        tri = torch.ones((L, L), dtype=torch.bool, device=xc.device).tril()
        # masked before the exponent: above the diagonal cum_l - cum_s > 0
        # can pass float32's range (|dt A| ~ 3.6 a step at the reference's
        # init, 128 steps a chunk), and the reference's exp-then-where gives
        # 0 x inf = NaN in the backward there; the forward's bits are the
        # reference's (exp(-inf) = 0)
        decay = torch.exp(torch.where(
            tri[:, :, None], cum[:, :, :, None, :] - cum[:, :, None, :, :],
            -torch.inf))                                       # (B,nc,L,L,H)
        cb = torch.einsum("bcln,bcsn->bcls", Cv, Bv)           # x's dtype
        att = cb[..., None] * decay                            # f32
        del decay
        y = torch.einsum("bclsh,bcshp->bclhp", att, xc * dtc[..., None])
        del att
        decay_end = torch.exp(cum[:, :, -1:, :] - cum)         # (B,nc,L,H)
        st = torch.einsum("bcln,bclhp->cbhnp", Bv.to(f32),
                          xc * (decay_end * dtc)[..., None]).contiguous()
        chunk_decay = torch.exp(cum[:, :, -1]).transpose(0, 1).contiguous()
        return y, st, chunk_decay, cum

    def decode(self, x: torch.Tensor, cache: dict, *,
               backend: str = "cuda"):
        """One token x (B, 1, d_model) against ``cache``:
        ``h <- exp(dt A) h + dt B x``, ``y = C h + D x``.  The cache is
        updated in place (the reference returns a new one); the new conv
        tail is cast to the cache's dtype.  Returns (output, cache)."""
        B = x.shape[0]
        di, H, N, P = self.di, self.H, self.N, self.P
        f32 = torch.float32
        z, xin, Bc, Cc, dt = self.split_in(x)                  # (B,1,.)
        conv_out, new_conv = self.causal_conv(torch.cat([xin, Bc, Cc], -1),
                                              cache["conv"])
        xin, Bc, Cc = torch.split(conv_out, [di, N, N], dim=-1)
        A = -torch.exp(self.A_log)
        dt1 = dt[:, 0]                                         # (B,H)
        dA = torch.exp(dt1 * A)
        xh = xin[:, 0].reshape(B, H, P).to(f32)
        Bv = Bc[:, 0].to(f32)                                  # (B,N)
        Cv = Cc[:, 0].to(f32)
        upd = Bv[:, None, :, None] * (dt1[..., None] * xh)[:, :, None, :]
        h = cache["ssm"] * dA[..., None, None] + upd           # (B,H,N,P)
        y = torch.einsum("bn,bhnp->bhp", Cv, h) + xh * self.D[:, None]
        y = y.reshape(B, 1, di).to(x.dtype)
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(h)
        return self._gated_out(y, z, backend), cache


def init_cache(cfg: ArchConfig, batch: int, *, dtype, device) -> dict:
    """A Mamba-2 layer's zeroed decode cache: ``conv`` (batch, d_conv - 1,
    d_inner + 2 d_state) in ``dtype``, ``ssm`` (batch, H, d_state,
    head_dim) in float32."""
    ssm = cfg.ssm
    d = cfg.d_model
    return {
        "conv": torch.zeros((batch, ssm.d_conv - 1,
                             ssm.d_inner(d) + 2 * ssm.d_state),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, ssm.n_heads(d), ssm.d_state,
                            ssm.head_dim), dtype=torch.float32,
                           device=device),
    }
