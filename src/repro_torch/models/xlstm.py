"""xLSTM mixers of the port: mLSTM (matrix memory, chunked-parallel in
prefill, the one-token recurrence in decode) and sLSTM (scalar memory, a
scan with a hidden-to-hidden recurrence) [arXiv:2405.04517].

Ported from the reference's ``repro/models/xlstm.py``, with its parameter
names, shapes and casts.  The reference writes both in plain jnp, outside
any Pallas kernel, so the port writes them in plain PyTorch and leaves
their products to ``torch.matmul``/``torch.einsum``.

mLSTM's prefill is the reference's chunk loop: within a chunk of L steps
the gated scores ``D_ts (q_t . k_s)``, across chunks the carried float32
state ``(C, n)``.  Above the diagonal (t < s) ``cum_t - cum_s`` is minus
the sum of the log forget gates over (t, s], and its ``exp`` overflows
once that sum passes -88.  The reference masks after the exponent with
``where``: a finite forward, but ``0 x inf = NaN`` in the backward.  The
port masks before it, ``exp(where(tri, cum_t - cum_s, -inf))``: the same
forward values and a finite gradient.  :meth:`MLSTM.state_from_seq` is
the reference's ``_mlstm_state_from_seq`` (``transformer.py:194-208``):
the final state recomputed from the gates, the weights rounded to h's
dtype, the products accumulated in float32.

sLSTM's input projection ``x @ w_in`` is one product over the whole
prompt (the reference takes it a step at a time: the same rows); the scan
itself is a loop over the steps, each emitting ``h`` in x's dtype, its
four gates' recurrences one ``bmm`` over the heads.  The steps of the
pre-activations are taken with one ``unbind`` and the emitted ``h`` are
stacked once: per-step indexing and slice writes would make autograd
zero-fill a gradient of the whole sequence at every step (a backward
quadratic in S), where the reference's ``lax.scan`` is linear.  ``r``
is float32 in a model of any dtype, since the reference reads it through
``.astype(float32)``.  The loop is :func:`scan`, read through
:data:`SCAN`, so a caller that runs the model on meta tensors can set a
stand-in of the same shapes there.
"""

from __future__ import annotations

import contextvars
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from .config import ArchConfig
from .layers import empty_param
from .ssm import chunk_len


def scan(cell, pre: torch.Tensor, state: tuple, r: torch.Tensor,
         dtype: torch.dtype) -> tuple:
    """sLSTM's loop: ``cell`` over the steps of ``pre`` (B, S, 4, H, dh)
    from ``state``.  Returns (every step's ``h`` in ``dtype``, stacked
    (B, S, H, dh); the final state)."""
    hs = []
    for pre_t in pre.unbind(1):
        state = cell(pre_t, state, r)
        hs.append(state[0].to(dtype))
    return torch.stack(hs, dim=1), state


#: the scan :meth:`SLSTM.forward` runs, with :func:`scan`'s signature
SCAN: contextvars.ContextVar = contextvars.ContextVar("SCAN", default=scan)


def _dims(cfg: ArchConfig) -> tuple[int, int, int]:
    return cfg.n_heads, cfg.d_head, cfg.n_heads * cfg.d_head


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as jnp rounds a weakly typed Python
    scalar to the array's dtype."""
    return torch.tensor(value, dtype=dtype).item()


def _final_state(k: torch.Tensor, v: torch.Tensor, log_f: torch.Tensor,
                 i_g: torch.Tensor) -> dict:
    """The reference's ``_mlstm_state_from_seq`` from a prompt's k, v (B,
    S, H, dh) and gates (B, S, H): ``w_s = exp(cum_S - cum_s) i_s``
    rounded to k's dtype, then ``C = sum_s w_s k_s v_s^T`` and ``n = sum_s
    w_s k_s`` accumulated in float32 (the operands widened, which is
    exact)."""
    f32 = torch.float32
    cum = torch.cumsum(log_f, dim=1)
    w = (torch.exp(cum[:, -1:] - cum) * i_g).to(k.dtype).to(f32)
    k = k.to(f32)
    return {"C": torch.einsum("bsh,bshd,bshe->bhde", w, k, v.to(f32)),
            "n": torch.einsum("bsh,bshd->bhd", w, k)}


class MLSTM(nn.Module):
    """The mLSTM mixer of one layer (``mlstm``, ``mlstm_decode``)."""

    def __init__(self, cfg: ArchConfig, *, dtype, device, chunk: int = 128):
        super().__init__()
        self.cfg = cfg
        self.chunk = chunk
        d = cfg.d_model
        H, _, di = _dims(cfg)
        self.wq = empty_param((d, di), dtype, device)
        self.wk = empty_param((d, di), dtype, device)
        self.wv = empty_param((d, di), dtype, device)
        self.wif = empty_param((d, 2 * H), dtype, device)
        self.wo = empty_param((di, d), dtype, device)
        self.ogate = empty_param((d, di), dtype, device)

    def qkvif(self, x: torch.Tensor):
        """q, k, v (B, S, H, dh) in x's dtype, k over sqrt(dh) after the
        product (the divisor rounded to x's dtype, as a weakly typed
        Python scalar is in jnp); log f and i (B, S, H) in float32, the
        gates' product in x's dtype, ``i = exp(log_sigmoid(.))``
        (``F.logsigmoid`` is ``jax.nn.log_sigmoid``'s ``min(x, 0) -
        log1p(exp(-|x|))``)."""
        B, S, _ = x.shape
        H, dh, _ = _dims(self.cfg)
        dt = x.dtype
        q = (x @ self.wq.to(dt)).reshape(B, S, H, dh)
        k = (x @ self.wk.to(dt)).reshape(B, S, H, dh) / _rounded(
            math.sqrt(dh), dt)
        v = (x @ self.wv.to(dt)).reshape(B, S, H, dh)
        i_raw, f_raw = torch.split((x @ self.wif.to(dt)).float(), H, dim=-1)
        return q, k, v, F.logsigmoid(f_raw), torch.exp(F.logsigmoid(i_raw))

    def _out(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The output gate ``sigmoid(x @ ogate)`` (x's dtype) and ``wo``."""
        y = y.to(x.dtype) * torch.sigmoid(x @ self.ogate.to(x.dtype))
        return y @ self.wo.to(x.dtype)

    def forward(self, x: torch.Tensor, *, return_state: bool = False):
        """Chunked-parallel mLSTM over x (B, S, d_model), chunks of the
        largest divisor of S that is at most ``chunk``.  With
        ``return_state``, returns (output, :meth:`state_from_seq`)."""
        B, S, _ = x.shape
        H, dh, di = _dims(self.cfg)
        f32 = torch.float32
        L = chunk_len(S, self.chunk)
        q, k, v, log_f, i_g = self.qkvif(x)
        tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
        C = torch.zeros((B, H, dh, dh), dtype=f32, device=x.device)
        n = torch.zeros((B, H, dh), dtype=f32, device=x.device)
        ys = []
        for c0 in range(0, S, L):
            t = slice(c0, c0 + L)
            qi, ki, vi = q[:, t].to(f32), k[:, t].to(f32), v[:, t].to(f32)
            fi, ii = log_f[:, t], i_g[:, t]
            cum = torch.cumsum(fi, dim=1)                       # (B,L,H)
            # masked before the exponent: above the diagonal cum_l - cum_s
            # >= 0 passes float32's range within a chunk of 128 at full
            # width, and the reference's exp-then-where gives 0 x inf = NaN
            # in the backward there; the forward's values are the
            # reference's (exp(-inf) = 0)
            decay = torch.exp(torch.where(
                tri[None, :, :, None],
                cum[:, :, None, :] - cum[:, None, :, :], -torch.inf))
            w = torch.einsum("blhd,bshd->blsh", qi, ki) * decay \
                * ii[:, None]
            del decay
            y_num = torch.einsum("blsh,bshd->blhd", w, vi)
            y_den = w.sum(dim=2)                                # (B,L,H)
            del w
            qdec = qi * torch.exp(cum)[..., None]
            y_num = y_num + torch.einsum("blhd,bhde->blhe", qdec, C)
            y_den = y_den + torch.einsum("blhd,bhd->blh", qdec, n)
            ys.append(y_num / torch.clamp(y_den.abs(), min=1.0)[..., None])
            # the state after the chunk
            wi = torch.exp(cum[:, -1:, :] - cum) * ii           # (B,L,H)
            Cs = torch.einsum("blh,blhd,blhe->bhde", wi, ki, vi)
            ns = torch.einsum("blh,blhd->bhd", wi, ki)
            cd = torch.exp(cum[:, -1])                          # (B,H)
            C = C * cd[..., None, None] + Cs
            n = n * cd[..., None] + ns
        y = self._out(torch.cat(ys, dim=1).reshape(B, S, di), x)
        if not return_state:
            return y
        return y, _final_state(k, v, log_f, i_g)

    def state_from_seq(self, h: torch.Tensor) -> dict:
        """The final ``{"C", "n"}`` state of a prompt h (B, S, d_model),
        recomputed from its gates (:func:`_final_state`)."""
        _, k, v, log_f, i_g = self.qkvif(h)
        return _final_state(k, v, log_f, i_g)

    def decode(self, x: torch.Tensor, cache: dict):
        """One token x (B, 1, d_model) against ``cache`` ``{"C", "n"}``:
        ``C <- f C + i k v^T``, ``n <- f n + i k``, ``y = C^T q / max(|n .
        q|, 1)``.  The cache is updated in place (the reference returns a
        new one).  Returns (output, cache)."""
        B = x.shape[0]
        _, _, di = _dims(self.cfg)
        f32 = torch.float32
        q, k, v, log_f, i_g = self.qkvif(x)
        f1 = torch.exp(log_f[:, 0])                             # (B,H)
        i1 = i_g[:, 0]
        q1, k1, v1 = q[:, 0].to(f32), k[:, 0].to(f32), v[:, 0].to(f32)
        C = cache["C"] * f1[..., None, None] \
            + i1[..., None, None] * torch.einsum("bhd,bhe->bhde", k1, v1)
        n = cache["n"] * f1[..., None] + i1[..., None] * k1
        num = torch.einsum("bhd,bhde->bhe", q1, C)
        den = torch.clamp(torch.einsum("bhd,bhd->bh", q1, n).abs(), min=1.0)
        cache["C"].copy_(C)
        cache["n"].copy_(n)
        return self._out((num / den[..., None]).reshape(B, 1, di), x), cache


class SLSTM(nn.Module):
    """The sLSTM mixer of one layer (``slstm``, ``slstm_decode``): the
    pre-activations of the gates z, i, f, o (blocks of width d_model, each
    head-major) are ``x @ w_in`` plus the head-wise recurrence ``h @ r``;
    exponential gating with the stabiliser ``m``."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        H, dh, _ = _dims(cfg)
        self.w_in = empty_param((d, 4 * d), dtype, device)
        self.r = empty_param((4, H, dh, dh), torch.float32, device)
        self.wo = empty_param((d, d), dtype, device)

    def recurrence(self) -> torch.Tensor:
        """``r`` as (H, dh, 4 dh), each head's four gate blocks side by
        side: one ``bmm`` over the heads gives every gate's recurrence."""
        H, dh, _ = _dims(self.cfg)
        return self.r.permute(1, 2, 0, 3).reshape(H, dh, 4 * dh)

    def cell(self, pre: torch.Tensor, state: tuple,
             r: torch.Tensor) -> tuple:
        """One step from the input pre-activations ``pre`` (B, 4, H, dh)
        in float32 (the gate blocks z, i, f, o, each head-major), the state
        (h, c, n, m), each (B, H, dh) float32, and :meth:`recurrence`: the
        new state.  Few launches a step: the scan is bound by them."""
        h, c, n, m = state
        H, B = h.shape[1], h.shape[0]
        rec = torch.bmm(h.transpose(0, 1), r)                   # (H,B,4dh)
        gates = pre + rec.view(H, B, 4, -1).permute(1, 2, 0, 3)
        z_r, i_r, f_r, o_r = gates.unbind(1)
        log_f_m = F.logsigmoid(f_r) + m
        m_new = torch.maximum(log_f_m, i_r)
        i_s = torch.exp(i_r - m_new)
        f_s = torch.exp(log_f_m - m_new)
        c_new = torch.addcmul(f_s * c, i_s, torch.tanh(z_r))
        n_new = torch.addcmul(i_s, f_s, n)
        h_new = torch.sigmoid(o_r) * c_new / torch.clamp(n_new, min=1.0)
        return h_new, c_new, n_new, m_new

    def forward(self, x: torch.Tensor, *, return_state: bool = False):
        """The scan over x (B, S, d_model) from the zero state.  With
        ``return_state``, returns (output, the final ``{"h", "c", "n",
        "m"}``)."""
        B, S, d = x.shape
        H, dh, _ = _dims(self.cfg)
        pre = (x @ self.w_in.to(x.dtype)).float().view(B, S, 4, H, dh)
        r = self.recurrence()
        state = tuple(torch.zeros((B, H, dh), dtype=torch.float32,
                                  device=x.device) for _ in range(4))
        with torch.profiler.record_function("slstm_scan"):
            hs, state = SCAN.get()(self.cell, pre, state, r, x.dtype)
            hs = hs.reshape(B, S, d)
        out = hs @ self.wo.to(hs.dtype)
        if return_state:
            return out, {k: t.reshape(B, d) for k, t in zip("hcnm", state)}
        return out

    def decode(self, x: torch.Tensor, cache: dict):
        """One token x (B, 1, d_model) against ``cache`` ``{"h", "c", "n",
        "m"}``, updated in place.  Returns (output, cache)."""
        B, _, d = x.shape
        H, dh, _ = _dims(self.cfg)
        pre = (x[:, 0] @ self.w_in.to(x.dtype)).float().view(B, 4, H, dh)
        new = self.cell(pre, tuple(cache[k].view(B, H, dh) for k in "hcnm"),
                        self.recurrence())
        for k, t in zip("hcnm", new):
            cache[k].view(B, H, dh).copy_(t)
        return (new[0].reshape(B, 1, d).to(x.dtype) @ self.wo.to(x.dtype),
                cache)


def init_cache(btype: str, cfg: ArchConfig, batch: int, *,
               device) -> dict:
    """An xLSTM layer's zeroed decode cache, float32: ``{"C"}`` (batch, H,
    dh, dh) and ``{"n"}`` (batch, H, dh) for mLSTM, ``{"h", "c", "n",
    "m"}`` (batch, d_model) for sLSTM."""
    f32 = torch.float32
    if btype == "mlstm":
        H, dh, _ = _dims(cfg)
        return {"C": torch.zeros((batch, H, dh, dh), dtype=f32,
                                 device=device),
                "n": torch.zeros((batch, H, dh), dtype=f32, device=device)}
    return {k: torch.zeros((batch, cfg.d_model), dtype=f32, device=device)
            for k in "hcnm"}
