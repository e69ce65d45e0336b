"""Transformer layer primitives of the port: norms, RoPE, GQA attention
(global or sliding-window, prefill and one-token decode against a KV cache
or a ring), the dense MLPs and the GShard-style mixture of experts.

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
embedding) in the model's dtype and casts it at its use
(``.to(x.dtype)``): a serving model stores the compute dtype (no copy, the
same bits), a training model float32 masters; a parameter
that the reference reads through ``.astype(float32)`` (the norms' ``w``
here, Mamba-2's ``A_log``, ``D``, ``dt_bias`` and ``norm_w``) stays in
float32 in a model of any dtype (:func:`norm_param`), since a bf16 copy
would round it.

Decode reads a cache in the compute dtype or, as the reference's
``attention_decode`` does for an int8 cache, int8 values with float32
per-head scales (the reference's ``quant_kv``).

A ``local`` (sliding-window) block attends to the last ``cfg.window``
positions.  Its prefill runs K8 with the window; its decode cache is a ring
of W = min(window, cache length) slots, position p in slot ``p % W``, and
decode masks every slot whose position is not in ``(pos - window, pos]``.
That is the reference's ``attention`` (its ``forward``), not its
``attention_decode`` past the window: once a cache reaches ``window`` the
reference's decode masks with the grown cache length and writes slot
``pos % S_cache`` over a prefill that put the last ``window`` keys in slots
``0 .. window - 1`` (ROADMAP queue 3).

:class:`MoE` is the reference's ``moe``: the router's softmax in float32,
top-k gates renormalised, a capacity of C slots per expert and chunk of
``token_chunk`` tokens with the same tokens dropped; it dispatches by
index (gather, ``index_add_``) where the reference multiplies one-hot
``(tc, E, C)`` tensors, the same function.  It has no kernel of its own:
the reference's is plain jnp, outside any Pallas kernel.  On rows split
over data-parallel ranks (:data:`TOKEN_SPLIT`) it routes the chunks of
the global micro-batch, as one process routes them.

Not ported: ``constrain`` and the sharding annotations (a sharded model's
blocks run on whole weights, ``parallel.sharding.Gathered``).
"""

from __future__ import annotations

import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .config import ArchConfig


#: the data-parallel ranks that split the rows of the micro-batch a block
#: runs on (``parallel.sharding.TokenSplit``: their number ``ranks``, this
#: rank's ``index`` among them in the rows' order, and ``gather``: every
#: rank's per-token tensor in the global token order), None on one process
TOKEN_SPLIT: contextvars.ContextVar = contextvars.ContextVar(
    "TOKEN_SPLIT", default=None)


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


def _ring(t: torch.Tensor, n: int) -> torch.Tensor:
    """The last n positions of t (B, S, ...) in a ring of n slots along dim
    1, position p in slot ``p % n``; zeros in slots no position reached."""
    S = t.shape[1]
    p = torch.arange(max(0, S - n), S, device=t.device)
    out = t.new_zeros((t.shape[0], n) + t.shape[2:])
    out[:, p % n] = t[:, p]
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
        dt = x.dtype
        q = (x @ self.wq.to(dt)).reshape(B, -1, cfg.n_heads, cfg.d_head)
        k = (x @ self.wk.to(dt)).reshape(B, -1, cfg.n_kv_heads, cfg.d_head)
        v = (x @ self.wv.to(dt)).reshape(B, -1, cfg.n_kv_heads, cfg.d_head)
        return (rope(q, positions, cfg.rope_theta),
                rope(k, positions, cfg.rope_theta), v)

    def window(self, local: bool) -> int:
        """The sliding window of a ``local`` block (0: none)."""
        return self.cfg.window if local else 0

    def prefill(self, x: torch.Tensor, *, cache_len: int | None = None,
                local: bool = False, backend: str = "cuda"):
        """Attention over the whole prompt x (B, S, d_model) through K8, with
        the window for a ``local`` block.  Returns (output, k, v); k/v
        (B, S, n_kv_heads, d_head) are the prompt's cache, or, with
        ``cache_len``, a cache of that many slots that holds the prompt's
        first and zeros past them.  A local block's cache is a ring of
        W = min(window, cache_len or S) slots holding the last W positions,
        position p in slot ``p % W`` (the reference keeps them in order,
        ``k[:, -window:]``: the same slots rotated)."""
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        q, k, v = self.qkv(x, positions)
        window = self.window(local)
        out = ops.flash_attention(q, k, v, softcap=self.cfg.attn_softcap,
                                  window=window, backend=backend)
        if window:
            n = min(window, S if cache_len is None else cache_len)
            k, v = (_ring(t, n) for t in (k, v))
        elif cache_len is not None:
            k, v = (_padded(t, cache_len) for t in (k, v))
        return out.reshape(B, S, self.cfg.q_dim) @ self.wo.to(x.dtype), k, v

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, pos: int, *, local: bool = False,
               k_scale: torch.Tensor | None = None,
               v_scale: torch.Tensor | None = None,
               split=None) -> torch.Tensor:
        """One token x (B, 1, d_model) at position ``pos`` against a
        (B, S_cache, n_kv_heads, d_head) cache.  Writes the token's k/v into
        slot ``pos`` of the caches in place (the reference returns updated
        copies); a ``local`` block's cache is a ring (:meth:`prefill`): slot
        ``pos % S_cache``.  Scores in float32 over the whole cache, masked
        with -1e30 where the slot's position is past ``pos`` (or not in the
        window, ``(pos - window, pos]``, or not written yet); the
        probabilities cast to x's dtype before P·V, as the reference
        does.  An int8 cache (the reference's ``quant_kv``) comes with
        float32 per-head scales ``k_scale``/``v_scale`` (B, 1, n_kv_heads,
        1): the token's post-RoPE k/v are written as ``clip(round(k /
        k_scale), -127, 127)``, and the cache is read as ``q.to(x.dtype) *
        scale.to(x.dtype)``.

        ``split`` (``parallel.sharding.CacheSplit``): the caches are this
        rank's slots ``[split.start, split.start + S_cache)`` of a cache of
        ``split.total`` slots split over ranks that all run the same token.
        Each slot's position is reckoned from its global index (a ring's on
        the global ring length), only the rank that holds slot ``pos``
        writes it, and the softmax is global: the scores' maximum and the
        sum of their exponents all-reduced, the probabilities cast to x's
        dtype, P·V of the rank's slots in float32, all-reduced, then cast
        to x's dtype."""
        cfg = self.cfg
        B, n = x.shape[0], cache_k.shape[1]
        start, total = (0, n) if split is None else (split.start, split.total)
        positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
        q, k, v = self.qkv(x, positions)
        window = self.window(local)
        slots = torch.arange(start, start + n, device=x.device)
        if window:
            if pos >= total and total < window:
                raise ValueError(f"a ring of {total} slots cannot hold the "
                                 f"window {window} at position {pos}")
            held = pos - (pos - slots) % total  # each slot's position
            valid = (held >= 0) & (held > pos - window)
            slot = pos % total
        else:
            valid = slots <= pos
            slot = pos
        int8 = cache_k.dtype == torch.int8
        if int8:
            k = torch.clamp(torch.round(k / k_scale), -127, 127)
            v = torch.clamp(torch.round(v / v_scale), -127, 127)
        if start <= slot < start + n:
            cache_k[:, slot - start] = k[:, 0]
            cache_v[:, slot - start] = v[:, 0]
        if int8:
            keys = cache_k.to(x.dtype) * k_scale.to(x.dtype)
            values = cache_v.to(x.dtype) * v_scale.to(x.dtype)
        else:
            keys, values = cache_k, cache_v
        rep = cfg.n_heads // cfg.n_kv_heads
        qg = q.reshape(B, cfg.n_kv_heads, rep, cfg.d_head)
        scores = torch.einsum("bgrd,bsgd->bgrs", qg.float(),
                              keys.float()) * (1.0 / math.sqrt(cfg.d_head))
        scores = softcap(scores, cfg.attn_softcap)
        scores = torch.where(valid, scores, -1e30)
        if split is None:
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            out = torch.einsum("bgrs,bsgd->bgrd", probs, values)
        else:
            top = split.all_reduce(
                scores.amax(dim=-1, keepdim=True) if n
                else scores.new_full(scores.shape[:-1] + (1,), -1e30), "max")
            e = torch.exp(scores - top)
            probs = (e / split.all_reduce(e.sum(dim=-1, keepdim=True),
                                          "sum")).to(x.dtype)
            out = split.all_reduce(torch.einsum(
                "bgrs,bsgd->bgrd", probs.float(), values.float()), "sum")
            out = out.to(x.dtype)
        return out.reshape(B, 1, cfg.q_dim) @ self.wo.to(x.dtype)


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
        h = x @ self.wi.to(x.dtype)
        if self.act == "swiglu":
            h = F.silu(x @ self.wg.to(x.dtype)) * h
        elif self.act == "geglu":
            h = F.gelu(x @ self.wg.to(x.dtype), approximate="tanh") * h
        else:
            h = F.gelu(h, approximate="tanh")
        return h @ self.wo.to(h.dtype)


class MoE(nn.Module):
    """The reference's GShard-style mixture of experts (``moe_pdefs``,
    ``moe``): E experts with the MLP's widths, top-k routing, and, where
    the config says so, a shared expert (an :class:`MLP`) added after.
    Gated experts (``wg``) use SiLU whatever ``cfg.act`` is, ungated ones
    GeLU (tanh), as the reference computes them."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        self.moe = mc = cfg.moe
        d, f, E = cfg.d_model, cfg.d_ff, mc.n_experts
        self.router = empty_param((d, E), dtype, device)
        self.wi = empty_param((E, d, f), dtype, device)
        if cfg.act != "gelu":
            self.wg = empty_param((E, d, f), dtype, device)
        self.wo = empty_param((E, f, d), dtype, device)
        self.shared = (MLP(cfg, dtype=dtype, device=device)
                       if mc.shared_expert else None)

    def capacity(self, tc: int) -> int:
        """Slots of each expert in a chunk of ``tc`` tokens."""
        mc = self.moe
        return min(tc, max(1, int(tc * mc.top_k / mc.n_experts
                                  * mc.capacity_factor)))

    def route(self, xc: torch.Tensor):
        """The routing of a chunk xc (tc, d): each token's top-k experts
        (tc, K), their gates (tc, K, float32), each choice's slot in its
        expert's queue (tc, K) and whether it is kept (tc, K).  The router's
        logits in xc's dtype, cast to float32 for the softmax; the top-k
        gates over their sum (at least 1e-9); a choice's slot is its place
        in its expert's queue, counted over the chunk's (token, choice)
        pairs in order, and a choice at slot C or past is dropped."""
        E, K = self.moe.n_experts, self.moe.top_k
        probs = torch.softmax((xc @ self.router.to(xc.dtype)).float(),
                              dim=-1)
        gate, expert = torch.topk(probs, K, dim=-1)
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        onehot = F.one_hot(expert.reshape(-1), E)
        slot = ((onehot.cumsum(0) * onehot).sum(-1) - 1).view_as(expert)
        return expert, gate, slot, slot < self.capacity(xc.shape[0])

    def experts(self, xe: torch.Tensor) -> torch.Tensor:
        """Every expert's MLP over its C slots: xe (E, C, d) -> (E, C, d)."""
        h = torch.bmm(xe, self.wi.to(xe.dtype))
        if hasattr(self, "wg"):
            h = F.silu(torch.bmm(xe, self.wg.to(xe.dtype))) * h
        else:
            h = F.gelu(h, approximate="tanh")
        return torch.bmm(h, self.wo.to(h.dtype))

    def forward(self, x: torch.Tensor, *,
                token_chunk: int = 8192) -> torch.Tensor:
        """x (B, S, d) -> (B, S, d), the tokens taken in chunks of
        ``token_chunk`` (B S must be a multiple of the chunk, as in the
        reference).  Each kept choice's token is copied into its expert's
        slot (empty slots hold zeros), the experts run on their slots, and
        each token sums its kept choices' outputs times their gates (cast
        to x's dtype) in float32 (with at most two choices a token, as the
        configs have, the sum does not depend on the order of the adds); a
        token whose every choice was dropped gets zeros (and the shared
        expert).  On rows split over ranks (:data:`TOKEN_SPLIT`) the
        chunks and C are those of the global micro-batch: a rank routes
        its part of each chunk, and a choice's slot also counts the
        chunk's choices of the same expert on the ranks before it (every
        token's experts gathered), so the same choices are dropped."""
        B, S, d = x.shape
        T = B * S
        split = TOKEN_SPLIT.get()
        ranks, first = (1, 0) if split is None else (split.ranks,
                                                     split.index * T)
        tc = min(token_chunk, ranks * T)
        if ranks * T % tc:
            raise ValueError(f"MoE: {ranks * T} tokens are not a multiple "
                             f"of the chunk of {tc}")
        E, C = self.moe.n_experts, self.capacity(tc)
        xt = x.reshape(T, d)
        # this rank's part [a, b) of each chunk it holds tokens of
        cuts = [0] + [c - first for c in range(tc, ranks * T, tc)
                      if first < c < first + T] + [T]
        parts = list(zip(cuts[:-1], cuts[1:]))
        routes = [self.route(xt[a:b])[:3] for a, b in parts]
        if split is not None:
            every = split.gather(torch.cat([r[0] for r in routes]))
            for i, (a, b) in enumerate(parts):
                start = (first + a) // tc * tc
                seen = every[start:first + a].reshape(-1)
                before = torch.zeros(E, dtype=seen.dtype,
                                     device=x.device).scatter_add_(
                    0, seen, torch.ones_like(seen))
                expert, gate, slot = routes[i]
                routes[i] = (expert, gate, slot + before[expert])
        y = torch.empty_like(xt)
        for (a, b), (expert, gate, slot) in zip(parts, routes):
            xc, n = xt[a:b], b - a
            # every choice in (token, choice) order, so no shape depends
            # on the routing (a dry run routes meta tensors): a dropped
            # one fills a spare input slot E C and reads any output slot
            # with a gate of 0
            token = torch.arange(n, device=x.device).repeat_interleave(
                expert.shape[1])
            keep = (slot < C).reshape(-1)
            where = (expert * C + slot).reshape(-1)
            xe = xc.new_zeros((E * C + 1, d))
            xe[torch.where(keep, where, E * C)] = xc[token]
            out = self.experts(xe[:E * C].view(E, C, d)).view(E * C, d)
            gate = torch.where(keep, gate.to(x.dtype).float().reshape(-1), 0)
            part = out[where.clamp_max(E * C - 1)].float() * gate[:, None]
            y[a:b] = torch.zeros((n, d), dtype=torch.float32,
                                 device=x.device).index_add_(
                0, token, part).to(x.dtype)
        y = y.view(B, S, d)
        if self.shared is not None:
            y = y + self.shared(x)
        return y
