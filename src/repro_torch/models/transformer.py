"""Model assembly and the serving entry points, for patterns of ``attn``,
``local`` (sliding-window attention), ``mamba2``, ``shared_attn``,
``mlstm`` and ``slstm`` blocks, with dense or mixture-of-experts
feed-forwards, in float weights or int8 (``quantized=True``).

Ported from the reference's ``repro/models/transformer.py``.  A model is
``n_groups`` repetitions of its ``pattern``; the reference stacks each
slot's parameters over groups and scans them, the port keeps one block per
layer in an ``nn.ModuleList`` in the reference's order (group g, slot s at
index ``g * len(slots) + s``) and loops over it.  A ``shared_attn`` entry
of the pattern (Zamba2) applies one weight-shared attention + MLP block,
``Transformer.shared_attn``, at the head of every group, before the mixer
slots wherever the pattern names it (the reference's ``group_body``), each
application with its own KV cache.

Entry points, as the reference's:
  * :func:`loss_fn`     — the causal LM loss of a batch (training);
  * :func:`prefill`     — last-position logits and the caches of a prompt;
  * :func:`decode_step` — one token against the caches;
  * :func:`forward`     — the hidden states of the whole stack.

The caches are a list with one entry per block application, in the order
the blocks run (:meth:`Transformer.stack`: group by group, in
:func:`group_order`): ``{"k", "v"}`` for an attention block (with
``quant_kv``, int8 k/v and their float32 scales ``{"k_s", "v_s"}``),
``{"conv", "ssm"}`` for a Mamba-2 block, ``{"C", "n"}`` for an mLSTM block
and ``{"h", "c", "n", "m"}`` for an sLSTM block.  A ``local`` block's
``{"k", "v"}`` is a ring of min(window, length) slots, position p in slot
``p % W`` (:meth:`.layers.Attention.prefill`); its decode follows the
reference's ``forward`` past the window, not its ``decode_step`` (ROADMAP
queue 3).

``quantized=True`` runs the int8 model of
:func:`repro_torch.serve.quantize.quantize_params` as the reference's
``forward(quantized=True)`` does: the embedding, the unembedding, the
final norm and the shared block dequantized up front, each other block's
weights dequantized at its use (``q.to(bf16) * s.to(bf16)``, cast to the
dtype the block keeps them in) and dropped after it.

Each entry point takes ``backend``: ``"cuda"`` (the default) runs the
kernels (K8 flash attention in prefill, K9 RMSNorm and its fused residual
add, K10 the SSM state scan in a Mamba-2 prefill) on CUDA tensors and
their plain versions on CPU tensors; ``"ref"`` runs the plain versions
everywhere.  The model's device is the card unless the caller asks for
another (``device="cpu"``, or ``"meta"`` to count parameters).

Training (:func:`loss_fn`, ``mode="train"``): the model holds float32
masters (``Transformer(cfg, dtype=torch.float32)``, parameters made
trainable with ``requires_grad_()``) and computes in ``dtype`` (bf16 by
default, the reference's ``loss_fn``): each weight is cast at its use,
where the reference casts (``.astype(x.dtype)``), the embedding rows
gathered from the float32 table and then cast (so its gradient adds the
repeated tokens' rows in float32), the norm weights and Mamba-2's scalars
read in float32.  With ``cfg.remat == "block"`` each group runs under
``torch.utils.checkpoint`` (non-reentrant), as the reference's
``jax.checkpoint`` of ``group_body``: its activations are recomputed in
the backward; with ``"dots"`` the outputs of its products without a batch
dimension are kept and the rest recomputed (:mod:`.remat`).  On the card
K8 (its window instance in Gemma-2's local layers), K9 and K10 (Mamba-2's
inter-chunk scan) run with their backward kernels (``kernels.ops``); the
xLSTM and MoE blocks differentiate through plain tensor ops.

``seq_shard`` (the reference's keyword; :func:`forward`, :func:`loss_fn`,
:func:`prefill` in modes "train" and "prefill", on a model laid out on a
mesh with a "model" axis of several ranks): between blocks the residual
stream is this rank's part of the sequence over "model"; each block
gathers it whole at its entry and keeps its part at its exit
(``parallel.sharding.StreamSplit``), so a checkpoint keeps 1/tp of its
group's input.  Every block runs whole, as every model rank runs it
without the split: the results are the same bits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..core.backend.base import resolve_device
from ..kernels import ops
from ..kernels.library import is_dtensor
from . import layers as L
from . import remat as R
from . import ssm as SSM
from . import xlstm as XL
from .config import ArchConfig

BLOCK_TYPES = ("attn", "local", "shared_attn", "mamba2", "mlstm", "slstm")


def mixer_slots(cfg: ArchConfig) -> list[tuple[str, str]]:
    """(slot_name, block_type) for stacked slots (shared_attn excluded), the
    reference's names (``s{i}_{type}``)."""
    return [(f"s{i}_{b}", b) for i, b in enumerate(cfg.pattern)
            if b != "shared_attn"]


def group_order(cfg: ArchConfig) -> list[str]:
    """The block types of one group in the order they run, as the
    reference's ``group_body``: the shared block first (where the pattern
    has one), then the mixer slots in pattern order."""
    shared = ["shared_attn"] if "shared_attn" in cfg.pattern else []
    return shared + [b for _, b in mixer_slots(cfg)]


def has_ffn(btype: str, cfg: ArchConfig) -> bool:
    return cfg.d_ff != 0 and btype not in ("mamba2", "mlstm", "slstm")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a block type the reference does not have."""
    for b in cfg.pattern:
        if b not in BLOCK_TYPES:
            raise ValueError(f"{cfg.name}: unknown block type {b!r}")


class Block(nn.Module):
    """One ``attn``, ``local`` or ``shared_attn`` block: pre-norm attention
    (with the sliding window in a ``local`` block) and the feed-forward (an
    :class:`.layers.MLP`, or :class:`.layers.MoE` where the config has
    experts), with the reference's ``post_norm`` (sandwich) and
    ``parallel_block`` variants."""

    def __init__(self, cfg: ArchConfig, with_ffn: bool, *, btype: str,
                 dtype, device):
        super().__init__()
        self.cfg = cfg
        self.local = btype == "local"
        d = cfg.d_model
        self.ln1 = L.norm_param(d, device)
        self.attn = L.Attention(cfg, dtype=dtype, device=device)
        if cfg.post_norm:
            self.ln1_post = L.norm_param(d, device)
        self.ffn = None
        if with_ffn:
            self.ln2 = L.norm_param(d, device)
            ffn = L.MoE if cfg.moe is not None else L.MLP
            self.ffn = ffn(cfg, dtype=dtype, device=device)
            if cfg.post_norm:
                self.ln2_post = L.norm_param(d, device)

    def forward(self, x: torch.Tensor, *, mode: str, cache=None, pos=None,
                cache_len: int | None = None, backend: str = "cuda"):
        """Returns (x, cache): the prompt's k/v in modes "train"/"prefill"
        (``cache_len`` slots long, where given), ``cache`` itself, written
        in place, in mode "decode"."""
        cfg, eps = self.cfg, self.cfg.norm_eps
        h = ops.rmsnorm(x, self.ln1, eps=eps, backend=backend)
        if mode == "decode":
            k, v, split = cache["k"], cache["v"], None
            if is_dtensor(k):  # this rank's slots of a cache split along S
                from ..parallel import sharding

                split = sharding.cache_split(k)
                k, v = k.to_local(), v.to_local()
            a = self.attn.decode(h, k, v, pos, local=self.local,
                                 k_scale=cache.get("k_s"),
                                 v_scale=cache.get("v_s"), split=split)
        else:
            a, k, v = self.attn.prefill(h, cache_len=cache_len,
                                        local=self.local, backend=backend)
            cache = {"k": k, "v": v}
        if cfg.post_norm:
            a = ops.rmsnorm(a, self.ln1_post, eps=eps, backend=backend)
        if self.ffn is None:
            return x + a, cache
        if cfg.parallel_block:
            f = self.ffn(ops.rmsnorm(x, self.ln2, eps=eps, backend=backend))
            return x + a + f, cache
        # x = x + a, then ln2 of it: one fused K9 launch
        h, x = ops.rmsnorm_residual(a, x, self.ln2, eps=eps,
                                    backend=backend)
        f = self.ffn(h)
        if cfg.post_norm:
            f = ops.rmsnorm(f, self.ln2_post, eps=eps, backend=backend)
        return x + f, cache


class MambaBlock(nn.Module):
    """One ``mamba2`` block: pre-norm Mamba-2 mixer and the residual add (no
    MLP: Zamba2's lives in the shared block)."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = L.norm_param(cfg.d_model, device)
        self.mamba = SSM.Mamba2(cfg, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, *, mode: str, cache=None, pos=None,
                cache_len: int | None = None, backend: str = "cuda"):
        """Returns (x, cache): the prompt's conv tail and final state in
        mode "prefill", None in mode "train", ``cache`` itself, updated in
        place, in mode "decode".  ``cache_len`` is the attention blocks'
        and has no effect here."""
        h = ops.rmsnorm(x, self.ln1, eps=self.cfg.norm_eps, backend=backend)
        if mode == "decode":
            y, cache = self.mamba.decode(h, cache, backend=backend)
        elif mode == "prefill":
            y, cache = self.mamba(h, return_state=True, backend=backend)
        else:
            y = self.mamba(h, backend=backend)
        return x + y, cache


class XLSTMBlock(nn.Module):
    """One ``mlstm`` or ``slstm`` block: pre-norm xLSTM mixer
    (:class:`.xlstm.MLSTM`, :class:`.xlstm.SLSTM`, under the block type's
    name, as the reference's parameters are) and the residual add; no
    feed-forward."""

    def __init__(self, cfg: ArchConfig, *, btype: str, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.btype = btype
        self.ln1 = L.norm_param(cfg.d_model, device)
        mixer = XL.MLSTM if btype == "mlstm" else XL.SLSTM
        self.add_module(btype, mixer(cfg, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, *, mode: str, cache=None, pos=None,
                cache_len: int | None = None, backend: str = "cuda"):
        """Returns (x, cache): the prompt's final state in mode "prefill"
        (mLSTM's recomputed from its gates, the reference's
        ``_mlstm_state_from_seq``), None in mode "train", ``cache`` itself,
        updated in place, in mode "decode".  ``pos`` and ``cache_len`` are
        the attention blocks' and have no effect here."""
        h = ops.rmsnorm(x, self.ln1, eps=self.cfg.norm_eps, backend=backend)
        mixer = getattr(self, self.btype)
        if mode == "decode":
            y, cache = mixer.decode(h, cache)
        elif mode == "prefill":
            y, cache = mixer(h, return_state=True)
        else:
            y = mixer(h)
        return x + y, cache


def _block(cfg: ArchConfig, btype: str, *, dtype, device) -> nn.Module:
    if btype == "mamba2":
        return MambaBlock(cfg, dtype=dtype, device=device)
    if btype in ("mlstm", "slstm"):
        return XLSTMBlock(cfg, btype=btype, dtype=dtype, device=device)
    return Block(cfg, has_ffn(btype, cfg), btype=btype, dtype=dtype,
                 device=device)


class Transformer(nn.Module):
    """The reference's model for patterns of ``attn``, ``local``,
    ``mamba2``, ``shared_attn``, ``mlstm`` and ``slstm`` blocks: token
    embedding, ``n_layers``
    blocks (and the shared block, where the pattern has one), final norm,
    unembedding (tied or not).  Parameters are created uninitialised on
    ``device`` (the card when None), in ``dtype`` but for the float32 ones
    (:mod:`.layers`); fill them with :func:`..weights.init_params` or
    :func:`..weights.load_reference_params`."""

    def __init__(self, cfg: ArchConfig, *, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        d, v = cfg.d_model, cfg.vocab
        self.embed = L.empty_param((v, d), dtype, device)
        self.final_norm = L.norm_param(d, device)
        self.layers = nn.ModuleList(
            _block(cfg, btype, dtype=dtype, device=device)
            for _ in range(cfg.n_groups) for _, btype in mixer_slots(cfg))
        self.shared_attn = (Block(cfg, True, btype="shared_attn",
                                  dtype=dtype, device=device)
                            if "shared_attn" in cfg.pattern else None)
        if not cfg.tie_embeddings:
            self.unembed = L.empty_param((d, v), dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def stack(self) -> list[nn.Module]:
        """The blocks in the order they run, one per entry of the caches:
        group by group, in :func:`group_order`."""
        layers = iter(self.layers)
        order = group_order(self.cfg)
        return [self.shared_attn if b == "shared_attn" else next(layers)
                for _ in range(self.cfg.n_groups) for b in order]


def count_params(model: Transformer | ArchConfig) -> int:
    """Exact parameter count of a model, or of a config's model built on
    the meta device (the reference's ``count_params`` of its ``ParamDef``
    tree; the shared block counts once)."""
    if isinstance(model, ArchConfig):
        model = Transformer(model, device="meta")
    return sum(p.numel() for p in model.parameters())


def count_active_params(cfg: ArchConfig) -> int:
    """Parameters a token runs through, as the reference's
    ``count_active_params``: a mixture of experts' (n_experts - top_k)
    unchosen expert MLPs a layer left out."""
    total = count_params(cfg)
    if not cfg.moe:
        return total
    d, f = cfg.d_model, cfg.d_ff
    n_mats = 3 if cfg.act in ("swiglu", "geglu") else 2
    inactive = n_mats * d * f * (cfg.moe.n_experts - cfg.moe.top_k)
    return total - cfg.n_layers * inactive


def _embed(model, tokens: torch.Tensor, quantized: bool,
           prefix_embeds: torch.Tensor | None = None,
           dtype: torch.dtype | None = None) -> torch.Tensor:
    """The prompt's embeddings in ``dtype`` (the model's by default): the
    rows gathered from the table and then cast, as the reference's
    ``emb[tokens].astype(dtype)``; an int8 model's rows gathered before
    they are dequantized (the same bits as the reference's whole
    dequantized table)."""
    dtype = model.dtype if dtype is None else dtype
    x = (model.embed_rows(tokens.long()) if quantized
         else F.embedding(tokens.long(), model.embed)).to(dtype)
    if model.cfg.tie_embeddings:
        x = x * math.sqrt(model.cfg.d_model)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dtype), x], dim=1)
    return x


def _unembed(model, h: torch.Tensor, quantized: bool = False
             ) -> torch.Tensor:
    if quantized:
        w = model.unembed_weight()
    else:
        w = model.embed.T if model.cfg.tie_embeddings else model.unembed
    return L.softcap((h @ w.to(h.dtype)).float(), model.cfg.final_softcap)


def init_caches(cfg: ArchConfig, batch: int, seq_len: int, *,
                dtype=torch.bfloat16, device=None,
                quant_kv: bool = False) -> list[dict]:
    """Zeroed caches, one per block application in the order the blocks run
    (:meth:`Transformer.stack`; the reference stacks them over groups):
    ``{"k", "v"}`` of (batch, seq_len, n_kv_heads, d_head) in ``dtype`` for
    attention (a ``local`` block's ring min(window, seq_len) slots long, as
    the reference sizes it), :func:`.ssm.init_cache` (the conv tail in
    ``dtype``, the state in float32) for Mamba-2, :func:`.xlstm.init_cache`
    (float32) for mLSTM and sLSTM.  With ``quant_kv``, the reference's int8
    KV cache: k/v in int8 and per-head float32 scales ``{"k_s", "v_s"}`` of
    (batch, 1, n_kv_heads, 1), each 0.05."""
    check_supported(cfg)
    device = resolve_device(device)

    def cache(btype):
        if btype == "mamba2":
            return SSM.init_cache(cfg, batch, dtype=dtype, device=device)
        if btype in ("mlstm", "slstm"):
            return XL.init_cache(btype, cfg, batch, device=device)
        n = min(cfg.window or seq_len, seq_len) if btype == "local" \
            else seq_len
        shape = (batch, n, cfg.n_kv_heads, cfg.d_head)
        kv_dtype = torch.int8 if quant_kv else dtype
        out = {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
               "v": torch.zeros(shape, dtype=kv_dtype, device=device)}
        if quant_kv:
            for key in ("k_s", "v_s"):
                out[key] = torch.full((batch, 1, cfg.n_kv_heads, 1), 0.05,
                                      dtype=torch.float32, device=device)
        return out

    return [cache(b) for _ in range(cfg.n_groups) for b in group_order(cfg)]


def _check_quantized(model, quantized: bool) -> Transformer:
    """The model whose blocks run: the int8 model's meta skeleton (its
    ``skeleton``) with ``quantized``, else the model itself."""
    is_int8 = hasattr(model, "skeleton")
    if quantized and not is_int8:
        raise TypeError("quantized=True takes the int8 model of "
                        "repro_torch.serve.quantize_params")
    if is_int8 and not quantized:
        raise TypeError("an int8 model runs with quantized=True")
    return model.skeleton if quantized else model


def _run(block, x, seq, **kwargs):
    """A block on the whole stream: with ``seq`` (a ``StreamSplit``), x is
    this rank's part, gathered at the entry and split again at the exit."""
    if seq is None:
        return block(x, **kwargs)
    x, cache = block(seq.gather(x), **kwargs)
    return seq.scatter(x), cache


def _train_stack(net: Transformer, x: torch.Tensor, backend: str,
                 seq=None) -> torch.Tensor:
    """The blocks of a training forward, group by group (each group under
    ``torch.utils.checkpoint`` with ``remat`` "block" or "dots", the
    latter's policy :func:`.remat.dots_policy`, while autograd records): no
    caches are kept."""
    blocks = net.stack()
    n = len(group_order(net.cfg))
    remat = net.cfg.remat != "none" and torch.is_grad_enabled()
    ctx = R.context_fn(net.cfg.remat)
    kw = {} if ctx is None else {"context_fn": ctx}

    def group(x, g):
        for block in blocks[g * n:(g + 1) * n]:
            x, _ = _run(block, x, seq, mode="train", backend=backend)
        return x

    for g in range(net.cfg.n_groups):
        x = (checkpoint(group, x, g, use_reentrant=False, **kw) if remat
             else group(x, g))
    return x


def forward(model: Transformer, tokens: torch.Tensor, *,
            prefix_embeds: torch.Tensor | None = None, mode: str = "train",
            caches: list | None = None, pos: int | None = None,
            cache_len: int | None = None, backend: str = "cuda",
            quantized: bool = False, dtype: torch.dtype | None = None,
            seq_shard: bool = False):
    """Hidden states through the full stack: returns (h, caches).  Modes
    ``"train"`` (no caches; each group under checkpoint where the config's
    ``remat`` is ``"block"`` or ``"dots"``), ``"prefill"`` (the prompt's
    caches, one per block application; the KV caches ``cache_len`` slots
    long where given)
    and ``"decode"`` (one token at ``pos`` against ``caches``, written in
    place).  ``dtype`` is the compute dtype (the model's by default: a
    float32 model trains in bf16 with ``dtype=torch.bfloat16``).  With
    ``quantized``, ``model`` is the int8 model of
    :func:`repro_torch.serve.quantize_params` and each block runs on its
    weights dequantized just before it.  ``seq_shard``: the residual
    stream split along the sequence over "model" between blocks (modes
    "train" and "prefill"; see the module's doc); h is whole."""
    net = _check_quantized(model, quantized)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "decode" and (caches is None or pos is None):
        raise ValueError("decode takes caches and pos")
    x = _embed(model, tokens, quantized, prefix_embeds, dtype)
    seq = None
    if seq_shard and mode != "decode":
        from ..parallel import sharding

        seq = sharding.stream_split(
            model.mesh if quantized else sharding.model_mesh(model),
            x.shape[1])
        if seq is not None:
            x = seq.scatter(x)
    if mode == "train" and not quantized:
        x = _train_stack(net, x, backend, seq)
        if seq is not None:
            x = seq.gather(x)
        return ops.rmsnorm(x, model.final_norm, eps=model.cfg.norm_eps,
                           backend=backend), None
    # a local block's ring keeps the last positions: only the global caches
    # must hold the whole prompt
    if cache_len is not None and cache_len < x.shape[1] and any(
            b in ("attn", "shared_attn") for b in model.cfg.pattern):
        raise ValueError(f"cache_len {cache_len} < prompt length "
                         f"{x.shape[1]}")
    shared = (model.block_weights(net.shared_attn)
              if quantized and net.shared_attn is not None else None)
    # an int8 model on a mesh routes MoE rows as Gathered's blocks do
    token = L.TOKEN_SPLIT.set(getattr(model, "split", None))
    new_caches = []
    try:
        for i, block in enumerate(net.stack()):
            kwargs = dict(mode=mode, pos=pos, cache_len=cache_len,
                          backend=backend,
                          cache=caches[i] if mode == "decode" else None)
            if quantized:
                weights = (shared if block is net.shared_attn
                           else model.block_weights(block))
                x, cache = _run(
                    lambda x, **kw: functional_call(block, weights, (x,), kw),
                    x, seq, **kwargs)
                del weights
            else:
                x, cache = _run(block, x, seq, **kwargs)
            new_caches.append(cache)
    finally:
        L.TOKEN_SPLIT.reset(token)
    if seq is not None:
        x = seq.gather(x)
    x = ops.rmsnorm(x, model.final_norm, eps=model.cfg.norm_eps,
                    backend=backend)
    return x, (None if mode == "train" else new_caches)


def loss_fn(model: Transformer, tokens: torch.Tensor, labels: torch.Tensor,
            *, prefix_embeds: torch.Tensor | None = None,
            vocab_chunk: int = 256, dtype: torch.dtype = torch.bfloat16,
            backend: str = "cuda", seq_shard: bool = False) -> torch.Tensor:
    """The causal LM loss, as the reference's ``loss_fn``: the hidden
    states of :func:`forward` in mode ``"train"`` computing in ``dtype``,
    the prefix's positions trimmed, then the sequence in chunks of c
    positions (the largest divisor of S at most ``vocab_chunk``), each
    chunk's float32 logits (after ``final_softcap``) formed under
    ``torch.utils.checkpoint`` while autograd records, so the (B, S, vocab)
    logits never exist at once; ``logsumexp - gold`` summed over the
    tokens, in chunk order, and divided by B S.  A float32 scalar.
    ``seq_shard``: :func:`forward`'s."""
    h, _ = forward(model, tokens, prefix_embeds=prefix_embeds, mode="train",
                   backend=backend, dtype=dtype, seq_shard=seq_shard)
    npre = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    h = h[:, npre:]
    B, S, _ = h.shape
    c = min(vocab_chunk, S)
    while S % c:  # largest divisor <= vocab_chunk (prefix-trimmed lengths)
        c -= 1
    labels = labels.long()

    def chunk(hc, lc):
        logits = _unembed(model, hc)                       # (B, c, V) f32
        gold = torch.gather(logits, -1, lc[..., None])[..., 0]
        return (torch.logsumexp(logits, dim=-1) - gold).sum()

    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for hc, lc in zip(h.split(c, dim=1), labels.split(c, dim=1)):
        total = total + (checkpoint(chunk, hc, lc, use_reentrant=False)
                         if remat else chunk(hc, lc))
    return total / (B * S)


def _served(model, quantized: bool, rows_split: bool = True):
    """The model a serving call runs: a model laid out on a mesh
    (``parallel.sharding.shard_model``) seen through
    ``parallel.sharding.Gathered``, as training runs it (each block's
    weights gathered whole at each call, the embedding, final norm and
    unembedding once a call, MoE routing over the rows of every data
    rank, or over this rank's where ``rows_split`` is false), an int8
    model on a mesh with the same routing (its weights gathered at use by
    ``serve.quantize``), else the model itself."""
    if quantized and hasattr(model, "on_rows"):
        return model.on_rows(rows_split)
    if not is_dtensor(getattr(model, "embed", None)):
        return model
    from ..parallel import sharding

    return sharding.Gathered(model,
                             sharding.dp_axes(sharding.model_mesh(model)),
                             rows_split=rows_split)


def prefill(model: Transformer, tokens: torch.Tensor, *,
            prefix_embeds: torch.Tensor | None = None,
            cache_len: int | None = None, backend: str = "cuda",
            quantized: bool = False, seq_shard: bool = False):
    """Prefill: last-position logits (B, 1, vocab) in float32 and the caches
    for decode.  The KV caches hold the prompt's S positions; with
    ``cache_len`` (>= S) they are allocated that long, zero past the prompt,
    so that decode can write past it (the reference's caller grows them);
    each attention block writes its prompt's k/v into them once.  A
    ``local`` block's ring is min(window, cache_len or S) slots long and
    holds the last of the prompt's positions.  The Mamba-2 caches
    (``conv``, ``ssm``) and the xLSTM states pass through.

    A model laid out on a mesh serves this rank's rows: ``tokens`` are its
    rows of the batch (split over the data-parallel axes as
    ``data.pipeline.shard_batch`` splits them), and the logits and caches
    are theirs.  Every rank of the "model" axis computes whole heads, so
    the caches are replicated over it (the reference shards the KV heads
    over "model").  Every rank of the mesh calls it together.
    ``seq_shard``: :func:`forward`'s; the caches are whole.  For decode
    against caches split along the sequence, every rank prefills the
    same rows and ``parallel.sharding.split_caches`` splits the caches."""
    model = _served(model, quantized)
    h, caches = forward(model, tokens, prefix_embeds=prefix_embeds,
                        mode="prefill", cache_len=cache_len, backend=backend,
                        quantized=quantized, seq_shard=seq_shard)
    return _unembed(model, h[:, -1:], quantized), caches


def decode_step(model: Transformer, token: torch.Tensor, caches: list,
                pos: int, *, backend: str = "cuda",
                quantized: bool = False):
    """One decode step: token (B, 1) against the caches at position
    ``pos``.  Returns (logits (B, 1, vocab) float32, caches); the caches are
    updated in place.  On a mesh, this rank's rows and caches
    (:func:`prefill`), or, where the KV caches are split along the sequence
    (``parallel.sharding.split_caches``: ``DTensor`` k/v), the same rows on
    every rank against this rank's slots (``layers.Attention.decode``)."""
    model = _served(model, quantized, rows_split=not any(
        is_dtensor(c.get("k")) for c in caches))
    h, caches = forward(model, token, mode="decode", caches=caches, pos=pos,
                        backend=backend, quantized=quantized)
    return _unembed(model, h, quantized), caches
