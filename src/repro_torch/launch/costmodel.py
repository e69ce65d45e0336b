"""Analytic per-cell cost model, as the reference's ``launch/costmodel.py``.

It prices the reference's algorithm term by term, so its numbers equal the
reference's; the roofline (:mod:`.roofline`) reads them.  All values are
GLOBAL per step; divide by the cards for per-card terms.

FLOP conventions: multiply-add = 2 FLOPs; backward = 2x forward;
full-forward remat adds +1 forward.

Where the port does other work than the priced algorithm, the formula
stays the reference's:
  * a mixture of experts fills its capacity slots by a gather and sums
    them back by ``index_add_`` (``models.layers.MoE``), where the
    reference multiplies one-hot dispatch and combine tensors: the
    dispatch einsums' 2 x 2 E C D FLOPs a chunk priced in
    :func:`_ffn_flops_per_token` are not executed by the port;
  * the port's loss recomputes each chunk's logits under checkpoint
    (``models.transformer.loss_fn``), one more unembedding forward than
    the head priced here (the reference does not remat its head).
"""

from __future__ import annotations

import dataclasses

from ..models.config import ArchConfig, ShapeSpec
from ..models.transformer import count_active_params, count_params

# per-chunk constants matching the model code
Q_CHUNK = 512
MOE_TOKEN_CHUNK = 8192


def _n_nonembed(arch: ArchConfig) -> float:
    """Active params excluding embedding/unembedding tables — the LM head
    is accounted separately because prefill/decode compute it at one
    position only."""
    n = count_active_params(arch)
    n -= arch.vocab * arch.d_model * (1 if arch.tie_embeddings else 2)
    return n


@dataclasses.dataclass(frozen=True)
class CellCost:
    flops: float               # executed FLOPs (incl. remat, dispatch, attn)
    model_flops: float         # 6·N_active·tokens (train) / 2·N_active·tokens
    hbm_bytes: float           # HBM traffic
    coll_bytes: float          # inter-card bytes (all reduced collectives)
    components: dict


def _layer_linear_flops_per_token(arch: ArchConfig) -> float:
    """Matmul FLOPs per token per *average* mixer layer (forward)."""
    d = arch.d_model
    per = 0.0
    mixers = [b for b in arch.pattern if b != "shared_attn"]
    for b in mixers:
        if b in ("attn", "local"):
            per += 2 * d * (arch.q_dim + 2 * arch.kv_dim) + 2 * arch.q_dim * d
            per += _ffn_flops_per_token(arch)
        elif b == "mamba2":
            ssm = arch.ssm
            di = ssm.d_inner(d)
            per += 2 * d * (2 * di + 2 * ssm.d_state + ssm.n_heads(d)) \
                + 2 * di * d
        elif b == "mlstm":
            di = arch.n_heads * arch.d_head
            per += 2 * d * (3 * di + 2 * arch.n_heads) + 2 * di * d \
                + 2 * d * di  # ogate
        elif b == "slstm":
            per += 2 * d * 4 * d + 2 * d * d \
                + 2 * 4 * d * arch.d_head  # recurrent R per head
    per /= len(mixers)
    return per


def _ffn_flops_per_token(arch: ArchConfig) -> float:
    d, f = arch.d_model, arch.d_ff
    n_mats = 3 if arch.act in ("swiglu", "geglu") else 2
    if arch.moe is None:
        return 2 * n_mats * d * f
    mc = arch.moe
    flops = 2 * n_mats * d * f * mc.top_k            # expert matmuls (top-k)
    flops += 2 * d * mc.n_experts                    # router
    # GShard dispatch/combine einsums: 2·E·C·D each, C = tc·k/E·cf per chunk
    # (priced as the reference runs them; the port gathers instead)
    C_over_tc = mc.top_k / mc.n_experts * mc.capacity_factor
    flops += 2 * 2 * mc.n_experts * C_over_tc * MOE_TOKEN_CHUNK * d \
        / MOE_TOKEN_CHUNK  # per token: 2 einsums × E·(C/tc)·D
    if mc.shared_expert:
        flops += 2 * n_mats * d * f
    return flops


def _attn_quadratic_flops(arch: ArchConfig, B: int, S: int) -> float:
    """Causal QKᵀ + PV FLOPs (forward), summed over attention layers."""
    total = 0.0
    n_groups = arch.n_groups
    blocks = list(arch.pattern)
    for b in blocks:
        if b in ("attn", "shared_attn"):
            eff = S / 2                       # causal average context
        elif b == "local":
            w = arch.window or S
            eff = min(w, S / 2)
        else:
            continue
        total += n_groups * 2 * 2 * B * S * eff * arch.n_heads * arch.d_head
    # ssm/mlstm intra-chunk quadratic ~ L·chunk terms (small): add mamba2
    for b in blocks:
        if b == "mamba2":
            L = arch.ssm.chunk
            H = arch.ssm.n_heads(arch.d_model)
            P = arch.ssm.head_dim
            N = arch.ssm.d_state
            # per chunk: CBᵀ (L²N) + att·x (L²·H·P) + states (L·H·N·P)
            per_tok = 2 * L * N + 2 * L * H * P / 1 + 2 * H * N * P
            total += n_groups * B * S * per_tok
        if b == "mlstm":
            L = 128
            H, dh = arch.n_heads, arch.d_head
            per_tok = 2 * L * H * dh * 2 + 2 * H * dh * dh * 2 / L
            total += n_groups * B * S * per_tok
    return total


def _vocab_flops(arch: ArchConfig, B: int, S: int) -> float:
    return 2 * B * S * arch.d_model * arch.vocab


def _shared_linear_flops(arch: ArchConfig, T: int) -> float:
    """The shared block's matmuls at each group's application."""
    if "shared_attn" not in arch.pattern:
        return 0.0
    d = arch.d_model
    per = 2 * d * (arch.q_dim + 2 * arch.kv_dim) + 2 * arch.q_dim * d \
        + _ffn_flops_per_token(arch)
    return per * arch.n_groups * T


def train_cost(arch: ArchConfig, shape: ShapeSpec, n_chips: int,
               grad_accum: int) -> CellCost:
    B, S = shape.global_batch, shape.seq_len
    T = B * S
    lin_f = _layer_linear_flops_per_token(arch) * arch.n_layers * T
    lin_f += _shared_linear_flops(arch, T)
    attn_f = _attn_quadratic_flops(arch, B, S)
    head_f = _vocab_flops(arch, B, S) + 2 * T * arch.d_model  # embed gather
    fwd = lin_f + attn_f + head_f
    # bwd 2×, remat +1× fwd of the block stack (head is not rematted)
    flops = fwd + 2 * fwd + (lin_f + attn_f)
    model_flops = 6.0 * (_n_nonembed(arch)
                         + arch.d_model * arch.vocab) * T

    # HBM bytes (global): weights fetched per microbatch (bf16 compute via
    # the FSDP gather lands in HBM once per microbatch), grads f32 RW,
    # optimizer f32 states, per-group activation residuals, attention KV.
    P = count_params(arch)
    act_res = grad_accum * arch.n_groups * (T // grad_accum) * arch.d_model * 2
    kv_bytes = arch.n_layers * T * 2 * arch.kv_dim * 2
    opt_mult = 12 if arch.optimizer == "adamw" else 5
    hbm = (grad_accum * P * 2              # weight reads per microbatch
           + 2 * P * 4 * 2                 # grad accum read+write (fwd+bwd)
           + P * opt_mult                  # optimizer update traffic
           + 4 * act_res                   # save + read (fwd, bwd)
           + 3 * kv_bytes                  # attention KV write + bwd reread
           + 6 * T * arch.d_model * 2)     # residual stream traffic / layer≈

    # Collectives (global bytes):
    #  FSDP all-gather of bf16 weights per microbatch + grad reduce-scatter
    #  (f32) + TP all-reduces of activations (2 per layer fwd, 2 bwd, 1 remat)
    tp_ar = 5 * arch.n_layers * T * arch.d_model * 2
    coll = grad_accum * P * 2 + P * 4 + tp_ar
    comp = {"linear_flops": lin_f, "attn_flops": attn_f, "head_flops": head_f,
            "weights_hbm": grad_accum * P * 2, "opt_hbm": P * opt_mult,
            "act_res_hbm": 4 * act_res, "fsdp_ag": grad_accum * P * 2,
            "grad_rs": P * 4, "tp_allreduce": tp_ar}
    return CellCost(flops, model_flops, hbm, coll, comp)


def prefill_cost(arch: ArchConfig, shape: ShapeSpec, n_chips: int) -> CellCost:
    B, S = shape.global_batch, shape.seq_len
    T = B * S
    lin_f = _layer_linear_flops_per_token(arch) * arch.n_layers * T
    lin_f += _shared_linear_flops(arch, T)
    attn_f = _attn_quadratic_flops(arch, B, S)
    head_f = 2 * B * arch.d_model * arch.vocab      # last position only
    flops = lin_f + attn_f + head_f
    model_flops = 2.0 * _n_nonembed(arch) * T \
        + 2.0 * B * arch.d_model * arch.vocab
    P = count_params(arch)
    kv_bytes = arch.n_layers * T * 2 * arch.kv_dim * 2
    hbm = P * 2 + 2 * kv_bytes + 8 * T * arch.d_model * 2
    tp_ar = 2 * arch.n_layers * T * arch.d_model * 2
    coll = P * 2 + tp_ar                            # fsdp ag once + tp
    return CellCost(flops, model_flops, hbm, coll,
                    {"linear": lin_f, "attn": attn_f, "kv_hbm": kv_bytes})


def decode_cost(arch: ArchConfig, shape: ShapeSpec, n_chips: int) -> CellCost:
    B, S = shape.global_batch, shape.seq_len
    lin_f = _layer_linear_flops_per_token(arch) * arch.n_layers * B
    attn_read = 0.0
    for b in arch.pattern:
        if b in ("attn", "shared_attn"):
            attn_read += arch.n_groups * B * S * 2 * arch.kv_dim
        elif b == "local":
            attn_read += arch.n_groups * B * min(arch.window or S, S) \
                * 2 * arch.kv_dim
        elif b == "mamba2":
            ssm = arch.ssm
            attn_read += arch.n_groups * B * ssm.n_heads(arch.d_model) \
                * ssm.d_state * ssm.head_dim * 4 * 2  # f32 state RW
        elif b == "mlstm":
            attn_read += arch.n_groups * B * arch.n_heads * arch.d_head \
                * arch.d_head * 4 * 2
        elif b == "slstm":
            attn_read += arch.n_groups * B * arch.d_model * 4 * 4 * 2
    attn_f = 0.0
    for b in arch.pattern:
        if b in ("attn", "shared_attn"):
            attn_f += arch.n_groups * 2 * 2 * B * S * arch.n_heads * arch.d_head
        elif b == "local":
            attn_f += arch.n_groups * 2 * 2 * B * min(arch.window or S, S) \
                * arch.n_heads * arch.d_head
        elif b in ("mamba2",):
            ssm = arch.ssm
            attn_f += arch.n_groups * 2 * B * ssm.n_heads(arch.d_model) \
                * ssm.d_state * ssm.head_dim * 2
        elif b == "mlstm":
            attn_f += arch.n_groups * 2 * B * arch.n_heads \
                * arch.d_head * arch.d_head * 2
    head_f = 2 * B * arch.d_model * arch.vocab
    flops = lin_f + attn_f + head_f
    model_flops = 2.0 * _n_nonembed(arch) * B \
        + 2.0 * B * arch.d_model * arch.vocab
    P = count_params(arch)
    hbm = P * 2 + attn_read + 4 * B * arch.d_model * arch.n_layers * 2
    # decode TP: per-layer psum of (B,1,D) activations ×2 + distributed
    # softmax partials (tiny); weights resident (no FSDP gather in serving)
    coll = 2 * arch.n_layers * B * arch.d_model * 2
    return CellCost(flops, model_flops, hbm, coll,
                    {"linear": lin_f, "attn": attn_f, "cache_hbm": attn_read})


def cell_cost(arch: ArchConfig, shape: ShapeSpec, n_chips: int,
              grad_accum: int = 8) -> CellCost:
    if shape.kind == "train":
        return train_cost(arch, shape, n_chips, grad_accum)
    if shape.kind == "prefill":
        return prefill_cost(arch, shape, n_chips)
    return decode_cost(arch, shape, n_chips)
