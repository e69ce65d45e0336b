"""Architecture configuration schema for the assigned model fleet.

The port's own copy of the reference's ``repro/models/config.py``, data only
(no torch): the same fields, defaults and parameter counts."""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    shared_expert: bool = False
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128
    d_conv: int = 4

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int                      # total mixer layers (pattern repeats)
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # repeating block pattern; len(pattern) * n_groups == n_layers
    # (shared_attn entries do not count toward n_layers — they reuse weights)
    pattern: tuple[str, ...] = ("attn",)
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    window: int = 0                    # sliding window for "local" blocks
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 10000.0
    act: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    norm_eps: float = 1e-5
    parallel_block: bool = False       # command-r style attn ∥ ffn
    post_norm: bool = False            # gemma2 sandwich norms
    tie_embeddings: bool = False
    qkv_bias: bool = False
    frontend: Literal["none", "audio_stub", "vision_stub"] = "none"
    n_prefix_embeds: int = 0           # stub frontend tokens (vlm patches …)
    optimizer: Literal["adamw", "adafactor"] = "adamw"
    # "dots": the reference's hillclimb sets it (dataclasses.replace)
    remat: Literal["none", "block", "dots"] = "block"
    # which shapes support serve_step at 500k ("sub-quadratic" per brief)
    long_context_ok: bool = False

    @property
    def n_groups(self) -> int:
        mixers = [b for b in self.pattern if b != "shared_attn"]
        assert self.n_layers % len(mixers) == 0, (self.name, self.pattern)
        return self.n_layers // len(mixers)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    def n_params(self) -> int:
        """Approximate parameter count (dense-equivalent accounting)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        per_attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        n_ff_mats = 3 if self.act in ("swiglu", "geglu") else 2
        per_ffn = n_ff_mats * d * f
        if self.moe:
            per_ffn *= self.moe.n_experts
            per_ffn += d * self.moe.n_experts  # router
            if self.moe.shared_expert:
                per_ffn += n_ff_mats * d * f
        total = 0
        mixers = [b for b in self.pattern if b != "shared_attn"]
        for b in mixers:
            if b in ("attn", "local"):
                total += per_attn + per_ffn + 2 * d
            elif b == "mamba2":
                di = self.ssm.d_inner(d)
                total += d * 2 * di + di * d + di * (2 * self.ssm.d_state) \
                    + per_ffn + 2 * d
            elif b in ("mlstm", "slstm"):
                di = 2 * d
                total += d * 3 * di + di * d + 2 * d
        total *= self.n_groups
        if "shared_attn" in self.pattern:
            total += per_attn + 3 * d * self.d_ff + 2 * d  # one shared block
        total += v * d * (1 if self.tie_embeddings else 2)
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE top-k accounting) for MODEL_FLOPS."""
        if not self.moe:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        n_ff_mats = 3 if self.act in ("swiglu", "geglu") else 2
        dense_ffn = n_ff_mats * d * f
        per_layer_saving = dense_ffn * (self.moe.n_experts - self.moe.top_k)
        return self.n_params() - self.n_layers * per_layer_saving


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}
