"""Grok-1 314B: MoE 8 experts top-2, GQA 48/8, attention softcap
[hf:xai-org/grok-1; unverified].  Adafactor (factored second moment) keeps
optimizer state within HBM at 256 chips."""
import dataclasses
from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_head=128, d_ff=32768, vocab=131072, pattern=("attn",),
    moe=MoEConfig(n_experts=8, top_k=2), act="gelu", attn_softcap=30.0,
    optimizer="adafactor",
)

SMOKE = dataclasses.replace(
    CONFIG, name="grok-1-314b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
    moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=8.0))
