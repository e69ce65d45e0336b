"""Llama-4 Scout 17B-active/16E: MoE top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  The vision early-fusion
frontend is a STUB (text tokens only in input_specs)."""
import dataclasses
from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, d_head=128, d_ff=8192, vocab=202048, pattern=("attn",),
    moe=MoEConfig(n_experts=16, top_k=1, shared_expert=True), act="swiglu",
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama4-scout-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
    moe=MoEConfig(n_experts=4, top_k=1, shared_expert=True,
                  capacity_factor=8.0))
