"""Phi-3-vision 4.2B: phi3-mini backbone + CLIP frontend
[hf:microsoft/Phi-3-vision-128k-instruct; hf].  The CLIP tower is a STUB:
input_specs() provides precomputed patch embeddings as a prefix."""
import dataclasses
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", n_layers=32, d_model=3072, n_heads=32,
    n_kv_heads=32, d_head=96, d_ff=8192, vocab=32064, pattern=("attn",),
    act="swiglu", frontend="vision_stub", n_prefix_embeds=256,
)

SMOKE = dataclasses.replace(
    CONFIG, name="phi-3-vision-4.2b-smoke", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_head=16, d_ff=128, vocab=256,
    n_prefix_embeds=8)
