"""Command R+ 104B: GQA, no-bias, parallel attn∥ffn blocks
[hf:CohereForAI/c4ai-command-r-v01 family; unverified]."""
import dataclasses
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b", n_layers=64, d_model=12288, n_heads=96,
    n_kv_heads=8, d_head=128, d_ff=33792, vocab=256000, pattern=("attn",),
    act="swiglu", parallel_block=True, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="command-r-plus-104b-smoke", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=256)
