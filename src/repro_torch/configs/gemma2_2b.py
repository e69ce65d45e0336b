"""Gemma-2 2B: local+global alternating attention, logit softcapping,
sandwich norms [arXiv:2408.00118; hf]."""
import dataclasses
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b", n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
    d_head=256, d_ff=9216, vocab=256000, pattern=("local", "attn"),
    window=4096, attn_softcap=50.0, final_softcap=30.0, act="geglu",
    post_norm=True, tie_embeddings=True,
    # local layers bound decode KV at the window → 500k decode is feasible
    long_context_ok=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma2-2b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=256, window=32)
