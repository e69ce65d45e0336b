"""DeepSeek-Coder-33B: llama-arch dense [arXiv:2401.14196; hf]."""
import dataclasses
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b", n_layers=62, d_model=7168, n_heads=56,
    n_kv_heads=8, d_head=128, d_ff=19200, vocab=32256, pattern=("attn",),
    act="swiglu", rope_theta=100000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="deepseek-coder-33b-smoke", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=256)
