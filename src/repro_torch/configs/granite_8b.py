"""IBM Granite-8B-Code: llama-arch dense [arXiv:2405.04324; hf]."""
import dataclasses
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_head=128, d_ff=14336, vocab=49152, pattern=("attn",), act="swiglu",
    rope_theta=10000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="granite-8b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=256)
