"""Zamba2-7B: Mamba2 backbone + shared attention block
[arXiv:2411.15242; unverified].  81 Mamba2 layers; a single weight-shared
attention+MLP block is applied every 3 mamba layers (27 applications)."""
import dataclasses
from ..models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b", n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_head=112, d_ff=14336, vocab=32000,
    pattern=("shared_attn", "mamba2", "mamba2", "mamba2"),
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=128),
    act="gelu", long_context_ok=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="zamba2-7b-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=128, vocab=256,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=16))
