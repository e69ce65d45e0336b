"""MusicGen-medium: decoder-only over EnCodec tokens [arXiv:2306.05284; hf].
The EnCodec/conditioning frontend is a STUB: input_specs() provides
precomputed frame embeddings as a prefix (per the assignment brief)."""
import dataclasses
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", n_layers=48, d_model=1536, n_heads=24,
    n_kv_heads=24, d_head=64, d_ff=6144, vocab=2048, pattern=("attn",),
    act="gelu", frontend="audio_stub", n_prefix_embeds=64,
)

SMOKE = dataclasses.replace(
    CONFIG, name="musicgen-medium-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=128, vocab=128, n_prefix_embeds=4)
