"""xLSTM-1.3B: mLSTM/sLSTM blocks at ratio 7:1 [arXiv:2405.04517;
unverified].  d_ff=0: the blocks are projection-internal (no separate FFN)."""
import dataclasses
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_head=512, d_ff=0, vocab=50304,
    pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm",
             "slstm"),
    act="gelu", long_context_ok=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="xlstm-1.3b-smoke", n_layers=2, d_model=64, n_heads=2,
    n_kv_heads=2, d_head=32, d_ff=0, vocab=256,
    pattern=("mlstm", "slstm"))
