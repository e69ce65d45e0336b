"""The LM harness of the port: architecture configs, layers, the model
assembly with its serving and training entry points, and weights.  Ported from the
reference's ``repro/models`` for every block type it has: ``attn``,
``local``, ``shared_attn``, ``mamba2``, ``mlstm`` and ``slstm``."""

from .config import SHAPES, ArchConfig, MoEConfig, ShapeSpec, SSMConfig
from .ssm import Mamba2
from .transformer import (Block, MambaBlock, Transformer, XLSTMBlock,
                          count_active_params, count_params, decode_step,
                          forward, init_caches, loss_fn, prefill)
from .xlstm import MLSTM, SLSTM
from .weights import (init_params, load_reference_params,
                      load_reference_state, param_tree, reference_tree)

__all__ = [
    "ArchConfig", "MoEConfig", "SSMConfig", "ShapeSpec", "SHAPES", "Block",
    "MambaBlock", "Mamba2", "MLSTM", "SLSTM", "Transformer", "XLSTMBlock",
    "count_active_params", "count_params", "decode_step", "forward",
    "init_caches", "loss_fn", "prefill", "init_params",
    "load_reference_params", "load_reference_state", "param_tree",
    "reference_tree",
]
