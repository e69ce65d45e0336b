"""The LM harness of the port: architecture configs, layers, the model
assembly with its serving entry points, and weights.  Ported from the
reference's ``repro/models`` for blocks of type ``attn``, ``mamba2`` and
``shared_attn``."""

from .config import SHAPES, ArchConfig, MoEConfig, ShapeSpec, SSMConfig
from .ssm import Mamba2
from .transformer import (Block, MambaBlock, Transformer, count_params,
                          decode_step, forward, init_caches, prefill)
from .weights import init_params, load_reference_params

__all__ = [
    "ArchConfig", "MoEConfig", "SSMConfig", "ShapeSpec", "SHAPES", "Block",
    "MambaBlock", "Mamba2", "Transformer", "count_params", "decode_step",
    "forward", "init_caches", "prefill", "init_params",
    "load_reference_params",
]
