"""Assigned-architecture registry: one module per architecture, exact public
configs, selectable via ``--arch <id>`` everywhere (smoke tests, dry-run,
roofline, train/serve drivers).

The port's own copy of the reference's ``repro/configs/``: the same ten
architectures as data, with their smoke-test reductions."""

from __future__ import annotations

import importlib

from ..models.config import ArchConfig

ARCH_IDS = (
    "granite_8b",
    "gemma2_2b",
    "deepseek_coder_33b",
    "command_r_plus_104b",
    "musicgen_medium",
    "zamba2_7b",
    "xlstm_1p3b",
    "phi3_vision_4p2b",
    "grok1_314b",
    "llama4_scout_17b_a16e",
)

_ALIASES = {
    "granite-8b": "granite_8b",
    "gemma2-2b": "gemma2_2b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "command-r-plus-104b": "command_r_plus_104b",
    "musicgen-medium": "musicgen_medium",
    "zamba2-7b": "zamba2_7b",
    "xlstm-1.3b": "xlstm_1p3b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "grok-1-314b": "grok1_314b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
}


def get_config(arch: str) -> ArchConfig:
    arch = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def smoke_config(arch: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    mod = importlib.import_module(
        f"repro_torch.configs.{_ALIASES.get(arch, arch).replace('-', '_').replace('.', 'p')}")
    return mod.SMOKE


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
