"""Hardware descriptors — the single source of machine-specific constants.

No layer above this module hard-codes a shared-memory size, a warp width or
a bandwidth number: schedule defaults (`stencil/schedule.py`) consume a
:class:`Hardware` descriptor.  Descriptors are registered by name, so
:func:`resolve_hardware` accepts either a ``Hardware`` instance or a string
(``"h100"``).
"""

from __future__ import annotations

import dataclasses

MiB = 1024 * 1024
KiB = 1024


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Per-core (TPU) / per-SM (GPU) machine model used by the toolchain.

    ``vmem_bytes`` is the fast on-chip working-set budget a single kernel
    block may occupy: VMEM on TPU, shared memory on GPU.  ``lane`` /
    ``sublane`` are the vector-register tiling constraints: (128, 8) for f32
    on TPU; a GPU "lane" is the warp width with no sublane constraint.
    """

    name: str
    peak_flops: float      # FLOP/s
    hbm_bw: float          # B/s
    link_bw: float         # B/s per interconnect link (0 if n/a)
    vmem_bytes: int = 16 * MiB
    kind: str = "tpu"      # "tpu" | "gpu" | "cpu"
    lane: int = 128        # unit-stride vector width a tile must align to
    sublane: int = 8       # second-minor tile multiple (1 = unconstrained)


_REGISTRY: dict[str, Hardware] = {}


def register_hardware(hw: Hardware, *, overwrite: bool = False) -> Hardware:
    if hw.name in _REGISTRY and not overwrite:
        raise ValueError(f"hardware {hw.name!r} already registered")
    _REGISTRY[hw.name] = hw
    return hw


def get_hardware(name: str) -> Hardware:
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown hardware {name!r}; registered: {known}") from None


def available_hardware() -> list[str]:
    return sorted(_REGISTRY)


def resolve_hardware(hw: Hardware | str | None,
                     default: "Hardware | str | None" = None) -> Hardware:
    """Accept a descriptor, a registered name, or None (→ ``default``)."""
    if hw is None:
        hw = default if default is not None else H100
    if isinstance(hw, str):
        return get_hardware(hw)
    return hw


# -- presets ----------------------------------------------------------------

TPU_V5E = register_hardware(Hardware(
    "tpu-v5e", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9,
    vmem_bytes=16 * MiB, kind="tpu", lane=128, sublane=8))

TPU_V4 = register_hardware(Hardware(
    "tpu-v4", peak_flops=275e12, hbm_bw=1228e9, link_bw=50e9,
    vmem_bytes=16 * MiB, kind="tpu", lane=128, sublane=8))

# paper §VIII-A: Piz Daint's P100 nodes (the paper's measurement platform)
P100 = register_hardware(Hardware(
    "p100", peak_flops=4.7e12, hbm_bw=501.1e9, link_bw=0,
    vmem_bytes=48 * KiB, kind="gpu", lane=32, sublane=1))

V100 = register_hardware(Hardware(
    "v100", peak_flops=7.8e12, hbm_bw=900e9, link_bw=25e9,
    vmem_bytes=96 * KiB, kind="gpu", lane=32, sublane=1))

# H100 SXM data sheet: the stencils are f32 on CUDA cores (no tensor
# cores), so the peak is the 67 TFLOP/s f32 rate; shared memory is what one
# block may use (227 KB of the SM's 256 KB); NVLink 450 GB/s each way
H100 = register_hardware(Hardware(
    "h100", peak_flops=67e12, hbm_bw=3.35e12, link_bw=450e9,
    vmem_bytes=232448, kind="gpu", lane=32, sublane=1))
