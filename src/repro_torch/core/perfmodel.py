"""Model-driven performance engineering (paper §VI-C, Fig. 10).

The paper's "17-line script": compute each kernel's peak performance *if it
were memory-bandwidth bound*, counting every element of every accessed field
exactly once (deliberately ignoring caches), then rank kernels by aggregate
runtime and report utilization vs the bound.

Hardware descriptors live in :mod:`repro_torch.core.hardware` (the H100 is
the port's default target; the TPU and the paper's P100 presets stay for
parity with the reference package); every
bound below takes the descriptor — or a registered hardware name — so the
same model prices a program for any registered part.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from .graph import Node, StencilProgram
from .hardware import Hardware, resolve_hardware

BYTES = {"float32": 4, "float64": 8, "bfloat16": 2, "float16": 2}


def _dtype_bytes(dtype) -> int:
    return BYTES.get(str(getattr(dtype, "name", dtype)), 4)


def node_bytes(program: StencilProgram, node: Node) -> int:
    """Unique bytes moved by a node: every accessed field element once
    (K-interface fields carry nk+1 levels)."""
    dom = program.node_dom(node)
    ei, ej = node.extend
    plane = (dom.nj + 2 * ej) * (dom.ni + 2 * ei)
    total = 0
    touched = list(dict.fromkeys(node.stencil.read_fields() + node.writes()))
    for f in touched:
        decl = program.fields.get(f)
        nbytes = _dtype_bytes(decl.dtype if decl else "float32")
        mult = 2 if (f in node.stencil.read_fields() and f in node.writes()) else 1
        vol = node.stencil.k_extent_of(f, dom.nk) * plane
        total += vol * nbytes * mult
    # temporaries live in VMEM after fusion → no HBM traffic
    return total


def node_flops(program: StencilProgram, node: Node) -> int:
    dom = program.node_dom(node)
    ei, ej = node.extend
    vol = dom.nk * (dom.nj + 2 * ej) * (dom.ni + 2 * ei)
    flops = vol * node.stencil.flops()
    # a LevelSearch marches O(nk) source layers per output point (compare +
    # two selects per layer in the reference's Pallas lowering; a bisection
    # is cheaper but the bound prices the worst backend) — nk-dependent, so it
    # cannot live in the stencil's static per-point count
    n_search = node.stencil.count_level_searches()
    if n_search:
        flops += n_search * 3 * dom.nk * vol
    return flops


def node_bound_seconds(program: StencilProgram, node: Node,
                       hw: Hardware | str | None = None) -> float:
    """max(memory term, compute term) — the kernel cannot run faster."""
    hw = resolve_hardware(hw)
    return max(node_bytes(program, node) / hw.hbm_bw,
               node_flops(program, node) / hw.peak_flops)


def program_bytes(program: StencilProgram) -> int:
    return sum(node_bytes(program, n) for n in program.all_nodes())


def program_bound_seconds(program: StencilProgram,
                          hw: Hardware | str | None = None) -> float:
    hw = resolve_hardware(hw)
    return sum(node_bound_seconds(program, n, hw) for n in program.all_nodes())


@dataclasses.dataclass
class KernelReport:
    label: str
    bytes_moved: int
    flops: int
    bound_s: float
    measured_s: float | None = None

    @property
    def utilization(self) -> float | None:
        if self.measured_s is None or self.measured_s == 0:
            return None
        return self.bound_s / self.measured_s


def program_report(program: StencilProgram,
                   hw: Hardware | str | None = None,
                   measure: Callable[[Node], float] | None = None,
                   ) -> list[KernelReport]:
    """Per-kernel bounds, ranked worst-utilization-first when measured —
    the paper's Fig. 10 'model-augmented kernel runtimes'."""
    hw = resolve_hardware(hw)
    out = []
    for n in program.all_nodes():
        r = KernelReport(
            label=n.label,
            bytes_moved=node_bytes(program, n),
            flops=node_flops(program, n),
            bound_s=node_bound_seconds(program, n, hw),
            measured_s=measure(n) if measure else None,
        )
        out.append(r)
    if measure:
        out.sort(key=lambda r: (r.utilization if r.utilization is not None else 1.0))
    else:
        out.sort(key=lambda r: -r.bound_s)
    return out


def format_report(reports: list[KernelReport]) -> str:
    lines = [f"{'kernel':40s} {'bytes':>12s} {'bound_us':>10s} "
             f"{'meas_us':>10s} {'util%':>7s}"]
    for r in reports:
        meas = f"{r.measured_s * 1e6:10.1f}" if r.measured_s else f"{'-':>10s}"
        util = (f"{r.utilization * 100:6.1f}%" if r.utilization is not None
                else f"{'-':>7s}")
        lines.append(f"{r.label:40s} {r.bytes_moved:12d} "
                     f"{r.bound_s * 1e6:10.2f} {meas} {util}")
    return "\n".join(lines)
