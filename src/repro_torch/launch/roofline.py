"""Roofline: three-term analysis per (arch x shape), priced for the H100,
as the reference's ``launch/roofline.py`` prices its own chips.

    compute term    = FLOPs / (cards x PEAK_FLOPS)
    memory term     = HBM bytes / (cards x HBM_BW)
    collective term = collective bytes / (cards x the mesh's link rate)

FLOPs and bytes come from the analytic cost model (:mod:`.costmodel`, the
reference's formulas).  The link rate is the slowest of the mesh's axes
that carry collectives: an axis whose ranks fit in one host of
``CARDS_PER_HOST`` cards runs over NVLink at ``NVLINK_BW``, an axis that
spans hosts over the network at ``NET_BW`` a card.  Both 16-wide axes of
the production (16, 16) mesh span two hosts, so its terms take ``NET_BW``;
each record also carries the NVLink figure beside it.  One card
(``chips=1``) has no collective term.  These are data-sheet prices, not
measurements.

Usage: python -m repro_torch.launch.roofline [--json results/torch_roofline.json]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..configs import ARCH_IDS, get_config
from ..models.config import SHAPE_BY_NAME, SHAPES, ArchConfig, ShapeSpec
from .costmodel import cell_cost

# NVIDIA H100 SXM5 80GB data sheet (700 W):
PEAK_FLOPS = 989e12          # bf16 tensor core, dense, per card
HBM_BW = 3.35e12             # HBM3, bytes/s per card
HBM_BYTES = 80e9             # HBM3 a card
# NVLink 4: 900 GB/s a card both ways together, 450e9 each way
NVLINK_BW = 450e9
# one 400 Gb/s NDR InfiniBand port a card, as in a DGX H100: 50e9 each way
NET_BW = 50e9
CARDS_PER_HOST = 8           # a DGX / HGX H100 host
CHIPS = 256
MESH = (16, 16)              # the production mesh, ("data", "model")

RESULTS = Path(__file__).resolve().parents[3] / "results"


def link_bw(mesh_shape: tuple[int, ...]) -> float | None:
    """Bytes/s each way a card of the slowest axis of ``mesh_shape`` (ranks
    numbered row-major, the last axis fastest, as the mesh's): NVLink where
    the axis's ranks lie in one host, the network where they span hosts;
    None for a mesh of one rank."""
    rates, stride = [], 1
    for size in reversed(mesh_shape):
        if size > 1:
            within = stride * size <= CARDS_PER_HOST
            rates.append(NVLINK_BW if within else NET_BW)
        stride *= size
    return min(rates) if rates else None


def _mesh_of(chips: int) -> tuple[int, ...]:
    if chips == CHIPS:
        return MESH
    if chips == 2 * CHIPS:
        return (2,) + MESH
    return (chips,)


def analyze_cell(arch_id: str | ArchConfig, shape_name: str | ShapeSpec, *,
                 chips: int = CHIPS, grad_accum: int | None = None) -> dict:
    """The record of one cell: a registered arch id and shape name (the
    reference's), or a config and a :class:`ShapeSpec` of the caller's (a
    cut model at its own batch and length on ``chips=1``); ``grad_accum``
    the reference's rule (16 where d_model >= 6000, else 8) unless given."""
    arch = get_config(arch_id) if isinstance(arch_id, str) else arch_id
    shape = (SHAPE_BY_NAME[shape_name] if isinstance(shape_name, str)
             else shape_name)
    name = arch_id if isinstance(arch_id, str) else arch.name
    if shape.name == "long_500k" and not arch.long_context_ok:
        return {"arch": name, "shape": shape.name, "active": False}
    ga = grad_accum or (16 if arch.d_model >= 6000 else 8)
    cost = cell_cost(arch, shape, chips, grad_accum=ga)
    link = link_bw(_mesh_of(chips))
    t_comp = cost.flops / (chips * PEAK_FLOPS)
    t_mem = cost.hbm_bytes / (chips * HBM_BW)
    t_coll = 0.0 if link is None else cost.coll_bytes / (chips * link)
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    # roofline fraction: useful model FLOPs per second at the bound vs peak
    roofline_frac = (cost.model_flops / bound) / (chips * PEAK_FLOPS)
    rec = {
        "arch": name, "shape": shape.name, "active": True,
        "chips": chips, "grad_accum": ga,
        "compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll,
        "collective_nvlink_s": (0.0 if link is None
                                else cost.coll_bytes / (chips * NVLINK_BW)),
        "link_bytes_per_s": link,
        "dominant": dominant, "bound_s": bound,
        "model_flops": cost.model_flops,
        "hlo_flops_corrected": cost.flops,
        "hbm_bytes": cost.hbm_bytes, "coll_bytes": cost.coll_bytes,
        "useful_ratio": cost.model_flops / cost.flops,
        "roofline_fraction": roofline_frac,
        "components": cost.components,
    }
    # the dry run's record of the same cell, where it was run
    dj = RESULTS / "torch_dryrun" / f"{name}__{shape.name}__pod16x16.json"
    if chips == CHIPS and dj.exists():
        d = json.loads(dj.read_text())
        rec["dryrun_collectives"] = d.get("collectives", {})
        rec["dryrun_memory"] = d.get("memory", {})
    rec["what_moves_it"] = _advice(rec)
    return rec


def _advice(rec: dict) -> str:
    dom = rec["dominant"]
    if dom == "compute":
        if rec["useful_ratio"] < 0.6:
            return ("compute-bound with low useful ratio: cut remat recompute "
                    "(checkpoint policy) and MoE dispatch overhead")
        return "compute-bound near model FLOPs: already near roofline"
    if dom == "memory":
        return ("memory-bound: raise arithmetic intensity — fuse norms/"
                "elementwise into matmuls, keep KV/cache reads bf16, larger "
                "microbatch to amortize weight reads")
    return ("collective-bound: shrink the FSDP gather span (replicate small "
            "params), overlap grad reduce-scatter with backward, keep the "
            "model axis inside a host's NVLink")


def full_table(chips: int = CHIPS) -> list[dict]:
    return [analyze_cell(arch, shape.name, chips=chips)
            for arch in ARCH_IDS for shape in SHAPES]


def format_markdown(rows: list[dict]) -> str:
    out = ["| arch | shape | compute_s | memory_s | collective_s "
           "(NVLink) | dominant | MODEL_FLOPS | exec FLOPs | useful "
           "| roofline frac |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if not r.get("active"):
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | skipped "
                       "| — | — | — | — |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {r['collective_s']:.4f} "
            f"({r['collective_nvlink_s']:.4f}) | "
            f"{r['dominant']} | {r['model_flops']:.3e} | "
            f"{r['hlo_flops_corrected']:.3e} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction'] * 100:.1f}% |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=str(RESULTS / "torch_roofline.json"))
    args = ap.parse_args(argv)
    rows = full_table()
    Path(args.json).parent.mkdir(parents=True, exist_ok=True)
    Path(args.json).write_text(json.dumps(rows, indent=1))
    print("priced from the H100 data sheet, not measured: "
          f"{CHIPS} cards, mesh {MESH}, {PEAK_FLOPS:.4g} FLOP/s bf16, "
          f"{HBM_BW:.4g} B/s HBM, links {link_bw(MESH):.4g} B/s "
          f"(NVLink {NVLINK_BW:.4g})")
    print(format_markdown(rows))
    active = [r for r in rows if r.get("active")]
    worst = min(active, key=lambda r: r["roofline_fraction"])
    coll = max(active, key=lambda r: r["collective_s"] /
               max(r["compute_s"], r["memory_s"], 1e-12))
    print(f"\nworst roofline fraction: {worst['arch']} × {worst['shape']} "
          f"({worst['roofline_fraction'] * 100:.1f}%)")
    print(f"most collective-bound:  {coll['arch']} × {coll['shape']}")


if __name__ == "__main__":
    main()
