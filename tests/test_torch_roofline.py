"""The port's roofline (``repro_torch.launch.roofline``): priced for the
H100 only.  Its terms are the cost model's numbers over (cards x the
data-sheet rates); its active cells are the reference's; the reference's
records, recomputed at the port's rates, give the port's ``dominant`` and
``roofline_fraction``; no TPU rate is left in the port."""

import re
from pathlib import Path

import pytest

from repro.launch import roofline as RR

from repro_torch import configs as TC
from repro_torch.launch import costmodel as TCM
from repro_torch.launch import roofline as TR
from repro_torch.models.config import SHAPE_BY_NAME

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tables():
    return TR.full_table(), RR.full_table()


def test_the_rates_are_the_h100_data_sheet_s():
    assert (TR.PEAK_FLOPS, TR.HBM_BW, TR.NVLINK_BW, TR.NET_BW) == (
        989e12, 3.35e12, 450e9, 50e9)
    assert TR.CHIPS == 256 and TR.MESH == (16, 16)
    # both 16-wide axes span two hosts of 8 cards: the network's rate
    assert TR.link_bw((16, 16)) == TR.link_bw((2, 16, 16)) == 50e9
    assert TR.link_bw((1, 8)) == TR.link_bw((2, 4)) == 450e9
    assert TR.link_bw((2, 8)) == 50e9 and TR.link_bw((1, 1)) is None


def test_terms_are_the_cost_over_the_cards_rates(tables):
    port, _ = tables
    for r in port:
        if not r["active"]:
            continue
        cfg = TC.get_config(r["arch"])
        ga = 16 if cfg.d_model >= 6000 else 8
        c = TCM.cell_cost(cfg, SHAPE_BY_NAME[r["shape"]], 256, grad_accum=ga)
        assert r["compute_s"] == c.flops / (256 * 989e12)
        assert r["memory_s"] == c.hbm_bytes / (256 * 3.35e12)
        assert r["collective_s"] == c.coll_bytes / (256 * 50e9)
        assert r["collective_nvlink_s"] == c.coll_bytes / (256 * 450e9)
        assert r["bound_s"] == max(r["compute_s"], r["memory_s"],
                                   r["collective_s"])


def test_active_cells_are_the_reference_s(tables):
    port, ref = tables
    assert [(r["arch"], r["shape"], r["active"]) for r in port] == [
        (r["arch"], r["shape"], r["active"]) for r in ref]


def test_reference_records_at_the_port_s_rates(tables):
    """The reference's terms rescaled from its rates to the H100's give the
    port's dominant term and roofline fraction."""
    port, ref = tables
    for p, r in zip(port, ref):
        if not r["active"]:
            continue
        terms = {"compute": r["compute_s"] * RR.PEAK_FLOPS / TR.PEAK_FLOPS,
                 "memory": r["memory_s"] * RR.HBM_BW / TR.HBM_BW,
                 "collective": r["collective_s"] * RR.ICI_BW / TR.NET_BW}
        dominant = max(terms, key=terms.get)
        frac = r["model_flops"] / max(terms.values()) / (256 * TR.PEAK_FLOPS)
        assert p["dominant"] == dominant, (p["arch"], p["shape"])
        assert abs(p["roofline_fraction"] - frac) <= 1e-12 * frac
        assert p["model_flops"] == r["model_flops"]
        assert p["hlo_flops_corrected"] == r["hlo_flops_corrected"]


def test_one_card_has_no_collective_term():
    rec = TR.analyze_cell("granite_8b", "train_4k", chips=1)
    assert rec["collective_s"] == 0.0 and rec["link_bytes_per_s"] is None
    assert rec["compute_s"] == rec["hlo_flops_corrected"] / 989e12


def test_no_tpu_rate_in_the_port_s_pricing():
    """The TPU v5e's rates appear in no module of the port but the
    optimizer's table of target hardware (``core/hardware.py``: the tuner
    prices a "tpu-v5e" target to take the reference's schedule decisions,
    K4's K-blocking among them); the launch tools price the H100 only."""
    port = ROOT / "src" / "repro_torch"
    holding = {str(p.relative_to(port)) for p in port.rglob("*.py")
               for tpu in ("197e12", "819e9", "197e+12", "8.19e11")
               if tpu in p.read_text()}
    assert holding == {"core/hardware.py"}, holding
    for p in (port / "launch").glob("*.py"):
        assert not re.search(r"\btpu", p.read_text(), re.I), p


def test_main_writes_the_table(tmp_path, capsys):
    TR.main(["--json", str(tmp_path / "r.json")])
    out = capsys.readouterr().out
    assert "priced from the H100 data sheet, not measured" in out
    assert (tmp_path / "r.json").exists()
