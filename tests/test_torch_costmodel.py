"""The port's cost model (``repro_torch.launch.costmodel``) and parameter
counts against the reference's: every architecture x shape at the
reference's ``grad_accum`` (16 where d_model >= 6000, else 8), and a cut
config at a one-card shape, each field and component within rel 1e-12;
``count_params`` and ``count_active_params`` exactly."""

import dataclasses

import pytest

from repro import configs as RC
from repro.launch import costmodel as RCM
from repro.models import config as RCF
from repro.models import transformer as RT

from repro_torch import configs as TC
from repro_torch.launch import costmodel as TCM
from repro_torch.models import config as TCF
from repro_torch.models import count_active_params, count_params

FIELDS = ("flops", "model_flops", "hbm_bytes", "coll_bytes")


def _close(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert abs(a - b) <= 1e-12 * abs(b), (f, a, b)
    assert set(got.components) == set(want.components)
    for k, b in want.components.items():
        a = got.components[k]
        assert abs(a - b) <= 1e-12 * abs(b), (k, a, b)


@pytest.mark.parametrize("shape", [s.name for s in RCF.SHAPES])
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_cell_cost_equals_the_reference_s(arch, shape):
    ref = RC.get_config(arch)
    ga = 16 if ref.d_model >= 6000 else 8
    _close(TCM.cell_cost(TC.get_config(arch), TCF.SHAPE_BY_NAME[shape], 256,
                         grad_accum=ga),
           RCM.cell_cost(ref, RCF.SHAPE_BY_NAME[shape], 256, grad_accum=ga))


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_parameter_counts_equal_the_reference_s(arch):
    ref, cfg = RC.get_config(arch), TC.get_config(arch)
    assert count_params(cfg) == RT.count_params(ref)
    assert count_active_params(cfg) == RT.count_active_params(ref)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_a_cut_config_at_a_one_card_shape(kind):
    """Granite-8B cut to 8 layers at 8 x 4096, ``grad_accum`` 2 (the
    training cell of the card's smoke run), on one card."""
    ref = dataclasses.replace(RC.get_config("granite_8b"), n_layers=8)
    cfg = dataclasses.replace(TC.get_config("granite_8b"), n_layers=8)
    rs = RCF.ShapeSpec("cell", 4096, 8, kind)
    ts = TCF.ShapeSpec("cell", 4096, 8, kind)
    _close(TCM.cell_cost(cfg, ts, 1, grad_accum=2),
           RCM.cell_cost(ref, rs, 1, grad_accum=2))
