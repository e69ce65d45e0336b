"""The port's DSL front half against the reference package: the same
``@gtstencil`` source parses to the same IR (equal content fingerprints),
and the four programs of the dycore step build the same graphs."""

import numpy as np
import pytest

from repro.core.backend import stencil_fingerprint as ref_fingerprint
from repro.core.stencil.ir import Stencil as RefStencil
from repro.fv3 import dyncore as RD
from repro.fv3 import stencils as RS

from repro_torch.core.backend import stencil_fingerprint
from repro_torch.core.hardware import H100, get_hardware
from repro_torch.core.stencil import Field, Param, Schedule, gtstencil
from repro_torch.core.stencil.schedule import default_schedule
from repro_torch.fv3 import dyncore as TD
from repro_torch.fv3 import stencils as TS

NAMES = sorted(k for k, v in vars(RS).items() if isinstance(v, RefStencil))
PROGRAMS = ["build_csw_program", "build_dsw_program",
            "build_tracer_program", "build_remap_program"]


@pytest.mark.parametrize("name", NAMES)
def test_stencil_fingerprints_agree(name):
    ref, port = getattr(RS, name), getattr(TS, name)
    assert stencil_fingerprint(port) == ref_fingerprint(ref)
    assert repr(port) == repr(ref)
    assert port.extents() == ref.extents()
    assert port.temporaries() == ref.temporaries()


@pytest.mark.parametrize("nk", [4, 9])
def test_unrolled_interp_fingerprints_agree(nk):
    assert (stencil_fingerprint(TS.interface_interp_stencil(nk))
            == ref_fingerprint(RS.interface_interp_stencil(nk)))


@pytest.mark.parametrize("builder", PROGRAMS)
def test_programs_have_same_nodes_and_fields(builder):
    cfg_r, cfg_t = RD.FV3Config(npx=12, nk=5), TD.FV3Config(npx=12, nk=5)
    ref = getattr(RD, builder)(cfg_r, cfg_r.seq_dom())
    port = getattr(TD, builder)(cfg_t, cfg_t.seq_dom())
    assert port.name == ref.name
    assert port.params == ref.params
    assert ({k: (d.transient, d.interface) for k, d in port.fields.items()}
            == {k: (d.transient, d.interface) for k, d in ref.fields.items()})
    rn, pn = ref.all_nodes(), port.all_nodes()
    assert [n.label for n in pn] == [n.label for n in rn]
    assert [n.extend for n in pn] == [n.extend for n in rn]
    assert ([stencil_fingerprint(n.stencil) for n in pn]
            == [ref_fingerprint(n.stencil) for n in rn])


def test_frontend_parses_regions_intervals_and_params():
    @gtstencil
    def flux(q: Field, out: Field, dt: Param):
        with computation(PARALLEL), interval(1, -1):
            out = dt * (q[1, 0, 0] - q[-1, 0, 0])
            with horizontal(region[:, 0]):
                out = q
    assert flux.params == ("dt",)
    assert flux.outputs == ("out",)
    (comp,) = flux.computations
    assert [s.region is not None for s in comp.statements] == [False, True]
    assert comp.statements[0].interval.resolve(6) == (1, 5)
    assert flux.extents()["q"] == (-1, 1, 0, 0, 0, 0)


def test_h100_preset_and_gpu_default_schedule():
    assert get_hardware("h100") is H100
    assert (H100.kind, H100.lane, H100.sublane) == ("gpu", 32, 1)
    assert H100.vmem_bytes == 232448 and H100.hbm_bw == 3.35e12
    assert H100.peak_flops == 67e12 and H100.link_bw == 450e9
    sched = default_schedule(TS.tridiag_solve, (80, 192, 192), hw=H100)
    assert isinstance(sched, Schedule)
    assert sched.block_k == 0 and not sched.k_as_grid
    assert sched.carry_storage == "vmem"
    assert np.prod([sched.block_i, sched.block_j]) > 0
