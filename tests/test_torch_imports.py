"""Boundaries of the PyTorch port: it imports neither JAX nor the reference
package, its entry points run on the card unless the caller asks for the
CPU, and ``chip_smoke.py`` refuses to report without a card or a checkout."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import StencilProgram
from repro_torch.core.backend import (TuningCache, compile_program,
                                      resolve_device, set_default_cache)
from repro_torch.core.stencil import DomainSpec
from repro_torch.fv3 import dyncore as TD
from repro_torch.fv3 import state as TSt
from repro_torch.fv3 import stencils as TS

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.fixture(autouse=True, scope="module")
def _own_tuning_cache(tmp_path_factory):
    """The port's tuning cache of this file: a throwaway file, never the
    working tree's ``.repro_cache/torch_tuning.json``."""
    set_default_cache(TuningCache(
        tmp_path_factory.mktemp("torch_tuning") / "torch_tuning.json"))
    yield
    set_default_cache(None)


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module or "")
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_port_import_loads_no_jax():
    code = ("import sys, repro_torch.fv3.dyncore, repro_torch.fv3.state, "
            "repro_torch.core.backend.cuda, "
            "repro_torch.core.backend.batching, repro_torch.kernels.ops, "
            "repro_torch.core.passes, repro_torch.core.autotune, "
            "repro_torch.core.transfer_tuning, repro_torch.core.perfmodel, "
            "repro_torch.core.transforms, repro_torch.core.analysis, "
            "repro_torch.core.rewrite, repro_torch.core.backend.cache; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_to_run_without_a_card(no_card):
    cfg = TD.FV3Config(npx=12, nk=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.make_step_sequential(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.make_step_sequential(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        TSt.init_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.make_step_ensemble(cfg, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSt.ensemble_state(cfg, 2)
    prog = TD.build_tracer_program(cfg, cfg.seq_dom())
    with pytest.raises(RuntimeError, match="CUDA"):
        compile_program(prog)
    assert resolve_device("cpu") == torch.device("cpu")


def test_compile_program_takes_opt_level_zero_only():
    """Opt levels 1–4, ``verify="full"`` and ``batch="vmap:auto"`` now run
    (they raised before the optimizer was ported); opt level 0 stays the
    default of ``compile_program``."""
    dom = DomainSpec(ni=4, nj=4, nk=3, halo=2)
    p = StencilProgram("one", dom)
    p.declare("u")
    p.declare("cx")
    p.add(TS.courant_x, {"u": "u", "cx": "cx"})
    p.propagate_extents()
    u = torch.ones(dom.padded_shape())
    for kw in ({"opt_level": 1}, {"opt_level": 2}, {"opt_level": 3},
               {"opt_level": 4}, {"verify": "full"}):
        run = compile_program(p, device="cpu", **kw)
        assert run.n_kernels == 1
        assert (run.opt_report is None) == ("opt_level" not in kw)
        out = run({"u": u}, {"dtdx": 0.5})
        assert torch.allclose(out["cx"][:, 2:6, 2:6],
                              torch.full((3, 4, 4), 0.5))
    auto = compile_program(p, device="cpu", n_members=2, batch="vmap:auto")
    assert auto.batch in ("vmap:1", "vmap:2")  # C resolved at compile time
    out = auto({"u": torch.stack([u, 2 * u])}, {"dtdx": 0.5})
    assert torch.equal(out["cx"][1, :, 2:6, 2:6], torch.full((3, 4, 4), 1.0))
    run = compile_program(p, device="cpu")
    assert run.opt_report is None and run.hardware == "h100"
    assert run.n_kernels == 1 and run.device == torch.device("cpu")
    out = run({"u": u}, {"dtdx": 0.5})
    assert torch.allclose(out["cx"][:, 2:6, 2:6], torch.full((3, 4, 4), 0.5))
    ens = compile_program(p, device="cpu", n_members=2)
    assert ens.n_kernels == 1 and ens.n_members == 2 and ens.batch == "vmap"
    out = ens({"u": torch.stack([u, 2 * u])}, {"dtdx": 0.5})
    assert torch.equal(out["cx"][1, :, 2:6, 2:6], torch.full((3, 4, 4), 1.0))
    with pytest.raises(ValueError, match="lies on"):
        compile_program(p, device="meta")({"u": u}, {"dtdx": 0.5})


def _smoke(cwd: Path, script: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _smoke(ROOT, ROOT / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    proc = _smoke(tmp_path, lone)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
