"""The port's orchestration, lint CLI and rule registry against the
reference's.

``orchestrate`` of a program is ``compile_program``'s runner; ``Monitor``
hooks fire synchronously in the order emitted, with detached tensors;
``python -m repro_torch.lint`` exits 0 on the FV3 programs and prints the
same violations and lints as ``python -m repro.lint`` at opt 0 and at opt 3
(on the reference's tuning preset); the port's rule registry equals the
reference's, recompute-vs-exchange included.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.core.rewrite as RR
import repro.lint as RL
import repro_torch.core.rewrite as TR

from repro_torch import lint as TL
from repro_torch.core import compile_program
from repro_torch.core.backend import TuningCache, set_default_cache
from repro_torch.core.orchestration import Monitor, bind_constants, orchestrate
from repro_torch.core.rewrite import (ExchangeModel, RecomputeVsExchange,
                                      available_rules, get_rule)
from repro_torch.fv3 import dyncore as TD

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _own_tuning_cache(tmp_path_factory):
    """The port's tuning cache of this file: a throwaway file, never the
    working tree's ``.repro_cache/torch_tuning.json``."""
    set_default_cache(TuningCache(
        tmp_path_factory.mktemp("torch_tuning") / "torch_tuning.json"))
    yield
    set_default_cache(None)


@pytest.mark.parametrize("opt_level", [0, 3])
def test_orchestrate_compiles_a_program_like_compile_program(opt_level):
    cfg = TD.FV3Config(npx=8, nk=3, n_tracers=1)
    prog = TD.build_tracer_program(cfg, cfg.seq_dom())
    fn = orchestrate(prog, opt_level=opt_level, device="cpu", donate=True)
    ref = compile_program(prog, opt_level=opt_level, device="cpu")
    assert fn.n_kernels == ref.n_kernels
    torch.manual_seed(0)
    ins = {f: torch.rand(cfg.seq_dom().padded_shape()) + 0.5
           for f in ("u", "v", "qvapor")}
    params = TD.default_params(cfg)
    a, b = fn(dict(ins), params), ref(dict(ins), params)
    assert torch.equal(a["qvapor_out"], b["qvapor_out"])


def test_orchestrate_hands_back_a_plain_function():
    def step(x, *, scale):
        return x * scale

    assert orchestrate(step) is step
    bound = bind_constants(step, scale=3.0)
    assert torch.equal(bound(torch.ones(2)), torch.full((2,), 3.0))


def test_monitor_hooks_fire_in_order_with_detached_tensors():
    seen = []
    mon = Monitor()
    mon.register("a", lambda v: seen.append(("a", v)))
    mon.register("b", lambda v: seen.append(("b", v)))
    x = torch.ones(2, requires_grad=True)
    mon.emit("a", x * 2)
    mon.emit("missing", x)
    mon.emit("b", 5)
    mon.emit("a", x)
    assert [n for n, _ in seen] == ["a", "b", "a"]
    assert not seen[0][1].requires_grad and seen[1][1] == 5
    assert torch.equal(seen[0][1], torch.full((2,), 2.0))
    mon.enabled = False
    mon.emit("a", x)
    assert len(seen) == 3


def test_lint_cli_exits_zero_on_fv3(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_CACHE_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.lint", "-q"],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1].startswith(
        "repro_torch.lint: 8 program(s), 0 violation(s)")


@pytest.mark.parametrize("opt_level", [0, 3])
def test_lint_reports_what_the_reference_reports(capsys, opt_level):
    argv = ["fv3", "--opt-level", str(opt_level)]
    assert RL.main(argv) == 0
    want = capsys.readouterr().out.replace("repro.lint:", "LINT:")
    # the reference's jnp ladder tunes for its tpu-v5e preset
    assert TL.main(argv, hardware="tpu-v5e") == 0
    got = capsys.readouterr().out.replace("repro_torch.lint:", "LINT:")
    assert got == want
    assert "0 violation(s)" in got.splitlines()[-1]


def test_lint_strict_fails_on_lints(capsys):
    assert TL.main(["fv3", "--strict", "-q"]) == 1
    assert "lint(s)" in capsys.readouterr().out


_CFG = TD.FV3Config(npx=8, nk=3, n_tracers=1)
PROGRAM = TD.build_tracer_program(_CFG, _CFG.seq_dom())


def _programs():
    return [TD.build_csw_program(_CFG, _CFG.seq_dom()), PROGRAM]


def test_lint_resolves_module_targets(capsys):
    """``pkg.mod`` scans the module's globals; ``pkg.mod:attr`` takes a
    program or a zero-argument factory of programs."""
    assert TL.main([__name__, f"{__name__}:_programs", "-q"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("repro_torch.lint: 3 program(s)")
    assert f"[{__name__}:tracer_2d] OK" in lines
    assert f"[{__name__}:c_sw+riem] 0 violation(s), 1 lint(s)" in lines
    with pytest.raises(SystemExit, match="no StencilProgram"):
        TL.main(["repro_torch.fv3.stencils"])
    with pytest.raises(SystemExit, match="expected StencilProgram"):
        TL.main(["repro_torch.fv3.dyncore:STATE_FIELDS"])


def test_rule_registry_matches_the_reference():
    # tests of either package register rules of their own into the
    # registry of the process; keep the rules the packages define
    def own(registry):
        return [n for n in registry.available_rules() if getattr(
            registry.get_rule(n), "fn", type(registry.get_rule(n))
        ).__module__.startswith(("repro.", "repro_torch."))]

    assert own(RR) == own(TR)
    assert "recompute_vs_exchange" in available_rules()
    rule = get_rule("recompute_vs_exchange")
    assert isinstance(rule, RecomputeVsExchange)
    hw = type("HW", (), {"link_bw": 0, "hbm_bw": 2e12})()
    assert ExchangeModel(4, 2_000_000).seconds(hw) == pytest.approx(
        4 * 1.5e-6 + 1e-6)
