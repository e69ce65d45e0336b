"""The port's serving example, ``examples/torch_serve_lm.py``, run through
its ``main()`` on the CPU for every architecture, with float and int8
weights: greedy tokens of the asked shape, within the vocabulary, the
same on a second run (the weights and prompts come from seeds)."""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import configs as TC

ROOT = Path(__file__).resolve().parents[1]


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_serve_lm", ROOT / "examples" / "torch_serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_serve_example_runs_every_arch(arch, int8, capsys):
    argv = ["--arch", arch, "--device", "cpu", "--batch", "2",
            "--prompt-len", "16", "--new-tokens", "4"] + (
                ["--int8"] if int8 else [])
    main = _example().main
    tokens = main(argv)
    assert tokens.shape == (2, 4) and tokens.dtype == torch.long
    assert ((tokens >= 0) & (tokens < TC.smoke_config(arch).vocab)).all()
    assert torch.equal(main(argv), tokens)
    out = capsys.readouterr().out
    assert "prefill: B=2 S=16" in out and "seq1:" in out
