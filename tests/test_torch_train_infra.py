"""The port's training infrastructure on the CPU, mirroring
``tests/test_train_infra.py`` and ``tests/test_system.py``: the data
pipeline bit for bit against the reference's, checkpoints (round trip,
atomic publish and GC, async mode, a bf16 leaf, restore-then-resume equal
to the uninterrupted run), ``plan_mesh``, ``HeartbeatMonitor``, the loss
falling over 40 steps, and the launcher and ``examples/torch_train_lm.py``
in ``--smoke --device cpu`` mode."""

import importlib.util
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as RP

from repro_torch import configs as TC
from repro_torch.data.pipeline import (DataConfig, DataIterator,
                                       bf16_from_f64, make_batch)
from repro_torch.launch import train as launcher
from repro_torch.models import Transformer, init_params
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.elastic import HeartbeatMonitor, plan_mesh
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (TrainConfig, init_state,
                                          make_train_step)

from _torch_train_ref import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("step", [0, 1, 17, 999])
@pytest.mark.parametrize("kw", [dict(vocab=128, seq_len=16, global_batch=2,
                                     seed=3),
                                dict(vocab=1000, seq_len=40, global_batch=3,
                                     seed=0, n_prefix_embeds=8, d_model=24)],
                         ids=["tokens", "prefix"])
def test_make_batch_is_the_reference_s_bit_for_bit(kw, step):
    want = RP.make_batch(RP.DataConfig(**kw), step)
    got = make_batch(DataConfig(**kw), step, device="cpu")
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        if k == "prefix":
            assert got[k].dtype == torch.bfloat16
            assert np.array_equal(got[k].float().numpy(),
                                  w.astype(np.float32))
        else:
            assert got[k].dtype == torch.int32
            assert np.array_equal(got[k].numpy(), w)


def test_bf16_rounds_float64_as_jnp_does():
    """Values a float32 rounding carries onto a bf16 halfway point round
    as jnp rounds float64 to bf16: through float32, ties to even."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal(4096).astype(np.float32)
    bits = base.view(np.uint32) & np.uint32(0xFFFF0000)
    half = (bits | np.uint32(0x8000)).view(np.float32).astype(np.float64)
    tiny = np.abs(half) * 2.0 ** -30
    x = np.concatenate([half - tiny, half + tiny, half,
                        rng.standard_normal(4096) * 0.02])
    want = np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float32)
    assert np.array_equal(bf16_from_f64(x).float().numpy(), want)


def test_data_iterator_skip():
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=2)
    it1 = DataIterator(cfg, device="cpu")
    for _ in range(5):
        next(it1)
    it2 = DataIterator(cfg, device="cpu")
    it2.skip_to(5)
    assert torch.equal(next(it1)["tokens"], next(it2)["tokens"])


def test_checkpoint_roundtrip(tmp_path):
    state = {"w": torch.arange(12.0).reshape(3, 4), "step": 7,
             "h": torch.tensor([1.5, -2.25]).to(torch.bfloat16)}
    save_checkpoint(tmp_path, 7, state)
    assert latest_step(tmp_path) == 7
    like = {"w": torch.zeros(3, 4), "step": 0,
            "h": torch.zeros(2, dtype=torch.bfloat16)}
    restored, manifest = restore_checkpoint(tmp_path, like)
    assert manifest["step"] == 7 and manifest["n_leaves"] == 3
    assert restored["step"] == 7 and torch.equal(restored["w"], state["w"])
    assert torch.equal(restored["h"], state["h"])
    assert restored["w"] is like["w"]  # restored in place
    assert (tmp_path / "step_0000000007" / "arrays.npz").exists()
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(tmp_path, {"w": torch.zeros(3, 4)})


def test_checkpoint_atomic_gc(tmp_path):
    state = {"w": torch.zeros(2)}
    for s in range(5):
        save_checkpoint(tmp_path, s, state)
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(steps) == 3  # keep=3
    assert latest_step(tmp_path) == 4
    (tmp_path / "step_0000000009.tmp").mkdir()  # a write cut short
    assert latest_step(tmp_path) == 4


def test_checkpoint_async(tmp_path):
    w = torch.ones(8, 8)
    t = save_checkpoint(tmp_path, 1, {"w": w}, async_mode=True)
    w.zero_()  # the host copy was taken before the call returned
    t.join(timeout=30)
    restored, _ = restore_checkpoint(tmp_path, {"w": torch.zeros(8, 8)})
    assert torch.equal(restored["w"], torch.ones(8, 8))


def _granite(**changes):
    import dataclasses
    cfg = dataclasses.replace(TC.smoke_config("granite_8b"), **changes)
    return cfg, init_params(Transformer(cfg, dtype=torch.float32,
                                        device="cpu"), seed=0)


def test_restore_then_resume_equals_the_uninterrupted_run(tmp_path):
    """Train 2 steps, checkpoint, step 3; restore and step 3 again: the
    same loss and parameters (restart is transparent)."""
    cfg, model = _granite()
    state = init_state(cfg, model)
    step = make_train_step(cfg, TrainConfig(
        compute_dtype=torch.float32, opt=OptConfig(lr=1e-3, warmup=1)))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=1)
    for i in range(2):
        state, _ = step(state, make_batch(dcfg, i, device="cpu"))
    save_checkpoint(tmp_path, 2, state)
    state, m3 = step(state, make_batch(dcfg, 2, device="cpu"))
    after = [p.detach().clone() for p in state.params.parameters()]
    restored, manifest = restore_checkpoint(tmp_path, state)
    assert manifest["step"] == 2 and restored.step == 2
    restored, m3b = step(restored, make_batch(dcfg, 2, device="cpu"))
    assert float(m3["loss"]) == float(m3b["loss"])
    assert all(torch.equal(a, b) for a, b in
               zip(after, restored.params.parameters()))


def test_plan_mesh():
    assert plan_mesh(256) == (16, 16)
    assert plan_mesh(192) == (12, 16)   # lost 4 nodes → shrink data axis
    with pytest.raises(ValueError):
        plan_mesh(8)


def test_heartbeat_monitor():
    hb = HeartbeatMonitor(timeout_s=0.0)
    time.sleep(0.01)
    assert not hb.beat(1)
    assert hb.strikes == 1
    seen = []
    hb = HeartbeatMonitor(timeout_s=60.0,
                          on_straggle=lambda s, dt: seen.append(s))
    assert hb.beat(2) and hb.strikes == 0 and not seen


def test_lm_end_to_end_loss_decreases():
    """Tiny LM learns the synthetic repeat-structure: the loss drops over
    40 steps (data → model → grads → optimizer), as the reference's
    ``test_lm_end_to_end_loss_decreases``."""
    cfg, model = _granite()
    state = init_state(cfg, model)
    step = make_train_step(cfg, TrainConfig(
        compute_dtype=torch.float32, opt=OptConfig(lr=3e-3, warmup=5)))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=0)
    losses = []
    for i in range(40):
        state, m = step(state, make_batch(dcfg, i, device="cpu"))
        losses.append(float(m["loss"]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.2, (first, last)


def test_launcher_smoke_on_the_cpu_resumes(tmp_path, capsys):
    argv = ["--arch", "granite_8b", "--smoke", "--device", "cpu",
            "--steps", "4", "--seq", "32", "--global-batch", "4",
            "--grad-accum", "2", "--ckpt", str(tmp_path), "--ckpt-every",
            "2"]
    losses = launcher.main(argv)
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert latest_step(tmp_path) == 4
    resumed = launcher.main(argv[:argv.index("--steps") + 1] + ["6"]
                            + argv[argv.index("--steps") + 2:])
    out = capsys.readouterr().out
    assert "resumed at step 4" in out and len(resumed) == 2
    # more ranks come from torchrun (tests/test_torch_train_dist.py runs
    # them); a WORLD_SIZE without the rank's own variables is refused
    with pytest.raises(RuntimeError, match="torchrun"):
        import os
        os.environ["WORLD_SIZE"] = "2"
        try:
            launcher.main(argv)
        finally:
            del os.environ["WORLD_SIZE"]


@pytest.mark.parametrize("arch", ["granite_8b", "zamba2_7b"])
def test_train_example_on_the_cpu(arch, tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", ROOT / "examples" / "torch_train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    losses = mod.main(["--arch", arch, "--device", "cpu", "--steps", "3",
                       "--seq", "32", "--batch", "2", "--ckpt",
                       str(tmp_path), "--ckpt-every", "2"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert latest_step(tmp_path) == 2
    assert "trained 3 steps" in capsys.readouterr().out


def test_training_entry_points_refuse_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DataConfig(vocab=16, seq_len=8, global_batch=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--smoke", "--steps", "1"])
