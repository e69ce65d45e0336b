"""The port's training across ranks (``repro_torch.parallel.sharding``,
``train_step``'s sharded path, ``checkpoint``/``elastic.reshard_state``,
the launcher under ``WORLD_SIZE`` > 1) held against one process, over
gloo processes on the CPU.

One worker per rank steps every family in turn (few process groups):
Granite-8B, Gemma-2-2B (window 8, so the local mask cuts; the tied
table), Zamba2-7B (one group, and two: the shared block at each),
xLSTM-1.3B, Grok-1 (MoE, Adafactor; and at capacity factor 1, where the
capacity binds and a chunk of the micro-batch spans the data ranks) and
Granite with a vocabulary of 255 (shards of 128 and 127), smoke configs in float32, 2 steps of ``grad_accum`` 2 from
``init_params(seed=0)``, on meshes (2, 1), (1, 2) and (2, 2) of 2, 2 and
4 processes.  Each run's checkpoint after step 2 (gathered whole) equals
the one-process run at the bars ``tests/test_torch_train_step.py`` holds
the step to against the reference: loss and grad_norm at rtol 1e-5, the
optimizer state at rtol 1e-4 / atol 1e-6, the parameters 99.9 % within
that and every element within 0.05 lr.

Elastic: the (2, 2) checkpoint restored on 2 processes at (2, 1) and on
this process through ``reshard_state``, each run to step 4, equals the
uninterrupted one-process run.  The (2, 2) loss on the reference's own
inputs (``tests/test_distributed.py``'s sharded-loss test) is within 1e-5
relative of the reference's single-device ``loss_fn(dtype=float32)``.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import transformer as RT
from repro.parallel.sharding import init_params as ref_init_params

from repro_torch import configs as TC
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import train as launcher
from repro_torch.models import Transformer, init_params, loss_fn
from repro_torch.models import layers as TL
from repro_torch.train import checkpoint as CK
from repro_torch.train.checkpoint import latest_step
from repro_torch.train.elastic import reshard_state
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (TrainConfig, init_state,
                                          make_train_step)

from _torch_train_ref import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
LR = 1e-3
A, B, S = 2, 4, 32
FAMILIES = {
    "granite": ("granite_8b", {}),
    "gemma2": ("gemma2_2b", {"window": 8}),
    "zamba2": ("zamba2_7b", {}),
    # two groups: the shared block gathered twice, its gradient summed
    # over both uses before the one reduction
    "zamba2-g2": ("zamba2_7b", {"n_layers": 6}),
    "xlstm": ("xlstm_1p3b", {}),
    "grok1": ("grok1_314b", {}),
    # capacity 32 of 64 tokens' 128 choices: drops, routed over the
    # global micro-batch on every mesh
    "grok1-capacity": ("grok1_314b", {"moe": {"capacity_factor": 1.0}}),
    "granite-v255": ("granite_8b", {"vocab": 255}),
}
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}

WORKER = r"""
import dataclasses, datetime, json, sys
from pathlib import Path
import numpy as np
import torch, torch.distributed as dist
rank, world, init, out, shape, resume = sys.argv[1:7]
rank, world, shape = int(rank), int(world), tuple(json.loads(shape))
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch import configs as TC
from repro_torch.data.pipeline import DataConfig, make_batch, shard_batch
from repro_torch.launch.mesh import device_mesh
from repro_torch.models import Transformer, load_reference_params, loss_fn
from repro_torch.parallel import sharding as SH
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.elastic import reshard_state
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (TrainConfig, init_state,
                                          make_train_step)
FAMILIES = json.loads(sys.argv[7])
A, B, S, LR = 2, 4, 32, 1e-3
out = Path(out)
mesh = device_mesh(shape, ("data", "model"), device_type="cpu")

def config(arch, changes):
    cfg = TC.smoke_config(arch)
    if "moe" in changes:
        changes = dict(changes, moe=dataclasses.replace(cfg.moe,
                                                        **changes["moe"]))
    return dataclasses.replace(cfg, **changes)

tc = TrainConfig(grad_accum=A, compute_dtype=torch.float32,
                 opt=OptConfig(lr=LR, warmup=2))

def run(cfg, state, steps, tag):
    step = make_train_step(cfg, tc, dp_axes=SH.dp_axes(mesh),
                           param_specs=SH.param_shardings(state.params,
                                                          mesh))
    dc = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=4)
    metrics = []
    for i in steps:
        state, m = step(state, shard_batch(make_batch(dc, i, device="cpu"),
                                           mesh, A))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    save_checkpoint(out / tag, state.step, state)
    if rank == 0:
        (out / tag / "metrics.json").write_text(json.dumps(metrics))
    return state

for fam, (arch, changes) in FAMILIES.items():
    cfg = config(arch, changes)
    meta = Transformer(cfg, dtype=torch.float32, device="meta")
    state = init_state(cfg, SH.init_params(meta, seed=0, mesh=mesh))
    # the shards' layout is DTensor's own: its gather gives the whole
    for n, p in state.params.named_parameters():
        assert torch.equal(p.full_tensor(), SH.full_tensor(p.detach())), n
    run(cfg, state, range(2), f"fresh/{fam}")
    if resume != "-":
        like = init_state(cfg, SH.init_params(
            Transformer(cfg, dtype=torch.float32, device="meta"), seed=1,
            mesh=mesh))
        state, manifest = reshard_state(Path(resume) / fam, like, mesh)
        assert manifest["step"] == 2 and state.step == 2
        run(cfg, state, range(2, 4), f"resumed/{fam}")

ref = out.parent / "ref_loss.npz"
if ref.exists():  # the reference's own sharded-loss inputs
    data = np.load(ref)
    cfg = TC.smoke_config("granite_8b")
    model = Transformer(cfg, dtype=torch.float32, device="cpu")
    tree = {}
    for k in data.files:
        if k.startswith("p/"):
            node = tree
            *head, leaf = k[2:].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = data[k]
    load_reference_params(model, tree)
    SH.shard_model(model, mesh)
    batch = shard_batch({"tokens": torch.from_numpy(data["tokens"]),
                         "labels": torch.from_numpy(data["labels"])}, mesh)
    with torch.no_grad():
        loss = loss_fn(SH.Gathered(model, SH.dp_axes(mesh)),
                       batch["tokens"], batch["labels"],
                       dtype=torch.float32) / (shape[0])
    SH.all_reduce_over(loss, mesh, SH.dp_axes(mesh))
    if rank == 0:
        (out / "ref_loss.json").write_text(json.dumps(float(loss)))
dist.destroy_process_group()
"""


def _env(tmp):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1", REPRO_CACHE_DIR=str(tmp / "cache"))


def _wait(procs, what):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * len(procs), (
        what + "\n" + "\n".join(logs))
    return logs


def _workers(tmp, name, shape, resume="-"):
    out = tmp / name
    out.mkdir()
    world = shape[0] * shape[1]
    init = f"file://{tmp}/rdv-{name}"
    return [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), init, str(out),
         json.dumps(shape), resume, json.dumps(FAMILIES)],
        env=_env(tmp), cwd=tmp, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _ref_loss_inputs(path):
    """The reference's test inputs and its single-device float32 loss."""
    cfg = RC.smoke_config("granite_8b")
    params = ref_init_params(RT.model_pdefs(cfg), jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 64), 0, cfg.vocab)
    labels = jax.random.randint(jax.random.PRNGKey(2), (4, 64), 0, cfg.vocab)
    loss = float(RT.loss_fn(params, tokens, labels, cfg, dtype=jnp.float32))
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat["p/" + prefix + k] = np.asarray(v)

    walk(params, "")
    np.savez(path, tokens=np.asarray(tokens, np.int32),
             labels=np.asarray(labels, np.int32), **flat)
    return loss


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every process group, in turn: (2, 2) with the reference-loss check,
    then (2, 1) (also resuming the (2, 2) checkpoints) and (1, 2)."""
    tmp = tmp_path_factory.mktemp("dist")
    ref_loss = _ref_loss_inputs(tmp / "ref_loss.npz")
    _wait(_workers(tmp, "2x2", (2, 2)), "(2, 2)")
    (tmp / "ref_loss.npz").unlink()
    _wait(_workers(tmp, "2x1", (2, 1), resume=str(tmp / "2x2" / "fresh")),
          "(2, 1)")
    _wait(_workers(tmp, "1x2", (1, 2)), "(1, 2)")
    return tmp, ref_loss


def _config(fam):
    arch, changes = FAMILIES[fam]
    cfg = TC.smoke_config(arch)
    if "moe" in changes:
        changes = dict(changes, moe=dataclasses.replace(cfg.moe,
                                                        **changes["moe"]))
    return dataclasses.replace(cfg, **changes)


def _one_process(fam, steps):
    """The plain run: (metrics, checkpoint leaves) after each step."""
    cfg = _config(fam)
    state = init_state(cfg, init_params(
        Transformer(cfg, dtype=torch.float32, device="cpu"), seed=0))
    step = make_train_step(cfg, TrainConfig(
        grad_accum=A, compute_dtype=torch.float32,
        opt=OptConfig(lr=LR, warmup=2)))
    dc = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=4)
    out = []
    for i in range(steps):
        state, m = step(state, make_batch(dc, i, device="cpu"))
        out.append(((float(m["loss"]), float(m["grad_norm"])),
                    [CK._host(x) for x in CK._leaves(state)]))
    n_params = len(list(state.params.parameters()))
    return out, n_params


_PLAIN: dict = {}


def plain(fam):
    if fam not in _PLAIN:
        _PLAIN[fam] = _one_process(fam, 4)
    return _PLAIN[fam]


def _read(ckpt_dir):
    d = Path(ckpt_dir)
    step = latest_step(d)
    arrays = np.load(d / f"step_{step:010d}" / "arrays.npz")
    leaves = [arrays[f"leaf_{i}"] for i in range(len(arrays.files))]
    return json.loads((d / "metrics.json").read_text()), leaves


def _assert_close(metrics, leaves, want_metrics, want_leaves, n_params):
    for (l, g), (wl, wg) in zip(metrics, want_metrics):
        np.testing.assert_allclose(l, wl, rtol=1e-5)
        np.testing.assert_allclose(g, wg, rtol=1e-5)
    assert len(leaves) == len(want_leaves)
    a = np.concatenate([x.ravel() for x in leaves[:n_params]])
    b = np.concatenate([x.ravel() for x in want_leaves[:n_params]])
    near = np.abs(a - b) <= 1e-6 + 1e-4 * np.abs(b)
    assert near.mean() >= 0.999, near.mean()
    assert np.abs(a - b).max() <= 0.05 * LR, np.abs(a - b).max()
    for i, (x, y) in enumerate(zip(leaves[n_params:], want_leaves[n_params:])):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-6,
                                   err_msg=f"state leaf {i}")


@pytest.mark.parametrize("fam", list(FAMILIES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_equal_one_process(runs, mesh, fam):
    tmp, _ = runs
    metrics, leaves = _read(tmp / mesh / "fresh" / fam)
    want, n_params = plain(fam)
    _assert_close(metrics, leaves, [m for m, _ in want[:2]], want[1][1],
                  n_params)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_elastic_2x2_to_2x1_equals_the_uninterrupted_run(runs, fam):
    tmp, _ = runs
    metrics, leaves = _read(tmp / "2x1" / "resumed" / fam)
    want, n_params = plain(fam)
    _assert_close(metrics, leaves, [m for m, _ in want[2:]], want[3][1],
                  n_params)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_elastic_2x2_to_one_process_equals_the_uninterrupted_run(runs, fam):
    tmp, _ = runs
    cfg = _config(fam)
    like = init_state(cfg, init_params(
        Transformer(cfg, dtype=torch.float32, device="cpu"), seed=1))
    state, manifest = reshard_state(tmp / "2x2" / "fresh" / fam, like, None)
    assert manifest["step"] == 2 and state.step == 2
    step = make_train_step(cfg, TrainConfig(
        grad_accum=A, compute_dtype=torch.float32,
        opt=OptConfig(lr=LR, warmup=2)))
    dc = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=4)
    metrics = []
    for i in (2, 3):
        state, m = step(state, make_batch(dc, i, device="cpu"))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    want, n_params = plain(fam)
    _assert_close(metrics, [CK._host(x) for x in CK._leaves(state)],
                  [m for m, _ in want[2:]], want[3][1], n_params)


def test_capacity_family_drops_choices(monkeypatch):
    """One process's first micro-batch in "grok1-capacity" drops choices,
    so its runs above hold the routing of a binding capacity."""
    cfg = _config("grok1-capacity")
    model = init_params(Transformer(cfg, dtype=torch.float32, device="cpu"),
                        seed=0)
    dropped = []
    route = TL.MoE.route

    def counted(self, xc):
        out = route(self, xc)
        dropped.append(int((~out[3]).sum()))
        return out

    monkeypatch.setattr(TL.MoE, "route", counted)
    dc = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=4)
    b = make_batch(dc, 0, device="cpu")
    with torch.no_grad():
        loss_fn(model, b["tokens"][:B // A], b["labels"][:B // A],
                dtype=torch.float32)
    assert len(dropped) == cfg.n_layers and min(dropped) > 0, dropped


def test_2x2_loss_is_the_reference_s_single_device_loss(runs):
    tmp, ref_loss = runs
    got = json.loads((tmp / "2x2" / "ref_loss.json").read_text())
    assert abs(got - ref_loss) <= 1e-5 * abs(ref_loss), (got, ref_loss)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


LAUNCH = r"""
import sys
from repro_torch.launch import train
train.main(sys.argv[1:])
"""


def test_launcher_trains_saves_and_resumes_across_ranks(tmp_path, capsys):
    """Two ranks (gloo, torchrun's variables; the default model axis of
    one rank, so a (2, 1) mesh) train 4 steps and save;
    two ranks resume to 6; then one process resumes their checkpoint to
    8 (the launcher's elastic restore onto no mesh)."""
    argv = ["--arch", "granite_8b", "--smoke", "--device", "cpu",
            "--seq", "32", "--global-batch", "4", "--grad-accum", "2",
            "--ckpt", str(tmp_path / "ckpt"), "--ckpt-every", "2"]

    def ranks(steps):
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-c", LAUNCH, *argv, "--steps", str(steps)],
            env=dict(_env(tmp_path), RANK=str(r), LOCAL_RANK=str(r),
                     WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port)),
            cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(2)]
        return _wait(procs, f"launcher to step {steps}")

    logs = ranks(4)
    assert "mesh=(2, 1)" in logs[0] and "step     4" in logs[0]
    assert "loss=" not in logs[1]  # only rank 0 prints the steps
    assert latest_step(tmp_path / "ckpt") == 4
    logs = ranks(6)
    assert "resumed at step 4 (ckpt mesh=[2, 1], now=(2, 1))" in logs[0]
    assert latest_step(tmp_path / "ckpt") == 6
    losses = launcher.main(argv + ["--steps", "8"])
    out = capsys.readouterr().out
    assert "resumed at step 6 (ckpt mesh=[2, 1], now=None)" in out
    assert len(losses) == 2 and all(np.isfinite(losses))
