"""``seq_shard`` (the reference's keyword of ``forward``, ``loss_fn`` and
``prefill``): between blocks the residual stream is this rank's part of
the sequence over "model", gathered whole at each block's entry and split
again at its exit (``parallel.sharding.StreamSplit``), held against one
process over gloo processes on the CPU.

Each rank runs its rows of a 4-row batch of 15 tokens (a length the two
model ranks split unevenly) on a model laid out by ``parallel.sharding``,
float32, smoke configs from ``init_params(seed=0)``: a prefill, and a
loss (scaled by 1 / the data ranks, as ``train_step`` scales it) with
its backward through ``Gathered``.  Families: Granite-8B, Gemma-2-2B
(window 8), Zamba2-7B (the shared block) and xLSTM-1.3B.

* (1, 2): the prefill's logits and caches, the loss and every gradient
  are bit-equal to one process's.
* (2, 2): within the bars of ``test_torch_train_step.py``: logits 1e-5 of
  the largest |logit|, caches 1e-5 of each cache's largest |value|, the
  loss rtol 1e-5, the gradients rtol 1e-4 / atol 1e-6.
* On one process (no mesh) ``seq_shard`` changes nothing.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.models import Transformer, init_params, loss_fn, prefill

from _torch_train_ref import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_dist import _env, _wait

B, S = 4, 15
FAMILIES = {
    "granite": ("granite_8b", {}),
    "gemma2": ("gemma2_2b", {"window": 8}),
    "zamba2": ("zamba2_7b", {}),
    "xlstm": ("xlstm_1p3b", {}),
}
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}

COMMON = r"""
import dataclasses
import numpy as np
import torch
from repro_torch import configs as TC

def config(arch, changes):
    return dataclasses.replace(TC.smoke_config(arch), **changes)

def tokens(cfg, B, S):
    rng = np.random.default_rng(11)
    return (torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))),
            torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))))
"""

WORKER = COMMON + r"""
import datetime, json, sys
from pathlib import Path
import torch.distributed as dist
rank, world, init, out, shape, fams = sys.argv[1:7]
rank, world, shape = int(rank), int(world), tuple(json.loads(shape))
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.data.pipeline import local_rows
from repro_torch.launch.mesh import device_mesh
from repro_torch.models import Transformer, loss_fn, prefill
from repro_torch.parallel import sharding as SH
B, S = 4, 15
mesh = device_mesh(shape, ("data", "model"), device_type="cpu")
rows = local_rows(mesh, B)
for fam, (arch, changes) in json.loads(fams).items():
    cfg = config(arch, changes)
    model = SH.init_params(Transformer(cfg, dtype=torch.float32,
                                       device="meta"), seed=0, mesh=mesh)
    toks, labs = tokens(cfg, B, S)
    with torch.no_grad():
        logits, caches = prefill(model, toks[rows], backend="ref",
                                 seq_shard=True)
    model.requires_grad_(True)
    net = SH.Gathered(model, ("data",))
    loss = loss_fn(net, toks[rows], labs[rows], dtype=torch.float32,
                   backend="ref", seq_shard=True) / shape[0]
    net.backward(loss)
    total = SH.all_reduce_over(loss.detach().clone(), mesh, ("data",))
    grads = {k: SH.full_tensor(p.grad) for k, p in model.named_parameters()}
    torch.save({"rows": rows, "logits": logits, "caches": caches,
                "loss": total, "grads": grads},
               Path(out) / f"{fam}-{rank}.pt")
dist.destroy_process_group()
"""

exec(COMMON)  # config, tokens: the same code on both sides


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two process groups, started together."""
    tmp = tmp_path_factory.mktemp("seq_shard")
    procs = []
    for name, shape in MESHES.items():
        out = tmp / name
        out.mkdir()
        world = shape[0] * shape[1]
        procs += [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(world),
             f"file://{tmp}/rdv-{name}", str(out), json.dumps(shape),
             json.dumps(FAMILIES)],
            env=_env(tmp), cwd=tmp, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
    _wait(procs, "seq_shard on (1, 2) and (2, 2)")
    return tmp


_PLAIN: dict = {}


def plain(fam):
    """One process: the prefill, the loss and its gradients."""
    if fam not in _PLAIN:
        cfg = config(*FAMILIES[fam])
        model = init_params(Transformer(cfg, dtype=torch.float32,
                                        device="cpu"), seed=0)
        toks, labs = tokens(cfg, B, S)
        with torch.no_grad():
            logits, caches = prefill(model, toks, backend="ref")
        model.requires_grad_(True)
        loss = loss_fn(model, toks, labs, dtype=torch.float32, backend="ref")
        loss.backward()
        _PLAIN[fam] = {"logits": logits, "caches": caches,
                       "loss": loss.detach(),
                       "grads": {k: p.grad for k, p in
                                 model.named_parameters()}}
    return _PLAIN[fam]


def _close(got, want, rel):
    scale = max(want.abs().max().item(), 1e-30)
    return (got - want).abs().max().item() <= rel * scale


@pytest.mark.parametrize("fam", list(FAMILIES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_seq_shard_equals_one_process(runs, mesh, fam):
    want = plain(fam)
    exact = mesh == "1x2"
    world = MESHES[mesh][0] * MESHES[mesh][1]
    for r in range(world):
        got = torch.load(runs / mesh / f"{fam}-{r}.pt")
        rows = got["rows"]
        w = want["logits"][rows]
        if exact:
            assert torch.equal(got["logits"], w), r
        else:
            assert _close(got["logits"], w, 1e-5), r
            assert torch.equal(got["logits"].argmax(-1), w.argmax(-1)), r
        for i, (c, wc) in enumerate(zip(got["caches"], want["caches"])):
            for k, t in c.items():
                if exact:
                    assert torch.equal(t, wc[k][rows]), (r, i, k)
                else:
                    assert _close(t, wc[k][rows], 1e-5), (r, i, k)
        if exact:
            assert torch.equal(got["loss"], want["loss"]), r
        else:
            np.testing.assert_allclose(got["loss"].item(),
                                       want["loss"].item(), rtol=1e-5)
        for k, g in got["grads"].items():
            if exact:
                assert torch.equal(g, want["grads"][k]), (r, k)
            else:
                np.testing.assert_allclose(g.numpy(),
                                           want["grads"][k].numpy(),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=f"{r} {k}")


def test_seq_shard_on_one_process_changes_nothing():
    cfg = config(*FAMILIES["granite"])
    model = init_params(Transformer(cfg, dtype=torch.float32, device="cpu"),
                        seed=0)
    toks, labs = tokens(cfg, B, S)
    with torch.no_grad():
        a = prefill(model, toks, backend="ref")
        b = prefill(model, toks, backend="ref", seq_shard=True)
        la = loss_fn(model, toks, labs, dtype=torch.float32, backend="ref")
        lb = loss_fn(model, toks, labs, dtype=torch.float32, backend="ref",
                     seq_shard=True)
    assert torch.equal(a[0], b[0]) and torch.equal(la, lb)
