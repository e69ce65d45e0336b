"""Serving on a mesh (``repro_torch.models.prefill``/``decode_step`` on a
model laid out by ``parallel.sharding``) held against one process, over
gloo processes on the CPU (the harness of ``test_torch_train_dist.py``).

Each rank serves its rows of a 4-row prompt (``data.pipeline.shard_batch``
split over "data"), float32, smoke configs from ``init_params(seed=0)``: a
prefill into caches of S + 8 slots, then 8 greedy decode steps.  Families:
dense (Granite-8B), MoE on split rows (Grok-1 at capacity factor 1, so
choices are dropped and each chunk spans the data ranks), hybrid (Zamba2-7B
at two groups: the shared block at each, its KV caches and the SSM
caches), recurrent (xLSTM-1.3B) and a local window (Gemma-2-2B, window 8:
the ring wraps in the decode).  Meshes (2, 1), (1, 2) and (2, 2).  Every
step's logits are within 1e-5 of the largest |logit| of the one-process
run, the greedy tokens are the same, and so are the final caches (1e-5 of
each cache's largest |value|).

int8 weights on a mesh (``serve.quantize.shard_quantized``: each ``q``
laid out as its weight, each ``s`` the same with its last axis whole,
gathered at use): Granite-8B, Zamba2-7B (the shared block, dequantized up
front) and Gemma-2-2B (the tied table), quantized from the float32
masters of ``init_params(seed=0)``, serve the same rows as above with
``quantized=True``: logits and caches bit-equal to the unsharded int8
model serving the same rows.
"""

import json
import subprocess
import sys

import pytest
import torch

from repro_torch.models import (Transformer, decode_step, init_params,
                                prefill)

from _torch_train_ref import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_dist import _env, _wait

B, S, STEPS = 4, 16, 8
FAMILIES = {
    "granite": ("granite_8b", {}),
    "grok1-capacity": ("grok1_314b", {"moe": {"capacity_factor": 1.0}}),
    "zamba2-g2": ("zamba2_7b", {"n_layers": 6}),
    "xlstm": ("xlstm_1p3b", {}),
    "gemma2": ("gemma2_2b", {"window": 8}),
}
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
INT8 = {"granite-int8": "granite_8b", "zamba2-int8": "zamba2_7b",
        "gemma2-int8": "gemma2_2b"}

COMMON = r"""
import dataclasses
import numpy as np
import torch
from repro_torch import configs as TC

def config(arch, changes):
    cfg = TC.smoke_config(arch)
    if "moe" in changes:
        changes = dict(changes, moe=dataclasses.replace(cfg.moe,
                                                        **changes["moe"]))
    return dataclasses.replace(cfg, **changes)

def prompt(cfg, B, S):
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))

def serve(model, tokens, S, steps, prefill, decode_step, **kw):
    with torch.no_grad():
        logits, caches = prefill(model, tokens, cache_len=S + steps,
                                 backend="ref", **kw)
        out = [logits[:, -1]]
        for i in range(steps):
            tok = out[-1].argmax(-1, keepdim=True)
            logits, caches = decode_step(model, tok, caches, S + i,
                                         backend="ref", **kw)
            out.append(logits[:, -1])
    return torch.stack(out, 1), caches

def int8_model(arch):
    from repro_torch.models import Transformer, init_params
    from repro_torch.serve import quantize_params
    return quantize_params(init_params(Transformer(
        config(arch, {}), dtype=torch.float32, device="cpu"), seed=0))
"""

WORKER = COMMON + r"""
import datetime, json, sys
from pathlib import Path
import torch.distributed as dist
rank, world, init, out, shape, fams, int8 = sys.argv[1:8]
rank, world, shape = int(rank), int(world), tuple(json.loads(shape))
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.data.pipeline import local_rows
from repro_torch.launch.mesh import device_mesh
from repro_torch.models import Transformer, decode_step, prefill
from repro_torch.parallel import sharding as SH
B, S, STEPS = 4, 16, 8
mesh = device_mesh(shape, ("data", "model"), device_type="cpu")
rows = local_rows(mesh, B)
for fam, (arch, changes) in json.loads(fams).items():
    cfg = config(arch, changes)
    model = SH.init_params(Transformer(cfg, dtype=torch.float32,
                                       device="meta"), seed=0, mesh=mesh)
    logits, caches = serve(model, prompt(cfg, B, S)[rows], S, STEPS,
                           prefill, decode_step)
    torch.save({"rows": rows, "logits": logits, "caches": caches},
               Path(out) / f"{fam}-{rank}.pt")
from repro_torch.serve import shard_quantized
for fam, arch in json.loads(int8).items():
    cfg = config(arch, {})
    model = shard_quantized(int8_model(arch), mesh)
    logits, caches = serve(model, prompt(cfg, B, S)[rows], S, STEPS,
                           prefill, decode_step, quantized=True)
    torch.save({"rows": rows, "logits": logits, "caches": caches},
               Path(out) / f"{fam}-{rank}.pt")
dist.destroy_process_group()
"""

exec(COMMON)  # config, prompt, serve: the same code on both sides


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three process groups, started together."""
    tmp = tmp_path_factory.mktemp("serve_dist")
    procs = []
    for name, shape in MESHES.items():
        out = tmp / name
        out.mkdir()
        world = shape[0] * shape[1]
        procs += [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(world),
             f"file://{tmp}/rdv-{name}", str(out), json.dumps(shape),
             json.dumps(FAMILIES), json.dumps(INT8)],
            env=_env(tmp), cwd=tmp, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
    _wait(procs, "serving on (2, 1), (1, 2) and (2, 2)")
    return tmp


_PLAIN: dict = {}


def plain(fam):
    if fam not in _PLAIN:
        cfg = config(*FAMILIES[fam])
        model = init_params(Transformer(cfg, dtype=torch.float32,
                                        device="cpu"), seed=0)
        _PLAIN[fam] = serve(model, prompt(cfg, B, S), S, STEPS, prefill,
                            decode_step)
    return _PLAIN[fam]


def _leaves(caches):
    return [(i, k, t) for i, c in enumerate(caches) for k, t in c.items()]


@pytest.mark.parametrize("fam", list(FAMILIES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_serving_equals_one_process(runs, mesh, fam):
    want_logits, want_caches = plain(fam)
    world = MESHES[mesh][0] * MESHES[mesh][1]
    seen = torch.zeros(B, dtype=torch.bool)
    for r in range(world):
        got = torch.load(runs / mesh / f"{fam}-{r}.pt")
        rows = got["rows"]
        seen[rows] = True
        want = want_logits[rows]
        scale = want.abs().max().item()
        err = (got["logits"] - want).abs().max().item()
        assert err <= 1e-5 * scale, (r, err, scale)
        assert torch.equal(got["logits"].argmax(-1), want.argmax(-1)), r
        for (i, k, t), (_, _, w) in zip(_leaves(got["caches"]),
                                        _leaves(want_caches)):
            w = w[rows]
            assert t.shape == w.shape, (r, i, k)
            assert (t - w).abs().max().item() <= 1e-5 * max(
                w.abs().max().item(), 1e-30), (r, i, k)
    assert seen.all()


@pytest.mark.parametrize("fam", list(INT8))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_int8_serving_on_a_mesh_equals_the_unsharded_int8_model(runs, mesh,
                                                                fam):
    cfg = config(INT8[fam], {})
    model = int8_model(INT8[fam])
    world = MESHES[mesh][0] * MESHES[mesh][1]
    for r in range(world):
        got = torch.load(runs / mesh / f"{fam}-{r}.pt")
        logits, caches = serve(model, prompt(cfg, B, S)[got["rows"]], S,
                               STEPS, prefill, decode_step, quantized=True)
        assert torch.equal(got["logits"], logits), r
        for (i, k, t), (_, _, w) in zip(_leaves(got["caches"]),
                                        _leaves(caches)):
            assert torch.equal(t, w), (r, i, k)


def test_capacity_family_drops_in_decode_and_prefill(monkeypatch):
    """The MoE family's one-process run drops choices in its prefill and
    its decode steps, so the runs above hold a binding capacity."""
    from repro_torch.models import layers as TL

    dropped = []
    route = TL.MoE.route

    def counted(self, xc):
        out = route(self, xc)
        dropped.append(int((~out[3]).sum()))
        return out

    monkeypatch.setattr(TL.MoE, "route", counted)
    _PLAIN.pop("grok1-capacity", None)
    plain("grok1-capacity")
    cfg = config(*FAMILIES["grok1-capacity"])
    assert len(dropped) == cfg.n_layers * (1 + STEPS)
    assert dropped[0] > 0 and sum(dropped[cfg.n_layers:]) > 0, dropped
