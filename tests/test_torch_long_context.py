"""Decode against caches split along the sequence (the reference's
``long_ctx``: a batch of fewer rows than data ranks), held against one
process over gloo processes on the CPU.

Every rank prefills the same one-row prompt of 16 tokens on a model laid
out by ``parallel.sharding`` (float32, smoke configs from
``init_params(seed=0)``) into caches of 24 slots;
``parallel.sharding.split_caches`` keeps this rank's slots of each KV
cache (split over "data", then "model"); then 8 greedy decode steps, each
rank on the same token.  Families: Granite-8B, Gemma-2-2B (window 8: its
ring of 8 slots wraps in the decode, each rank holding a part of it),
Zamba2-7B (the shared block's caches split, the SSM states whole),
xLSTM-1.3B (no KV cache: every state whole) and Granite with an int8 KV
cache (the prefill's k/v quantized with per-head scales, which stay
whole).  Meshes (2, 1) and (2, 2).

Against one process decoding the same caches whole: every step's logits
within 1e-5 of the largest |logit|, the same greedy tokens, and each
rank's slots of the final caches within 1e-5 of the cache's largest
|value| (an int8 cache within one step of its grid), the other states
too.
"""

import json
import subprocess
import sys

import pytest
import torch

from repro_torch.models import Transformer, decode_step, init_params, prefill

from _torch_train_ref import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_dist import _env, _wait

S, STEPS = 16, 8
FAMILIES = {
    "granite": ("granite_8b", {}, False),
    "gemma2": ("gemma2_2b", {"window": 8}, False),
    "zamba2": ("zamba2_7b", {}, False),
    "xlstm": ("xlstm_1p3b", {}, False),
    "granite-int8-kv": ("granite_8b", {}, True),
}
MESHES = {"2x1": (2, 1), "2x2": (2, 2)}

COMMON = r"""
import dataclasses
import numpy as np
import torch
from repro_torch import configs as TC

def config(arch, changes):
    return dataclasses.replace(TC.smoke_config(arch), **changes)

def prompt(cfg, S):
    rng = np.random.default_rng(5)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (1, S)))

def int8_kv(caches):
    # each KV cache's k/v as int8 with a float32 scale per (row, head)
    out = []
    for c in caches:
        if "k" not in c:
            out.append(c)
            continue
        d = {}
        for key in ("k", "v"):
            t = c[key]
            s = t.abs().amax(dim=(1, 3), keepdim=True).clamp(min=1e-8) / 127
            d[key] = torch.clamp(torch.round(t / s), -127, 127).to(torch.int8)
            d[key + "_s"] = s.float()
        out.append(d)
    return out

def serve(model, caches, first, S, steps, decode_step):
    out = [first]
    with torch.no_grad():
        for i in range(steps):
            tok = out[-1].argmax(-1, keepdim=True)
            logits, caches = decode_step(model, tok, caches, S + i,
                                         backend="ref")
            out.append(logits[:, -1])
    return torch.stack(out, 1), caches
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
from repro_torch.launch.mesh import device_mesh
from repro_torch.models import Transformer, decode_step, prefill
from repro_torch.parallel import sharding as SH
S, STEPS = 16, 8
mesh = device_mesh(shape, ("data", "model"), device_type="cpu")
for fam, (arch, changes, quant) in json.loads(fams).items():
    cfg = config(arch, changes)
    model = SH.init_params(Transformer(cfg, dtype=torch.float32,
                                       device="meta"), seed=0, mesh=mesh)
    with torch.no_grad():
        logits, caches = prefill(model, prompt(cfg, S),
                                 cache_len=S + STEPS, backend="ref")
    if quant:
        caches = int8_kv(caches)
    caches = SH.split_caches(caches, mesh)
    logits, caches = serve(model, caches, logits[:, -1], S, STEPS,
                           decode_step)
    slots = [{k: (SH.cache_split(t).start if SH.cache_split(t) else 0,
                  SH.local(t)) for k, t in c.items()} for c in caches]
    torch.save({"logits": logits, "caches": slots},
               Path(out) / f"{fam}-{rank}.pt")
dist.destroy_process_group()
"""

exec(COMMON)  # config, prompt, int8_kv, serve: the same code on both sides


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two process groups, started together."""
    tmp = tmp_path_factory.mktemp("long_context")
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
    _wait(procs, "split caches on (2, 1) and (2, 2)")
    return tmp


_PLAIN: dict = {}


def plain(fam):
    if fam not in _PLAIN:
        arch, changes, quant = FAMILIES[fam]
        cfg = config(arch, changes)
        model = init_params(Transformer(cfg, dtype=torch.float32,
                                        device="cpu"), seed=0)
        with torch.no_grad():
            logits, caches = prefill(model, prompt(cfg, S),
                                     cache_len=S + STEPS, backend="ref")
        if quant:
            caches = int8_kv(caches)
        _PLAIN[fam] = serve(model, caches, logits[:, -1], S, STEPS,
                            decode_step)
    return _PLAIN[fam]


@pytest.mark.parametrize("fam", list(FAMILIES))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_split_cache_decode_equals_one_process(runs, mesh, fam):
    want_logits, want_caches = plain(fam)
    scale = want_logits.abs().max().item()
    world = MESHES[mesh][0] * MESHES[mesh][1]
    covered = {}
    for r in range(world):
        got = torch.load(runs / mesh / f"{fam}-{r}.pt")
        err = (got["logits"] - want_logits).abs().max().item()
        assert err <= 1e-5 * scale, (r, err, scale)
        assert torch.equal(got["logits"].argmax(-1),
                           want_logits.argmax(-1)), r
        for i, (c, w) in enumerate(zip(got["caches"], want_caches)):
            for k, (start, t) in c.items():
                want = w[k]
                split = k in ("k", "v")
                if split:
                    want = want[:, start:start + t.shape[1]]
                    covered.setdefault((i, k), []).append(
                        (start, t.shape[1]))
                assert t.shape == want.shape, (r, i, k)
                if t.dtype == torch.int8:
                    assert (t.int() - want.int()).abs().max() <= 1, (r, i, k)
                else:
                    bar = 1e-5 * max(w[k].abs().max().item(), 1e-30)
                    assert (t - want).abs().max().item() <= bar, (r, i, k)
    # the ranks' slots tile each KV cache once
    for (i, k), parts in covered.items():
        slots = sorted(j for start, m in parts
                       for j in range(start, start + m))
        assert slots == list(range(want_caches[i][k].shape[1])), (i, k)
