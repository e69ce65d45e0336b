"""``remat="dots"`` (``repro_torch.models.remat``: each group under
``torch.utils.checkpoint`` with a selective policy that keeps the outputs
of ``aten.mm``/``aten.addmm`` and recomputes the rest) against ``"block"``
and against the reference's ``loss_fn`` with ``remat="dots"`` (its
``dots_with_no_batch_dims_saveable``; the reference's hillclimb sets it
through ``dataclasses.replace``).

Families: Granite (dense), Grok-1 (the experts' ``bmm``, which is not
kept), Zamba2 (the SSD einsums, the shared block) and xLSTM (the mLSTM
einsums, the sLSTM scan), smoke configs in float32.

* The loss and every gradient are bit-equal to ``"block"``'s.
* Against the reference: the loss within 1e-5 relative, every gradient
  within rtol 1e-4 / atol 1e-6 (the bars of ``test_torch_train_loss.py``).
* ``SavedBytes`` counts what a forward keeps for its backward: under
  ``"dots"`` exactly ``"block"``'s plus the products' outputs, a count the
  meta device gives as well.
* On a gloo (2, 1) mesh, a sharded loss under ``"dots"`` equals
  ``"block"``'s bit for bit, and ``Gathered`` counts one use of each
  gathered weight: the recomputation in the backward counts none.
"""

import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from repro.models import transformer as RT

from repro_torch import configs as TC
from repro_torch.models import Transformer, init_params, loss_fn
from repro_torch.models import remat as R

from _torch_train_ref import one_torch_thread  # noqa: F401 (autouse)
from _torch_train_ref import (assert_trees_close, batch, configs,
                              port_grads, port_model, ref_params)
from test_torch_train_dist import _env, _wait

ARCHS = ("granite_8b", "grok1_314b", "zamba2_7b", "xlstm_1p3b")
B, S = 2, 64


def _run(cfg, toks, labs, params=None, **kw):
    """(loss, gradients) of the port's float32 loss of ``cfg``."""
    if params is None:
        model = init_params(Transformer(cfg, dtype=torch.float32,
                                        device="cpu"), seed=0)
        model.requires_grad_(True)
    else:
        model = port_model(cfg, params)
    loss = loss_fn(model, torch.from_numpy(toks), torch.from_numpy(labs),
                   dtype=torch.float32, **kw)
    loss.backward()
    return loss.detach(), model


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_is_bit_equal_to_block(arch):
    cfg = TC.smoke_config(arch)
    toks, labs, _ = batch(cfg, B, S, seed=5)
    la, ma = _run(dataclasses.replace(cfg, remat="block"), toks, labs)
    lb, mb = _run(dataclasses.replace(cfg, remat="dots"), toks, labs)
    assert torch.equal(la, lb)
    for (name, p), q in zip(ma.named_parameters(), mb.parameters()):
        assert torch.equal(p.grad, q.grad), name


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_matches_the_reference_s_dots(arch):
    rcfg, cfg = configs(arch, remat="dots")
    params = ref_params(rcfg)
    toks, labs, _ = batch(cfg, B, S, seed=7)
    f = jax.value_and_grad(lambda p, t, l: RT.loss_fn(
        p, t, l, rcfg, dtype=jnp.float32))
    want_loss, want = jax.jit(f)(params, toks, labs)
    loss, model = _run(cfg, toks, labs, params)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert_trees_close(port_grads(model), jax.tree.map(np.asarray, want),
                       rtol=1e-4, atol=1e-6)


def _saved(cfg, device, dtype=torch.bfloat16):
    model = Transformer(cfg, dtype=torch.float32, device=device)
    if device == "cpu":
        init_params(model, seed=0)
    model.requires_grad_(True)
    toks = torch.zeros((B, S), dtype=torch.long, device=device)
    with R.SavedBytes() as saved:  # the plain versions: meta has no kernel
        loss_fn(model, toks, toks, dtype=dtype, backend="ref")
    return saved


def test_dots_keeps_the_outputs_of_the_products():
    """Granite's dots keep, a layer and token, q, k, v, the attention's
    output projection, wi, wg and the MLP's output projection: that many
    bf16 values more than "block" keeps, on the CPU and on the meta
    device alike."""
    cfg = TC.smoke_config("granite_8b")
    per_token = (cfg.q_dim + 2 * cfg.kv_dim + cfg.d_model + 2 * cfg.d_ff
                 + cfg.d_model)
    counts = {}
    for remat in ("block", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        cpu, meta = _saved(c, "cpu"), _saved(c, "meta")
        assert (cpu.bytes, cpu.tensors) == (meta.bytes, meta.tensors)
        counts[remat] = cpu
    extra = counts["dots"].bytes - counts["block"].bytes
    assert extra == cfg.n_layers * B * S * per_token * 2
    assert counts["dots"].tensors - counts["block"].tensors == \
        7 * cfg.n_layers
    # "block" keeps each group's input (B, S, d) bf16 and what lies
    # outside the groups
    assert counts["block"].bytes >= cfg.n_groups * B * S * cfg.d_model * 2


def test_the_policy_keeps_only_products_without_a_batch_dim():
    class Ctx:
        is_recompute = False

    ops = torch.ops
    keep = [ops.aten.mm.default, ops.aten.addmm.default]
    redo = [ops.aten.bmm.default, ops.aten.mul.Tensor,
            ops.aten.add.Tensor, ops.aten.exp.default]
    redo += [getattr(ops.c10d, n).default for n in
             ("_allgather_base_", "allreduce_") if hasattr(ops.c10d, n)]
    x = torch.zeros(2, 3)
    for op in keep:
        args = (x, x.T) if op is ops.aten.mm.default else (x, x, x.T)
        assert R.dots_policy(Ctx(), op, *args) is CheckpointPolicy.MUST_SAVE
    for op in redo:
        assert R.dots_policy(Ctx(), op, x) is \
            CheckpointPolicy.PREFER_RECOMPUTE


WORKER = r"""
import datetime, dataclasses, json, sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist
rank, world, init, out = sys.argv[1:5]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch import configs as TC
from repro_torch.data.pipeline import local_rows
from repro_torch.launch.mesh import device_mesh
from repro_torch.models import Transformer, loss_fn
from repro_torch.parallel import sharding as SH
mesh = device_mesh((2, 1), ("data", "model"), device_type="cpu")
res = {}
for arch in ("granite_8b", "grok1_314b"):
    cfg = TC.smoke_config(arch)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32)))
    rows = local_rows(mesh, 4)
    for remat in ("block", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        model = SH.init_params(Transformer(c, dtype=torch.float32,
                                           device="meta"), seed=0,
                               mesh=mesh).requires_grad_(True)
        net = SH.Gathered(model, ("data",))
        loss = loss_fn(net, toks[rows], toks[rows], dtype=torch.float32,
                       backend="ref")
        uses = sorted(set(net._uses.values()))
        n = len(net._uses)
        net.backward(loss)
        left = sorted(set(net._uses.values()))
        res[f"{arch}/{remat}"] = {
            "loss": loss.item(), "uses": uses, "n": n, "left": left,
            "grads": {k: SH.full_tensor(p.grad).tolist()
                      for k, p in model.named_parameters()}}
if rank == 0:
    Path(out).write_text(json.dumps(res))
dist.destroy_process_group()
"""


def test_dots_on_a_gloo_mesh_counts_each_use_once(tmp_path):
    out = tmp_path / "out.json"
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "2",
         f"file://{tmp_path}/rdv", str(out)],
        env=_env(tmp_path), cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    _wait(procs, "remat on (2, 1)")
    res = json.loads(out.read_text())
    for arch in ("granite_8b", "grok1_314b"):
        block, dots = res[f"{arch}/block"], res[f"{arch}/dots"]
        n_params = len(block["grads"])
        for r in (block, dots):
            # every parameter gathered once in the forward, none left
            # after the backward: the recomputation counted no use
            assert r["uses"] == [1] and r["n"] == n_params, arch
            assert r["left"] == [0], arch
        assert dots["loss"] == block["loss"], arch
        assert dots["grads"] == block["grads"], arch
