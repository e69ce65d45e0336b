"""The port's sharding rules (``repro_torch.parallel.sharding``) and meshes
(``repro_torch.launch.mesh``) against the reference's, on the CPU.

* The placements of every parameter of every config (full size and smoke)
  equal the reference's ``logical_to_spec(d.axes, mesh)`` for the leaf the
  parameter maps to, on ("data", "model") and ("pod", "data", "model")
  (the reference's function reads only ``mesh.axis_names``; a leaf
  stacked over groups drops its leading "layers" entry).
* ``abstract_params`` allocates nothing; ``make_fv3_mesh`` is
  ``fv3.mesh.make_mesh`` of the same shape; ``make_production_mesh``
  refuses a process group of another size; a kernel refuses a DTensor.
* One rank on a (1, 1) mesh of one gloo process: a sharded train step
  equals the plain one bit for bit (every gather and reduction issued;
  a sum over one rank is a copy and the clip sums in the same order).
* An MoE layer on rows split over ranks (``layers.TOKEN_SPLIT``, each
  rank run in turn on this process) routes the global micro-batch's
  chunks, with a binding capacity, as one process routes them.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.models import transformer as RT
from repro.models.layers import ParamDef
from repro.parallel import sharding as RS

from repro_torch import configs as TC
from repro_torch.data.pipeline import DataConfig, local_rows, make_batch
from repro_torch.fv3.mesh import make_mesh
from repro_torch.kernels import library
from repro_torch.launch import mesh as LM
from repro_torch.models import Transformer, init_params
from repro_torch.models import layers as TL
from repro_torch.models.weights import reference_paths
from repro_torch.parallel import sharding as SH
from repro_torch.train import checkpoint as CK
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (TrainConfig, init_state,
                                          make_train_step)

from _torch_train_ref import one_torch_thread  # noqa: F401 (autouse)

MESHES = {"data-model": ("data", "model"),
          "pod-data-model": ("pod", "data", "model")}


def fake_mesh(names):
    """What the reference's rules read of a mesh: its axis names."""
    return types.SimpleNamespace(axis_names=names, mesh_dim_names=names)


def ref_leaf(defs, path):
    for k in path:
        defs = defs[k]
    assert isinstance(defs, ParamDef), path
    return defs


def expected_placements(spec, names):
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                out[names.index(a)] = Shard(d)
    return tuple(out)


@pytest.mark.parametrize("names", list(MESHES.values()), ids=list(MESHES))
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_placements_equal_the_reference_s(arch, smoke, names):
    cfg = (TC.smoke_config if smoke else TC.get_config)(arch)
    model = Transformer(cfg, dtype=torch.float32, device="meta")
    defs = RT.model_pdefs(cfg)
    mesh = fake_mesh(names)
    got = SH.param_shardings(model, mesh)
    shapes = dict(model.named_parameters())
    assert set(got) == set(shapes)
    for name, path, g in reference_paths(model):
        d = ref_leaf(defs, path)
        spec = tuple(RS.logical_to_spec(d.axes, mesh))
        if g >= 0:  # stacked: the "layers" axis resolves to nothing
            assert d.axes[0] == "layers" and spec[0] is None
            spec, shape = spec[1:], d.shape[1:]
        else:
            shape = d.shape
        assert tuple(shapes[name].shape) == tuple(shape), name
        assert got[name].spec == spec, (name, got[name].spec, spec)
        assert got[name].placements == expected_placements(spec, names), name
    assert SH.dp_axes(mesh) == RS.dp_axes(mesh)


def test_rules_and_batch_sharding():
    assert SH.RULES == RS.RULES
    mesh = fake_mesh(("pod", "data", "model"))
    assert SH.logical_to_spec(("fsdp", "tp", "layers", None), mesh) == (
        "data", "model", None, None)
    assert SH.logical_to_spec(("fsdp", "tp"), fake_mesh(("data",))) == (
        "data", None)
    assert SH.batch_sharding(mesh).spec == (("pod", "data"), None)
    assert SH.batch_sharding(mesh, seq_axis="seq").spec == (
        None, ("pod", "data"))
    assert SH.batch_sharding(mesh).placements == (Shard(0), Shard(0),
                                                  Replicate())


@pytest.mark.parametrize("layout,ensemble", [((8, 8), 1), ((2, 2), 1),
                                             ((1, 1), 4)])
def test_fv3_mesh_is_the_fv3_descriptor(layout, ensemble):
    got = LM.make_fv3_mesh(layout=layout, ensemble=ensemble)
    py, px = layout
    if ensemble > 1:
        want = make_mesh((ensemble, 6, py, px), ("ens", "tile", "y", "x"))
    else:
        want = make_mesh((6, py, px), ("tile", "y", "x"))
    assert got == want


@pytest.fixture
def one_rank(tmp_path):
    """A process group of this one process (gloo) and its (1, 1) mesh."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        yield LM.device_mesh((1, 1), ("data", "model"), device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_production_mesh_refuses_another_world_size(one_rank):
    with pytest.raises(ValueError, match="needs 256 ranks"):
        LM.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        LM.make_production_mesh(multi_pod=True)


def test_abstract_params_allocate_nothing(one_rank):
    # Grok-1 whole: 316 G parameters, 1.3 TB in float32 if allocated
    model = Transformer(TC.get_config("grok1_314b"), dtype=torch.float32,
                        device="meta")
    out = SH.abstract_params(model, one_rank)
    params = dict(model.named_parameters())
    assert set(out) == set(params)
    shardings = SH.param_shardings(model, one_rank)
    for name, t in out.items():
        assert isinstance(t, DTensor) and t.to_local().is_meta, name
        assert t.shape == params[name].shape and t.dtype == torch.float32
        assert tuple(t.placements) == shardings[name].placements


def test_zeros_without_keeps_the_other_dimensions_split(one_rank):
    w = SH._dtensor(torch.ones(4, 6), one_rank, (Shard(0), Shard(1)), (4, 6))
    assert SH.zeros_without(w, -1).placements == (Shard(0), Replicate())
    assert SH.zeros_without(w, -2).placements == (Replicate(), Shard(0))
    assert SH.zeros_without(w, -2).shape == (6,)
    z = SH.zeros_without(w)
    assert z.placements == w.placements and z.dtype == torch.float32


def test_a_kernel_refuses_a_dtensor(one_rank):
    w = SH._dtensor(torch.ones(8), one_rank, (Replicate(), Replicate()),
                    (8,))
    with pytest.raises(TypeError, match="DTensor"):
        library.pointer(w)
    assert library.pointer(torch.ones(8)) != 0


def test_one_rank_mesh_step_equals_the_plain_step(one_rank, tmp_path):
    """A (1, 1) mesh issues every gather and reduction over one rank; the
    step, its checkpoint and its restore through ``reshard_state`` equal
    the plain ones bit for bit."""
    from repro_torch.train.elastic import reshard_state

    cfg = TC.smoke_config("zamba2_7b")
    tc = TrainConfig(grad_accum=2, compute_dtype=torch.float32,
                     opt=OptConfig(lr=1e-3, warmup=2))
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=4)
    plain = init_state(cfg, init_params(
        Transformer(cfg, dtype=torch.float32, device="cpu"), seed=0))
    sharded = init_state(cfg, SH.init_params(
        Transformer(cfg, dtype=torch.float32, device="meta"), seed=0,
        mesh=one_rank))
    assert all(isinstance(p, DTensor) for p in sharded.params.parameters())
    step = make_train_step(cfg, tc)
    sstep = make_train_step(cfg, tc, dp_axes=SH.dp_axes(one_rank),
                            param_specs=SH.param_shardings(sharded.params,
                                                           one_rank))
    assert local_rows(one_rank, 4, 2).tolist() == [0, 1, 2, 3]
    for i in range(2):
        b = make_batch(dc, i, device="cpu")
        plain, m = step(plain, b)
        sharded, ms = sstep(sharded, b)
        assert float(ms["loss"]) == float(m["loss"])
        assert float(ms["grad_norm"]) == float(m["grad_norm"])
    for a, b in zip(CK._leaves(sharded), CK._leaves(plain)):
        np.testing.assert_array_equal(CK._host(a), CK._host(b))
    CK.save_checkpoint(tmp_path, 2, sharded)
    fresh = init_state(cfg, init_params(
        Transformer(cfg, dtype=torch.float32, device="cpu"), seed=1))
    back, manifest = reshard_state(tmp_path, fresh, one_rank)
    assert manifest["step"] == 2 and back.step == 2
    assert all(isinstance(p, DTensor) for p in back.params.parameters())
    for a, b in zip(CK._leaves(back), CK._leaves(sharded)):
        np.testing.assert_array_equal(CK._host(a), CK._host(b))
    with pytest.raises(ValueError, match="param_specs"):
        make_train_step(cfg, tc, param_specs={
            n: (Replicate(), Replicate())
            for n, _ in sharded.params.named_parameters()})(
                sharded, make_batch(dc, 2, device="cpu"))


class _RankView:
    """Rank ``index`` of ``ranks`` that split a micro-batch's rows, as
    ``layers.TOKEN_SPLIT`` reads them, on this process: ``gather`` keeps
    what this rank sends and returns ``every`` (all ranks' tensors, in
    order), or, before those are known, this rank's repeated."""

    def __init__(self, ranks, index, every=None):
        self.ranks, self.index, self.every = ranks, index, every

    def gather(self, t):
        self.sent = t
        return t.repeat(self.ranks, 1) if self.every is None else self.every


def _split_run(layer, xs, token_chunk, every=None):
    """Each rank's output and what it sent to the gather."""
    ys, sent = [], []
    for r, x in enumerate(xs):
        view = _RankView(len(xs), r, every)
        token = TL.TOKEN_SPLIT.set(view)
        try:
            ys.append(layer(x, token_chunk=token_chunk))
        finally:
            TL.TOKEN_SPLIT.reset(token)
        sent.append(view.sent)
    return ys, sent


@pytest.mark.parametrize("ranks,rows,S,chunk", [
    (2, 1, 24, 8192),   # one chunk, half on each rank
    (4, 1, 12, 16),     # chunks straddle ranks
    (2, 2, 12, 16),     # a rank holds a whole chunk and parts of two
    (3, 1, 16, 16),     # a chunk a rank
], ids=["one-chunk", "straddle", "parts", "aligned"])
def test_moe_routes_the_global_chunks_across_ranks(ranks, rows, S, chunk):
    """Grok-1's smoke MoE at capacity factor 1 (the capacity binds): the
    ranks' outputs, concatenated, equal one process's on the whole
    micro-batch; routing each rank's rows alone does too only where no
    chunk spans ranks."""
    cfg = TC.smoke_config("grok1_314b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0))
    layer = TL.MoE(cfg, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(ranks * 100 + S)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(
                tuple(p.shape)).astype(np.float32)) / p.shape[-2] ** 0.5)
    x = torch.from_numpy(rng.standard_normal(
        (ranks * rows, S, cfg.d_model)).astype(np.float32))
    want = layer(x, token_chunk=chunk)
    xs = list(x.split(rows))
    _, sent = _split_run(layer, xs, chunk)
    ys, _ = _split_run(layer, xs, chunk, every=torch.cat(sent))
    np.testing.assert_allclose(torch.cat(ys).numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)
    tc = min(chunk, ranks * rows * S)
    xt = x.reshape(-1, cfg.d_model)
    dropped = sum(int((~layer.route(xt[c:c + tc])[3]).sum())
                  for c in range(0, len(xt), tc))
    assert dropped > 0  # the capacity binds
    n = rows * S
    if n % min(chunk, n) == 0:  # else a rank alone cannot chunk its rows
        alone = torch.cat([layer(xr, token_chunk=chunk) for xr in xs])
        # the same only where every chunk lies on one rank
        assert torch.allclose(alone, want, rtol=1e-6, atol=1e-6) == (tc <= n)


def test_gathered_splits_tokens_only_over_dp_ranks(one_rank):
    """A block of a model on a mesh whose dp axes hold one rank runs with
    no split (the one-process routing)."""
    model = Transformer(TC.smoke_config("grok1_314b"), dtype=torch.float32,
                        device="meta")
    SH.init_params(model, seed=0, mesh=one_rank)
    assert SH.Gathered(model, SH.dp_axes(one_rank)).split is None
    split = SH.TokenSplit(one_rank, ("data",))
    assert (split.ranks, split.index) == (1, 0)
    t = torch.arange(6).reshape(3, 2)
    assert torch.equal(split.gather(t), t)
