"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's ``repro.launch.dryrun``.

* ``input_specs`` and ``state_specs`` of every cell on both production
  meshes equal the reference's (its side in a subprocess over 512 host
  devices, as ``tests/test_distributed.py`` runs its snippets) in global
  shape and dtype, and in placement but for what the port lays out
  otherwise: the caches are replicated over "model" (every "model" rank
  computes whole heads), an optimizer leaf takes its own parameter's
  layout (the reference's takes that of the first parameter of its
  shape, and replicates Adafactor's factored statistics), and Mamba-2's
  conv cache is in the model's dtype (the reference's ``init_caches`` makes
  it float32).  The ``long_500k`` decode cells (one row against the data
  ranks, the reference's ``long_ctx``) split their KV caches along the
  sequence over the data axes, then "model", as the reference's; their
  other states are replicated (the reference's with "model" dropped, as
  the row-split cells' are).
* Smoke configs on a fake (2, 2) mesh: the argument bytes are the sum of
  the local shards, and the collectives counted in a step are those
  ``parallel.sharding.Gathered``'s rules give.
* ``run_cell`` on one cell of the fake 256-rank mesh, and ``run_fv3`` on a
  small cubed sphere, record what rank 0 holds and issues: the FV3 step's
  collective-permutes are the halo strips rank 0 receives.
* The dry run's one-step sLSTM scan gives the real scan's shapes.
* The fake process group is imported only by the dry run's entry.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs as TC
from repro_torch.launch import dryrun as D
from repro_torch.models import transformer as TT
from repro_torch.models.config import SHAPE_BY_NAME
from repro_torch.models.weights import reference_paths
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding as SH
from repro_torch.train import optimizer as TO

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod16x16": False, "pod2x16x16": True}

REFERENCE = r"""
import json, sys
from repro.launch import dryrun as RD  # sets 512 host devices first
import jax
from repro.configs import ARCH_IDS, get_config
from repro.launch.mesh import make_production_mesh
from repro.models.config import SHAPE_BY_NAME

def flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                       for k in path)
        spec = [None if e is None else
                ([e] if isinstance(e, str) else list(e))
                for e in leaf.sharding.spec]
        out[key] = [list(leaf.shape), str(leaf.dtype), spec]
    return out

out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for a in ARCH_IDS:
        arch = get_config(a)
        st = RD.state_specs(arch, mesh)
        out[f"{mp}/{a}/params"] = flat(st.params)
        out[f"{mp}/{a}/opt"] = {f: flat(getattr(st.opt, f))
                                for f in st.opt._fields}
        for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            out[f"{mp}/{a}/{s}"] = flat(RD.input_specs(
                arch, SHAPE_BY_NAME[s], mesh))
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def fake():
    """The fake process groups of the module, torn down after it."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _spec(t) -> list:
    """A DTensor's placements as the reference's spec: for each tensor
    dimension the mesh axes that split it, in the mesh's order."""
    names = t.device_mesh.mesh_dim_names
    out = [[] for _ in range(t.ndim)]
    for i, p in enumerate(t.placements):
        if p.is_shard():
            out[p.dim].append(names[i])
    return out


def _norm(spec, drop=()) -> list:
    """A reference spec as lists of axes, the axes in ``drop`` left out."""
    return [[a for a in (e or []) if a not in drop] for e in spec]


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _same(t, want, *, stacked=False, drop=(), dtype=True):
    shape, wdtype, spec = want
    spec = spec + [None] * (len(shape) - len(spec))  # P(): all replicated
    if stacked:  # the reference's leading layer axis
        shape, spec = shape[1:], spec[1:]
    assert list(t.shape) == shape
    if dtype:
        assert _dtype(t) == wdtype, (_dtype(t), wdtype)
    assert _spec(t) == _norm(spec, drop), (_spec(t), spec)


def _cache_keys(cfg) -> list:
    """The reference's cache key of each entry of the port's list."""
    slots = [s for s, _ in TT.mixer_slots(cfg)]
    order = (["shared"] if "shared_attn" in cfg.pattern else []) + slots
    return order * cfg.n_groups


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_specs_equal_the_reference_s(reference, fake, arch, mesh_name):
    mp = MESHES[mesh_name]
    mesh = D.production_mesh(mp)
    cfg = TC.get_config(arch)
    # the training state
    state = D.state_specs(cfg, mesh)
    ref_params = reference[f"{mp}/{arch}/params"]
    ref_paths = {name: (path, g) for name, path, g in
                 reference_paths(state.params)}
    params = dict(state.params.named_parameters())
    assert len({"/".join(p) for p, _ in ref_paths.values()}) == len(
        ref_params)
    for name, p in params.items():
        path, g = ref_paths[name]
        _same(p, ref_params["/".join(path)], stacked=g >= 0)
    for field in state.opt._fields:
        want = reference[f"{mp}/{arch}/opt"][field]
        got = getattr(state.opt, field)
        if field == "count":
            assert list(got.shape) == want[""][0]
            continue
        for key, x in got.items():
            w = want[key]
            ts = x if isinstance(x, list) else [x]
            shape = ([len(ts)] if isinstance(x, list) else []) + list(
                ts[0].shape)
            assert shape == w[0] and _dtype(ts[0]) == w[1], (key, field)
            if field in ("m", "v") and TC.get_config(arch).optimizer == \
                    "adamw":  # each as its parameter
                p = ref_params[key]
                for t in ts:
                    _same(t, p, stacked=isinstance(x, list))
    # the inputs of each cell
    n_dp = math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for a in SH.dp_axes(mesh))
    for s in D.SHAPE_NAMES:
        shape = SHAPE_BY_NAME[s]
        want = reference[f"{mp}/{arch}/{s}"]
        long_ctx = shape.kind == "decode" and shape.global_batch < n_dp
        got = D.input_specs(cfg, shape, mesh)
        caches = got.pop("caches", [])
        for k, t in got.items():
            _same(t, want[k])
        if shape.kind != "decode":
            continue
        keys = _cache_keys(cfg)
        assert len(caches) == len(keys)
        for i, (c, key) in enumerate(zip(caches, keys)):
            g = i // (len(keys) // cfg.n_groups)
            for leaf, t in c.items():
                w = want[f"caches/{key}/{leaf}"]
                split = long_ctx and leaf in ("k", "v")
                if split:  # the slots over the data axes, then "model"
                    assert w[2][2] == list(SH.dp_axes(mesh)) + ["model"]
                _same(t, w, stacked=True, drop=() if split else ("model",),
                      dtype=not (leaf == "conv"))
                assert g < w[0][0]
        assert {f"caches/{k}/{leaf}" for k, c in zip(keys, caches)
                for leaf in c} == {k for k in want if k.startswith("caches")}


SMOKE = ("granite_8b", "zamba2_7b", "grok1_314b", "gemma2_2b",
         "xlstm_1p3b")


def _smoke_mesh():
    from repro_torch.launch.mesh import device_mesh

    D.fake_group(4)
    return device_mesh((2, 2), ("data", "model"), device_type="cpu")


def _gathers(t) -> int:
    """All-gathers of one gather of ``t``: one per split placement."""
    return sum(p.is_shard() for p in t.placements)


def _rank0_bytes(t) -> int:
    """Rank 0's bytes of ``t`` from its global shape and placements: the
    first of torch.chunk's parts of each split dimension."""
    shape = list(t.shape)
    for i, p in enumerate(t.placements):
        if p.is_shard():
            shape[p.dim] = -(-shape[p.dim] // t.device_mesh.size(i))
    return math.prod(shape) * t.element_size()


class _Apart:
    """The optimizer's own reductions, counted apart."""

    def __init__(self):
        self.kinds = []

    def record(self, kind, t, calls=1):
        self.kinds.append(kind)


@pytest.mark.parametrize("arch", SMOKE)
def test_smoke_cells_on_a_fake_2x2_mesh(fake, arch, monkeypatch):
    from repro_torch.train.train_step import TrainConfig, make_train_step

    mesh = _smoke_mesh()
    cfg = TC.smoke_config(arch)
    A, B, S = 2, 8, 32
    rows = torch.empty((B // 2, S), dtype=torch.int32, device="meta")
    apart = _Apart()
    monkeypatch.setattr(TO, "collectives", apart)
    state = D.state_specs(cfg, mesh)
    params = dict(state.params.named_parameters())
    # argument bytes: rank 0's shards by the placements
    want = sum(_rank0_bytes(p) for p in params.values())
    assert D.local_bytes(state.params) == want
    if cfg.optimizer == "adamw":  # m and v as the masters, and the count
        assert D.local_bytes(state) == 3 * want + 4
    # a training step: every block weight gathered at each use and again
    # in the recomputation, the top ones once a micro-batch; each
    # gradient reduced once a micro-batch over "data"
    step = make_train_step(cfg, TrainConfig(grad_accum=A), backend="ref",
                           param_specs=SH.param_shardings(state.params, mesh))
    collectives.reset()
    with D.one_step_scans():
        step(state, {"tokens": rows, "labels": rows})
    got = collectives.summary()["counts"]
    top = [params[n] for n in ("embed", "final_norm", "unembed")
           if n in params]
    blocks = sum(_gathers(p) for blk in state.params.stack()
                 for p in blk.parameters())
    remat = 2 if cfg.remat == "block" else 1
    # a mixture of experts gathers its rows' expert choices over "data"
    # (layers.TOKEN_SPLIT) once a layer
    moe = cfg.n_layers if cfg.moe is not None else 0
    assert got["all-gather"] == A * (sum(_gathers(p) for p in top)
                                     + remat * (blocks + moe))
    by_data = [p.placements[0].is_shard() for p in params.values()]
    assert got["reduce-scatter"] == A * sum(by_data)
    # the gradients replicated over "data" all-reduced, then the loss once
    assert got["all-reduce"] == A * (len(by_data) - sum(by_data)) + 1
    assert got["collective-permute"] == got["all-to-all"] == 0
    assert apart.kinds and set(apart.kinds) == {"all-reduce"}
    # serving: every weight gathered once at each use, nothing reduced
    model = D.abstract_model(cfg, mesh, torch.bfloat16)
    mparams = dict(model.named_parameters())
    assert D.local_bytes(model) == sum(_rank0_bytes(p)
                                       for p in mparams.values())
    top = [mparams[n] for n in ("embed", "unembed") if n in mparams]
    blocks = sum(_gathers(p) for blk in model.stack()
                 for p in blk.parameters())
    for kind in ("prefill", "decode"):
        collectives.reset()
        with torch.no_grad(), D.one_step_scans():
            if kind == "prefill":
                TT.prefill(model, rows, backend="ref")
            else:
                caches = TT.init_caches(cfg, B // 2, S, device="meta")
                TT.decode_step(model, rows[:, :1], caches, S - 1,
                               backend="ref")
        got = collectives.summary()["counts"]
        assert got["all-gather"] == sum(_gathers(p) for p in top) + \
            blocks + moe
        assert got["reduce-scatter"] == got["all-reduce"] == 0


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    return [tree]


def test_run_cell_records_a_cell_of_the_256_rank_mesh(fake, tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(D, "RESULTS", tmp_path)
    rec = D.run_cell("granite_8b", "decode_32k", multi_pod=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["n_devices"] == 256
    saved = json.loads((tmp_path / "granite_8b__decode_32k__pod16x16.json")
                       .read_text())
    assert saved == rec
    # rank 0's shards of the weights, the caches, the token and position
    mesh = D.production_mesh(False)
    cfg = TC.get_config("granite_8b")
    model = D.abstract_model(cfg, mesh, torch.bfloat16)
    ins = D.input_specs(cfg, SHAPE_BY_NAME["decode_32k"], mesh)
    want = sum(_rank0_bytes(t) for t in
               list(model.parameters()) + _leaves(ins))
    assert rec["memory"]["argument_bytes"] == want
    # every weight gathered once, nothing reduced
    counts = rec["collectives"]["counts"]
    assert counts["all-gather"] == sum(_gathers(p)
                                       for p in model.parameters())
    assert counts["all-reduce"] == counts["reduce-scatter"] == 0
    assert counts["collective-permute"] == counts["all-to-all"] == 0


def test_run_fv3_counts_rank_0_s_halo_strips(fake, tmp_path, monkeypatch):
    from repro_torch.fv3 import dyncore
    from repro_torch.fv3.dyncore import FV3Config

    cfg = FV3Config(npx=12, nk=4, halo=6, layout=(1, 1), n_split=1,
                    k_split=1)
    monkeypatch.setattr(D, "RESULTS", tmp_path)
    monkeypatch.setattr(D, "fv3_config", lambda multi_pod: cfg)
    exchanged = []
    make = dyncore.make_halo_exchanger

    def counting(dec, mesh=None):
        exchange = make(dec, mesh)

        def wrapped(fields, vector_pairs=()):
            exchanged.extend(fields.values())
            return exchange(fields, vector_pairs)
        return wrapped

    monkeypatch.setattr(dyncore, "make_halo_exchanger", counting)
    rec = D.run_fv3(multi_pod=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh"] == "fv3_6x1x1" and rec["n_devices"] == 6
    assert (tmp_path / "fv3__npx12x4__fv3_6x1x1.json").exists()
    # rank 0 holds one whole tile and receives, for every field it
    # exchanges, a strip across each of its 4 edges from the tile beyond:
    # h rows of the interior along W and E, of the padded width along S
    # and N
    h, nl = cfg.halo, cfg.npx
    want = sum(math.prod(f.shape[:-2]) * h * (2 * nl + 2 * (nl + 2 * h))
               * f.element_size() for f in exchanged)
    got = rec["collectives"]
    assert exchanged and got["counts"]["collective-permute"] == \
        4 * len(exchanged)
    assert got["bytes"]["collective-permute"] == want == got["total_bytes"]


def test_one_step_scan_keeps_the_scan_s_shapes():
    from repro_torch.models.xlstm import SLSTM

    cfg = TC.smoke_config("xlstm_1p3b")
    cell = SLSTM(cfg, dtype=torch.bfloat16, device="meta")
    x = torch.empty((2, 16, cfg.d_model), dtype=torch.bfloat16,
                    device="meta")
    real, real_state = cell(x, return_state=True)
    with D.one_step_scans():
        meta, meta_state = cell(x, return_state=True)
    assert (meta.shape, meta.dtype) == (real.shape, real.dtype)
    for k in real_state:
        assert (meta_state[k].shape, meta_state[k].dtype) == \
            (real_state[k].shape, real_state[k].dtype)


def test_the_fake_backend_is_imported_only_by_the_dry_run_s_entry():
    code = ("import sys, repro_torch.launch.dryrun, "
            "repro_torch.launch.roofline, repro_torch.launch.costmodel, "
            "repro_torch.launch.hillclimb; "
            "bad = [m for m in sys.modules if 'fake_pg' in m or "
            "m.split('.')[0] in ('jax', 'repro')]; assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
