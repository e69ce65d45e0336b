"""Multi-pod dry run, as the reference's ``launch/dryrun.py``: the step of
every (architecture x shape x mesh) cell run once as rank 0 of the
production mesh, on meta tensors: nothing is allocated and no card is
needed.

The reference lowers and compiles each cell with XLA over 512 host
devices and reads XLA's memory and cost analyses and its partitioned HLO.
The port has neither.  In their place:

  * the mesh is :func:`.mesh.make_production_mesh` on a fake process group
    of 256 (or 512) ranks (PyTorch's ``"fake"`` backend: every collective
    completes at once and moves nothing), made only here, at the entry;
  * the states are :func:`..parallel.sharding.abstract_model`'s: meta-device
    ``DTensor``s with the global shapes and the reference's placements;
  * the step (``train.train_step.make_train_step``, or ``prefill`` /
    ``decode_step`` on the mesh) runs once on rank 0's shards, with the
    plain versions passed explicitly (``backend="ref"``) and sLSTM's scan
    taken one step for all (:func:`one_step_scans`);
  * a record holds the collectives the step issued
    (:mod:`..parallel.collectives`: kind, count and result bytes), the
    argument and output bytes of rank 0, exact from the local shapes, and
    the run's wall time.  Temporary bytes are not estimated.

Where the port's cells differ from the reference's:

  * every "model" rank computes whole heads (``parallel.sharding.Gathered``),
    so the caches are replicated over "model", where the reference splits
    them over it;
  * a training cell whose micro-batch has fewer rows than there are data
    ranks (the multi-pod mesh at ``grad_accum`` 16) gives one row of each
    micro-batch to each of the first ranks, as ``torch.chunk`` splits it,
    and none to the others: rank 0 runs one row a micro-batch.

The ``long_500k`` decode cells (one row against 16 or 32 data ranks) split
their KV caches along the sequence over the data axes, then "model", as
the reference's ``long_ctx`` does (``parallel.sharding.split_caches``);
their recurrent states are replicated and every rank decodes the same row.

Usage:
    python -m repro_torch.launch.dryrun --arch granite_8b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--fv3]
Results land in results/torch_dryrun/<arch>__<shape>__<mesh>.json.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch

from ..configs import ARCH_IDS, get_config
from ..models import transformer as T
from ..models import xlstm
from ..models.config import SHAPE_BY_NAME, ArchConfig, ShapeSpec
from ..models.weights import param_tree
from ..parallel import collectives
from ..parallel import sharding as SH
from ..train.optimizer import opt_init
from ..train.train_step import TrainConfig, TrainState, make_train_step

RESULTS = Path(__file__).resolve().parents[3] / "results" / "torch_dryrun"
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def fake_group(world: int) -> None:
    """Make the default process group a fake one of ``world`` ranks, this
    process rank 0 (an existing fake group of another size is replaced)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def production_mesh(multi_pod: bool):
    """The production mesh on a fake process group of its size."""
    from .mesh import make_production_mesh

    fake_group(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def _n_dp(mesh) -> int:
    names = mesh.mesh_dim_names
    return math.prod(mesh.size(names.index(a)) for a in SH.dp_axes(mesh))


def local_bytes(tree) -> int:
    """The bytes this rank holds of every tensor in ``tree`` (nested
    dicts, lists, tuples, a model's parameters; a training state: its
    masters' and optimizer state's shards): a ``DTensor``'s local shard,
    a plain tensor whole."""
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    if isinstance(tree, torch.Tensor):
        t = SH.local(tree)
        return t.numel() * t.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(x) for x in tree)
    return 0


# ---------------------------------------------------------------------------
# input_specs / state_specs: meta-device DTensor stand-ins
# ---------------------------------------------------------------------------


def input_specs(arch: ArchConfig, shape: ShapeSpec, mesh) -> dict:
    """Abstract inputs of the cell (meta ``DTensor``s: global shape, dtype
    and placements, the reference's): the token ids int32 split over the
    data axes; a decode cell's caches (:func:`..models.init_caches`' list,
    one per block application) split over them along their rows and
    replicated over "model", its token and position.  A decode cell with
    fewer rows than data ranks (the reference's ``long_ctx``): the KV
    caches split along their slots (``sharding.cache_spec``), every other
    state and the token replicated."""
    dps = SH.dp_axes(mesh)
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def spec(shp, dtype, *entries):
        return SH.abstract_tensor(shp, dtype, SH.NamedSharding(mesh, entries))

    npre = arch.n_prefix_embeds
    if shape.kind in ("train", "prefill"):
        n = S - npre if npre else S
        specs = {"tokens": spec((B, n), i32, dps, None)}
        if shape.kind == "train":
            specs["labels"] = spec((B, n), i32, dps, None)
        if npre:
            specs["prefix"] = spec((B, npre, arch.d_model), torch.bfloat16,
                                   dps, None, None)
        return specs
    n_dp = _n_dp(mesh)
    caches = abstract_caches(T.init_caches(arch, B, S, device="meta"), mesh)
    return {"token": spec((B, 1), i32, *((dps, None) if B % n_dp == 0
                                         else (None, None))),
            "caches": caches, "pos": spec((), i32)}


def abstract_caches(caches: list, mesh) -> list:
    """Meta ``DTensor`` stand-ins of ``init_caches``' list (on the meta
    device): split over the data axes along their rows, or, for a batch of
    fewer rows than data ranks, each KV cache along its slots
    (``sharding.cache_spec``) and every other leaf replicated."""
    dps = SH.dp_axes(mesh)
    long_ctx = next(iter(caches[0].values())).shape[0] < _n_dp(mesh)

    def layout(k, t):
        if not long_ctx:
            return (dps,) + (None,) * (t.ndim - 1)
        return SH.cache_spec(mesh) if k in ("k", "v") else (None,) * t.ndim

    return [{k: SH.abstract_tensor(tuple(t.shape), t.dtype,
                                   SH.NamedSharding(mesh, layout(k, t)))
             for k, t in c.items()} for c in caches]


def abstract_model(arch: ArchConfig, mesh, dtype) -> T.Transformer:
    """The model of ``arch`` in ``dtype`` (its norm weights float32, as the
    port keeps them) with abstract parameters laid out on ``mesh``."""
    return SH.abstract_model(T.Transformer(arch, dtype=dtype, device="meta"),
                             mesh)


def _one_step_scan(cell, pre, state, r, dtype):
    """:func:`..models.xlstm.scan` on meta tensors, which hold no values:
    its first step stands for the S steps of the same shapes, its graph
    reaching the same weights, so a cell's run does not take S steps."""
    state = cell(pre[:, 0], state, r)
    h = state[0].to(dtype)[:, None]
    return h.expand(-1, pre.shape[1], -1, -1), state


@contextlib.contextmanager
def one_step_scans():
    """sLSTM's scan taken by :func:`_one_step_scan` inside the block."""
    token = xlstm.SCAN.set(_one_step_scan)
    try:
        yield
    finally:
        xlstm.SCAN.reset(token)


def state_specs(arch: ArchConfig, mesh, dtype=torch.float32) -> TrainState:
    """Abstract training state: the masters (:func:`abstract_model` in
    ``dtype``) and the optimizer state of ``arch.optimizer`` on their
    shards (each leaf laid out as its parameter, a factored statistic as
    the dimensions it keeps), at step 0."""
    model = abstract_model(arch, mesh, dtype).requires_grad_(True)
    return TrainState(model, opt_init(arch.optimizer, param_tree(model)), 0)


def grad_accum(arch: ArchConfig) -> int:
    """The reference's ``grad_accum`` of a training cell."""
    return 16 if arch.d_model >= 6000 else 8


def _rank_batch(ins: dict, mesh, A: int) -> dict:
    """Rank 0's rows of a training batch, as ``data.pipeline.shard_batch``
    takes them (mb / D rows of each of the A micro-batches of mb rows; one
    row where mb < D), as meta tensors."""
    D = _n_dp(mesh)
    mb = ins["tokens"].shape[0] // A
    rows = A * max(mb // D, 1)
    return {k: torch.empty((rows,) + tuple(v.shape[1:]), dtype=v.dtype,
                           device="meta") for k, v in ins.items()}


def build_cell(arch_id: str, shape_name: str, mesh):
    """(thunk, arguments): the thunk runs rank 0's step of the cell once on
    meta tensors; the arguments are what it holds (a training state and
    its batch; a serving model and its inputs)."""
    arch = get_config(arch_id)
    shape = SHAPE_BY_NAME[shape_name]
    dps = SH.dp_axes(mesh)
    ins = input_specs(arch, shape, mesh)
    if shape.kind == "train":
        A = grad_accum(arch)
        state = state_specs(arch, mesh)
        step = make_train_step(arch, TrainConfig(grad_accum=A),
                               backend="ref", dp_axes=dps,
                               param_specs=SH.param_shardings(state.params,
                                                              mesh))
        batch = _rank_batch(ins, mesh, A)
        return (lambda: step(state, batch)), (state, ins)
    model = abstract_model(arch, mesh, torch.bfloat16)
    if shape.kind == "prefill":
        prefix = ins.get("prefix")

        def run():
            with torch.no_grad():
                return T.prefill(model, SH.local(ins["tokens"]),
                                 prefix_embeds=(None if prefix is None
                                                else SH.local(prefix)),
                                 backend="ref")
        return run, (model, ins)
    caches = decode_caches(ins["caches"])

    def run():
        with torch.no_grad():
            return T.decode_step(model, SH.local(ins["token"]), caches,
                                 shape.seq_len - 1, backend="ref")
    return run, (model, ins)


def decode_caches(caches: list) -> list:
    """Rank 0's caches of a decode cell as ``decode_step`` takes them: a
    cache split along its slots stays a ``DTensor`` (the decode reads its
    split), every other leaf is this rank's shard."""
    return [{k: t if SH.cache_split(t) else SH.local(t)
             for k, t in c.items()} for c in caches]


def cell_active(arch: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and not arch.long_context_ok:
        return False, ("skipped: pure full-attention arch — 500k decode "
                       "requires sub-quadratic attention")
    return True, ""


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    arch = get_config(arch_id)
    shape = SHAPE_BY_NAME[shape_name]
    active, reason = cell_active(arch, shape)
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "active": active}
    if not active:
        rec["skip_reason"] = reason
        _save(rec)
        return rec
    t0 = time.time()
    try:
        mesh = production_mesh(multi_pod)
        fn, args = build_cell(arch_id, shape_name, mesh)
        collectives.reset()
        with one_step_scans():
            out = fn()
        rec["run_s"] = round(time.time() - t0, 1)
        rec["memory"] = {"argument_bytes": local_bytes(args),
                         "output_bytes": local_bytes(out)}
        rec["collectives"] = collectives.summary()
        rec["n_devices"] = mesh.size()
        rec["ok"] = True
        print(f"[OK] {arch_id} × {shape_name} × {mesh_name}: "
              f"{rec['run_s']}s  args={rec['memory']['argument_bytes']:.3e}B "
              f"coll={rec['collectives']['total_bytes']:.3e}B", flush=True)
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        rec["ok"] = False
        rec["run_s"] = round(time.time() - t0, 1)
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {arch_id} × {shape_name} × {mesh_name}: "
              f"{rec['error']}", flush=True)
    _save(rec)
    return rec


def _save(rec: dict):
    RESULTS.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    (RESULTS / name).write_text(json.dumps(rec, indent=1))


def fv3_config(multi_pod: bool):
    """The reference's FV3 cell: C48 (npx 48), 80 levels, halo 6, layout
    (8, 8), or (6, 6) with an ensemble of 2 on the multi-pod mesh."""
    from ..fv3.dyncore import FV3Config

    return FV3Config(npx=192 // 4, nk=80, halo=6,
                     layout=(6, 6) if multi_pod else (8, 8),
                     n_split=2, k_split=1)


def run_fv3(*, multi_pod: bool) -> dict:
    """The FV3 step on its topology-locked mesh (and an ensemble axis on
    the multi-pod one): ``make_step_distributed`` on the plain lowering,
    on a fake process group with a rank a process.  The state's blocks are
    plain CPU zeros (point-to-point sends take no meta tensor): rank 0
    steps its own 6 x 6 (plus halos) x 80 columns, and the fake receives
    leave its ghosts as they were."""
    from ..fv3.dyncore import all_state_fields, make_step_distributed
    from .mesh import make_fv3_mesh

    cfg = fv3_config(multi_pod)
    py, px = cfg.layout
    mesh_name = f"fv3_ens2x6x{py}x{px}" if multi_pod else f"fv3_6x{py}x{px}"
    rec = {"arch": "fv3", "shape": f"npx{cfg.npx}x{cfg.nk}", "mesh": mesh_name,
           "active": True}
    t0 = time.time()
    try:
        ens = 2 if multi_pod else 1
        fake_group(ens * 6 * py * px)
        mesh = make_fv3_mesh(layout=cfg.layout, ensemble=ens)
        step = make_step_distributed(
            cfg, mesh, backend="torch",
            member_axis="ens" if multi_pod else None, device="cpu")
        nlp = cfg.n_local + 2 * cfg.halo
        shp = ((ens,) if multi_pod else ()) + (6, py, px, cfg.nk, nlp, nlp)
        state = {k: torch.zeros(shp) for k in all_state_fields(cfg)}
        collectives.reset()
        out = step(state)
        rec["run_s"] = round(time.time() - t0, 1)
        per_rank = mesh.size
        rec["memory"] = {"argument_bytes": local_bytes(state) // per_rank,
                         "output_bytes": local_bytes(out) // per_rank}
        rec["collectives"] = collectives.summary()
        rec["n_devices"] = mesh.size
        rec["ok"] = True
        print(f"[OK] fv3 × {mesh_name}: {rec['run_s']}s "
              f"coll={rec['collectives']['total_bytes']:.3e}B", flush=True)
    except Exception as e:  # noqa: BLE001
        rec["ok"] = False
        rec["run_s"] = round(time.time() - t0, 1)
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] fv3 × {mesh_name}: {rec['error']}", flush=True)
    _save(rec)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fv3", action="store_true")
    args = ap.parse_args(argv)

    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]
    results = []
    t0 = time.time()
    if args.fv3:
        for mp in meshes:
            results.append(run_fv3(multi_pod=mp))
    elif args.all:
        for mp in meshes:
            for arch in ARCH_IDS:
                for shape in SHAPE_NAMES:
                    results.append(run_cell(arch, shape, multi_pod=mp))
            results.append(run_fv3(multi_pod=mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all, or --fv3")
        for mp in meshes:
            results.append(run_cell(args.arch, args.shape, multi_pod=mp))
    n_ok = sum(r.get("ok", False) for r in results)
    n_skip = sum(not r["active"] for r in results)
    print(f"\n{n_ok} ok / {n_skip} skipped / "
          f"{len(results) - n_ok - n_skip} failed of {len(results)} in "
          f"{time.time() - t0:.1f} s")
    return results


if __name__ == "__main__":
    main()
