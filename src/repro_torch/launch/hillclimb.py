"""Hillclimbs on three cells, as the reference's ``launch/hillclimb.py``:
a hypothesis, a change, the change run, a verdict.

  H1 zamba2_7b x long_500k (decode): int8 weights, then int8 KV caches.
  H2 xlstm_1p3b x prefill_32k: the residual stream split along the
     sequence (``seq_shard``), then other meshes, (32, 8) and (64, 4).
  H3 command_r_plus_104b x train_4k: ``remat="dots"``, then ``grad_accum``
     16 -> 8.

The reference lowers and compiles each variant with XLA on 512 host
devices and reads its memory analysis and partitioned HLO.  The port runs
each variant through its dry run instead (:mod:`.dryrun`): rank 0 of the
fake 256-rank mesh, on meta tensors, the plain versions passed
(``backend="ref"``).  Each run records

  * the collectives the step issued (:mod:`..parallel.collectives`: kind,
    count, bytes), and rank 0's argument and output bytes;
  * for H3, the bytes one micro-batch's forward keeps for its backward
    (:class:`..models.remat.SavedBytes`, from the local shapes): the
    port's stand-in for XLA's memory analysis, and what ``"dots"``
    changes.

The before and after terms are the cost model's (:mod:`.costmodel`) over
:mod:`.roofline`'s H100 constants: compute over ``PEAK_FLOPS``, HBM bytes
over ``HBM_BW``, collective bytes over the production mesh's
``link_bw``.  Every verdict and lesson is computed from these records.
H2's second iteration in the reference (bf16 hints to XLA's partitioner)
has no counterpart here and is recorded as such.

A record has the reference's keys; where the reference reads XLA
(``compiled``; ``memory_analysis``, before and after the change) the port
puts its dry run's record, and H2's mesh iteration reports argument bytes
where the reference reports XLA's temporaries (the dry run estimates
none).

Run: python -m repro_torch.launch.hillclimb [--which h1|h2|h3|all]
(CPU, a few minutes; results/torch_hillclimb.json).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

from ..configs import get_config
from ..models import transformer as T
from ..models.config import SHAPE_BY_NAME
from ..models.remat import SavedBytes
from ..parallel import collectives
from ..parallel import sharding as SH
from ..serve.quantize import abstract_quantized
from ..train.train_step import TrainConfig, make_train_step
from . import dryrun as D
from .costmodel import cell_cost
from .mesh import device_mesh
from .roofline import CHIPS, HBM_BW, HBM_BYTES, MESH, PEAK_FLOPS, link_bw

RESULTS = Path(__file__).resolve().parents[3] / "results"
#: the reference's bar: a change that moves its term by less is not kept
BAR = 0.05


def _terms(cost) -> dict:
    return {"compute_s": cost.flops / (CHIPS * PEAK_FLOPS),
            "memory_s": cost.hbm_bytes / (CHIPS * HBM_BW),
            "collective_s": cost.coll_bytes / (CHIPS * link_bw(MESH))}


def _dry(run, args) -> dict:
    """One run of a variant as rank 0: its collectives, its argument and
    output bytes, its wall time."""
    t0 = time.time()
    collectives.reset()
    with D.one_step_scans():
        out = run()
    return {"memory": {"argument_bytes": D.local_bytes(args),
                       "output_bytes": D.local_bytes(out)},
            "collectives": collectives.summary(),
            "run_s": round(time.time() - t0, 1)}


def _gain(before: float, after: float) -> float:
    return 1.0 - after / before


def _verdict(ok: bool) -> str:
    return "CONFIRMED" if ok else "REFUTED"


def _kv_read(arch, shape) -> float:
    """The KV caches' part of the cost model's decode ``cache_hbm`` (its
    attention terms)."""
    B, S = shape.global_batch, shape.seq_len
    n = 0.0
    for b in arch.pattern:
        if b in ("attn", "shared_attn"):
            n += arch.n_groups * B * S * 2 * arch.kv_dim
        elif b == "local":
            n += arch.n_groups * B * min(arch.window or S, S) \
                * 2 * arch.kv_dim
    return n


def _global_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def h1_int8_decode() -> dict:
    """zamba2 x long_500k: int8 weights, then an int8 KV cache."""
    arch = get_config("zamba2_7b")
    shape = SHAPE_BY_NAME["long_500k"]
    mesh = D.production_mesh(False)
    base = cell_cost(arch, shape, CHIPS)
    before = _terms(base)
    ins = D.input_specs(arch, shape, mesh)
    qmodel = abstract_quantized(arch, mesh, torch.bfloat16)

    def decode(caches):
        def run():
            with torch.no_grad():
                return T.decode_step(qmodel, SH.local(ins["token"]),
                                     D.decode_caches(caches),
                                     shape.seq_len - 1, backend="ref",
                                     quantized=True)
        return run

    qtensors = [*qmodel.q.values(), *qmodel.s.values(),
                *qmodel.plain.values()]
    rec1 = _dry(decode(ins["caches"]), (qtensors, ins))
    # iteration 1: the weights' bf16 bytes replaced by the int8 model's
    P = T.count_params(arch)
    int8_bytes = _global_bytes(qtensors)
    after1 = dict(before)
    after1["memory_s"] = (base.hbm_bytes - 2 * P + int8_bytes) \
        / (CHIPS * HBM_BW)
    gain1 = _gain(before["memory_s"], after1["memory_s"])
    kv = _kv_read(arch, shape)
    # iteration 2: int8 KV caches (float32 per-head scales), split as the
    # bf16 ones
    qcaches = D.abstract_caches(T.init_caches(
        arch, shape.global_batch, shape.seq_len, device="meta",
        quant_kv=True), mesh)
    ins2 = dict(ins, caches=qcaches)
    rec2 = _dry(decode(qcaches), (qtensors, ins2))

    def kv_bytes(caches):
        return sum(D.local_bytes(t) for c in caches for k, t in c.items()
                   if k in ("k", "v", "k_s", "v_s"))

    ratio = kv_bytes(qcaches) / kv_bytes(ins["caches"])
    after2 = dict(after1)
    after2["memory_s"] = after1["memory_s"] - kv * (1 - ratio) \
        / (CHIPS * HBM_BW)
    ok1 = gain1 >= BAR
    return {
        "cell": "zamba2_7b × long_500k",
        "iterations": [
            {"hypothesis": ("decode is memory-bound on weight reads; int8 "
                            "weights halve the weights' bytes"),
             "change": ("int8 weight-only quantization on the mesh "
                        "(serve.quantize.shard_quantized), dequantized "
                        "at use"),
             "before": before, "after": after1,
             "confirmed": ok1,
             "lesson": (f"{_verdict(ok1)}: the memory term moves by "
                        f"{gain1:.1%}: the int8 model is {int8_bytes:.3e} B "
                        f"against {2 * P:.3e} B of bf16 weights, in "
                        f"{base.hbm_bytes:.3e} B read a step, of which the "
                        f"KV caches are {kv / base.hbm_bytes:.1%}"),
             "compiled": rec1},
            {"hypothesis": ("the KV caches dominate the step's HBM reads; "
                            "int8 KV with per-head scales halves them"),
             "change": ("init_caches(quant_kv=True), split along the "
                        "sequence as the bf16 caches; int8 read path in "
                        "Attention.decode"),
             "before": after1, "after": after2,
             "confirmed": after2["memory_s"] < 0.7 * after1["memory_s"],
             "compiled": rec2},
        ],
        "before": before, "after": after2,
    }


def _prefill(arch, shape, mesh, *, seq_shard=False) -> dict:
    model = D.abstract_model(arch, mesh, torch.bfloat16)
    ins = D.input_specs(arch, shape, mesh)

    def run():
        with torch.no_grad():
            return T.prefill(model, SH.local(ins["tokens"]), backend="ref",
                             seq_shard=seq_shard)
    return _dry(run, (model, ins))


def h2_seq_parallel_prefill() -> dict:
    """xlstm x prefill_32k: the stream split along the sequence, then
    other meshes."""
    arch = get_config("xlstm_1p3b")
    shape = SHAPE_BY_NAME["prefill_32k"]
    mesh = D.production_mesh(False)
    rec_base = _prefill(arch, shape, mesh)
    rec_sp = _prefill(arch, shape, mesh, seq_shard=True)
    cb = rec_base["collectives"]["total_bytes"]
    ca = rec_sp["collectives"]["total_bytes"]
    ok1 = ca < (1 - BAR) * cb
    gathers = (rec_sp["collectives"]["counts"]["all-gather"]
               - rec_base["collectives"]["counts"]["all-gather"])
    totals = {"16x16": cb}
    args = {"16x16": rec_base["memory"]["argument_bytes"]}
    for shp in ((32, 8), (64, 4)):
        D.fake_group(CHIPS)
        m = device_mesh(shp, ("data", "model"), device_type="cpu")
        rec = _prefill(arch, shape, m)
        name = f"{shp[0]}x{shp[1]}"
        totals[name] = rec["collectives"]["total_bytes"]
        args[name] = rec["memory"]["argument_bytes"]
    best = min(totals, key=totals.get)
    ok3 = totals[best] < (1 - BAR) * cb
    base = cell_cost(arch, shape, CHIPS)
    before = _terms(base)
    refuted = 3 - ok1 - ok3
    return {
        "cell": "xlstm_1p3b × prefill_32k",
        "iterations": [
            {"hypothesis": ("the residual stream's collectives dominate; "
                            "splitting it along the sequence over "
                            "\"model\" cuts them"),
             "change": "seq_shard=True (gathered at each block's entry, "
                       "split at its exit)",
             "measured": {"coll_bytes_before": cb, "coll_bytes_after": ca},
             "confirmed": ok1,
             "lesson": (f"{_verdict(ok1)}: the split adds {gathers} "
                        f"all-gathers of the stream, {ca - cb:.3e} B; the "
                        f"{cb:.3e} B before it are the weights' gathers: "
                        "every model rank gathers whole weights and runs "
                        "whole blocks, so the split moves activation "
                        "memory, not collective bytes")},
            {"hypothesis": ("keeping collective-crossing tensors bf16 "
                            "halves the gather bytes"),
             "change": "bf16 mLSTM state einsum inputs, bf16 sLSTM h",
             "measured": {"coll_bytes_after": None},
             "confirmed": False,
             "lesson": ("no counterpart: the port gathers weights, not "
                        "q/k/v, and its gathers carry the weights' "
                        "dtype")},
            {"hypothesis": ("fewer model ranks, (32, 8) or (64, 4), cut "
                            "the collectives"),
             "change": "mesh reshape (16,16) → (32,8) → (64,4)",
             "measured": {
                 "coll_total_GB": {k: v / 1e9 for k, v in totals.items()},
                 "argument_GB": {k: v / 1e9 for k, v in args.items()}},
             "confirmed": ok3,
             "lesson": (f"{_verdict(ok3)}: " + ", ".join(
                 f"{k} {v:.3e} B" for k, v in totals.items())
                 + f" of collectives a prefill; rank 0 holds "
                 + ", ".join(f"{k} {v:.3e} B" for k, v in args.items()))},
        ],
        "stop_rule": (f"{refuted} of 3 iterations below the {BAR:.0%} bar"
                      + ("; stopped" if refuted == 3 else "")),
        "future_work": ("blocks split over \"model\" (Megatron style; "
                        "ROADMAP 12k-b): every model rank computes whole "
                        "blocks today, so no layout of the stream moves "
                        "the weights' gathers"),
        "before": before,
        "after": before,
    }


def _train(arch, mesh, shape, A: int) -> tuple[dict, SavedBytes]:
    """A training step of ``arch`` at ``grad_accum`` A as rank 0, and the
    bytes its first micro-batch's forward keeps for the backward."""
    dps = SH.dp_axes(mesh)
    ins = D.input_specs(arch, shape, mesh)
    state = D.state_specs(arch, mesh)
    step = make_train_step(arch, TrainConfig(grad_accum=A), backend="ref",
                           dp_axes=dps,
                           param_specs=SH.param_shardings(state.params,
                                                          mesh))
    batch = D._rank_batch(ins, mesh, A)
    rec = _dry(lambda: step(state, batch), (state, ins))
    mb = batch["tokens"].shape[0] // A
    net = SH.Gathered(state.params, dps)
    with SavedBytes() as saved, D.one_step_scans():
        T.loss_fn(net, batch["tokens"][:mb], batch["labels"][:mb],
                  backend="ref")
    rec["memory"]["saved_for_backward_bytes"] = saved.bytes
    return rec, saved


def h3_remat_and_accum() -> dict:
    """command-r x train_4k: ``remat="dots"``, then a smaller
    ``grad_accum``."""
    arch = get_config("command_r_plus_104b")
    shape = SHAPE_BY_NAME["train_4k"]
    mesh = D.production_mesh(False)
    base = cell_cost(arch, shape, CHIPS, grad_accum=16)
    before = _terms(base)
    rec0, _ = _train(arch, mesh, shape, 16)
    # iteration 1: the recomputation keeps the block stack's products
    arch2 = dataclasses.replace(arch, remat="dots")
    rec1, saved1 = _train(arch2, mesh, shape, 16)
    c = base.components
    after1 = dict(before)
    after1["compute_s"] = (base.flops - c["linear_flops"]) \
        / (CHIPS * PEAK_FLOPS)
    gain1 = _gain(before["compute_s"], after1["compute_s"])
    ok1 = gain1 >= BAR and saved1.bytes < HBM_BYTES
    # iteration 2: grad_accum 16 -> 8
    base8 = cell_cost(arch, shape, CHIPS, grad_accum=8)
    after2 = _terms(base8)
    after2["compute_s"] = after1["compute_s"]
    rec2, saved2 = _train(arch2, mesh, shape, 8)
    ok2 = (after2["collective_s"] < after1["collective_s"]
           and saved2.bytes < HBM_BYTES)
    return {
        "cell": "command_r_plus_104b × train_4k",
        "iterations": [
            {"hypothesis": ("the compute term carries the block stack's "
                            "forward again (remat \"block\"); keeping the "
                            "products' outputs removes its matmuls for "
                            "memory"),
             "change": "remat \"block\" → \"dots\" (aten.mm/addmm outputs "
                       "kept)",
             "before": before, "after": after1,
             "memory_analysis": {"before": rec0["memory"],
                                 "after": rec1["memory"]},
             "confirmed": ok1},
            {"hypothesis": ("the weights are gathered once a micro-batch; "
                            "halving grad_accum halves the gathers if the "
                            "activations still fit"),
             "change": "grad_accum 16 → 8",
             "before": after1, "after": after2,
             "memory_analysis": {"before": rec1["memory"],
                                 "after": rec2["memory"]},
             "confirmed": ok2},
        ],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--which", default="all",
                    choices=("h1", "h2", "h3", "all"))
    args = ap.parse_args(argv)
    out = {}
    for name, fn in (("h1", h1_int8_decode), ("h2", h2_seq_parallel_prefill),
                     ("h3", h3_remat_and_accum)):
        if args.which in (name, "all"):
            out[name] = fn()
            print(json.dumps(out[name], indent=1, default=str), flush=True)
    RESULTS.mkdir(parents=True, exist_ok=True)
    path = RESULTS / "torch_hillclimb.json"
    existing = json.loads(path.read_text()) if path.exists() else {}
    existing.update(out)
    path.write_text(json.dumps(existing, indent=1, default=str))
    return out


if __name__ == "__main__":
    main()
