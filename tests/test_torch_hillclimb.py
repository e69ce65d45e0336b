"""The port's hillclimbs (``repro_torch.launch.hillclimb``) on smoke
configs, each variant run through the dry run as rank 0 of the fake
256-rank mesh on meta tensors.

* Every record has the reference's keys (read from the reference's
  ``launch/hillclimb.py`` by its syntax tree, without running it), at the
  top and in each iteration.
* H1 (int8 weights, then int8 KV caches, on caches split along the
  sequence): one all-gather for each split placement of each int8 weight
  and scale at its use, and three all-reduces (max, sum, P·V) over each
  of the two axes that split the slots for each attention block; no
  other collective.
* H2 (``seq_shard``): the split adds one all-gather of the stream at each
  block's entry and one before the final norm, of the stream's padded
  shape, and nothing else; the mesh iteration runs (32, 8) and (64, 4).
* H3 (``remat="dots"``): a micro-batch keeps, beyond ``"block"``'s bytes,
  the outputs of each layer's seven products (bf16, rank 0's rows).
* ``main --which`` writes its records to ``RESULTS/torch_hillclimb.json``.
"""

import ast
import json
import math
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs as TC
from repro_torch.launch import dryrun as D
from repro_torch.launch import hillclimb as H
from repro_torch.models.config import SHAPE_BY_NAME

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    """The hillclimbs on smoke configs, their fake process group torn down
    after the module."""
    mp = pytest.MonkeyPatch()
    mp.setattr(H, "get_config", TC.smoke_config)
    yield {"h1": H.h1_int8_decode(), "h2": H.h2_seq_parallel_prefill(),
           "h3": H.h3_remat_and_accum()}
    mp.undo()
    if dist.is_initialized():
        dist.destroy_process_group()


def _reference_keys() -> dict:
    """Each reference hillclimb's returned keys and its iterations' keys."""
    tree = ast.parse((ROOT / "src/repro/launch/hillclimb.py").read_text())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or fn.name[:2] not in (
                "h1", "h2", "h3"):
            continue
        ret, = [n.value for n in fn.body if isinstance(n, ast.Return)]
        top = {k.value: v for k, v in zip(ret.keys, ret.values)}
        out[fn.name[:2]] = (set(top), [{k.value for k in d.keys}
                                       for d in top["iterations"].elts])
    return out


def test_records_have_the_reference_s_keys(smoke):
    for name, (top, iters) in _reference_keys().items():
        rec = smoke[name]
        assert set(rec) == top, name
        assert [set(it) for it in rec["iterations"]] == iters, name


def _splits(t) -> int:
    return sum(p.is_shard() for p in t.placements)


def test_h1_issues_the_gathers_and_the_softmax_s_reductions(smoke):
    cfg = TC.smoke_config("zamba2_7b")
    mesh = D.production_mesh(False)
    qm = H.abstract_quantized(cfg, mesh)
    prefix = {id(m): n for n, m in qm.skeleton.named_modules()}

    def gathers(module_name):
        return sum(_splits(d[n]) for n in qm.q if n.startswith(module_name)
                   for d in (qm.q, qm.s))

    stack = qm.skeleton.stack()
    shared = qm.skeleton.shared_attn
    blocks = sum(gathers(prefix[id(b)] + ".") for b in stack
                 if b is not shared)
    # the shared block once a step, the embedding's rows and the
    # unembedding once each; the float norms are replicated
    want = blocks + gathers("shared_attn.") + gathers("unembed") + \
        gathers("embed") * (2 if cfg.tie_embeddings else 1)
    attn = sum(b is shared for b in stack)
    shape = SHAPE_BY_NAME["long_500k"]
    rep = cfg.n_heads // cfg.n_kv_heads
    reduced = 2 * (2 * 1 * cfg.n_kv_heads * rep * 4
                   + 1 * cfg.n_kv_heads * rep * cfg.d_head * 4)
    for it in smoke["h1"]["iterations"]:
        coll = it["compiled"]["collectives"]
        assert coll["counts"]["all-gather"] == want
        assert coll["counts"]["all-reduce"] == 6 * attn
        assert coll["bytes"]["all-reduce"] == attn * reduced
        assert coll["counts"]["reduce-scatter"] == 0
    # rank 0 holds 1/256 of each KV cache's slots
    ins = D.input_specs(cfg, shape, mesh)
    k = next(c["k"] for c in ins["caches"] if "k" in c)
    assert k.to_local().shape[1] == shape.seq_len // 256


def test_h2_seq_shard_adds_the_stream_s_gathers(smoke):
    cfg = TC.smoke_config("xlstm_1p3b")
    shape = SHAPE_BY_NAME["prefill_32k"]
    it = smoke["h2"]["iterations"]
    m = it[0]["measured"]
    rows = shape.global_batch // 16
    c = -(-shape.seq_len // 16)
    stream = 16 * rows * c * cfg.d_model * 2  # gathered (16 parts) bf16
    assert m["coll_bytes_after"] - m["coll_bytes_before"] == \
        (cfg.n_layers + 1) * stream
    assert it[0]["confirmed"] is False
    assert it[1]["measured"] == {"coll_bytes_after": None}
    assert set(it[2]["measured"]["coll_total_GB"]) == {"16x16", "32x8",
                                                      "64x4"}
    assert it[2]["measured"]["coll_total_GB"]["16x16"] == \
        m["coll_bytes_before"] / 1e9


def test_h3_dots_keep_the_products_outputs(smoke):
    cfg = TC.smoke_config("command_r_plus_104b")
    shape = SHAPE_BY_NAME["train_4k"]
    it = smoke["h3"]["iterations"]
    block = it[0]["memory_analysis"]["before"]["saved_for_backward_bytes"]
    dots = it[0]["memory_analysis"]["after"]["saved_for_backward_bytes"]
    rows = max(shape.global_batch // 16 // 16, 1)  # a micro-batch, rank 0
    per_token = (cfg.q_dim + 2 * cfg.kv_dim + cfg.d_model + 2 * cfg.d_ff
                 + cfg.d_model)
    assert dots - block == cfg.n_layers * rows * shape.seq_len \
        * per_token * 2
    # grad_accum 8: a micro-batch of twice the rows keeps twice the bytes
    # (but for a few of fixed size)
    dots8 = it[1]["memory_analysis"]["after"]["saved_for_backward_bytes"]
    assert abs(dots8 - 2 * dots) <= 1e-4 * dots
    assert it[0]["after"]["compute_s"] < it[0]["before"]["compute_s"]
    assert it[1]["after"]["collective_s"] < it[1]["before"]["collective_s"]


def test_main_writes_the_records(smoke, tmp_path, monkeypatch):
    monkeypatch.setattr(H, "RESULTS", tmp_path)
    monkeypatch.setattr(H, "get_config", TC.smoke_config)
    out = H.main(["--which", "h1"])
    saved = json.loads((tmp_path / "torch_hillclimb.json").read_text())
    assert set(saved) == {"h1"} == set(out)
    assert saved["h1"]["cell"] == "zamba2_7b × long_500k"
    assert math.isclose(saved["h1"]["after"]["memory_s"],
                        smoke["h1"]["after"]["memory_s"])
