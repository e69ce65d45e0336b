"""The port's distributed dycore: the halo exchanger, the distributed step
and its member axis, against the reference.

Counterparts of ``tests/test_distributed.py`` and ``tests/test_ensemble.py``'s
``test_chunked_member_sharded_matches_unsharded``.  Every rank runs in this
process (``make_mesh`` without ``torch.distributed``): the exchanger on rank
blocks equals the port's ``exchange_reference`` on the global tensors bit
for bit and the reference's within 1e-6; the step equals the reference's
*sequential* step within 1e-5 over the interior (the reference's
distributed step raises on the JAX this repository pins); opt 4 drops the
``delpc`` exchange bit for bit.  Then the same step with its ranks spread
over 2, 3 and 4 gloo processes (``init_method="file://"``, a timeout each)
equals the in-process step bit for bit — pairs of ranks within and across
processes.
"""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.fv3 import dyncore as RD
from repro.fv3 import halo as RH
from repro.fv3 import state as RSt

from repro_torch.core.backend import TuningCache, set_default_cache
from repro_torch.fv3 import dyncore as TD
from repro_torch.fv3 import halo as TH
from repro_torch.fv3 import state as TSt
from repro_torch.fv3.mesh import Mesh, make_mesh

ROOT = Path(__file__).resolve().parents[1]
STEP_ATOL = 1e-5
SMALL = dict(npx=12, nk=2, halo=6, n_split=1, k_split=1, n_tracers=1)
TILE_MESH = ("tile", "y", "x")


@pytest.fixture(autouse=True, scope="module")
def _own_tuning_cache(tmp_path_factory):
    """The port's tuning cache of this file: a throwaway file, never the
    working tree's ``.repro_cache/torch_tuning.json``."""
    set_default_cache(TuningCache(
        tmp_path_factory.mktemp("torch_tuning") / "torch_tuning.json"))
    yield
    set_default_cache(None)


def _interior(a, cfg):
    h, n = cfg.halo, cfg.npx
    return np.asarray(a)[..., h:h + n, h:h + n]


def _global_fields(N, h, nk, lead=(), seed=0):
    """Random global fields with zero ghosts (numpy)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in ("q", "u", "v"):
        g = rng.standard_normal(lead + (6, nk, N + 2 * h, N + 2 * h)).astype(
            np.float32)
        g[..., :h, :] = g[..., -h:, :] = 0
        g[..., :h] = g[..., -h:] = 0
        out[k] = g
    return out


def _rank_stack(blocks, cfg):
    """(..., 6, py, px, nk, J, I) blocks → (..., ranks, nk, J, I)."""
    return {k: v.reshape(v.shape[:-6] + (-1,) + tuple(v.shape[-3:]))
            for k, v in blocks.items()}


@pytest.mark.parametrize("layout,N,h", [((2, 2), 8, 3), ((1, 1), 7, 3),
                                        ((3, 3), 12, 2)])
def test_exchanger_matches_exchange_reference(layout, N, h):
    cfg = TD.FV3Config(npx=N, nk=2, halo=h, layout=layout)
    glob = _global_fields(N, h, 2)
    tglob = {k: torch.from_numpy(v) for k, v in glob.items()}
    want = TSt.blocks_from_global(
        TH.exchange_reference(tglob, h, vector_pairs=[("u", "v")]), cfg)
    ex = TH.make_halo_exchanger(cfg.decomposition())
    blocks = _rank_stack(TSt.blocks_from_global(tglob, cfg), cfg)
    before = {k: v.clone() for k, v in blocks.items()}
    got = ex(blocks, vector_pairs=[("u", "v")])
    ref = RH.exchange_reference({k: jnp.asarray(v) for k, v in glob.items()},
                                h, vector_pairs=[("u", "v")])
    ref_blocks = RSt.blocks_from_global(ref, RD.FV3Config(
        npx=N, nk=2, halo=h, layout=layout))
    for k in glob:
        assert torch.equal(got[k].reshape(want[k].shape), want[k]), k
        np.testing.assert_allclose(got[k].reshape(want[k].shape).numpy(),
                                   np.asarray(ref_blocks[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
        # new tensors; the inputs are left as they were
        assert got[k].data_ptr() != blocks[k].data_ptr()
        assert torch.equal(blocks[k], before[k])
    assert len(ex.rounds) == len(RH.build_rounds(cfg.decomposition()))


@pytest.mark.parametrize("layout,N,h", [((2, 2), 8, 3), ((3, 3), 12, 2),
                                        ((2, 2), 12, 6)])
def test_exchanger_reads_no_stale_ghost_of_a_rank(layout, N, h):
    """After a step the ghosts of the rank blocks are stale (a program
    writes over them); the global field has the neighbour rank's cells
    there.  With stale values in every ghost cell that lies inside a tile,
    and in the tiles' own ghost rings, the exchanger still equals
    ``exchange_reference`` on the global tensors bit for bit — cube
    corners included, where both read the tiles' ghost rings as they
    were."""
    cfg = TD.FV3Config(npx=N, nk=2, halo=h, layout=layout)
    rng = np.random.default_rng(1)
    glob = {k: torch.from_numpy(rng.standard_normal(
        (6, 2, N + 2 * h, N + 2 * h)).astype(np.float32))
        for k in ("q", "u", "v")}
    want = TSt.blocks_from_global(
        TH.exchange_reference(glob, h, vector_pairs=[("u", "v")]), cfg)
    blocks = TSt.blocks_from_global(glob, cfg)
    nl = cfg.n_local
    py, px = layout
    jj = torch.arange(nl + 2 * h)
    in_rank = ((jj >= h) & (jj < h + nl))
    for y in range(py):
        for x in range(px):
            J, I = y * nl + jj, x * nl + jj
            in_tile = ((J >= h) & (J < h + N))[:, None] & \
                ((I >= h) & (I < h + N))[None, :]
            stale = in_tile & ~(in_rank[:, None] & in_rank[None, :])
            for v in blocks.values():
                v[:, y, x, :, stale] = 1e3
    ex = TH.make_halo_exchanger(cfg.decomposition())
    got = ex(_rank_stack(blocks, cfg), vector_pairs=[("u", "v")])
    for k in glob:
        assert torch.equal(got[k].reshape(want[k].shape), want[k]), k


def test_halo_exchanger_carries_leading_member_dim():
    """A batched exchange of (M, ranks, nk, J, I) blocks equals M exchanges
    of the members one at a time, bit for bit."""
    N, h, M = 8, 3, 3
    cfg = TD.FV3Config(npx=N, nk=2, halo=h, layout=(2, 2))
    ex = TH.make_halo_exchanger(cfg.decomposition())
    rng = np.random.default_rng(0)
    nl = cfg.n_local
    blocks = torch.from_numpy(rng.standard_normal(
        (M, 24, 2, nl + 2 * h, nl + 2 * h)).astype(np.float32))
    batched = ex({"q": blocks, "u": blocks + 1, "v": blocks - 1},
                 vector_pairs=[("u", "v")])
    for m in range(M):
        one = ex({"q": blocks[m], "u": blocks[m] + 1, "v": blocks[m] - 1},
                 vector_pairs=[("u", "v")])
        for k in one:
            assert torch.equal(batched[k][m], one[k]), (m, k)


def test_blocks_round_trip_like_the_reference():
    cfg_r = RD.FV3Config(npx=12, nk=2, halo=3, layout=(2, 2))
    cfg = TD.FV3Config(npx=12, nk=2, halo=3, layout=(2, 2))
    glob = _global_fields(12, 3, 2, lead=())
    got = TSt.blocks_from_global({k: torch.from_numpy(v)
                                  for k, v in glob.items()}, cfg)
    want = RSt.blocks_from_global(glob, cfg_r)
    for k in glob:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    back = TSt.global_from_blocks(got, cfg)
    ref_back = RSt.global_from_blocks(want, cfg_r)
    for k in glob:
        np.testing.assert_array_equal(back[k].numpy(), ref_back[k])


@pytest.fixture(scope="module")
def reference_seq():
    """The reference's sequential step at SMALL (its layout plays no part
    in a sequential step), compiled once for the file."""
    return RD.make_step_sequential(RD.FV3Config(**SMALL))


@pytest.fixture(scope="module")
def reference_step(reference_seq):
    """The reference's state at SMALL, layout (2, 2), before and after its
    sequential step."""
    cfg = RD.FV3Config(layout=(2, 2), **SMALL)
    s0 = {k: np.asarray(v) for k, v in RSt.init_state(cfg).items()}
    s1 = reference_seq({k: jnp.asarray(v) for k, v in s0.items()})
    return s0, {k: np.asarray(v) for k, v in s1.items()}


def _distributed(cfg, mesh, state, **kw):
    step = TD.make_step_distributed(cfg, mesh, device="cpu", **kw)
    out = step(TSt.blocks_from_global(TSt.state_from_reference(state, "cpu"),
                                      cfg))
    return step, out


def test_dycore_distributed_matches_sequential(reference_step):
    s0, ref = reference_step
    cfg = TD.FV3Config(layout=(2, 2), **SMALL)
    step, blocks = _distributed(cfg, make_mesh((6, 2, 2), TILE_MESH), s0)
    assert step.overlapped is False          # n_local 6 <= 2 * halo
    assert step.local_ranks == range(24)
    got = TSt.global_from_blocks(blocks, cfg)
    seq = TD.make_step_sequential(cfg, device="cpu")(
        TSt.state_from_reference(s0, "cpu"))
    for k in ref:
        err = np.abs(_interior(got[k], cfg) - _interior(ref[k], cfg)).max()
        assert err < STEP_ATOL, (k, err)
        err = (_interior(got[k], cfg) - _interior(seq[k], cfg))
        assert np.abs(err).max() < STEP_ATOL, k
    # one exchange of the state and one of delpc per acoustic substep, one
    # of the winds and tracers per remap step
    assert step.counters["exchanges"] == 3
    assert step.counters["step_calls"] == 1


def test_distributed_step_equals_sequential_over_substeps():
    """Several acoustic and remap substeps at opt 0 (no fusion, so the
    rank-local programs are the global ones): the ghosts the exchanger
    reads after a program wrote over them are the global field's, and the
    step equals the sequential step exactly over the interior."""
    cfg = TD.FV3Config(npx=12, nk=3, halo=6, layout=(2, 2), n_split=2,
                       k_split=2, n_tracers=1)
    s0 = TSt.init_state(cfg, device="cpu")
    step = TD.make_step_distributed(cfg, make_mesh((6, 2, 2), TILE_MESH),
                                    opt_level=0, device="cpu")
    got = TSt.global_from_blocks(step(TSt.blocks_from_global(s0, cfg)), cfg)
    ref = TD.make_step_sequential(cfg, opt_level=0, device="cpu")(s0)
    for k in ref:
        assert torch.equal(_interior_t(got[k], cfg),
                           _interior_t(ref[k], cfg)), k


def test_overlapped_step_matches_sequential():
    """n_local 14 > 2 * halo: each exchanged program runs split, and the
    step still equals the port's sequential step (itself held to the
    reference's)."""
    cfg = TD.FV3Config(layout=(2, 2), **dict(SMALL, npx=28))
    s0 = TSt.init_state(cfg, device="cpu")
    step = TD.make_step_distributed(cfg, make_mesh((6, 2, 2), TILE_MESH),
                                    device="cpu")
    assert step.overlapped is True
    got = TSt.global_from_blocks(step(TSt.blocks_from_global(s0, cfg)), cfg)
    ref = TD.make_step_sequential(cfg, device="cpu")(s0)
    for k in ref:
        err = np.abs(_interior(got[k], cfg) - _interior(ref[k], cfg)).max()
        assert err < STEP_ATOL, (k, err)


def test_dycore_distributed_opt4_drops_delpc_exchange_bitwise():
    """opt 4's recompute-vs-exchange rewrite widens c_sw so delpc is valid
    on a one-cell rim and drops the per-substep delpc exchange: bit for bit
    the opt-3 step, with n_split * k_split fewer exchanges."""
    cfg = TD.FV3Config(layout=(2, 2), **dict(SMALL, n_split=2))
    mesh = make_mesh((6, 2, 2), TILE_MESH)
    blocks = TSt.blocks_from_global(TSt.init_state(cfg, device="cpu"), cfg)
    step3 = TD.make_step_distributed(cfg, mesh, overlap=False, opt_level=3,
                                     device="cpu")
    step4 = TD.make_step_distributed(cfg, mesh, overlap=False, opt_level=4,
                                     device="cpu")
    assert step3.delpc_exchange_skipped is False
    assert step4.delpc_exchange_skipped is True
    b3, b4 = step3(blocks), step4(blocks)
    for k in b3:
        assert torch.equal(b3[k], b4[k]), k
    assert (step3.counters["exchanges"] - step4.counters["exchanges"]
            == cfg.n_split * cfg.k_split)


def _member_blocks(cfg, ens):
    return TSt.blocks_from_global(TSt.state_from_reference(ens, "cpu"), cfg)


@pytest.mark.parametrize("M,D,batch", [(2, 2, None), (4, 2, "vmap:1"),
                                       (4, 2, "grid")])
def test_member_sharded_matches_unsharded(reference_seq, M, D, batch):
    """Members shard over a leading member mesh axis, orthogonally to the
    tile decomposition (``n_members=M`` puts M // D on each group, batched
    per ``batch``): each member equals the reference's sequential step on
    that member within 1e-5, and the port's bit for bit."""
    cfg_r = RD.FV3Config(layout=(1, 1), **SMALL)
    cfg = TD.FV3Config(layout=(1, 1), **SMALL)
    ens = {k: np.asarray(v) for k, v in RSt.ensemble_state(cfg_r, M).items()}
    mesh = make_mesh((D, 6, 1, 1), ("member",) + TILE_MESH)
    kw = {} if M == D else {"n_members": M, "batch": batch}
    step = TD.make_step_distributed(cfg, mesh, member_axis="member",
                                    device="cpu", **kw)
    assert step.members_per_group == M // D
    assert step.overlapped is False
    if M > D:
        assert step.batch == batch and step.n_members == M
        assert step.member_chunk == (1 if batch == "vmap:1" else None)
    out = step(_member_blocks(cfg, ens))
    t_step = TD.make_step_sequential(cfg, device="cpu")
    for m in range(M):
        ref = reference_seq({k: jnp.asarray(v[m]) for k, v in ens.items()})
        mine = t_step({k: torch.from_numpy(v[m].copy())
                       for k, v in ens.items()})
        got = TSt.global_from_blocks({k: v[m] for k, v in out.items()}, cfg)
        for k in got:
            err = np.abs(_interior(got[k], cfg)
                         - _interior(ref[k], cfg)).max()
            assert err < STEP_ATOL, (m, k, err)
            assert torch.equal(_interior_t(got[k], cfg),
                               _interior_t(mine[k], cfg)), (m, k)


def _interior_t(x, cfg):
    h, n = cfg.halo, cfg.npx
    return x[..., h:h + n, h:h + n]


def test_distributed_validation():
    """Misconfigured requests fail before any compile, as the reference's:
    ``n_members`` without a member axis, M not a multiple of the member
    extent, a mesh that does not match the layout; the deprecated
    ``ensemble=True`` warns."""
    cfg = TD.FV3Config(**SMALL)
    with pytest.raises(ValueError, match="member_axis"):
        TD.make_step_distributed(cfg, None, n_members=4, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        TD.make_step_distributed(cfg, Mesh(("member",) + TILE_MESH,
                                           (3, 6, 1, 1)),
                                 member_axis="member", n_members=4,
                                 device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        TD.make_step_distributed(cfg, make_mesh((6, 2, 2), TILE_MESH),
                                 device="cpu")
    with pytest.warns(DeprecationWarning, match="member_axis"):
        step = TD.make_step_distributed(
            cfg, make_mesh((2, 6, 1, 1), ("ens",) + TILE_MESH),
            ensemble=True, device="cpu")
    assert step.members_per_group == 1
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh((6, 2), TILE_MESH)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert make_mesh((6, 1, 1), TILE_MESH).local_ranks == range(6)


# -- ranks over gloo processes ------------------------------------------------

WORKER = r"""
import datetime, sys
import torch, torch.distributed as dist
process, world, init, out, npx, py = sys.argv[1:7]
process, world, npx, py = int(process), int(world), int(npx), int(py)
dist.init_process_group("gloo", init_method=init, rank=process,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch.fv3.dyncore import FV3Config, make_step_distributed
from repro_torch.fv3.mesh import make_mesh
from repro_torch.fv3.state import blocks_from_global, init_state
cfg = FV3Config(npx=npx, nk=2, halo=6, layout=(py, py), n_split=1,
                k_split=1, n_tracers=1)
mesh = make_mesh((6, py, py), ("tile", "y", "x"))
step = make_step_distributed(cfg, mesh, device="cpu")
blocks = step(blocks_from_global(init_state(cfg, device="cpu"), cfg))
r = step.local_ranks
uneven = None
try:
    make_mesh((5, 1, 1), ("tile", "y", "x"))
except ValueError as e:
    uneven = str(e)
torch.save({"ranks": (r.start, r.stop), "overlapped": step.overlapped,
            "uneven": uneven,
            "blocks": {k: v.reshape((-1,) + tuple(v.shape[-3:]))[
                r.start:r.stop].clone() for k, v in blocks.items()}}, out)
dist.destroy_process_group()
"""


@pytest.mark.parametrize("npx,py,world", [(12, 2, 2), (12, 2, 4),
                                          (12, 1, 3), (28, 2, 2)])
def test_gloo_processes_match_the_in_process_step(tmp_path, npx, py, world):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               REPRO_CACHE_DIR=str(tmp_path / "cache"))
    init = f"file://{tmp_path}/rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(p), str(world), init,
         str(tmp_path / f"out{p}.pt"), str(npx), str(py)],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for p in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * world, "\n".join(logs)
    cfg = TD.FV3Config(npx=npx, nk=2, halo=6, layout=(py, py), n_split=1,
                       k_split=1, n_tracers=1)
    step = TD.make_step_distributed(cfg, make_mesh((6, py, py), TILE_MESH),
                                    device="cpu")
    want = _rank_stack(step(TSt.blocks_from_global(
        TSt.init_state(cfg, device="cpu"), cfg)), cfg)
    ranks = 6 * py * py
    held = []
    for p in range(world):
        got = torch.load(tmp_path / f"out{p}.pt")
        a, z = got["ranks"]
        held += range(a, z)
        assert got["overlapped"] == step.overlapped == (npx == 28)
        assert got["uneven"] is not None and "do not divide" in got["uneven"]
        for k, v in got["blocks"].items():
            assert torch.equal(v, want[k][a:z]), (p, k)
    assert held == list(range(ranks))
