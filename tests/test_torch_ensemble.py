"""The ensemble member axis of the port against the reference.

Every batched path of the port is bit-identical to the port's own loop over
members (what the kernels' member axis must preserve), and within the
whole-step bar of the reference's jnp ensemble step: max abs error < 1e-5
over the interior.  Runs on the CPU, where the ``"cuda"`` backend takes the
plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import StencilProgram as RProgram
from repro.core import compile_program as r_compile_program
from repro.fv3 import dyncore as RD
from repro.fv3 import halo as RH
from repro.fv3 import state as RSt

from repro_torch.core import StencilProgram, compile_program
from repro_torch.fv3 import dyncore as TD
from repro_torch.fv3 import halo as TH
from repro_torch.fv3 import state as TSt

STEP_ATOL = 1e-5
BATCHES = ["grid", "vmap", "vmap:2", "vmap:2,grid"]


def _members(names, dom, m, seed=7, interface=()):
    rng = np.random.default_rng(seed)
    out = {}
    for f in names:
        a = rng.uniform(0.8, 1.2, (m, 6) + dom.padded_shape(f in interface))
        if f in ("cx", "cy"):
            a = a - 1.0
        out[f] = a.astype(np.float32)
    return out


def _torch(fields):
    return {k: torch.from_numpy(v) for k, v in fields.items()}


def _assert_member_loop(out, singles, keys):
    for k in keys:
        want = torch.stack([s[k] for s in singles])
        assert out[k].shape == want.shape, k
        assert torch.equal(out[k], want), \
            (k, (out[k] - want).abs().max().item())


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("batch", BATCHES)
def test_fvtp2d_member_batch_equals_member_loop(backend, batch):
    cfg = TD.FV3Config(npx=8, nk=3)
    dom = cfg.seq_dom()
    p = StencilProgram("fvtp2d", dom)
    for f in ("q", "cx", "cy", "qout"):
        p.declare(f)
    TD.add_fvtp2d(p, "q", "qout", "t")
    p.propagate_extents()
    params = TD.default_params(cfg)
    M = 3
    fields = _members(("q", "cx", "cy"), dom, M)
    single = compile_program(p, backend, device="cpu")
    singles = [single({k: v[m] for k, v in _torch(fields).items()}, params)
               for m in range(M)]
    fn = compile_program(p, backend, n_members=M, batch=batch, device="cpu")
    out = fn(_torch(fields), params)
    _assert_member_loop(out, singles, ["qout"])
    assert fn.n_kernels == single.n_kernels == 11
    assert fn.n_members == M and fn.batch == batch
    chunked = ":" in batch
    assert fn.member_chunk == (2 if chunked else None)
    assert fn.n_chunks == (2 if chunked else None)
    # the reference's jnp ensemble lowering of the same motif (vmap over
    # tiles, as its step does)
    rp = RProgram("fvtp2d", RD.FV3Config(npx=8, nk=3).seq_dom())
    for f in ("q", "cx", "cy", "qout"):
        rp.declare(f)
    RD.add_fvtp2d(rp, "q", "qout", "t")
    rp.propagate_extents()
    rfn = jax.vmap(r_compile_program(rp, "jnp", n_members=M, batch="vmap"),
                   in_axes=(1, None), out_axes=1)
    ref = rfn({k: jnp.asarray(v) for k, v in fields.items()}, params)
    np.testing.assert_allclose(out["qout"].numpy(), np.asarray(ref["qout"]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("batch", BATCHES)
def test_remap_member_batch_interface_and_search(backend, batch):
    """K-interface fields and the ``index_search`` level search under the
    member axis, M = 3 (ragged against C = 2)."""
    cfg = TD.FV3Config(npx=6, nk=8, halo=6, n_tracers=0)
    dom = cfg.seq_dom()
    prog = TD.build_remap_program(cfg, dom, fields=("pt",))
    params = TD.default_params(cfg)
    M = 3
    fields = _torch(_members(("delp", "pt"), dom, M, seed=11))
    single = compile_program(prog, backend, device="cpu")
    singles = [single({k: v[m] for k, v in fields.items()}, params)
               for m in range(M)]
    fn = compile_program(prog, backend, n_members=M, batch=batch,
                         device="cpu")
    out = fn(dict(fields), params)
    _assert_member_loop(out, singles, ["delp_out", "pt_out"])
    assert fn.n_kernels == single.n_kernels


def test_broadcast_input_reaches_the_runners_uncopied():
    """A field expanded across members (member stride 0) gives the same
    result as M copies of it."""
    cfg = TD.FV3Config(npx=6, nk=3)
    dom = cfg.seq_dom()
    p = TD.build_csw_program(cfg, dom)
    params = TD.default_params(cfg)
    M = 2
    names = ("u", "v", "delp", "pt", "w")
    fields = _torch(_members(names, dom, M, seed=5))
    metrics = TD._metric_terms(cfg, (6,) + dom.padded_shape(), "cpu")
    fn = compile_program(p, "cuda", n_members=M, batch="grid", device="cpu")
    wide = {k: v.expand((M,) + tuple(v.shape)) for k, v in metrics.items()}
    assert wide["cosa"].stride(0) == 0
    out = fn({**fields, **wide}, params)
    copied = fn({**fields, **{k: v.contiguous() for k, v in wide.items()}},
                params)
    for k in ("w", "delpc", "ptc"):
        assert torch.equal(out[k], copied[k]), k


def test_batched_exchange_matches_member_loop():
    N, h, nk, M = 8, 3, 2, 3
    rng = np.random.default_rng(2)
    shape = (M, 6, nk, N + 2 * h, N + 2 * h)
    fields = {n: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for n in ("q", "u", "v")}
    vec = [("u", "v")]
    batched = TH.exchange_reference(fields, h, vector_pairs=vec)
    ref = RH.exchange_reference({k: jnp.asarray(v.numpy())
                                 for k, v in fields.items()}, h,
                                vector_pairs=vec)
    for m in range(M):
        single = TH.exchange_reference({k: v[m] for k, v in fields.items()},
                                       h, vector_pairs=vec)
        for k in fields:
            assert torch.equal(batched[k][m], single[k]), (k, m)
            np.testing.assert_array_equal(batched[k].numpy(),
                                          np.asarray(ref[k]))


# ---------------------------------------------------------------------------
# ensemble state and the ensemble step
# ---------------------------------------------------------------------------


def _step_cfgs():
    small = dict(npx=12, nk=2, halo=6, n_split=1, k_split=1, n_tracers=1)
    deep = dict(small, nk=8, n_tracers=2)
    return [small, deep]


@pytest.mark.parametrize("m", [1, 3])
def test_ensemble_state_matches_reference_bitwise(m):
    kw = dict(npx=8, nk=3, halo=6, n_tracers=2)
    ref = RSt.ensemble_state(RD.FV3Config(**kw), m, seed=4)
    got = TSt.ensemble_state_numpy(TD.FV3Config(**kw), m, seed=4)
    dev = TSt.ensemble_state(TD.FV3Config(**kw), m, seed=4, device="cpu")
    assert set(got) == set(ref) == set(dev)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]))
        np.testing.assert_array_equal(dev[k].numpy(), got[k])
    base = TSt.init_state_numpy(TD.FV3Config(**kw), 4)
    np.testing.assert_array_equal(got["pt"][0], base["pt"])
    if m > 1:
        assert not np.array_equal(got["pt"][1], base["pt"])
        np.testing.assert_array_equal(got["pt"][1][:, :, :6], base["pt"][:, :, :6])
        np.testing.assert_array_equal(got["u"][1], base["u"])


@pytest.fixture(scope="module")
def reference_ensemble():
    """The reference's jnp ensemble step at opt 0, per configuration."""
    runs = {}
    for kw in _step_cfgs():
        cfg = RD.FV3Config(**kw)
        ens0 = RSt.ensemble_state(cfg, 3)
        step = RD.make_step_ensemble(cfg, 3, backend="jnp", opt_level=0)
        out = step(dict(ens0))
        runs[kw["nk"]] = ({k: np.asarray(v) for k, v in ens0.items()},
                          {k: np.asarray(v) for k, v in out.items()}, step)
    return runs


@pytest.mark.parametrize("cfg_kw", _step_cfgs(), ids=["nk2", "nk8"])
@pytest.mark.parametrize("backend,batch", [
    ("cuda", None), ("cuda", "vmap:2"), ("cuda", "vmap:2,grid"),
    ("cuda", "grid:2"), ("torch", None)])
def test_ensemble_step_matches_member_loop_and_reference(
        reference_ensemble, cfg_kw, backend, batch):
    cfg = TD.FV3Config(**cfg_kw)
    ens0_np, ref, ref_step = reference_ensemble[cfg.nk]
    M = 3
    ens0 = TSt.state_from_reference(ens0_np, "cpu")
    step_e = TD.make_step_ensemble(cfg, M, backend=backend, batch=batch,
                                   device="cpu")
    out = step_e(dict(ens0))
    step_s = TD.make_step_sequential(cfg, backend=backend, device="cpu")
    singles = [step_s({k: v[m] for k, v in ens0.items()}) for m in range(M)]
    _assert_member_loop(out, singles, list(ref))
    h, n = cfg.halo, cfg.npx
    for k in ref:
        err = np.abs(out[k].numpy()[..., h:h + n, h:h + n]
                     - ref[k][..., h:h + n, h:h + n]).max()
        assert err < STEP_ATOL, (k, err)
    assert step_e.n_kernels == step_s.n_kernels == ref_step.n_kernels
    assert step_e.batch == (batch or ("grid" if backend == "cuda"
                                      else "vmap"))
    chunked = batch is not None
    assert step_e.member_chunk == (2 if chunked else None)
    assert step_e.n_chunks == (2 if chunked else None)
    assert step_e.counters["step_calls"] == 1


def test_ensemble_kernel_count_independent_of_members():
    cfg = TD.FV3Config(npx=6, nk=3)
    counts = {(m, b): TD.make_step_ensemble(cfg, m, batch=b,
                                            device="cpu").n_kernels
              for m in (1, 2, 4) for b in ("grid", "vmap:2", "vmap:2,grid")}
    assert set(counts.values()) == {110}
    assert TD.make_step_sequential(cfg, device="cpu").n_kernels == 110


def test_ensemble_step_refuses_auto_chunks():
    cfg = TD.FV3Config(npx=6, nk=3)
    with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
        TD.make_step_ensemble(cfg, 4, batch="vmap:auto", device="cpu")
    with pytest.raises(ValueError, match="batch"):
        TD.make_step_ensemble(cfg, 4, batch="pmap", device="cpu")
