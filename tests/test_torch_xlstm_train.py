"""xLSTM training in the port against the reference, on the CPU.

* The mLSTM's intra-chunk decay is masked before the exponent: where a
  chunk's forget gates overflow float32's exponent range, the reference's
  gradient is non-finite (``where(tri, exp(cum_l - cum_s), 0)`` gives 0 x
  inf) and the port's is finite, with the same loss.
* The sLSTM scan's autograd graph is linear in S: one ``unbind`` of the
  pre-activations and one ``stack`` of the emitted h, with no per-step
  ``SelectBackward0`` (a read ``pre[:, t]``) or ``CopySlices`` (a write
  ``hs[:, t] = h``); its output, final state and gradients are the
  reference's.
* ``chip_smoke.train_flops`` counts the model FLOPs of the families the
  card trains, held against counts by hand on the smoke configs: MoE's
  top-k experts, the shared expert and the router; the mLSTM's chunk
  products and state terms; the sLSTM's recurrence.
* ``chip_smoke.slstm_clock`` counts each sLSTM mixer's forward, its
  recomputation and its backward once a micro-batch in a training step,
  and leaves the step's values as they are.
"""

import collections
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as RT
from repro.models import xlstm as RX
from repro.parallel.sharding import init_params as ref_init_params

from repro_torch import configs as TC
from repro_torch.models import SLSTM, Transformer, loss_fn

from _torch_train_ref import one_torch_thread  # noqa: F401 (autouse)
from _torch_train_ref import (batch, configs, port_grads, port_model,
                              ref_params)

ROOT = Path(__file__).resolve().parents[1]


def test_mlstm_gradient_finite_where_the_masked_decay_overflows():
    """A smoke xLSTM whose forget gates shut hard: the embeddings' first
    column 5 (about 8 after the pre-norm) and the forget half of ``wif``'s
    first row -1, so log f ~ -8 a step, far below -2, and within a chunk
    of 64 the sum of the log forget gates passes float32's exponent range
    (-88).  The reference's gradient is non-finite there; the port's is
    finite, its loss the reference's, and its directional derivative
    equal to the central difference of the reference's own loss within
    2e-2, as the Mamba-2 test of ``test_torch_train_loss_hybrid.py``."""
    rcfg, cfg = configs("xlstm_1p3b")
    H = rcfg.n_heads

    def shut(path, x):
        key = jax.tree_util.keystr(path)
        if key.endswith("['mlstm']['wif']"):
            return x.at[..., 0, H:].set(-1.0)
        if key == "['embed']":
            return x.at[:, 0].set(5.0)
        return x

    params = jax.tree_util.tree_map_with_path(shut, ref_params(rcfg))
    toks, labs, _ = batch(cfg, 2, 64, seed=5)
    f = jax.jit(lambda p: RT.loss_fn(p, toks, labs, rcfg, dtype=jnp.float32))
    want_loss, want = jax.value_and_grad(f)(params)
    assert np.isfinite(float(want_loss))
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(want))
    model = port_model(cfg, params)
    assert model.layers[0].mlstm.chunk >= 64  # one chunk of the 64 steps
    loss = loss_fn(model, torch.from_numpy(toks), torch.from_numpy(labs),
                   dtype=torch.float32)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    leaves = [np.asarray(g, np.float64)
              for g in jax.tree.leaves(port_grads(model))]
    assert all(np.isfinite(g).all() for g in leaves)
    rng = np.random.default_rng(0)
    v = jax.tree.map(lambda x: (0.02 * rng.standard_normal(x.shape)).astype(
        np.float32), params)
    dot = sum(float((g * np.asarray(d, np.float64)).sum())
              for g, d in zip(leaves, jax.tree.leaves(v)))
    eps = 1e-2
    shift = lambda s: jax.tree.map(lambda p, d: p + s * eps * d, params, v)
    fd = (float(f(shift(1.0))) - float(f(shift(-1.0)))) / (2 * eps)
    assert abs(dot - fd) <= 2e-2 * abs(fd), (dot, fd)


def _graph_nodes(*roots) -> collections.Counter:
    """The autograd nodes reachable from ``roots``, counted by name."""
    seen, stack, names = set(), [r for r in roots if r is not None], \
        collections.Counter()
    while stack:
        node = stack.pop()
        if node in seen:
            continue
        seen.add(node)
        names[node.name()] += 1
        stack.extend(n for n, _ in node.next_functions if n is not None)
    return names


def test_slstm_scan_graph_is_linear_and_matches_the_reference():
    """At S 64 the sLSTM's graph holds one ``UnbindBackward0`` of the
    pre-activations and one ``StackBackward0`` of the emitted h, and no
    ``SelectBackward0`` or ``CopySlices`` node; the output, the final (h,
    c, n, m) and the gradients of a seeded cotangent (x, ``w_in``, ``r``,
    ``wo``) equal the reference's ``jax.vjp`` at the smoke tolerances
    (values 1e-5, gradients rtol 1e-4 / atol 1e-6)."""
    rcfg = configs("xlstm_1p3b")[0]
    tcfg = TC.smoke_config("xlstm_1p3b")
    p = ref_init_params(RX.slstm_pdefs(rcfg), jax.random.PRNGKey(3))
    mod = SLSTM(tcfg, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for name, t in mod.named_parameters():
            t.copy_(torch.from_numpy(np.array(p[name])))
    mod.requires_grad_(True)
    rng = np.random.default_rng(4)
    B, S, d = 2, 64, rcfg.d_model
    x = (0.5 * rng.standard_normal((B, S, d))).astype(np.float32)
    g_out = rng.standard_normal((B, S, d)).astype(np.float32)
    g_state = {k: rng.standard_normal((B, d)).astype(np.float32)
               for k in "hcnm"}

    xt = torch.from_numpy(x).requires_grad_(True)
    out, state = mod(xt, return_state=True)
    names = _graph_nodes(out.grad_fn, *(state[k].grad_fn for k in "hcnm"))
    assert names["SelectBackward0"] == 0 and names["CopySlices"] == 0, names
    assert names["UnbindBackward0"] >= 1 and names["StackBackward0"] == 1
    (out * torch.from_numpy(g_out)).sum().add(sum(
        (state[k] * torch.from_numpy(g_state[k])).sum()
        for k in "hcnm")).backward()

    (want_out, want_state), vjp = jax.vjp(
        lambda q, y: RX.slstm(q, y, rcfg, return_state=True), p,
        jnp.asarray(x))
    gp, gx = vjp((jnp.asarray(g_out),
                  {k: jnp.asarray(v) for k, v in g_state.items()}))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **tol)
    for k in "hcnm":
        np.testing.assert_allclose(state[k].detach().numpy(),
                                   np.asarray(want_state[k]), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-6)
    for name, t in mod.named_parameters():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gp[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _attn_flops(cfg, B, S) -> int:
    """An attention block's projections and its causal products."""
    d, H, KVH, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return (2 * B * S * (2 * d * H * D + 2 * d * KVH * D)
            + 4 * B * H * D * S * (S + 1) // 2)


def _by_hand(arch, B, S) -> int:
    """3 x the forward's FLOPs of ``arch``'s smoke config, from its
    widths."""
    cfg = TC.smoke_config(arch)
    d, H, dh, f, V = (cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff,
                      cfg.vocab)
    fwd = 2 * B * S * d * V                                   # unembedding
    for btype in cfg.pattern * cfg.n_groups:
        if btype == "mlstm":
            di, L = H * dh, min(S, 128)
            fwd += 2 * B * S * (4 * d * di + d * 2 * H + di * d)
            fwd += B * S * H * (4 * L * dh + 4 * dh * dh + 4 * dh)
        elif btype == "slstm":
            fwd += 2 * B * S * (d * 4 * d + d * d)            # w_in, wo
            fwd += B * S * H * 8 * dh * dh                    # h @ r
        else:
            mc = cfg.moe
            mats = 3 if cfg.act == "swiglu" else 2
            fwd += _attn_flops(cfg, B, S)
            fwd += 2 * B * S * d * mc.n_experts               # router
            fwd += 2 * B * S * mc.top_k * mats * d * f        # experts
            if mc.shared_expert:
                fwd += 2 * B * S * 3 * d * f                  # SwiGLU MLP
    return 3 * fwd


@pytest.mark.parametrize("S", [64, 256])
@pytest.mark.parametrize("arch", ["xlstm_1p3b", "llama4_scout_17b_a16e",
                                  "grok1_314b"])
def test_train_flops_counts_the_new_families_by_hand(arch, S):
    """``chip_smoke.train_flops`` on a meta-device smoke model equals the
    count by hand: S 64 takes the mLSTM in one chunk of 64, S 256 in two
    of 128."""
    cfg = TC.smoke_config(arch)
    model = Transformer(cfg, dtype=torch.float32, device="meta")
    assert _chip_smoke().train_flops(model, 2, S) == _by_hand(arch, 2, S)


def test_train_kernels_follow_the_pattern():
    """The kernels a training step must launch, from the pattern: xLSTM
    only K9's plain instance (no K8, no residual norm); the MoE models K8,
    K9 and its residual instance; Zamba2 also K10; Gemma-2 past its window
    K8's window instances."""
    C = _chip_smoke()
    get = TC.get_config
    assert C.train_kernels(get("xlstm_1p3b"), 4096) == C.TRAIN_NORM
    for arch in ("llama4_scout_17b_a16e", "grok1_314b", "granite_8b"):
        assert sorted(C.train_kernels(get(arch), 4096)) == sorted(
            C.TRAIN_LAUNCHES)
    assert set(C.train_kernels(get("zamba2_7b"), 4096)) == set(
        C.TRAIN_LAUNCHES + C.TRAIN_SCAN)
    assert set(C.train_kernels(get("gemma2_2b"), 8192)) == set(
        C.TRAIN_LAUNCHES + C.TRAIN_WINDOW)
    assert set(C.train_kernels(get("gemma2_2b"), 4096)) == set(
        C.TRAIN_LAUNCHES)


def test_slstm_clock_counts_each_span_and_leaves_the_step_alone():
    """Two float32 steps of the smoke xLSTM (its sLSTM under checkpoint),
    ``grad_accum`` 2, one of them under ``chip_smoke.slstm_clock``: the
    clock sees the mixer's forward, recomputation and backward once a
    micro-batch, each a positive time, and the clocked step's loss,
    grad_norm and parameters equal the unclocked step's bitwise."""
    from repro.data.pipeline import DataConfig, make_batch
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (TrainConfig, init_state,
                                              make_train_step)

    C = _chip_smoke()
    rcfg, cfg = configs("xlstm_1p3b")
    assert cfg.remat == "block" and "slstm" in cfg.pattern
    b = make_batch(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4,
                              seed=2), 0)
    b = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    step = make_train_step(cfg, TrainConfig(
        grad_accum=2, compute_dtype=torch.float32,
        opt=OptConfig(lr=1e-3, warmup=2)))
    runs = []
    for clocked in (False, True):
        state = init_state(cfg, port_model(cfg, ref_params(rcfg)))
        ms = {}
        if clocked:
            with C.slstm_clock(state.params, ms):
                state, m = step(state, b)
        else:
            state, m = step(state, b)
        runs.append((m, [p.detach().clone()
                         for p in state.params.parameters()], ms))
    (m0, p0, _), (m1, p1, ms) = runs
    n = cfg.pattern.count("slstm") * cfg.n_groups * 2
    assert {k: ms["n_" + k] for k in C.SLSTM_SPANS} == dict.fromkeys(
        C.SLSTM_SPANS, n), ms
    assert all(ms[k] > 0 for k in C.SLSTM_SPANS), ms
    assert float(m0["loss"]) == float(m1["loss"])
    assert float(m0["grad_norm"]) == float(m1["grad_norm"])
    assert all(torch.equal(a, c) for a, c in zip(p0, p1))
