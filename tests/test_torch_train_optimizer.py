"""The port's optimizers (``repro_torch.train.optimizer``) and gradient
compression against the reference's on its stacked parameter tree.

The port keeps one module per layer and hands the optimizer the
reference's tree with its stacked leaves split per layer
(``param_tree``); the results, mapped back with ``reference_tree``, must
be the reference's: AdamW's decay of every layer's norm weights (stacked
(G, d) leaves) but not of ``final_norm`` or Zamba2's unstacked
``shared_attn`` norms; Adafactor's column statistic of a stacked 1-D leaf
shared across layers, and its RMS clip over a whole slot.  Gradients are
drawn with numpy; bars rtol 1e-5 / atol 1e-7 (the frameworks reduce in
other orders; AdamW's elementwise steps agree to round-off), compression
bit for bit."""

import jax
import numpy as np
import pytest
import torch

from repro.parallel import compression as RCMP
from repro.train import optimizer as RO

from repro_torch.models import param_tree, reference_tree
from repro_torch.parallel import compression as TCMP
from repro_torch.train import optimizer as TO

from _torch_train_ref import one_torch_thread  # noqa: F401 (autouse)
from _torch_train_ref import (assert_trees_close, configs, port_model,
                              ref_params)

RTOL, ATOL = 1e-5, 1e-7


def _grads_like(params, seed, scale=1e-2):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape))
                        .astype(np.float32), params)


def _split(tree_np, like):
    """A reference tree of numpy arrays in the port's flat layout."""
    out = {}
    for key, x in like.items():
        a = tree_np
        for k in key.split("/"):
            a = a[k]
        out[key] = ([torch.tensor(np.array(a[i])) for i in range(len(x))]
                    if isinstance(x, list) else torch.tensor(np.array(a)))
    return out


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["granite_8b", "zamba2_7b",
                                  "llama4_scout_17b_a16e"])
def test_optimizer_steps_match_the_reference(arch, kind):
    rcfg, cfg = configs(arch)
    params = ref_params(rcfg)
    model = port_model(cfg, params)
    tree = param_tree(model)
    ocfg = RO.OptConfig(lr=1e-2, warmup=2)
    tcfg = TO.OptConfig(lr=1e-2, warmup=2)
    rstate = RO.opt_init(kind, params)
    tstate = TO.opt_init(kind, tree)
    update = jax.jit(RO.opt_update, static_argnums=(0, 1))
    for step in range(3):
        g = _grads_like(params, seed=step)
        params, rstate = update(kind, ocfg, params, g, rstate)
        TO.opt_update(kind, tcfg, tree, _split(g, tree), tstate)
        assert int(tstate.count) == int(rstate.count) == step + 1
    assert_trees_close(reference_tree(tree), jax.tree.map(np.asarray, params),
                       RTOL, ATOL)
    for field in rstate._fields[:-1]:
        assert_trees_close(reference_tree(getattr(tstate, field)),
                           jax.tree.map(np.asarray, getattr(rstate, field)),
                           RTOL, ATOL)


def test_adamw_decays_as_the_stacked_view():
    """One AdamW step with zero gradients moves exactly the decayed leaves:
    every layer's norms (stacked, ndim 2), not final_norm or Zamba2's
    shared block's norms (unstacked, ndim 1)."""
    _, cfg = configs("zamba2_7b")
    rcfg, _ = configs("zamba2_7b")
    model = port_model(cfg, ref_params(rcfg))
    tree = param_tree(model)
    with torch.no_grad():
        for t in TO.leaves(tree):
            t.fill_(1.0)
    zeros = {k: [torch.zeros_like(t) for t in x] if isinstance(x, list)
             else torch.zeros_like(x) for k, x in tree.items()}
    state = TO.adamw_init(tree)
    TO.adamw_update(TO.OptConfig(lr=1.0, warmup=1), tree, zeros, state)
    moved = {k for k, x in tree.items()
             if float((x[0] if isinstance(x, list) else x)[..., 0].flatten()[0])
             != 1.0}
    assert "blocks/s1_mamba2/ln1" in moved and "final_norm" not in moved
    assert "shared_attn/ln1" not in moved and "shared_attn/attn/wq" in moved
    assert "blocks/s1_mamba2/mamba/A_log" in moved


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_decreases_quadratic(kind):
    """The reference's quadratic test, on the port."""
    p = {"w": torch.tensor([2.0, -3.0, 1.0]), "b": torch.tensor([0.5])}
    cfg = TO.OptConfig(lr=0.1, warmup=1, weight_decay=0.0)
    state = TO.opt_init(kind, p)
    losses = []
    for _ in range(50):
        losses.append(float((p["w"] ** 2).sum() + (p["b"] ** 2).sum()))
        g = {"w": 2 * p["w"], "b": 2 * p["b"]}
        TO.opt_update(kind, cfg, p, g, state)
    assert losses[-1] < 0.2 * losses[0]


def test_clip_by_global_norm_matches_the_reference():
    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal((4, 8)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32) * 10}
    want, wn = RO.clip_by_global_norm(g, 1.0)
    tg = {"a": [torch.tensor(g["a"][i]) for i in range(4)],
          "b": torch.tensor(g["b"])}
    got, gn = TO.clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    np.testing.assert_allclose(torch.stack(got["a"]).numpy(), want["a"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["b"].numpy(), want["b"], rtol=1e-6)
    # below the bar nothing moves
    small = {"a": torch.full((3,), 0.1)}
    TO.clip_by_global_norm(small, 1.0)
    assert torch.equal(small["a"], torch.full((3,), 0.1))


def test_compression_is_the_reference_s_bit_for_bit():
    rng = np.random.default_rng(1)
    g = {"w": rng.standard_normal(1000).astype(np.float32),
         "m": rng.standard_normal((3, 7)).astype(np.float32)}
    tg = {"w": torch.tensor(g["w"]), "m": [torch.tensor(r) for r in g["m"]]}
    want = RCMP.compress_decompress(g)
    got = TCMP.compress_decompress(tg)
    assert np.array_equal(got["w"].numpy(), np.asarray(want["w"]))
    assert np.array_equal(torch.stack(got["m"]).numpy(),
                          np.asarray(want["m"]))
    res, tres = RCMP.init_residual(g), TCMP.init_residual(tg)
    for _ in range(5):
        comp, res = RCMP.compress_with_feedback(g, res)
        tcomp, tres = TCMP.compress_with_feedback(tg, tres)
        assert np.array_equal(tcomp["w"].numpy(), np.asarray(comp["w"]))
        assert np.array_equal(torch.stack(tres["m"]).numpy(),
                              np.asarray(res["m"]))


def test_gradient_compression_error_feedback():
    """The reference's error-feedback test, on the port."""
    g = {"w": torch.from_numpy(np.random.default_rng(0)
                               .standard_normal(1000).astype(np.float32))}
    res = TCMP.init_residual(g)
    acc = torch.zeros(1000)
    for _ in range(20):
        comp, res = TCMP.compress_with_feedback(g, res)
        acc = acc + comp["w"]
    err_fb = float((acc - 20 * g["w"]).abs().max())
    naive = sum(g["w"].to(torch.bfloat16).float() for _ in range(20))
    assert err_fb < float((naive - 20 * g["w"]).abs().max())
