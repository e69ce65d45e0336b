"""The port's training loss and gradients against the reference's, as in
``tests/test_torch_train_loss.py``, for the prefix (phi3-vision), MoE
(Grok-1, Llama-4 Scout), Mamba-2 (Zamba2, whose shared block runs once a
group) and xLSTM smoke configs.  Zamba2's K10 runs through its
``autograd.Function`` (``kernels.ssm_scan.SSMStateScan``), which on CPU
tensors runs the plain forward and the plain backward
(``ssm_state_scan_bwd_ref``); on the card, the kernels."""

import pytest

from _torch_train_ref import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_loss import check_loss_and_grads

ARCHS = ("phi3_vision_4p2b", "grok1_314b", "llama4_scout_17b_a16e",
         "zamba2_7b", "xlstm_1p3b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    check_loss_and_grads(arch)


def test_mamba2_gradient_finite_where_the_masked_decay_overflows():
    """Past float32's exponent range inside a chunk (here A_log 4: |dt A|
    ~ 70 a step, chunks of 16), the reference's intra-chunk decay
    ``where(tri, exp(cum_l - cum_s), 0)`` overflows above the diagonal and
    its gradient is NaN (0 x inf); at Zamba2-7B's full width (chunks of
    128, A_log 1 at init) that happens from the first step.  The port
    masks before the exponent: the same loss, finite gradients, and their
    directional derivative equal to the central difference of the
    reference's own loss within 2e-2."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.models import transformer as RT
    from repro_torch.models import loss_fn

    from _torch_train_ref import (batch, configs, port_grads, port_model,
                                  ref_params)

    rcfg, cfg = configs("zamba2_7b")
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.full_like(x, 4.0)
        if "A_log" in jax.tree_util.keystr(path) else x, ref_params(rcfg))
    toks, labs, _ = batch(cfg, 2, 64, seed=3)
    f = jax.jit(lambda p: RT.loss_fn(p, toks, labs, rcfg, dtype=jnp.float32))
    want_loss, want = jax.value_and_grad(f)(params)
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(want))
    model = port_model(cfg, params)
    loss = loss_fn(model, torch.from_numpy(toks), torch.from_numpy(labs),
                   dtype=torch.float32)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = port_grads(model)
    leaves = [np.asarray(g, np.float64) for g in jax.tree.leaves(got)]
    assert all(np.isfinite(g).all() for g in leaves)
    rng = np.random.default_rng(0)
    # a direction of the weights' own scale (0.02); the central
    # difference in float32 is good to ~1e-3 of the derivative here
    v = jax.tree.map(lambda x: (0.02 * rng.standard_normal(x.shape)).astype(
        np.float32), params)
    dot = sum(float((g * np.asarray(d, np.float64)).sum())
              for g, d in zip(leaves, jax.tree.leaves(v)))
    eps = 1e-2
    shift = lambda s: jax.tree.map(lambda p, d: p + s * eps * d, params, v)
    fd = (float(f(shift(1.0))) - float(f(shift(-1.0)))) / (2 * eps)
    assert abs(dot - fd) <= 2e-2 * abs(fd), (dot, fd)
