"""The port's training forward (``repro_torch.models.loss_fn`` with
``mode="train"``, each group under ``torch.utils.checkpoint`` where
``remat == "block"``) and its gradients, against the reference's
``jax.value_and_grad(loss_fn(..., dtype=float32))``, for the dense, the
sliding-window and the cross-attention-free audio families' smoke
configs; ``tests/test_torch_train_loss_hybrid.py`` takes the prefix,
MoE, Mamba-2 and xLSTM ones.  The reference's parameters are carried in
with ``load_reference_params``; the port's gradients are mapped back onto
the reference's stacked tree (``reference_tree``).  Bars: the loss within
1e-5 relative, every gradient within rtol 1e-4 / atol 1e-6.  On the CPU
the kernels' plain versions run (through K8's and K9's
``autograd.Function``s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as RT

from repro_torch.models import loss_fn

from _torch_train_ref import one_torch_thread  # noqa: F401 (autouse)
from _torch_train_ref import (assert_trees_close, batch, configs,
                              port_grads, port_model, ref_params)

ARCHS = ("granite_8b", "gemma2_2b", "deepseek_coder_33b",
         "command_r_plus_104b", "musicgen_medium")
B, S = 2, 64


def check_loss_and_grads(arch):
    rcfg, cfg = configs(arch)
    params = ref_params(rcfg)
    toks, labs, pre = batch(cfg, B, S, seed=7)
    f = jax.value_and_grad(lambda p, t, l, x: RT.loss_fn(
        p, t, l, rcfg, prefix_embeds=x, dtype=jnp.float32))
    want_loss, want = jax.jit(f)(params, toks, labs, pre)
    model = port_model(cfg, params)
    loss = loss_fn(model, torch.from_numpy(toks), torch.from_numpy(labs),
                   prefix_embeds=None if pre is None
                   else torch.from_numpy(pre), dtype=torch.float32)
    assert loss.dtype == torch.float32 and loss.shape == ()
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert_trees_close(port_grads(model), jax.tree.map(np.asarray, want),
                       rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    check_loss_and_grads(arch)


def test_remat_recomputes_the_same_gradients():
    """``remat == "block"`` (checkpointed groups and loss chunks) gives the
    gradients of the plain graph bit for bit; ``vocab_chunk`` only splits
    the sum."""
    _, cfg = configs("granite_8b")
    _, cfg_none = configs("granite_8b", remat="none")
    rcfg, _ = configs("granite_8b")
    params = ref_params(rcfg, seed=3)
    toks, labs, _ = batch(cfg, B, S, seed=1)
    grads = []
    for c, chunk in ((cfg, 16), (cfg_none, 16), (cfg, 64)):
        model = port_model(c, params)
        loss = loss_fn(model, torch.from_numpy(toks), torch.from_numpy(labs),
                       dtype=torch.float32, vocab_chunk=chunk)
        loss.backward()
        grads.append((float(loss), [p.grad.clone() for p in
                                    model.parameters()]))
    assert grads[0][0] == grads[1][0]
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))
    np.testing.assert_allclose(grads[2][0], grads[0][0], rtol=1e-6)


def test_loss_fn_without_grad_builds_no_graph():
    rcfg, cfg = configs("granite_8b")
    model = port_model(cfg, ref_params(rcfg))
    toks, labs, _ = batch(cfg, B, S, seed=2)
    with torch.no_grad():
        loss = loss_fn(model, torch.from_numpy(toks), torch.from_numpy(labs),
                       dtype=torch.float32)
    assert loss.grad_fn is None and torch.isfinite(loss)
