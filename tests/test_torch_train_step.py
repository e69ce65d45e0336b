"""The port's train step (``repro_torch.train.train_step``) against the
reference's, on the CPU, with ``grad_accum`` 2 over 3 steps.

* float32: the reference's ``make_train_step`` never reads
  ``compute_dtype`` (it always computes in bf16; ROADMAP queue 3), so the
  port's float32 step is held against a composition, written here, of the
  reference's own ``loss_fn(dtype=float32)``, microbatch accumulation in
  its order, ``clip_by_global_norm`` and ``opt_update``: loss and
  grad_norm at rtol 1e-5, the optimizer state at rtol 1e-4 / atol 1e-6,
  the parameters as ``_assert_params_close`` says, after every step.
* bfloat16: against the reference's ``make_train_step`` itself, within
  the reference's own distance between its bf16 step and the float32
  composition.
* A reference ``TrainState`` after 2 steps carried into the port
  (``load_reference_state``), then step 3 in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import make_batch as ref_make_batch
from repro.models import transformer as RT
from repro.parallel.compression import compress_decompress
from repro.train import optimizer as RO
from repro.train import train_step as RTS

from repro_torch.models import load_reference_state, param_tree
from repro_torch.models import reference_tree
from repro_torch.train import optimizer as TO
from repro_torch.train.train_step import (TrainConfig, init_state,
                                          make_train_step)

from _torch_train_ref import one_torch_thread  # noqa: F401 (autouse)
from _torch_train_ref import (assert_trees_close, configs, port_model,
                              ref_params)

A, B, S = 2, 4, 32


def ref_f32_step(rcfg, ocfg, compression=False):
    """The reference's train step computing in float32: its loss_fn with
    dtype=float32 in its own microbatch order, then its clip and update."""
    grad_fn = jax.value_and_grad(lambda p, t, l: RT.loss_fn(
        p, t, l, rcfg, dtype=jnp.float32))

    def step(state, tokens, labels):
        mb = tokens.shape[0] // A
        grads = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                             state.params)
        tot = jnp.zeros((), jnp.float32)
        for i in range(A):
            loss, g = grad_fn(state.params, tokens[i * mb:(i + 1) * mb],
                              labels[i * mb:(i + 1) * mb])
            grads = jax.tree.map(lambda a, b: a + b, grads, g)
            tot = tot + loss
        grads = jax.tree.map(lambda g: g / A, grads)
        if compression:
            grads = compress_decompress(grads)
        grads, gn = RO.clip_by_global_norm(grads, ocfg.clip_norm)
        params, opt = RO.opt_update(rcfg.optimizer, ocfg, state.params,
                                    grads, state.opt)
        return (RTS.TrainState(params, opt, state.step + 1),
                {"loss": tot / A, "grad_norm": gn})

    return jax.jit(step)


def _batches(cfg, n):
    dcfg = RDataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=4)
    return [ref_make_batch(dcfg, i) for i in range(n)]


def _torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _assert_params_close(got, want, lr):
    """Parameters after AdamW or Adafactor steps: 99.9 % of the elements
    within rtol 1e-4 / atol 1e-6, every one within 0.05 lr.  A normalised
    step m / (sqrt(v) + eps) of a gradient element at the two frameworks'
    round-off (|g| ~ 1e-6 of the largest, where the loss tests hold the
    gradients) is a ratio of two such round-offs, so a few elements move
    by a fraction of lr (seen: 0.011 lr)."""
    a = np.concatenate([x.ravel() for x in jax.tree.leaves(got)])
    b = np.concatenate([x.ravel() for x in jax.tree.leaves(want)])
    near = np.abs(a - b) <= 1e-6 + 1e-4 * np.abs(b)
    assert near.mean() >= 0.999, near.mean()
    assert np.abs(a - b).max() <= 0.05 * lr, np.abs(a - b).max()


def _assert_state_close(tstate, rstate, rtol, atol, lr=None):
    got = reference_tree(param_tree(tstate.params))
    want = jax.tree.map(np.asarray, rstate.params)
    if lr is None:
        assert_trees_close(got, want, rtol, atol)
    else:
        assert jax.tree.structure(got) == jax.tree.structure(want)
        _assert_params_close(got, want, lr)
    for field in rstate.opt._fields[:-1]:
        assert_trees_close(reference_tree(getattr(tstate.opt, field)),
                           jax.tree.map(np.asarray,
                                        getattr(rstate.opt, field)),
                           rtol, atol)
    assert int(tstate.opt.count) == int(rstate.opt.count)
    assert tstate.step == int(rstate.step)


@pytest.mark.parametrize("arch,changes,compression", [
    ("granite_8b", {}, False), ("zamba2_7b", {}, False),
    ("grok1_314b", {}, True),
    # a window shorter than the batch's S tokens, so the local mask cuts
    ("gemma2_2b", {"window": 8}, False)],
    ids=["granite-adamw", "zamba2-adamw", "grok1-adafactor-compressed",
         "gemma2-adamw"])
def test_f32_train_step_matches_the_reference_composition(arch, changes,
                                                         compression):
    rcfg, cfg = configs(arch, **changes)
    params = ref_params(rcfg)
    ocfg = RO.OptConfig(lr=1e-3, warmup=2)
    rstate = RTS.init_state(rcfg, params)
    tstate = init_state(cfg, port_model(cfg, params))
    rstep = ref_f32_step(rcfg, ocfg, compression)
    tstep = make_train_step(cfg, TrainConfig(
        grad_accum=A, compute_dtype=torch.float32,
        opt=TO.OptConfig(lr=1e-3, warmup=2), grad_compression=compression))
    for b in _batches(cfg, 3):
        rstate, rm = rstep(rstate, b["tokens"], b["labels"])
        tstate, tm = tstep(tstate, _torch_batch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-5)
        assert tm["step"] == tstate.step
        _assert_state_close(tstate, rstate, 1e-4, 1e-6, lr=1e-3)
    assert all(p.grad is None for p in tstate.params.parameters())


def test_bf16_train_step_holds_to_the_reference_s():
    """The port's bf16 step against the reference's ``make_train_step``
    (which computes in bf16): the distance of the losses and of the
    parameters after 3 steps within the reference's own distance between
    that bf16 step and its float32 composition."""
    rcfg, cfg = configs("granite_8b")
    params = ref_params(rcfg)
    ocfg = RO.OptConfig(lr=1e-3, warmup=2)
    r16 = jax.jit(RTS.make_train_step(rcfg, RTS.TrainConfig(
        grad_accum=A, opt=ocfg)))
    r32 = ref_f32_step(rcfg, ocfg)
    s16 = s32 = RTS.init_state(rcfg, params)
    tstate = init_state(cfg, port_model(cfg, params))
    tstep = make_train_step(cfg, TrainConfig(
        grad_accum=A, compute_dtype=torch.bfloat16,
        opt=TO.OptConfig(lr=1e-3, warmup=2)))
    d_port, d_ref = [], []
    for b in _batches(cfg, 3):
        s16, m16 = r16(s16, b)
        s32, m32 = r32(s32, b["tokens"], b["labels"])
        tstate, tm = tstep(tstate, _torch_batch(b))
        d_port.append(abs(float(tm["loss"]) - float(m16["loss"])))
        d_ref.append(abs(float(m16["loss"]) - float(m32["loss"])))
    assert max(d_port) <= max(d_ref), (d_port, d_ref)
    got = reference_tree(param_tree(tstate.params))
    p16, p32 = (jax.tree.map(np.asarray, s.params) for s in (s16, s32))
    dist = lambda a, b: np.mean(np.abs(np.concatenate(
        [x.ravel() for x in jax.tree.leaves(a)])
        - np.concatenate([x.ravel() for x in jax.tree.leaves(b)])))
    assert dist(got, p16) <= dist(p16, p32), (dist(got, p16),
                                              dist(p16, p32))


def test_reference_state_carried_across_then_step_3():
    """A reference TrainState after 2 steps (params, AdamW moments and
    count, step) carried into the port; the third step agrees."""
    rcfg, cfg = configs("granite_8b")
    ocfg = RO.OptConfig(lr=1e-3, warmup=2)
    rstep = ref_f32_step(rcfg, ocfg)
    rstate = RTS.init_state(rcfg, ref_params(rcfg))
    batches = _batches(cfg, 3)
    for b in batches[:2]:
        rstate, _ = rstep(rstate, b["tokens"], b["labels"])
    tstate = init_state(cfg, port_model(cfg, ref_params(rcfg, seed=5)))
    tstate = load_reference_state(tstate, rstate)
    _assert_state_close(tstate, rstate, 0.0, 0.0)
    rstate, rm = rstep(rstate, batches[2]["tokens"], batches[2]["labels"])
    tstate, tm = make_train_step(cfg, TrainConfig(
        grad_accum=A, compute_dtype=torch.float32,
        opt=TO.OptConfig(lr=1e-3, warmup=2)))(tstate,
                                              _torch_batch(batches[2]))
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    _assert_state_close(tstate, rstate, 1e-4, 1e-6, lr=1e-3)
