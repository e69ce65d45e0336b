"""The port's mixture of experts (``repro_torch.models.layers.MoE``)
against the reference's ``repro.models.layers.moe`` on the CPU.

The reference dispatches and combines with one-hot ``(tc, E, C)``
products; the port gathers each kept choice's token into its expert's slot
and adds the outputs back by index.  Both must compute the same function
and drop the same (token, choice) pairs: capacity C per chunk of
``token_chunk`` tokens, a choice's place in its expert's queue counted over
the chunk's (token, choice) pairs in order.  Inputs come from numpy with a
seed; the reference's parameters are carried over.  The layer is held at
``TOL`` (1e-5, float32, as the model paths), the routing exactly, at
Llama-4 Scout's routing (16 experts, top-1, a shared expert) and Grok-1's
(8 experts, top-2, GeLU experts), both at the real capacity factor 1.25
so that tokens drop, over several chunks of 64 tokens and at a decode
step's 8 tokens (Scout: C = 1)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.parallel.sharding import init_params as ref_init_params

from repro_torch import configs as TC
from repro_torch.models import (Transformer, init_params,
                                load_reference_params)
from repro_torch.models import layers as TL

TOL = 1e-5
# each model's expert routing at the real capacity factor, narrow widths
NARROW = dict(d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
              vocab=256, n_layers=2)
ARCHS = ("llama4_scout_17b_a16e", "grok1_314b")


def _configs(arch):
    return (dataclasses.replace(RC.get_config(arch), **NARROW),
            dataclasses.replace(TC.get_config(arch), **NARROW))


def _moe(arch, seed=0):
    """The reference's MoE parameters and the port's layer holding them."""
    cfg, tcfg = _configs(arch)
    p = ref_init_params(RL.moe_pdefs(cfg), jax.random.PRNGKey(seed))
    layer = TL.MoE(tcfg, dtype=torch.float32, device="cpu")
    for name, t in layer.named_parameters():
        leaf = p
        for key in name.split("."):
            leaf = leaf[key]
        t.data.copy_(torch.tensor(np.asarray(leaf)))
    assert sum(t.numel() for t in layer.parameters()) == sum(
        a.size for a in jax.tree.leaves(p))
    return cfg, p, layer


def _reference_routing(p, xc, cfg, C):
    """The kept (token, expert, slot) triples and their gates of one chunk,
    step by step as the reference's ``moe`` computes them
    (``models/layers.py:288-296``)."""
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    tc = xc.shape[0]
    logits = (xc @ p["router"].astype(xc.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, K)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                        1e-9)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.float32)
    pos = jnp.cumsum(onehot.reshape(tc * K, E), axis=0).reshape(
        tc, K, E) * onehot - 1.0
    keep = np.asarray((pos >= 0) & (pos < C))
    pos, gate_vals = np.asarray(pos), np.asarray(gate_vals)
    t, k, e = np.nonzero(keep)
    return {(int(a), int(b), int(pos[a, c, b])): float(gate_vals[a, c])
            for a, c, b in zip(t, k, e)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,S,chunk", [(4, 48, 64), (2, 96, 64),
                                       (8, 1, 8192)],
                         ids=["4x48 in 3 chunks", "2x96 in 3 chunks",
                              "decode B=8"])
def test_moe_matches_reference(arch, B, S, chunk):
    """The layer's output against ``moe(..., token_chunk=chunk)``; the
    routing of every chunk, choice for choice, against the reference's,
    with choices dropped (capacity factor 1.25)."""
    cfg, p, layer = _moe(arch, B * S)
    x = np.random.default_rng(B * S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    want = RL.moe(p, jnp.asarray(x), cfg, token_chunk=chunk)
    got = layer(torch.from_numpy(x), token_chunk=chunk)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    tc = min(chunk, B * S)
    C = layer.capacity(tc)
    assert C == min(tc, max(1, int(tc * cfg.moe.top_k / cfg.moe.n_experts
                                   * cfg.moe.capacity_factor)))
    xt = x.reshape(-1, cfg.d_model)
    dropped = 0
    for c0 in range(0, B * S, tc):
        expert, gate, slot, keep = layer.route(
            torch.from_numpy(xt[c0:c0 + tc]))
        token = torch.arange(tc)[:, None].expand_as(expert)
        mine = {(int(a), int(b), int(c)): float(g)
                for a, b, c, g in zip(token[keep], expert[keep], slot[keep],
                                      gate[keep])}
        n_drop = int((~keep).sum())
        ref = _reference_routing(p, jnp.asarray(xt[c0:c0 + tc]), cfg, C)
        assert mine.keys() == ref.keys()
        for key, g in mine.items():
            assert abs(g - ref[key]) <= 1e-6, key
        assert len(mine) + n_drop == tc * cfg.moe.top_k
        dropped += n_drop
    assert dropped > 0  # the capacity binds
    if S == 1 and arch.startswith("llama4"):
        assert C == 1


def test_moe_drops_by_queue_order():
    """Capacity by (token, choice) order, counted anew in each chunk: with
    every token routed to one expert, the first C tokens of each chunk keep
    it and the rest get only the shared expert."""
    cfg, p, layer = _moe("llama4_scout_17b_a16e")
    with torch.no_grad():
        layer.router.zero_()
        layer.router[:, 3] = 1.0  # every token with positive sum -> expert 3
    x = torch.rand(1, 128, cfg.d_model) + 0.1
    y = layer(x, token_chunk=64)
    shared = layer.shared(x)
    C = layer.capacity(64)
    routed = (y - shared).abs().amax(-1)[0]
    for c0 in (0, 64):
        assert routed[c0:c0 + C].min() > 0
        assert not routed[c0 + C:c0 + 64].any()
    want = RL.moe(jax.tree.map(jnp.asarray, {
        k: (v if k != "router" else np.asarray(layer.router))
        for k, v in p.items()}), jnp.asarray(x.numpy()), cfg, token_chunk=64)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_moe_checks_its_chunks():
    cfg, _, layer = _moe("grok1_314b")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        layer(torch.zeros(1, 100, cfg.d_model), token_chunk=64)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_weights_follow_the_reference(arch):
    """``load_reference_params`` fills the router, the (G, E, d, f) experts
    (``wg`` only for gated ones) and the shared expert of each group;
    ``init_params`` draws them normal x 0.02, as the reference's rule."""
    cfg, tcfg = _configs(arch)
    tree = jax.tree.map(np.asarray, ref_init_params(
        RT.model_pdefs(cfg), jax.random.PRNGKey(1)))
    model = load_reference_params(
        Transformer(tcfg, dtype=torch.float32, device="cpu"), tree)
    ffn = tree["blocks"]["s0_attn"]["ffn"]
    assert ffn["wi"].shape == (2, cfg.moe.n_experts, cfg.d_model, cfg.d_ff)
    for g in range(cfg.n_groups):
        mine = model.layers[g].ffn
        assert isinstance(mine, TL.MoE)
        for name, t in mine.named_parameters():
            leaf = ffn
            for key in name.split("."):
                leaf = leaf[key]
            assert torch.equal(t, torch.tensor(leaf[g])), name
    assert hasattr(model.layers[0].ffn, "wg") == (cfg.act != "gelu")
    assert (model.layers[0].ffn.shared is not None) == \
        cfg.moe.shared_expert
    fresh = init_params(Transformer(tcfg, dtype=torch.float32,
                                    device="cpu"), 3)
    for name, t in fresh.layers[1].ffn.named_parameters():
        assert 0.015 < t.std().item() < 0.025, name
