"""The port's LM serving path (``repro_torch.models``) against the
reference's jnp model (``repro.models.transformer``) on the CPU.

The reference's parameters (``init_params`` from a PRNG key) are carried
into the port with ``load_reference_params``; prompts and prefix embeddings
are drawn with numpy from a seed and handed to both.  In float32 the
port's ``prefill`` (last-position logits and KV caches) and 8 greedy
``decode_step``s must agree with the reference's at rtol = atol = 1e-5,
with identical tokens, for the dense ``attn`` configs; on the CPU the
kernels' plain versions run (the card runs K8/K9, ``tests/test_torch_cuda.py``
and ``chip_smoke.py``)."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import transformer as RT
from repro.models.config import SHAPES as REF_SHAPES
from repro.parallel.sharding import init_params as ref_init_params

from repro_torch import configs as TC
from repro_torch.kernels import library
from repro_torch.models import (SHAPES, Transformer, count_params,
                                decode_step, forward, init_caches,
                                init_params, load_reference_params, prefill)

TOL = 1e-5
N_DECODE = 8
SERVED = ("granite_8b", "deepseek_coder_33b", "command_r_plus_104b",
          "musicgen_medium", "phi3_vision_4p2b")
# Granite's own head width (128) and GQA ratio (4), at two narrow layers
NARROW_GRANITE = dict(name="granite-8b-narrow", n_layers=2, d_model=256,
                      n_heads=8, n_kv_heads=2, d_head=128, d_ff=512,
                      vocab=256)
UNPORTED = {"gemma2_2b": "12b", "grok1_314b": "12c",
            "llama4_scout_17b_a16e": "12c", "zamba2_7b": "12d",
            "xlstm_1p3b": "12e"}


def _served(name):
    """(reference config, the port's, prompt length)."""
    if name == "granite_8b_narrow":
        return (dataclasses.replace(RC.get_config("granite_8b"),
                                    **NARROW_GRANITE),
                dataclasses.replace(TC.get_config("granite_8b"),
                                    **NARROW_GRANITE), 256)
    return RC.smoke_config(name), TC.smoke_config(name), 32


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def _grow(caches, n):
    """The reference's serving driver grows its prefill caches by ``n``
    slots (``examples/serve_lm.py``)."""
    def grow(path, leaf):
        names = [getattr(k, "key", "") for k in path]
        if ("k" in names or "v" in names) and leaf.ndim == 5:
            pad = jnp.zeros(leaf.shape[:2] + (n,) + leaf.shape[3:],
                            leaf.dtype)
            return jnp.concatenate([leaf, pad], axis=2)
        return leaf
    return jax.tree_util.tree_map_with_path(grow, caches)


def _check_caches(ref_caches, port_caches, cfg, length):
    slot = "s0_attn"
    for g in range(cfg.n_groups):
        for kv in ("k", "v"):
            want = np.asarray(ref_caches[slot][kv][g])[:, :length]
            got = port_caches[g][kv][:, :length].numpy()
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_configs_are_the_reference_configs(arch):
    for get in ("get_config", "smoke_config"):
        want, got = getattr(RC, get)(arch), getattr(TC, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.n_params() == want.n_params()
        assert got.n_active_params() == want.n_active_params()
        assert got.n_groups == want.n_groups
    assert TC.ARCH_IDS == RC.ARCH_IDS
    assert TC._ALIASES == RC._ALIASES
    assert [dataclasses.asdict(s) for s in SHAPES] == \
        [dataclasses.asdict(s) for s in REF_SHAPES]


@pytest.mark.parametrize("name", SERVED + ("granite_8b_narrow",))
def test_prefill_and_greedy_decode_match_reference(name):
    cfg, tcfg, S = _served(name)
    params = ref_init_params(RT.model_pdefs(cfg), jax.random.PRNGKey(0))
    model = Transformer(tcfg, dtype=torch.float32, device="cpu")
    load_reference_params(model, _numpy_tree(params))
    rng = np.random.default_rng(S + len(name))
    B, npre = 2, cfg.n_prefix_embeds
    tokens = rng.integers(0, cfg.vocab, (B, S - npre)).astype(np.int32)
    prefix = (rng.standard_normal((B, npre, cfg.d_model)).astype(np.float32)
              if npre else None)

    want, rcaches = RT.prefill(
        params, jnp.asarray(tokens), cfg, dtype=jnp.float32,
        prefix_embeds=None if prefix is None else jnp.asarray(prefix))
    library.reset_launches()
    got, tcaches = prefill(
        model, torch.from_numpy(tokens), cache_len=S + N_DECODE,
        prefix_embeds=None if prefix is None else torch.from_numpy(prefix))
    assert sum(library.LAUNCHES.values()) == 0  # CPU: the plain versions
    assert got.dtype == torch.float32 and got.shape == (B, 1, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    _check_caches(rcaches, tcaches, cfg, S)
    assert not any(c[kv][:, S:].any() for c in tcaches for kv in "kv")

    rcaches = _grow(rcaches, N_DECODE)
    ref_decode = jax.jit(partial(RT.decode_step, cfg=cfg, dtype=jnp.float32))
    rtok = jnp.argmax(want, -1).astype(jnp.int32)
    ttok = got.argmax(-1)
    for i in range(N_DECODE):
        assert np.array_equal(np.asarray(rtok), ttok.numpy())
        want, rcaches = ref_decode(params, rtok, rcaches, jnp.int32(S + i))
        got, tcaches = decode_step(model, ttok, tcaches, S + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        rtok = jnp.argmax(want, -1).astype(jnp.int32)
        ttok = got.argmax(-1)
    assert np.array_equal(np.asarray(rtok), ttok.numpy())
    _check_caches(rcaches, tcaches, cfg, S + N_DECODE)


def test_forward_train_mode_matches_reference():
    cfg = RC.smoke_config("command_r_plus_104b")
    params = ref_init_params(RT.model_pdefs(cfg), jax.random.PRNGKey(3))
    model = Transformer(TC.smoke_config("command_r_plus_104b"),
                        dtype=torch.float32, device="cpu")
    load_reference_params(model, _numpy_tree(params))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
    want, _ = RT.forward(params, jnp.asarray(tokens), cfg, dtype=jnp.float32)
    got, caches = forward(model, torch.from_numpy(tokens))
    assert caches is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch", SERVED)
def test_count_params_of_the_full_model(arch):
    """Full width and depth on the meta device (no memory): the same
    parameters as the reference's ``ParamDef`` tree (Granite-8B: 8.17 G)."""
    model = Transformer(TC.get_config(arch), device="meta")
    assert count_params(model) == RT.count_params(RC.get_config(arch))
    assert model.device.type == "meta"


@pytest.mark.parametrize("arch", sorted(UNPORTED))
def test_unported_architectures_raise(arch):
    with pytest.raises(NotImplementedError, match=f"item {UNPORTED[arch]}"):
        Transformer(TC.smoke_config(arch), device="cpu")
    with pytest.raises(NotImplementedError, match=f"item {UNPORTED[arch]}"):
        init_caches(TC.smoke_config(arch), 1, 8, device="cpu")


def test_quantized_weights_raise():
    model = init_params(Transformer(TC.smoke_config("granite_8b"),
                                    dtype=torch.float32, device="cpu"))
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="item 12f"):
        prefill(model, tokens, quantized=True)
    caches = init_caches(model.cfg, 1, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="item 12f"):
        decode_step(model, tokens[:, :1], caches, 0, quantized=True)


def test_init_params_is_seeded_normal_with_zero_norms():
    cfg = TC.smoke_config("granite_8b")
    a = init_params(Transformer(cfg, dtype=torch.float32, device="cpu"), 5)
    b = init_params(Transformer(cfg, dtype=torch.float32, device="cpu"), 5)
    c = init_params(Transformer(cfg, dtype=torch.bfloat16, device="cpu"), 5)
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(p.to(torch.bfloat16), r), name  # f32 draws, cast
        if name.rsplit(".", 1)[-1] in ("ln1", "ln2", "final_norm"):
            assert not p.any(), name
        else:
            assert 0.015 < p.std().item() < 0.025, name
    other = init_params(Transformer(cfg, dtype=torch.float32, device="cpu"),
                        6)
    assert not torch.equal(a.embed, other.embed)


def test_load_reference_params_checks_the_tree():
    cfg = RC.smoke_config("granite_8b")
    tree = _numpy_tree(ref_init_params(RT.model_pdefs(cfg),
                                       jax.random.PRNGKey(0)))
    model = Transformer(TC.smoke_config("granite_8b"), dtype=torch.bfloat16,
                        device="cpu")
    load_reference_params(model, tree)
    assert model.layers[1].attn.wq.dtype == torch.bfloat16
    assert torch.equal(model.layers[1].attn.wq,
                       torch.tensor(tree["blocks"]["s0_attn"]["attn"]["wq"][1])
                       .to(torch.bfloat16))
    bad = dict(tree, unembed=tree["unembed"][:, :8])
    with pytest.raises(ValueError, match="shape"):
        load_reference_params(model, bad)
    with pytest.raises(ValueError, match="no place"):
        load_reference_params(model, dict(tree, extra=np.zeros(3)))
    with pytest.raises(ValueError, match="no final_norm"):
        load_reference_params(model, {k: v for k, v in tree.items()
                                      if k != "final_norm"})
