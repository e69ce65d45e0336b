"""The port's LM serving path (``repro_torch.models``) against the
reference's jnp model (``repro.models.transformer``) on the CPU.

The reference's parameters (``init_params`` from a PRNG key) are carried
into the port with ``load_reference_params``; prompts and prefix embeddings
are drawn with numpy from a seed and handed to both.  In float32 the
port's ``prefill`` (last-position logits and KV caches) and 8 greedy
``decode_step``s must agree with the reference's at rtol = atol = 1e-5,
with identical tokens and every cache (KV, Mamba-2's ``conv``/``ssm``,
mLSTM's ``C``/``n``, sLSTM's ``h``/``c``/``n``/``m``) alike, for the dense
``attn`` configs, the MoE models, Zamba2 and xLSTM; on the CPU the kernels'
plain versions run (the card runs K8/K9/K10, ``tests/test_torch_cuda.py``
and ``chip_smoke.py``).  In bfloat16 the port's logits must sit as close to
the reference's bf16 logits as those sit to its float32 ones."""

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
          "musicgen_medium", "phi3_vision_4p2b", "zamba2_7b", "grok1_314b",
          "llama4_scout_17b_a16e", "xlstm_1p3b")
# Gemma-2 is served too; its decode past the window is held against the
# reference's forward, not its decode_step (tests/test_torch_gemma2.py)
FULL_SIZE = SERVED + ("gemma2_2b",)
# Granite's own head width (128) and GQA ratio (4), at two narrow layers
NARROW_GRANITE = dict(name="granite-8b-narrow", n_layers=2, d_model=256,
                      n_heads=8, n_kv_heads=2, d_head=128, d_ff=512,
                      vocab=256)
# Zamba2-7B's head widths (attention d_head 112; SSM P = N = 64, chunk
# 128), one group: the shared block and 3 Mamba-2 layers
NARROW_ZAMBA2 = dict(name="zamba2-7b-narrow", n_layers=3, d_model=256,
                     n_heads=4, n_kv_heads=4, d_head=112, d_ff=512,
                     vocab=256)
# Llama-4 Scout's head width (128), GQA ratio (5) and routing (16 experts,
# top-1, a shared expert, capacity factor 1.25: prefill and decode drop)
NARROW_SCOUT = dict(name="llama4-scout-narrow", n_layers=2, d_model=256,
                    n_heads=10, n_kv_heads=2, d_head=128, d_ff=512,
                    vocab=256)
NARROW = {"granite_8b_narrow": ("granite_8b", NARROW_GRANITE),
          "zamba2_7b_narrow": ("zamba2_7b", NARROW_ZAMBA2),
          "llama4_scout_narrow": ("llama4_scout_17b_a16e", NARROW_SCOUT)}
# Gemma-2's head width (256), window 64 (a prompt of 256 runs past it),
# sandwich norms and softcaps; bf16 logits only (its decode past the
# window is not the reference's decode_step)
NARROW_GEMMA2 = dict(name="gemma2-2b-narrow", n_layers=2, d_model=256,
                     n_heads=4, n_kv_heads=2, d_head=256, d_ff=512,
                     vocab=256, window=64)
BF16_NARROW = dict(NARROW, gemma2_2b_narrow=("gemma2_2b", NARROW_GEMMA2))
# Zamba2's smoke config with the shared block named mid-pattern, two
# groups: the reference's group_body still applies it first in each group
SHARED_MID = {"zamba2_7b_shared_mid": (
    "zamba2_7b", dict(name="zamba2-7b-shared-mid", n_layers=4,
                      pattern=("mamba2", "shared_attn", "mamba2")))}


def _served(name):
    """(reference config, the port's, prompt length)."""
    if name in BF16_NARROW:
        arch, narrow = BF16_NARROW[name]
        return (dataclasses.replace(RC.get_config(arch), **narrow),
                dataclasses.replace(TC.get_config(arch), **narrow), 256)
    if name in SHARED_MID:
        arch, mid = SHARED_MID[name]
        return (dataclasses.replace(RC.smoke_config(arch), **mid),
                dataclasses.replace(TC.smoke_config(arch), **mid), 32)
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
    """Every cache of the port (one per block application, group by group:
    the shared block's first, then the mixer slots', as the reference's
    ``group_body`` runs them) against the reference's (per slot, stacked
    over groups; the shared block's under "shared"): the first ``length``
    slots of a KV cache, the whole of a Mamba-2 one."""
    slots = (["shared"] if "shared_attn" in cfg.pattern else []) + [
        f"s{i}_{b}" for i, b in enumerate(cfg.pattern) if b != "shared_attn"]
    assert len(port_caches) == cfg.n_groups * len(slots)
    for g in range(cfg.n_groups):
        for j, slot in enumerate(slots):
            cache = port_caches[g * len(slots) + j]
            assert sorted(cache) == sorted(ref_caches[slot])
            for leaf, want in ref_caches[slot].items():
                want, got = np.asarray(want[g]), cache[leaf].numpy()
                if leaf in ("k", "v"):
                    want, got = want[:, :length], got[:, :length]
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


@pytest.mark.parametrize("name", SERVED + tuple(NARROW) + tuple(SHARED_MID))
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
    assert not any(c[kv][:, S:].any() for c in tcaches if "k" in c
                   for kv in "kv")

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


@pytest.mark.parametrize("arch", FULL_SIZE)
def test_count_params_of_the_full_model(arch):
    """Full width and depth on the meta device (no memory): the same
    parameters as the reference's ``ParamDef`` tree (Granite-8B: 8.17 G;
    the MoE models' experts, routers and shared experts included)."""
    model = Transformer(TC.get_config(arch), device="meta")
    assert count_params(model) == RT.count_params(RC.get_config(arch))
    assert model.device.type == "meta"


def test_unknown_block_types_raise():
    cfg = dataclasses.replace(TC.smoke_config("granite_8b"),
                              pattern=("attn", "rwkv"))
    with pytest.raises(ValueError, match="unknown block type 'rwkv'"):
        Transformer(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown block type 'rwkv'"):
        init_caches(cfg, 1, 8, device="cpu")


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


def test_zamba2_forward_train_mode_matches_reference():
    cfg = RC.smoke_config("zamba2_7b")
    params = ref_init_params(RT.model_pdefs(cfg), jax.random.PRNGKey(4))
    model = Transformer(TC.smoke_config("zamba2_7b"), dtype=torch.float32,
                        device="cpu")
    load_reference_params(model, _numpy_tree(params))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 36))
    want, _ = RT.forward(params, jnp.asarray(tokens), cfg, dtype=jnp.float32)
    got, caches = forward(model, torch.from_numpy(tokens))
    assert caches is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


# parameters the reference reads through .astype(float32): float32 in a
# model of any dtype
F32_PARAMS = ("ln1", "ln2", "final_norm", "A_log", "D", "dt_bias", "norm_w",
              "ln1_post", "ln2_post", "r")


def test_init_params_follows_the_reference_rule():
    """Zeros where the reference's ``init_scale`` is 0 (the norms,
    ``norm_w``), ones for its 1-D ``init_scale`` 1 parameters (``A_log``,
    ``D``, ``dt_bias``), normal x 0.02 elsewhere; in a bf16 model the
    parameters the reference widens stay float32."""
    cfg = TC.smoke_config("zamba2_7b")
    model = init_params(Transformer(cfg, dtype=torch.bfloat16, device="cpu"),
                        2)
    names = dict(model.named_parameters())
    assert "shared_attn.attn.wq" in names and "layers.2.mamba.A_log" in names
    for name, p in names.items():
        leaf = name.rsplit(".", 1)[-1]
        assert p.dtype == (torch.float32 if leaf in F32_PARAMS
                           else torch.bfloat16), name
        if leaf in ("ln1", "ln2", "final_norm", "norm_w"):
            assert not p.any(), name
        elif leaf in ("A_log", "D", "dt_bias"):
            assert (p == 1).all(), name
        else:
            assert 0.015 < p.float().std().item() < 0.025, name
    shapes = {n: tuple(p.shape) for n, p in names.items()}
    assert shapes["layers.0.mamba.w_in"] == (64, 2 * 128 + 2 * 16 + 8)
    assert shapes["layers.0.mamba.conv_w"] == (4, 128 + 2 * 16)


def test_load_reference_params_fills_the_shared_block():
    cfg = dataclasses.replace(RC.smoke_config("zamba2_7b"), n_layers=6)
    tree = _numpy_tree(ref_init_params(RT.model_pdefs(cfg),
                                       jax.random.PRNGKey(0)))
    model = Transformer(dataclasses.replace(TC.smoke_config("zamba2_7b"),
                                            n_layers=6),
                        dtype=torch.bfloat16, device="cpu")
    load_reference_params(model, tree)
    assert torch.equal(model.shared_attn.attn.wq,
                       torch.tensor(tree["shared_attn"]["attn"]["wq"])
                       .to(torch.bfloat16))
    assert torch.equal(model.shared_attn.ffn.wi,
                       torch.tensor(tree["shared_attn"]["ffn"]["wi"])
                       .to(torch.bfloat16))
    # group 1, slot s2: layer 1 * 3 + 1; the f32 scalars keep their bits
    blk = tree["blocks"]["s2_mamba2"]
    assert model.layers[4].mamba.A_log.dtype == torch.float32
    assert torch.equal(model.layers[4].mamba.dt_bias,
                       torch.tensor(blk["mamba"]["dt_bias"][1]))
    assert torch.equal(model.layers[4].mamba.w_in,
                       torch.tensor(blk["mamba"]["w_in"][1])
                       .to(torch.bfloat16))
    shared = dict(tree["shared_attn"], ffn={"wo": tree["shared_attn"]["ffn"]
                                            ["wo"]})
    with pytest.raises(ValueError, match="no shared_attn/ffn/wi"):
        load_reference_params(model, dict(tree, shared_attn=shared))
    with pytest.raises(ValueError, match="no place"):
        load_reference_params(model, dict(tree, blocks=dict(
            tree["blocks"], s4_mamba2=blk)))


def _stressed(tree, seed):
    """The reference's tree with seeded norm weights near -1, so that
    ``1 + w`` lies in [0.05, 0.15], where a bf16 copy of ``w`` (8 bits of
    ``w``, not of ``1 + w``) moves the scale by up to ~3 %; and Mamba-2's
    scalars drawn as Mamba-2 initialises them (A in [1, 16], dt in [1e-3,
    1e-1], D in [0.5, 1.5])."""
    rng = np.random.default_rng(seed)

    def fill(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k in ("ln1", "ln2", "final_norm", "norm_w", "ln1_post",
                       "ln2_post"):
                out[k] = -1.0 + 0.1 * rng.uniform(0.5, 1.5, v.shape)
            elif k == "A_log":
                out[k] = np.log(rng.uniform(1.0, 16.0, v.shape))
            elif k == "D":
                out[k] = rng.uniform(0.5, 1.5, v.shape)
            elif k == "dt_bias":
                dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), v.shape))
                out[k] = dt + np.log(-np.expm1(-dt))
            else:
                out[k] = v
        return out

    return jax.tree.map(lambda a: np.asarray(a, np.float32), fill(tree))


@pytest.mark.parametrize("name", tuple(BF16_NARROW))
def test_bf16_logits_hold_to_the_reference(name):
    """The bf16 model against the reference's bf16 model (float32 masters,
    cast at use) on the same weights and prompts: the mean |difference| of
    every position's logits within the reference's own bf16-vs-float32
    mean distance.  The norm weights and Mamba-2's scalars are stressed
    (``_stressed``): stored in bf16, as before they were kept in float32,
    the port lands 2.3-2.6x that distance away."""
    from repro_torch.models.transformer import _unembed

    cfg, tcfg, S = _served(name)
    tree = _stressed(_numpy_tree(ref_init_params(RT.model_pdefs(cfg),
                                                 jax.random.PRNGKey(0))), 5)
    params = jax.tree.map(jnp.asarray, tree)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, S))

    def ref_logits(dtype):
        h, _ = RT.forward(params, jnp.asarray(tokens), cfg, dtype=dtype)
        return np.asarray(RT._unembed(params, h, cfg), np.float32)

    want32, want16 = ref_logits(jnp.float32), ref_logits(jnp.bfloat16)
    model = load_reference_params(
        Transformer(tcfg, dtype=torch.bfloat16, device="cpu"), tree)
    for pname, p in model.named_parameters():
        if pname.rsplit(".", 1)[-1] in F32_PARAMS:
            assert p.dtype == torch.float32, pname
    h, _ = forward(model, torch.from_numpy(tokens))
    got = _unembed(model, h).numpy()
    bar = np.abs(want16 - want32).mean()
    assert np.isfinite(got).all() and got.shape == want16.shape
    assert np.abs(got - want16).mean() <= bar, (np.abs(got - want16).mean(),
                                                bar)
