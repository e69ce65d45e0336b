"""The port's xLSTM mixers and model (``repro_torch.models.xlstm``, the
``mlstm``/``slstm`` blocks) against the reference's jnp
(``repro.models.xlstm``, ``repro.models.transformer``) on the CPU.

Parameters are the reference's (``init_params`` from a PRNG key), carried
into the port; inputs are drawn with numpy from a seed.  In float32 the
port's outputs, states and caches must agree with the reference's at
rtol = atol = 1e-5; in bfloat16 the whole model's logits must sit as close
to the reference's bf16 logits as those sit to its float32 ones."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import transformer as RT
from repro.models import xlstm as RX
from repro.parallel.sharding import init_params as ref_init_params

from repro_torch import configs as TC
from repro_torch.kernels import library
from repro_torch.models import (MLSTM, SLSTM, Transformer, XLSTMBlock,
                                decode_step, forward, init_caches,
                                load_reference_params, prefill)
from repro_torch.models.transformer import _unembed
from repro_torch.models.xlstm import init_cache

TOL = 1e-5
N_DECODE = 8
CFG = RC.smoke_config("xlstm_1p3b")
TCFG = TC.smoke_config("xlstm_1p3b")
# xLSTM-1.3B's head width (4 heads of 512 at d_model 2048), at d_model 512:
# 2 heads of 256, one group of 3 mLSTM layers and an sLSTM layer
NARROW = dict(name="xlstm-1.3b-narrow", n_layers=4, d_model=512, n_heads=2,
              n_kv_heads=2, d_head=256, vocab=256,
              pattern=("mlstm", "mlstm", "mlstm", "slstm"))


def _params(pdefs, seed):
    p = ref_init_params(pdefs, jax.random.PRNGKey(seed))
    return p, jax.tree.map(np.asarray, p)


@torch.no_grad()
def _load(module, tree):
    """A mixer's parameters from the reference's (unstacked) leaves."""
    for name, p in module.named_parameters():
        p.copy_(torch.tensor(np.asarray(tree[name])).to(p.dtype))
    return module


def _x(shape, seed, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("S,chunk", [(32, 8), (37, 8), (200, 8),
                                     (200, 128)])
def test_mlstm_matches_reference(S, chunk):
    """Chunks of the largest divisor of S at most ``chunk``: 8, 1 (S = 37
    is prime), 8 and 100."""
    p, tree = _params(RX.mlstm_pdefs(CFG), 0)
    x = _x((2, S, CFG.d_model), S)
    want = RX.mlstm(p, jnp.asarray(x), CFG, chunk=chunk)
    mod = _load(MLSTM(TCFG, dtype=torch.float32, device="cpu", chunk=chunk),
                tree)
    got = mod(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, want)


def test_mlstm_decode_matches_reference():
    """Eight steps of the recurrence from a nonzero state, every state
    compared."""
    p, tree = _params(RX.mlstm_pdefs(CFG), 1)
    mod = _load(MLSTM(TCFG, dtype=torch.float32, device="cpu"), tree)
    rng = np.random.default_rng(2)
    H, dh = CFG.n_heads, CFG.d_head
    ref_cache = {"C": jnp.asarray(rng.standard_normal((2, H, dh, dh)),
                                  jnp.float32),
                 "n": jnp.asarray(rng.standard_normal((2, H, dh)),
                                  jnp.float32)}
    cache = {k: torch.from_numpy(np.array(v)) for k, v in ref_cache.items()}
    for t in range(N_DECODE):
        x = _x((2, 1, CFG.d_model), 10 + t)
        want, ref_cache = RX.mlstm_decode(p, jnp.asarray(x), ref_cache, CFG)
        got, out = mod.decode(torch.from_numpy(x), cache)
        assert out is cache  # written in place
        _close(got, want)
        for k in ("C", "n"):
            _close(cache[k], ref_cache[k])


def test_slstm_with_state_and_decode_match_reference():
    """The scan over a prompt with ``return_state`` (the output and the
    final h, c, n, m), then eight decode steps from that state."""
    p, tree = _params(RX.slstm_pdefs(CFG), 3)
    mod = _load(SLSTM(TCFG, dtype=torch.float32, device="cpu"), tree)
    assert mod.r.dtype == torch.float32
    x = _x((2, 24, CFG.d_model), 4)
    want, ref_state = RX.slstm(p, jnp.asarray(x), CFG, return_state=True)
    got, state = mod(torch.from_numpy(x), return_state=True)
    _close(got, want)
    assert sorted(state) == sorted(ref_state) == list("chmn")
    for k in "hcnm":
        _close(state[k], ref_state[k])
    for t in range(N_DECODE):
        x = _x((2, 1, CFG.d_model), 20 + t)
        want, ref_state = RX.slstm_decode(p, jnp.asarray(x), ref_state, CFG)
        got, out = mod.decode(torch.from_numpy(x), state)
        assert out is state
        _close(got, want)
        for k in "hcnm":
            _close(state[k], ref_state[k])


def test_slstm_without_state_matches_reference():
    p, tree = _params(RX.slstm_pdefs(CFG), 5)
    mod = _load(SLSTM(TCFG, dtype=torch.float32, device="cpu"), tree)
    x = _x((3, 17, CFG.d_model), 6, scale=2.0)
    _close(mod(torch.from_numpy(x)), RX.slstm(p, jnp.asarray(x), CFG))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_from_seq_matches_reference(dtype):
    """The prefill's final (C, n), recomputed from the gates: in float32 at
    1e-5; in bfloat16 (the weights rounded to h's dtype, the products
    accumulated in float32) against the reference run op by op, at 1e-5 of
    the largest |value|."""
    p, tree = _params(RX.mlstm_pdefs(CFG), 7)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    mod = _load(MLSTM(TCFG, dtype=tdt, device="cpu"), tree)
    h = _x((2, 40, CFG.d_model), 8)
    with jax.disable_jit():
        want = RT._mlstm_state_from_seq(p, jnp.asarray(h).astype(jdt), CFG)
    got = mod.state_from_seq(torch.from_numpy(h).to(tdt))
    for k in ("C", "n"):
        assert got[k].dtype == torch.float32
        w = np.asarray(want[k])
        tol = TOL if dtype == "float32" else TOL * np.abs(w).max()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=TOL, atol=tol)


def test_mlstm_forward_state_is_state_from_seq():
    """The state a prefill hands to decode is ``state_from_seq`` of the
    prompt (not the chunk scan's carry)."""
    _, tree = _params(RX.mlstm_pdefs(CFG), 9)
    mod = _load(MLSTM(TCFG, dtype=torch.bfloat16, device="cpu"), tree)
    h = torch.from_numpy(_x((2, 32, CFG.d_model), 10)).to(torch.bfloat16)
    _, state = mod(h, return_state=True)
    want = mod.state_from_seq(h)
    for k in ("C", "n"):
        assert torch.equal(state[k], want[k])


def test_mlstm_chunked_matches_stepwise():
    """The reference's invariant (``tests/test_models.py:127``, its bar):
    the chunked form over 32 steps equals 32 decode steps from zero."""
    _, tree = _params(RX.mlstm_pdefs(CFG), 0)
    mod = _load(MLSTM(TCFG, dtype=torch.float32, device="cpu", chunk=8),
                tree)
    x = torch.from_numpy(_x((1, 32, CFG.d_model), 11))
    y_chunk = mod(x)
    cache = init_cache("mlstm", TCFG, 1, device="cpu")
    y_step = torch.cat([mod.decode(x[:, t:t + 1], cache)[0]
                        for t in range(32)], dim=1)
    np.testing.assert_allclose(y_chunk.numpy(), y_step.numpy(), rtol=2e-2,
                               atol=2e-3)


def test_mlstm_closed_forget_gates_stay_finite():
    """Forget gates shut hard (log f ~ -160 a step): within a chunk of 8
    ``exp(cum_l - cum_s)`` above the diagonal overflows to inf, which the
    mask must drop (``inf * 0`` would be NaN); equal to the reference."""
    p, tree = _params(RX.mlstm_pdefs(CFG), 12)
    H = CFG.n_heads
    wif = np.array(tree["wif"])
    wif[:, H:] = -2.0
    tree = dict(tree, wif=wif)
    p = dict(p, wif=jnp.asarray(wif))
    x = np.abs(_x((2, 32, CFG.d_model), 13)) + 0.5
    log_f = -np.logaddexp(0.0, -(x @ wif[:, H:]))
    assert (-log_f[:, :8].sum(1) > 88).all()  # exp of it overflows
    want = RX.mlstm(p, jnp.asarray(x), CFG, chunk=8)
    mod = _load(MLSTM(TCFG, dtype=torch.float32, device="cpu", chunk=8),
                tree)
    got = mod(torch.from_numpy(x))
    assert torch.isfinite(got).all() and np.isfinite(np.asarray(want)).all()
    _close(got, want)


def _model(cfg, tcfg, seed, dtype=torch.float32):
    params, tree = _params(RT.model_pdefs(cfg), seed)
    model = load_reference_params(Transformer(tcfg, dtype=dtype,
                                              device="cpu"), tree)
    return params, tree, model


def _check_states(ref_caches, caches, cfg):
    """Every port cache (layer by layer) against the reference's (per slot,
    stacked over groups)."""
    slots = [f"s{i}_{b}" for i, b in enumerate(cfg.pattern)]
    assert len(caches) == cfg.n_groups * len(slots)
    for i, cache in enumerate(caches):
        g, s = divmod(i, len(slots))
        want = ref_caches[slots[s]]
        assert sorted(cache) == sorted(want)
        for leaf in cache:
            assert cache[leaf].dtype == torch.float32
            _close(cache[leaf], np.asarray(want[leaf])[g])


@pytest.mark.parametrize("name,S", [("smoke", 32), ("narrow", 200)])
def test_model_prefill_and_greedy_decode_match_reference(name, S):
    """The whole model in float32: ``prefill`` and 8 greedy
    ``decode_step``s against the reference's, the same tokens, every
    mLSTM ``C``/``n`` and sLSTM ``h``/``c``/``n``/``m`` cache compared
    after the prefill and after the last step.  The narrow model has
    xLSTM-1.3B's ratio of head width to d_model and chunks of 100."""
    cfg, tcfg = CFG, TCFG
    if name == "narrow":
        cfg = dataclasses.replace(RC.get_config("xlstm_1p3b"), **NARROW)
        tcfg = dataclasses.replace(TC.get_config("xlstm_1p3b"), **NARROW)
    params, _, model = _model(cfg, tcfg, 0)
    tokens = np.random.default_rng(S).integers(0, cfg.vocab, (2, S)
                                               ).astype(np.int32)
    want, rcaches = RT.prefill(params, jnp.asarray(tokens), cfg,
                               dtype=jnp.float32)
    library.reset_launches()
    got, caches = prefill(model, torch.from_numpy(tokens))
    assert sum(library.LAUNCHES.values()) == 0  # CPU: the plain versions
    _close(got, want)
    _check_states(rcaches, caches, cfg)
    ref_decode = jax.jit(partial(RT.decode_step, cfg=cfg, dtype=jnp.float32))
    rtok = jnp.argmax(want, -1).astype(jnp.int32)
    ttok = got.argmax(-1)
    for i in range(N_DECODE):
        assert np.array_equal(np.asarray(rtok), ttok.numpy())
        want, rcaches = ref_decode(params, rtok, rcaches, jnp.int32(S + i))
        got, caches = decode_step(model, ttok, caches, S + i)
        _close(got, want)
        rtok = jnp.argmax(want, -1).astype(jnp.int32)
        ttok = got.argmax(-1)
    assert np.array_equal(np.asarray(rtok), ttok.numpy())
    _check_states(rcaches, caches, cfg)


def test_model_train_mode_matches_reference():
    params, _, model = _model(CFG, TCFG, 4)
    tokens = np.random.default_rng(3).integers(0, CFG.vocab, (2, 36))
    want, _ = RT.forward(params, jnp.asarray(tokens), CFG, dtype=jnp.float32)
    got, caches = forward(model, torch.from_numpy(tokens))
    assert caches is None
    _close(got, want)


def test_init_caches_are_the_reference_states():
    """Zeroed float32 states of the reference's shapes, in the model's
    order (``init_caches`` of the reference stacks them over groups)."""
    cfg = dataclasses.replace(CFG, n_layers=4)
    tcfg = dataclasses.replace(TCFG, n_layers=4)
    want = RT.init_caches(cfg, 3, 16)
    got = init_caches(tcfg, 3, 16, device="cpu")
    assert len(got) == 4
    for i, cache in enumerate(got):
        slot = f"s{i % 2}_{cfg.pattern[i % 2]}"
        assert sorted(cache) == sorted(want[slot])
        for k, t in cache.items():
            assert t.dtype == torch.float32 and not t.any()
            assert tuple(t.shape) == want[slot][k].shape[1:]


def test_blocks_and_parameters_are_the_reference_layout():
    """One ``XLSTMBlock`` per layer with ``ln1`` and the mixer under its
    type's name; ``r`` and the norms float32 in a bf16 model."""
    model = Transformer(TCFG, dtype=torch.bfloat16, device="cpu")
    assert [type(b) for b in model.stack()] == [XLSTMBlock] * 2
    names = {n: p for n, p in model.named_parameters()}
    assert sorted(names) == sorted(
        ["embed", "final_norm", "unembed", "layers.0.ln1",
         "layers.1.ln1", "layers.1.slstm.r", "layers.1.slstm.w_in",
         "layers.1.slstm.wo"]
        + [f"layers.0.mlstm.{w}" for w in ("wq", "wk", "wv", "wif", "wo",
                                            "ogate")])
    for n, p in names.items():
        leaf = n.rsplit(".", 1)[-1]
        assert p.dtype == (torch.float32 if leaf in ("ln1", "final_norm",
                                                     "r")
                           else torch.bfloat16), n


def _stressed(tree, seed):
    """Norm weights near -1, so ``1 + w`` lies in [0.05, 0.15], where a bf16
    copy of ``w`` would move the scale by up to ~3 %."""
    rng = np.random.default_rng(seed)

    def fill(node):
        return {k: fill(v) if isinstance(v, dict) else
                (-1.0 + 0.1 * rng.uniform(0.5, 1.5, v.shape)
                 if k in ("ln1", "final_norm") else v)
                for k, v in node.items()}

    return jax.tree.map(lambda a: np.asarray(a, np.float32), fill(tree))


def test_bf16_logits_hold_to_the_reference():
    """The narrow bf16 model against the reference's bf16 model (float32
    masters, cast at use) on the same weights and prompts of 200 tokens:
    the mean |difference| of every position's logits within the
    reference's own bf16-vs-float32 mean distance."""
    cfg = dataclasses.replace(RC.get_config("xlstm_1p3b"), **NARROW)
    tcfg = dataclasses.replace(TC.get_config("xlstm_1p3b"), **NARROW)
    tree = _stressed(_params(RT.model_pdefs(cfg), 0)[1], 5)
    params = jax.tree.map(jnp.asarray, tree)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 200))

    def ref_logits(dtype):
        h, _ = RT.forward(params, jnp.asarray(tokens), cfg, dtype=dtype)
        return np.asarray(RT._unembed(params, h, cfg), np.float32)

    want32, want16 = ref_logits(jnp.float32), ref_logits(jnp.bfloat16)
    model = load_reference_params(
        Transformer(tcfg, dtype=torch.bfloat16, device="cpu"), tree)
    h, _ = forward(model, torch.from_numpy(tokens))
    got = _unembed(model, h).numpy()
    bar = np.abs(want16 - want32).mean()
    assert np.isfinite(got).all() and got.shape == want16.shape
    assert np.abs(got - want16).mean() <= bar, (np.abs(got - want16).mean(),
                                                bar)


def test_full_model_counts_the_reference_parameters():
    """xLSTM-1.3B at full width and depth on the ``meta`` device: 42 mLSTM
    and 6 sLSTM layers, the reference's 1,238,632,448 parameters."""
    from repro_torch.models import count_params

    model = Transformer(TC.get_config("xlstm_1p3b"), device="meta")
    kinds = [b.btype for b in model.stack()]
    assert kinds.count("mlstm") == 42 and kinds.count("slstm") == 6
    assert count_params(model) == 1_238_632_448 == RT.count_params(
        RC.get_config("xlstm_1p3b"))
