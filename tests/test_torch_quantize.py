"""The port's int8 serving (``repro_torch.serve.quantize``, ``quantized=True``
and the int8 KV cache of ``repro_torch.models``) against the reference's
(``repro.serve.quantize``, ``repro.models.transformer``) on the CPU.

Parameters are the reference's (``init_params`` from a PRNG key), carried
into the port's float32 model, which is then quantized on each side; the
int8 values and scales must be the reference's bit for bit, and the
quantized prefill and greedy decode must agree with the reference's at
rtol = atol = 1e-5 in float32.  The reference's quantized forward is run op
by op (``jax.disable_jit``): compiled, XLA's default excess precision
skips some of the bf16 roundings that its ``dequantize`` writes (the
smoke xLSTM's logits then leave the 1e-5 bar), and the port computes
what it writes."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import transformer as RT
from repro.parallel.sharding import init_params as ref_init_params
from repro.serve import quantize as RQ

from repro_torch import configs as TC
from repro_torch.kernels import library
from repro_torch.models import (Transformer, decode_step, init_caches,
                                init_params, load_reference_params, prefill)
from repro_torch.models.weights import _leaves, reference_paths
from repro_torch.serve import (QuantizedModel, dequantize,
                               quantization_error, quantize_params)

TOL = 1e-5
N_DECODE = 8
ARCHS = ("granite_8b", "zamba2_7b", "gemma2_2b", "llama4_scout_17b_a16e",
         "xlstm_1p3b")
F32_PARAMS = ("ln1", "ln2", "final_norm", "A_log", "D", "dt_bias", "norm_w",
              "ln1_post", "ln2_post", "r")


def _setup(arch, seed=0):
    """(reference config, its params, the port's float32 model)."""
    cfg = RC.smoke_config(arch)
    params = ref_init_params(RT.model_pdefs(cfg), jax.random.PRNGKey(seed))
    model = load_reference_params(
        Transformer(TC.smoke_config(arch), dtype=torch.float32, device="cpu"),
        jax.tree.map(np.asarray, params))
    return cfg, params, model


def _stacked(qm: QuantizedModel, model) -> dict:
    """The port's int8 model in the reference's layout: path -> {"q", "s"}
    (block parameters stacked over groups) or the float leaf."""
    groups = {}
    for name, path, g in reference_paths(model):
        parts = ({"q": qm.q[name], "s": qm.s[name]} if name in qm.q
                 else {"": qm.plain[name]})
        for k, t in parts.items():
            groups.setdefault(path + ((k,) if k else ()), []).append((g, t))
    return {path: (ts[0][1] if ts[0][0] < 0 else
                   torch.stack([t for _, t in sorted(ts, key=lambda x: x[0])]))
            for path, ts in groups.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_params_is_the_reference_bit_for_bit(arch):
    """Every int8 ``q`` and float32 ``s`` of the reference's tree, and every
    leaf it leaves in float (``final_norm``, the shared block's norms), the
    same bits; stacked 1-D block leaves (norms, Mamba-2's scalars)
    quantize with one scale per layer."""
    _, params, model = _setup(arch)
    want = dict(_leaves(jax.tree.map(np.asarray, RQ.quantize_params(params))))
    got = _stacked(quantize_params(model), model)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert np.array_equal(g, w), path
    if arch == "zamba2_7b":
        assert ("blocks", "s1_mamba2", "mamba", "A_log", "s") in want
        assert ("shared_attn", "ln1") in want  # left in float32
    assert ("final_norm",) in want


@pytest.mark.parametrize("arch", ARCHS)
def test_quantization_error_is_the_reference_number(arch):
    _, params, model = _setup(arch, 1)
    want = RQ.quantization_error(params)
    got = quantization_error(model)
    assert 0.0 < got < 0.02
    assert abs(got - want) <= 1e-7 * want, (got, want)


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_meta_model_shapes_are_quantized_pdefs(arch):
    """On a full-size ``meta`` model, shapes only: the reference's
    ``quantized_pdefs`` of its ``ParamDef`` tree."""
    model = Transformer(TC.get_config(arch), device="meta")
    qm = quantize_params(model)
    assert qm.device.type == "meta" and qm.skeleton.device.type == "meta"
    is_pdef = lambda x: isinstance(x, RQ.ParamDef)  # noqa: E731
    want = dict(_leaves(jax.tree.map(
        lambda d: d.shape, RQ.quantized_pdefs(RT.model_pdefs(
            RC.get_config(arch))), is_leaf=is_pdef)))
    got = {path: tuple(t.shape) for path, t in _stacked(qm, model).items()}
    assert got == want
    assert all(t.dtype == torch.int8 for t in qm.q.values())
    assert all(t.dtype == torch.float32 for t in qm.s.values())


def _grow(caches, n):
    """The reference's serving driver grows its prefill's KV caches."""
    def grow(path, leaf):
        names = [getattr(k, "key", "") for k in path]
        if ("k" in names or "v" in names) and leaf.ndim == 5:
            pad = jnp.zeros(leaf.shape[:2] + (n,) + leaf.shape[3:],
                            leaf.dtype)
            return jnp.concatenate([leaf, pad], axis=2)
        return leaf
    return jax.tree_util.tree_map_with_path(grow, caches)


def _check_caches(ref_caches, caches, cfg, length):
    slots = (["shared"] if "shared_attn" in cfg.pattern else []) + [
        f"s{i}_{b}" for i, b in enumerate(cfg.pattern) if b != "shared_attn"]
    assert len(caches) == cfg.n_groups * len(slots)
    for i, cache in enumerate(caches):
        g, j = divmod(i, len(slots))
        want = ref_caches[slots[j]]
        assert sorted(cache) == sorted(want)
        for leaf, t in cache.items():
            w, got = np.asarray(want[leaf][g]), t.numpy()
            if leaf in ("k", "v"):
                w, got = w[:, :length], got[:, :length]
            np.testing.assert_allclose(got, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_prefill_and_decode_match_reference(arch):
    """``prefill`` and 8 greedy ``decode_step``s with ``quantized=True`` at
    float32 compute against the reference's, the same tokens and every
    cache alike; the port's int8 path also equals its model dequantized up
    front, bit for bit."""
    cfg, params, model = _setup(arch, 2)
    qparams = RQ.quantize_params(params)
    qm = quantize_params(model)
    del model
    S = 24
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, S)
                                               ).astype(np.int32)
    with jax.disable_jit():
        want, rcaches = RT.prefill(qparams, jnp.asarray(tokens), cfg,
                                   dtype=jnp.float32, quantized=True)
    library.reset_launches()
    got, caches = prefill(qm, torch.from_numpy(tokens),
                          cache_len=S + N_DECODE, quantized=True)
    assert sum(library.LAUNCHES.values()) == 0  # CPU: the plain versions
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    _check_caches(rcaches, caches, cfg, S)
    upfront, up_caches = prefill(dequantize(qm), torch.from_numpy(tokens),
                                 cache_len=S + N_DECODE)
    assert torch.equal(got, upfront)
    rcaches = _grow(rcaches, N_DECODE)
    ref_decode = partial(RT.decode_step, cfg=cfg, dtype=jnp.float32,
                         quantized=True)
    rtok = jnp.argmax(want, -1).astype(jnp.int32)
    ttok = got.argmax(-1)
    for i in range(N_DECODE):
        assert np.array_equal(np.asarray(rtok), ttok.numpy())
        with jax.disable_jit():
            want, rcaches = ref_decode(qparams, rtok, rcaches,
                                       jnp.int32(S + i))
        got, caches = decode_step(qm, ttok, caches, S + i, quantized=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        rtok = jnp.argmax(want, -1).astype(jnp.int32)
        ttok = got.argmax(-1)
    assert np.array_equal(np.asarray(rtok), ttok.numpy())
    _check_caches(rcaches, caches, cfg, S + N_DECODE)


def test_int8_logits_meet_the_reference_bar():
    """The reference's own bar (``tests/test_models.py``): quantization
    error under 0.02, and the int8 prefill's logits correlated above 0.99
    with the float32 model's."""
    model = init_params(Transformer(TC.smoke_config("granite_8b"),
                                    dtype=torch.float32, device="cpu"), 0)
    assert quantization_error(model) < 0.02
    tokens = torch.randint(0, 256, (1, 16),
                           generator=torch.Generator().manual_seed(0))
    lf, _ = prefill(model, tokens)
    lq, _ = prefill(quantize_params(model), tokens, quantized=True)
    corr = np.corrcoef(lf.numpy().ravel(), lq.numpy().ravel())[0, 1]
    assert corr > 0.99, corr


# Granite at a narrow width whose block products have the full model's gain:
# every weight is drawn at 0.02 whatever the width, so a product's gain is
# 0.02 sqrt(fan-in), 1.28 at d_model 4096; here d_model 256 (d_ff 3.5x, as
# Granite-8B's) with the block weights scaled by sqrt(4096 / 256) = 4
GAIN_CFG = {"d_model": 256, "d_ff": 896, "n_heads": 4, "n_kv_heads": 2,
            "d_head": 64}
GAIN_SCALE = 4.0


def _correlations(n_layers: int) -> tuple[float, float]:
    """(the reference's, the port's) correlation of int8 logits with the
    float32 model's, on the gain-matched narrow Granite of ``n_layers``
    layers, the same parameters on both sides."""
    rcfg = dataclasses.replace(RC.smoke_config("granite_8b"),
                               n_layers=n_layers, **GAIN_CFG)
    params = dict(ref_init_params(RT.model_pdefs(rcfg),
                                  jax.random.PRNGKey(0)))
    params["blocks"] = jax.tree.map(
        lambda p: p * GAIN_SCALE if p.ndim >= 3 else p, params["blocks"])
    model = load_reference_params(
        Transformer(dataclasses.replace(TC.smoke_config("granite_8b"),
                                        n_layers=n_layers, **GAIN_CFG),
                    dtype=torch.float32, device="cpu"),
        jax.tree.map(np.asarray, params))
    tokens = np.random.default_rng(0).integers(0, rcfg.vocab, (2, 16)
                                               ).astype(np.int32)
    rf, _ = RT.prefill(params, jnp.asarray(tokens), rcfg, dtype=jnp.float32)
    with jax.disable_jit():
        rq, _ = RT.prefill(RQ.quantize_params(params), jnp.asarray(tokens),
                           rcfg, dtype=jnp.float32, quantized=True)
    tf, _ = prefill(model, torch.from_numpy(tokens))
    tq, _ = prefill(quantize_params(model), torch.from_numpy(tokens),
                    quantized=True)

    def corr(a, b):
        return np.corrcoef(np.asarray(a, np.float64).ravel(),
                           np.asarray(b, np.float64).ravel())[0, 1]

    return corr(rq, rf), corr(tq.numpy(), tf.numpy())


def test_int8_correlation_falls_with_depth_as_the_reference_s():
    """The int8 logits' correlation with float32 falls with depth on the
    reference's quantized forward as on the port's: at 36 layers (Granite-8B's
    depth) and 2 (the reference's test's), the two correlations agree to
    1e-6, and at 36 layers each has lost over 5x what it lost at 2."""
    r2, t2 = _correlations(2)
    r36, t36 = _correlations(36)
    assert abs(r2 - t2) < 1e-6 and abs(r36 - t36) < 1e-6, (r2, t2, r36, t36)
    assert r2 > 0.99 and t2 > 0.99, (r2, t2)
    assert 1 - r36 > 5 * (1 - r2) and 1 - t36 > 5 * (1 - t2), (r2, r36)


def test_int8_model_holds_int8_and_dequantizes_a_block_at_a_time(
        monkeypatch):
    """Only int8 values (and their scales, and the leaves the reference
    leaves in float) are resident; the skeleton holds no values; a block's
    weights are dequantized when it runs, one block at a time; in bf16
    compute the float32 parameters (norms, Mamba-2's scalars, sLSTM's
    ``r``) reach the block in float32, the rest in bf16."""
    cfg = TC.smoke_config("zamba2_7b")
    model = init_params(Transformer(cfg, dtype=torch.float32, device="cpu"),
                        1)
    qm = quantize_params(model).with_dtype(torch.bfloat16)
    assert qm.dtype == torch.bfloat16 and qm.device.type == "cpu"
    assert all(p.device.type == "meta" for p in qm.skeleton.parameters())
    assert sorted(qm.plain) == ["final_norm", "shared_attn.ln1",
                                "shared_attn.ln2"]
    n_params = sum(p.numel() for p in model.parameters())
    n_q = sum(t.numel() for t in qm.q.values())
    assert qm.nbytes() < n_params + 4 * (n_params - n_q) + sum(
        4 * t.numel() for t in qm.s.values()) + 1
    seen = []
    block_weights = QuantizedModel.block_weights

    def recording(self, block):
        w = block_weights(self, block)
        seen.append({k: t.dtype for k, t in w.items()})
        return w

    monkeypatch.setattr(QuantizedModel, "block_weights", recording)
    logits, _ = prefill(qm, torch.zeros((1, 8), dtype=torch.long),
                        quantized=True)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    # the shared block once, up front, then each of the 3 mixer layers
    assert len(seen) == 1 + cfg.n_layers
    for dtypes in seen:
        for name, dt in dtypes.items():
            leaf = name.rsplit(".", 1)[-1]
            assert dt == (torch.float32 if leaf in F32_PARAMS
                          else torch.bfloat16), name


def test_quantized_flag_must_match_the_model():
    model = init_params(Transformer(TC.smoke_config("granite_8b"),
                                    dtype=torch.float32, device="cpu"))
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(TypeError, match="quantize_params"):
        prefill(model, tokens, quantized=True)
    qm = quantize_params(model)
    with pytest.raises(TypeError, match="quantized=True"):
        prefill(qm, tokens)
    caches = init_caches(model.cfg, 1, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(TypeError, match="quantize_params"):
        decode_step(model, tokens[:, :1], caches, 0, quantized=True)


def test_with_dtype_shares_the_int8_weights():
    model = init_params(Transformer(TC.smoke_config("xlstm_1p3b"),
                                    dtype=torch.float32, device="cpu"))
    qm = quantize_params(model)
    q16 = qm.with_dtype(torch.bfloat16)
    assert q16.q is qm.q and q16.dtype == torch.bfloat16
    tokens = torch.zeros((2, 8), dtype=torch.long)
    got, caches = prefill(q16, tokens, quantized=True)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert caches[0]["C"].dtype == torch.float32


def _calibrated(caches):
    """Per (group, prompt, kv head) scales of a stacked float cache (G, B,
    S, n_kv, d_head), as the reference's test calibrates them: max |value|
    over positions and head dims, at least 1e-6, over 127."""
    return np.maximum(np.abs(caches).max(axis=(2, 4), keepdims=True),
                      1e-6) / 127.0


def _quantized(values, scale):
    return np.clip(np.round(values / scale), -127, 127).astype(np.int8)


@pytest.mark.parametrize("arch", ("granite_8b", "gemma2_2b"))
@pytest.mark.parametrize("scales", ("calibrated", "default"))
def test_int8_kv_decode_matches_reference(arch, scales, monkeypatch):
    """Greedy decode against int8 KV caches on both sides: "calibrated" —
    the float prefill's caches, scales calibrated from them (per prompt
    and kv head), quantized into the int8 caches, decode from position
    16; "default" — ``init_caches(quant_kv=True)`` (scales 0.05), decode
    from position 0 (the reference's own ``init_caches`` zeroes its
    scales: given 0.05).  Logits within 1e-5; the int8 caches equal but where
    the written value k / scale lies within 1e-6 (relative) of a .5
    boundary, where one unit of difference is allowed.  Gemma-2's local
    blocks' caches are rings the decode does not wrap."""
    cfg, params, model = _setup(arch, 4)
    B, S0, n = 2, 16, 8
    size = S0 + n
    rng = np.random.default_rng(5)
    if scales == "calibrated":
        tokens = rng.integers(0, cfg.vocab, (B, S0)).astype(np.int32)
        want, rcaches = RT.prefill(params, jnp.asarray(tokens), cfg,
                                   dtype=jnp.float32)
        got, caches = prefill(model, torch.from_numpy(tokens),
                              cache_len=size)
        start = S0
        ref_q = {}
        for slot, sub in _grow(rcaches, n).items():
            s = {k: _calibrated(np.asarray(sub[k])[:, :, :S0])
                 for k in ("k", "v")}
            ref_q[slot] = {"k": _quantized(np.asarray(sub["k"]), s["k"]),
                           "v": _quantized(np.asarray(sub["v"]), s["v"]),
                           "k_s": s["k"].astype(np.float32),
                           "v_s": s["v"].astype(np.float32)}
        qcaches = init_caches(model.cfg, B, size, dtype=torch.float32,
                              device="cpu", quant_kv=True)
        slots = [f"s{i}_{b}" for i, b in enumerate(cfg.pattern)]
        for i, c in enumerate(qcaches):
            g, j = divmod(i, len(slots))
            for k in c:
                c[k].copy_(torch.from_numpy(ref_q[slots[j]][k][g]))
        rcaches = jax.tree.map(jnp.asarray, ref_q)
    else:
        want = None
        tokens = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        rcaches = RT.init_caches(cfg, B, size, dtype=jnp.float32,
                                 quant_kv=True)
        # the reference's init_caches stacks its caches over groups with
        # zeros of each leaf's shape, which drops the 0.05 it fills the
        # scales with (k / 0 then writes +-127, read back as 0): hand it
        # the scales its code names, as the port's init_caches has them
        assert not any(np.asarray(c[k]).any() for c in rcaches.values()
                       for k in ("k_s", "v_s"))
        rcaches = {slot: dict(c, k_s=jnp.full_like(c["k_s"], 0.05),
                              v_s=jnp.full_like(c["v_s"], 0.05))
                   for slot, c in rcaches.items()}
        qcaches = init_caches(model.cfg, B, size, dtype=torch.float32,
                              device="cpu", quant_kv=True)
        for c in qcaches:
            assert c["k"].dtype == torch.int8 and c["k_s"].dtype == \
                torch.float32
            assert tuple(c["k_s"].shape) == (B, 1, cfg.n_kv_heads, 1)
            assert (c["k_s"] == 0.05).all() and (c["v_s"] == 0.05).all()
        start = 0
    written = []
    rounding = torch.round

    def recording(t):
        written.append(t.detach().clone())
        return rounding(t)

    ref_decode = jax.jit(partial(RT.decode_step, cfg=cfg, dtype=jnp.float32))
    rtok = (jnp.asarray(tokens) if want is None
            else jnp.argmax(want, -1).astype(jnp.int32))
    ttok = torch.from_numpy(np.array(rtok))
    for i in range(n):
        assert np.array_equal(np.asarray(rtok), ttok.numpy())
        want, rcaches = ref_decode(params, rtok, rcaches,
                                   jnp.int32(start + i))
        with monkeypatch.context() as m:
            m.setattr(torch, "round", recording)
            got, qcaches = decode_step(model, ttok, qcaches, start + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        rtok = jnp.argmax(want, -1).astype(jnp.int32)
        ttok = got.argmax(-1)
    # each attention block of each step rounds its k, then its v
    n_attn = len(qcaches)
    assert len(written) == 2 * n_attn * n
    slots = [f"s{i}_{b}" for i, b in enumerate(cfg.pattern)]
    for i, c in enumerate(qcaches):
        g, j = divmod(i, len(slots))
        for key, idx in (("k", 0), ("v", 1)):
            w = np.asarray(rcaches[slots[j]][key][g])
            assert c[key].dtype == torch.int8
            for step in range(n):
                pos = start + step
                ratio = written[2 * (step * n_attn + i) + idx][:, 0].numpy()
                got_w, want_w = c[key][:, pos].numpy(), w[:, pos]
                near = np.abs(np.abs(ratio - np.floor(ratio)) - 0.5) <= \
                    1e-6 * np.maximum(1.0, np.abs(ratio))
                differ = got_w != want_w
                assert not (differ & ~near).any(), (i, key, pos)
                assert (np.abs(got_w.astype(int) - want_w) <= 1).all()
            for k in ("k_s", "v_s"):
                assert np.array_equal(c[k].numpy(),
                                      np.asarray(rcaches[slots[j]][k][g]))
