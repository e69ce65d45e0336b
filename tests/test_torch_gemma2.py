"""The port's Gemma-2 pieces (sliding-window ``local`` blocks, their ring
caches, K8's window) against the reference's jnp model on the CPU.

The reference's parameters are carried into the port with
``load_reference_params``; prompts and inputs are drawn with numpy from a
seed and handed to both.  K8's plain version with a window (what the
wrapper runs on CPU tensors, and what the card's kernel is held against)
against attention written out per query at 1e-6, and through
``Attention.prefill`` (with its projections) against the reference's
``layers.attention(local=True)``; the model's prefill (logits and every
cache, a local ring compared slot by slot) against ``RT.prefill``, and its
greedy decode at each step against the reference's ``forward`` over the
whole sequence; the modules and the model at ``TOL`` (1e-5, float32).  The
reference's own ``decode_step`` leaves the window once a cache reaches it
(ROADMAP queue 3), so the port's decode is held against it only while the
last position stays below the window."""

import dataclasses
from functools import partial

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
from repro_torch.kernels import library
from repro_torch.kernels import ops as KO
from repro_torch.kernels import ref as KR
from repro_torch.models import (Transformer, decode_step, init_caches,
                                load_reference_params, prefill)
from repro_torch.models import layers as TL

TOL = 1e-5          # float32 model paths
FN_TOL = 1e-6       # single functions
# Gemma-2's head width (256) at a window past one 64-key tile of the
# kernel's (D 256), GQA 2:1
NARROW = dict(name="gemma2-2b-narrow", n_layers=2, d_model=256, n_heads=4,
              n_kv_heads=2, d_head=256, d_ff=512, vocab=256, window=64)


def _configs(narrow=None):
    if narrow is None:
        return RC.smoke_config("gemma2_2b"), TC.smoke_config("gemma2_2b")
    return (dataclasses.replace(RC.get_config("gemma2_2b"), **narrow),
            dataclasses.replace(TC.get_config("gemma2_2b"), **narrow))


def _model(cfg, tcfg, seed=0):
    params = ref_init_params(RT.model_pdefs(cfg), jax.random.PRNGKey(seed))
    model = Transformer(tcfg, dtype=torch.float32, device="cpu")
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return params, model


def _ring_slot(p: int, n: int) -> int:
    """The port's ring slot of position p (:func:`layers._ring`)."""
    return p % n


@pytest.mark.parametrize("S,window", [(7, 3), (40, 16), (40, 40), (40, 64),
                                      (33, 1)])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_window_mask_is_the_reference_models(S, window, softcap):
    """K8's plain version with a window: key k seen by query q iff
    q - window < k <= q, masked after the softcap; a window of S or more,
    or 0, is the causal attention bit for bit."""
    rng = np.random.default_rng(S + window)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, S, 4, 16), (2, S, 2, 16), (2, S, 2, 16)))
    got = KO.flash_attention(q, k, v, softcap=softcap, window=window)
    kk, vv = (x.repeat_interleave(2, dim=2) for x in (k, v))
    for qi in range(S):
        keys = [j for j in range(S) if qi - window < j <= qi]
        s = torch.einsum("bhd,bkhd->bhk", q[:, qi], kk[:, keys]) / 4.0
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        want = torch.einsum("bhk,bkhd->bhd", torch.softmax(s, -1),
                            vv[:, keys])
        torch.testing.assert_close(got[:, qi], want, rtol=FN_TOL,
                                   atol=FN_TOL)
    causal = KO.flash_attention(q, k, v, softcap=softcap)
    assert torch.equal(KO.flash_attention(q, k, v, softcap=softcap,
                                          window=0), causal)
    assert torch.equal(KO.flash_attention(q, k, v, softcap=softcap,
                                          window=S), causal)
    assert torch.equal(got, KR.flash_attention_ref(q, k, v, softcap=softcap,
                                                   window=window))
    with pytest.raises(ValueError, match="window"):
        KO.flash_attention(q, k, v, window=-1)


@pytest.mark.parametrize("narrow,S", [(None, 24), (None, 40),
                                      (NARROW, 160)], ids=["smoke-24",
                                                           "smoke-40",
                                                           "narrow-160"])
def test_local_attention_prefill_matches_reference(narrow, S):
    """``Attention.prefill(local=True)``, K8's plain version with the
    window, against ``layers.attention(local=True)`` of the same weights;
    and its ring cache, slot by slot, against the reference's prefill
    cache (the last ``window`` positions in order)."""
    cfg, tcfg = _configs(narrow)
    p = ref_init_params(RL.attention_pdefs(cfg), jax.random.PRNGKey(S))
    attn = TL.Attention(tcfg, dtype=torch.float32, device="cpu")
    for name, t in attn.named_parameters():
        t.data.copy_(torch.tensor(np.asarray(p[name])))
    x = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    want = RL.attention(p, jnp.asarray(x), cfg, local=True)
    _, wcache = RT._attention_prefill(p, jnp.asarray(x), cfg, True,
                                      ("data",))
    library.reset_launches()
    got, k, v = attn.prefill(torch.from_numpy(x), local=True)
    assert library.LAUNCHES["flash_attention"] == 0  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    W = min(cfg.window, S)
    assert k.shape[1] == v.shape[1] == W == wcache["k"].shape[1]
    for i in range(W):  # the reference's slot i holds position S - W + i
        slot = _ring_slot(S - W + i, W)
        for got_c, want_c in ((k, wcache["k"]), (v, wcache["v"])):
            np.testing.assert_allclose(got_c[:, slot].numpy(),
                                       np.asarray(want_c[:, i]),
                                       rtol=TOL, atol=TOL)
    glob, _, _ = attn.prefill(torch.from_numpy(x))
    if S > cfg.window:  # the window binds
        assert not np.allclose(glob.numpy(), got.numpy(), atol=1e-3)


@pytest.mark.parametrize("S", [24, 40])
def test_gemma2_prefill_matches_reference(S):
    """Logits and caches of the smoke Gemma-2 (window 32) with prompts on
    both sides of the window: global caches slot for slot, a local ring by
    position (:func:`_ring_slot`); sandwich norms, tied embeddings times
    sqrt(d_model), both softcaps and GeGLU come along."""
    cfg, tcfg = _configs()
    params, model = _model(cfg, tcfg)
    tokens = np.random.default_rng(S).integers(0, cfg.vocab, (2, S))
    want, rcaches = RT.prefill(params, jnp.asarray(tokens), cfg,
                               dtype=jnp.float32)
    got, tcaches = prefill(model, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert len(tcaches) == cfg.n_groups * 2
    for g in range(cfg.n_groups):
        for j, slot in enumerate(("s0_local", "s1_attn")):
            cache = tcaches[2 * g + j]
            for leaf in ("k", "v"):
                ref = np.asarray(rcaches[slot][leaf][g])
                mine = cache[leaf].numpy()
                assert mine.shape == ref.shape
                if slot == "s1_attn" or S <= cfg.window:
                    np.testing.assert_allclose(mine, ref, rtol=TOL, atol=TOL)
                    continue
                W = cfg.window
                for i in range(W):
                    np.testing.assert_allclose(
                        mine[:, _ring_slot(S - W + i, W)], ref[:, i],
                        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("S,n", [(24, 46), (40, 12)])
def test_gemma2_decode_follows_reference_forward(S, n):
    """Greedy decode past the window (smoke window 32; from 24 to 70 the
    ring wraps twice): each step's logits against the reference's
    ``forward`` over the whole sequence at that position (causal, so one
    forward over the final sequence gives every step's), every step's
    token the reference's argmax; while the last position stays below the
    window, also against the reference's own ``decode_step``."""
    cfg, tcfg = _configs()
    params, model = _model(cfg, tcfg)
    tokens = np.random.default_rng(S + n).integers(0, cfg.vocab, (2, S))
    logits, caches = prefill(model, torch.from_numpy(tokens),
                             cache_len=S + n)
    assert [c["k"].shape[1] for c in caches] == [min(cfg.window, S + n),
                                                 S + n] * cfg.n_groups
    seq = [torch.from_numpy(tokens), logits.argmax(-1)]
    steps = [logits]
    for i in range(n - 1):
        out, caches = decode_step(model, seq[-1], caches, S + i)
        steps.append(out)
        seq.append(out.argmax(-1))
    full = torch.cat(seq, dim=1).numpy()  # S + n tokens
    h, _ = RT.forward(params, jnp.asarray(full), cfg, dtype=jnp.float32)
    want = np.asarray(RT._unembed(params, h, cfg))
    for i, got in enumerate(steps):
        pos = S - 1 + i
        np.testing.assert_allclose(got[:, 0].numpy(), want[:, pos],
                                   rtol=TOL, atol=TOL)
        assert np.array_equal(want[:, pos].argmax(-1), full[:, pos + 1])

    # the reference's decode_step, only while it stays inside the window
    below = cfg.window - S
    if below <= 0:
        return
    rlogits, rcaches = RT.prefill(params, jnp.asarray(tokens), cfg,
                                  dtype=jnp.float32)
    rcaches = jax.tree.map(
        lambda a: jnp.concatenate([a, jnp.zeros(a.shape[:2] + (below,)
                                                + a.shape[3:], a.dtype)], 2)
        if a.ndim == 5 else a, rcaches)
    ref_decode = jax.jit(partial(RT.decode_step, cfg=cfg, dtype=jnp.float32))
    for i in range(below):
        rlogits, rcaches = ref_decode(params, jnp.asarray(full[:, S + i:
                                                               S + i + 1]),
                                      rcaches, jnp.int32(S + i))
        np.testing.assert_allclose(steps[i + 1].numpy(), np.asarray(rlogits),
                                   rtol=TOL, atol=TOL)


def test_local_caches_are_rings_of_the_window():
    """``init_caches`` sizes a local cache min(window, seq_len), as the
    reference's ``init_caches``; decode writes position p to slot p % W and
    refuses a ring shorter than the window once it would wrap."""
    tcfg = TC.smoke_config("gemma2_2b")
    for seq_len in (16, 32, 100):
        caches = init_caches(tcfg, 2, seq_len, dtype=torch.float32,
                             device="cpu")
        want = jax.tree.map(lambda a: a.shape, RT.init_caches(
            RC.smoke_config("gemma2_2b"), 2, seq_len, dtype=jnp.float32))
        assert caches[0]["k"].shape == want["s0_local"]["k"][1:]
        assert caches[1]["k"].shape == want["s1_attn"]["k"][1:]
    attn = TL.Attention(tcfg, dtype=torch.float32, device="cpu")
    for t in attn.parameters():
        t.data.normal_(0, 0.02, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 1, tcfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    ck, cv = torch.zeros(2, 32, 2, 16), torch.zeros(2, 32, 2, 16)
    attn.decode(x, ck, cv, 45, local=True)
    assert ck[:, 45 % 32].any() and not ck[:, :13].any()
    short = torch.zeros(2, 8, 2, 16)
    attn.decode(x, short, short.clone(), 7, local=True)
    with pytest.raises(ValueError, match="ring of 8"):
        attn.decode(x, short, short.clone(), 8, local=True)
