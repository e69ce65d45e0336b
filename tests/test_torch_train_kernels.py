"""The backward of K8, K9 and K10 on the CPU: the plain versions
(``flash_attention_bwd_ref``, ``rmsnorm_bwd_ref``,
``rmsnorm_residual_bwd_ref``, ``ssm_state_scan_bwd_ref``) against
``jax.grad``/``jax.vjp`` of the reference's ``repro.kernels.ref``
functions, and the ``autograd.Function``s around the kernels (which run
those plain versions on CPU tensors) against torch's autograd of the plain
forward.  Inputs are drawn with numpy from seeds.

Bars: 1e-5 of each gradient's largest |value| in float32 (the two
frameworks sum in other orders).  The sliding window has no counterpart
in the reference's kernel, so a window is held against the port's plain
forward differentiated by torch.  The card's kernels are held against
these plain versions in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as RR

from repro_torch.kernels import library, ops, ref
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.rmsnorm import (RMSNorm, RMSNormResidual,
                                         rmsnorm_bwd, rmsnorm_residual_bwd)
from repro_torch.kernels.ssm_scan import ssm_state_scan_bwd

from _torch_train_ref import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5


def _close(a, b, tol=TOL, scale=None):
    """|a - b| within tol of b's largest |value| (or of ``scale``)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max() if scale is None else scale
    assert np.abs(a - b).max() <= tol * scale, (np.abs(a - b).max(), scale)


def _qkv(B, S, H, KVH, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, S, H, D), (B, S, KVH, D), (B, S, KVH, D), (B, S, H, D)))
    return q, k, v, do


ATTN = [  # B, S, H, KVH, D, softcap
    (2, 48, 4, 4, 16, 0.0),
    (1, 64, 4, 2, 32, 0.0),
    (2, 40, 6, 2, 16, 30.0),
    (1, 33, 8, 1, 64, 50.0),
]


@pytest.mark.parametrize("B,S,H,KVH,D,cap", ATTN)
def test_flash_attention_bwd_ref_matches_jax_grad(B, S, H, KVH, D, cap):
    q, k, v, do = _qkv(B, S, H, KVH, D, seed=S + H)
    f = lambda q, k, v: jnp.sum(RR.flash_attention_ref(q, k, v, softcap=cap)
                                * do)
    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.flash_attention_fwd_ref(tq, tk, tv, softcap=cap)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, softcap=cap)
    for g, w in zip(got, want):
        _close(g, w)
    # the forward's output is the reference's, and lse its log-sum-exp
    _close(o, RR.flash_attention_ref(q, k, v, softcap=cap))
    s = np.einsum("bqhd,bkhd->bhqk", q, np.repeat(k, H // KVH, 2)) \
        / math.sqrt(D)
    if cap:
        s = cap * np.tanh(s / cap)
    s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    _close(lse, (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0])


@pytest.mark.parametrize("window,cap", [(5, 0.0), (16, 30.0), (1, 0.0),
                                        (100, 0.0)])
def test_flash_attention_bwd_ref_window_matches_torch_autograd(window, cap):
    q, k, v, do = map(torch.from_numpy, _qkv(2, 50, 4, 2, 16, seed=window))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = ref.flash_attention_ref(q, k, v, softcap=cap, window=window)
    want = torch.autograd.grad(o, (q, k, v), do)
    o, lse = ref.flash_attention_fwd_ref(q.detach(), k.detach(), v.detach(),
                                         softcap=cap, window=window)
    got = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o,
                                      lse, do, softcap=cap, window=window)
    # window 1: each query sees itself alone, and dq = dk = 0; a gradient
    # that is 0 is held at the bar of the largest of the three
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        _close(g, w, scale=float(w.abs().max()) or scale)


@pytest.mark.parametrize("residual", [False, True],
                         ids=["rmsnorm", "residual"])
@pytest.mark.parametrize("rows,d", [(7, 32), (24, 96)])
def test_rmsnorm_bwd_ref_matches_jax_grad(rows, d, residual):
    rng = np.random.default_rng(rows * d)
    x, r, g, gs = (rng.standard_normal((rows, d)).astype(np.float32)
                   for _ in range(4))
    w = (0.3 * rng.standard_normal(d)).astype(np.float32)
    tx, tr, tw, tg, tgs = map(torch.from_numpy, (x, r, w, g, gs))
    if residual:
        def f(x, r, w):
            o, s = RR.rmsnorm_residual_ref(x, r, w)
            return jnp.sum(o * g) + jnp.sum(s * gs)
        dx, dr, dw = jax.grad(f, argnums=(0, 1, 2))(x, r, w)
        _close(dx, dr)
        got = ref.rmsnorm_residual_bwd_ref(tx, tr, tw, tg, tgs)
    else:
        dx, dw = jax.grad(lambda x, w: jnp.sum(RR.rmsnorm_ref(x, w) * g),
                          argnums=(0, 1))(x, w)
        got = ref.rmsnorm_bwd_ref(tx, tw, tg)
    _close(got[0], dx)
    _close(got[1], dw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (0, 30.0), (9, 0.0)])
def test_flash_attention_function_on_cpu(dtype, window, cap):
    """The Function (the plain forward with lse, the plain backward) against
    torch's autograd of the plain forward: equal in float32 to round-off;
    in bf16 the backward rounds P to bf16 before P^T dO (as the card's K8
    rounds P before P V) and dS to bf16 before dS K and dS^T Q (as the
    card's backward kernels round it to run those products on the tensor
    cores) where autograd of the plain forward rounds neither, so the
    gradients are held at a bf16 bar."""
    q, k, v, do = (torch.from_numpy(t).to(dtype)
                   for t in _qkv(2, 40, 4, 2, 32, seed=window + 3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = FlashAttention.apply(*leaves, cap, window)
    got = torch.autograd.grad(o, leaves, do)
    leaves2 = [t.clone().requires_grad_() for t in (q, k, v)]
    o2 = ref.flash_attention_ref(*leaves2, softcap=cap, window=window)
    want = torch.autograd.grad(o2, leaves2, do)
    assert torch.equal(o, o2)
    tol = TOL if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == dtype
        _close(g.float(), w.float(), tol)
    # ops.flash_attention takes the Function under autograd only
    assert ops.flash_attention(*leaves, softcap=cap, window=window).grad_fn \
        is not None
    with torch.no_grad():
        assert ops.flash_attention(*leaves, softcap=cap,
                                   window=window).grad_fn is None


def _bwd_f32_ds(q, k, v, o, lse, do, cap, window):
    """The plain bf16 backward's equations with dS kept in float32 (P still
    rounded to bf16 before P^T dO), written out here apart from
    ``ref.flash_attention_bwd_ref``: what the backward computed before it
    rounded dS to enter the tensor cores."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    rep = H // KVH
    scale = 1.0 / math.sqrt(D)
    q32, do32, o32 = q.float(), do.float(), o.float()
    k32, v32 = (t.repeat_interleave(rep, dim=2).float() for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
    dcap = 1.0
    if cap:
        t = torch.tanh(s / cap)
        s, dcap = cap * t, 1.0 - t * t
    keep = ref.attention_mask(S, window, q.device)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
    delta = (do32 * o32).sum(-1).transpose(1, 2)
    ds = p * (dp - delta[..., None]) * dcap
    p = p.to(torch.bfloat16).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k32) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    dk, dv = (x.reshape(B, S, KVH, rep, D).sum(3) for x in (dk, dv))
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


@pytest.mark.parametrize("B,S,H,KVH,D,window,cap", [
    (2, 64, 8, 2, 32, 0, 0.0),     # GQA 4
    (1, 80, 4, 1, 64, 24, 0.0),    # GQA 4, a window
    (2, 48, 4, 2, 16, 0, 30.0),    # a softcap
    (1, 96, 6, 2, 32, 40, 50.0),   # GQA 3, a window and a softcap
])
def test_flash_attention_bwd_bf16_ds_rounding_within_2x(B, S, H, KVH, D,
                                                         window, cap):
    """The plain bf16 backward rounds dS to bf16 before dS K and dS^T Q, as
    the card's backward kernels must to run those products on the tensor
    cores.  Each gradient's rows against float64 of the same bf16 inputs
    (error norm over the row's norm, rows above 1e-6 of the largest): the
    mean and the max within 2x of the same equations with dS kept in
    float32.  Holds the choice on the CPU before the card sees it."""
    q, k, v, do = (torch.from_numpy(t).to(torch.bfloat16)
                   for t in _qkv(B, S, H, KVH, D, seed=S + H + window))
    o, lse = ref.flash_attention_fwd_ref(q, k, v, softcap=cap, window=window)
    got = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, softcap=cap,
                                      window=window)
    kept = _bwd_f32_ds(q, k, v, o, lse, do, cap, window)
    wide = [t.double() for t in (q, k, v)]
    e_o, e_lse = ref.flash_attention_fwd_ref(*wide, softcap=cap,
                                             window=window)
    exact = ref.flash_attention_bwd_ref(*wide, e_o, e_lse, do.double(),
                                        softcap=cap, window=window)
    floor = 1e-6 * max(e.norm(dim=-1).max().item() for e in exact)
    # dS is rounded: dq and dk move, dv (P^T dO) does not
    assert not torch.equal(got[0], kept[0])
    assert not torch.equal(got[1], kept[1])
    assert torch.equal(got[2], kept[2])
    for g, f, e in zip(got, kept, exact):
        norm = e.norm(dim=-1)
        rel = [((x.double() - e).norm(dim=-1) / norm)[norm > floor]
               for x in (g, f)]
        assert rel[0].numel() > 0
        for stat in (torch.mean, torch.amax):
            rounded, unrounded = (stat(r).item() for r in rel)
            assert rounded <= 2.0 * unrounded, (stat.__name__, rounded,
                                                unrounded)
    # and the plain version's own switch computes those equations
    off = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, softcap=cap,
                                      window=window, round_ds=False)
    for a, b in zip(off, kept):
        _close(a.float(), b.float(), 1e-2)


def _bwd_tf32_kernels(q, k, v, o, lse, do, cap=0.0, window=0, products=3):
    """What K8's float32 backward kernels (``flash_attention_bwd_rows_kernel``
    then ``flash_attention_bwd_tf32_{dkdv,dq}_kernel``) compute, blockwise,
    in torch: tiles of 64 query rows x 64 keys, rows past S zero-filled;
    delta = rowsum(dO O) and lse from the rows kernel in f32; S and dP over
    D in chunks of 32 columns, each chunk's sum apart (3 TF32 products of
    the split operands, :func:`_tensor_core_product`) and added in f32 in
    chunk order; s = raw / sqrt(D) (with a softcap cap tanh(s / cap), dc =
    1 - t^2), P = 2^(raw scale log2 e - lse log2 e) where the key is
    visible, else 0, dS = (P dc) (dP - delta); then dV += P^T dO and dK +=
    dS^T Q (the dK/dV kernel's walk: each key tile, every query head of its
    group in order, query tiles from the key tile's causal start to the
    window's upper edge) and dQ += dS K (the dQ kernel's: key tiles from
    the window's lower edge to the causal frontier), each over a half of 32
    of the tile (the K of those products) into a sum of its own (3 TF32
    products of P or dS split in registers and of the transposed copy)
    added to the running sum in f32; dK and dQ times 1/sqrt(D) at the end.
    The sums round to nearest, where the tensor cores truncate: each sum
    on them spans 4 k8 steps, the long ones are in f32 (the float64 hold
    on the card answers for that)."""
    from test_torch_lm_kernels import _tensor_core_product

    B, S, H, D = q.shape
    KVH = k.shape[2]
    rep = H // KVH
    T = 64
    nt = -(-S // T)
    Sp = nt * T
    f32 = torch.float32
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=f32)
    log2e = torch.tensor(1.4426950408889634, dtype=f32)
    cs = scale * log2e
    to_cap = scale / torch.tensor(cap, dtype=f32) if cap else None

    def rows(x):  # (B, S, h, D) -> (B, h, Sp, D), zero rows past S
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, Sp - S)).permute(
            0, 2, 1, 3)

    qp, dop = rows(q), rows(do)
    kp = rows(k).repeat_interleave(rep, dim=1)
    vp = rows(v).repeat_interleave(rep, dim=1)
    delta = torch.nn.functional.pad((do * o).sum(-1).transpose(1, 2),
                                    (0, Sp - S))              # (B, H, Sp)
    nl = -torch.nn.functional.pad(lse, (0, Sp - S)) * log2e

    def chunked(a, b):  # a (.., 64, D) against b (.., 64, D) over D
        run = None
        for c0 in range(0, D, 32):
            part = _tensor_core_product(a[..., c0:c0 + 32],
                                        b[..., c0:c0 + 32].transpose(-1, -2),
                                        products)
            run = part if run is None else run + part
        return run

    blocks = {}  # (query tile, key tile) -> (P, dS), (B, H, 64, 64)
    for qt in range(nt):
        for kt in range(qt + 1):
            rq, rk = slice(qt * T, qt * T + T), slice(kt * T, kt * T + T)
            raw = chunked(qp[:, :, rq], kp[:, :, rk])
            dp = chunked(dop[:, :, rq], vp[:, :, rk])
            if cap:
                t = torch.tanh(raw * to_cap)
                dc = 1.0 - t * t
                p = torch.exp2((cap * t) * log2e + nl[:, :, rq, None])
            else:
                dc = 1.0
                p = torch.exp2(raw * cs + nl[:, :, rq, None])
            row = torch.arange(qt * T, qt * T + T)[:, None]
            key = torch.arange(kt * T, kt * T + T)[None, :]
            keep = (key <= row) & (row < S)
            if 0 < window < S:
                keep &= key + window > row
            p = torch.where(keep, p, 0.0)
            ds = (p * dc) * (dp - delta[:, :, rq, None])
            blocks[qt, kt] = p, ds

    def halves(a, b):  # a (.., 64, 64) @ b (.., 64, n): two sums of 32
        return [_tensor_core_product(a[..., i:i + 32], b[..., i:i + 32, :],
                                     products) for i in (0, 32)]

    dq = torch.zeros(B, H, Sp, D)
    dk = torch.zeros(B, KVH, Sp, D)
    dv = torch.zeros(B, KVH, Sp, D)
    win = 0 < window < S
    for qt in range(nt):  # the dQ kernel's walk
        lo = max(0, qt * T - window + 1) // T if win else 0
        run = torch.zeros(B, H, T, D)
        for kt in range(lo, qt + 1):
            for part in halves(blocks[qt, kt][1], kp[:, :, kt * T:kt * T + T]):
                run = run + part
        dq[:, :, qt * T:qt * T + T] = run * scale
    for kt in range(nt):  # the dK/dV kernel's walk
        q_end = min(S, kt * T + T - 1 + window) if win else S
        rk, kvh = slice(kt * T, kt * T + T), torch.arange(KVH)
        run_k, run_v = torch.zeros(B, KVH, T, D), torch.zeros(B, KVH, T, D)
        for hr in range(rep):
            h = kvh * rep + hr
            for qt in range(kt, -(-q_end // T)):
                p, ds = (x[:, h].transpose(-1, -2) for x in blocks[qt, kt])
                rq = slice(qt * T, qt * T + T)
                for part in halves(p, dop[:, h, rq]):
                    run_v = run_v + part
                for part in halves(ds, qp[:, h, rq]):
                    run_k = run_k + part
        dk[:, :, rk] = run_k * scale
        dv[:, :, rk] = run_v
    return tuple(x[:, :, :S].permute(0, 2, 1, 3) for x in (dq, dk, dv))


@pytest.mark.parametrize("B,S,H,KVH,D,window,cap", [
    (1, 80, 2, 1, 16, 0, 0.0),       # D 16: one chunk, half of it zeros
    (2, 70, 4, 2, 32, 0, 30.0),
    (1, 130, 4, 1, 64, 0, 0.0),      # GQA 4, a ragged last tile
    (1, 96, 2, 2, 96, 0, 50.0),
    (1, 100, 2, 1, 112, 0, 0.0),     # D 112: a last chunk of 16 columns
    (1, 128, 8, 1, 128, 0, 0.0),     # GQA 8
    (1, 90, 2, 1, 256, 0, 50.0),     # D 256: two CTAs a key tile
    (1, 150, 4, 2, 64, 40, 0.0),     # windows
    (1, 140, 2, 1, 256, 70, 50.0),
    (1, 130, 8, 1, 32, 3, 0.0),      # GQA 8, three keys a row
])
def test_flash_attention_bwd_tf32_design_meets_f32_bar(B, S, H, KVH, D,
                                                        window, cap):
    """K8's float32 backward design (3xTF32 products on 64 x 64 tiles,
    :func:`_bwd_tf32_kernels`) on the plain forward's o and lse: against
    ``jax.grad`` of the reference's attention at 1e-5 of each gradient's
    largest |value| (a window against torch's autograd of the plain
    forward, which the reference's kernel has none of), and against
    float64 within 1e-4 of each max and 2x the plain version's error, the
    card's bars (``chip_smoke.py``'s backward phase).  With one TF32
    product the same design misses them, so the bars tell the two apart."""
    q, k, v, do = _qkv(B, S, H, KVH, D, seed=S + D + window)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.flash_attention_fwd_ref(tq, tk, tv, softcap=cap,
                                         window=window)
    o = o.contiguous()
    got = _bwd_tf32_kernels(tq, tk, tv, o, lse, tdo, cap, window)
    if window:
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        want = torch.autograd.grad(ref.flash_attention_ref(
            *leaves, softcap=cap, window=window), leaves, tdo)
    else:
        f = lambda q, k, v: jnp.sum(RR.flash_attention_ref(q, k, v,
                                                           softcap=cap) * do)
        want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _close(g, w)
    plain = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, softcap=cap,
                                        window=window)
    wide = [t.double() for t in (tq, tk, tv)]
    e_o, e_lse = ref.flash_attention_fwd_ref(*wide, softcap=cap,
                                             window=window)
    exact = ref.flash_attention_bwd_ref(*wide, e_o, e_lse, tdo.double(),
                                        softcap=cap, window=window)

    def held(mine):
        ok = True
        for g, p, e in zip(mine, plain, exact):
            err, plain_err = ((x.double() - e).abs().max().item()
                              for x in (g, p))
            ok &= err <= 1e-4 * e.abs().max().item() and err <= 2 * plain_err
        return ok

    assert held(got)
    one = _bwd_tf32_kernels(tq, tk, tv, o, lse, tdo, cap, window, products=1)
    assert not held(one)


def test_flash_attention_lse_on_cpu():
    q, k, v, do = map(torch.from_numpy, _qkv(1, 20, 2, 1, 16, seed=1))
    lse = torch.empty(1, 2, 20)
    o = flash_attention(q, k, v, softcap=20.0, window=6, lse=lse)
    o2, lse2 = ref.flash_attention_fwd_ref(q, k, v, softcap=20.0, window=6)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    got = flash_attention_bwd(q, k, v, o, lse, do, softcap=20.0, window=6)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, softcap=20.0,
                                       window=6)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="lse"):
        flash_attention(q, k, v, lse=torch.empty(1, 20, 2))


@pytest.mark.parametrize("residual", [False, True],
                         ids=["rmsnorm", "residual"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rmsnorm_functions_on_cpu(dtype, residual):
    rng = np.random.default_rng(5)
    x, r, g, gs = (torch.from_numpy(rng.standard_normal((3, 6, 64))
                                    .astype(np.float32)).to(dtype)
                   for _ in range(4))
    w = torch.from_numpy((0.2 * rng.standard_normal(64)).astype(np.float32))
    mk = lambda: [t.clone().requires_grad_() for t in (x, r, w)]
    a, b = mk(), mk()
    if residual:
        o, s = RMSNormResidual.apply(*a, 1e-5)
        got = torch.autograd.grad((o.float() * g.float()).sum()
                                  + (s.float() * gs.float()).sum(), a)
        o2, s2 = ref.rmsnorm_residual_ref(*b)
        want = torch.autograd.grad((o2.float() * g.float()).sum()
                                   + (s2.float() * gs.float()).sum(), b)
        assert torch.equal(o, o2) and torch.equal(s, s2)
    else:
        o = RMSNorm.apply(a[0], a[2], 1e-5)
        got = torch.autograd.grad(o, (a[0], a[2]), g)
        o2 = ref.rmsnorm_ref(b[0], b[2])
        want = torch.autograd.grad(o2, (b[0], b[2]), g)
        assert torch.equal(o, o2)
    tol = TOL if dtype == torch.float32 else 1e-2
    for gg, ww in zip(got, want):
        assert gg.dtype == ww.dtype
        _close(gg.float(), ww.float(), tol)
    # the wrappers: the plain backward on CPU tensors
    if residual:
        dx, dw = rmsnorm_residual_bwd(x, r, w, g, gs)
        want = ref.rmsnorm_residual_bwd_ref(x, r, w, g, gs)
    else:
        dx, dw = rmsnorm_bwd(x, w, g)
        want = ref.rmsnorm_bwd_ref(x, w, g)
    assert torch.equal(dx, want[0]) and torch.equal(dw, want[1])


def test_rmsnorm_ops_take_the_function_under_autograd_only():
    x = torch.randn(4, 32, requires_grad=True)
    w = torch.zeros(32)
    assert ops.rmsnorm(x, w).grad_fn is not None
    assert ops.rmsnorm_residual(x, x.detach(), w)[0].grad_fn is not None
    with torch.no_grad():
        assert ops.rmsnorm(x, w).grad_fn is None
    assert ops.rmsnorm(x.detach(), w).grad_fn is None


def test_kernels_without_a_backward_refuse_grad():
    """K6 and K7 run on the card only without autograd: their wrappers
    raise (naming the ROADMAP item) where an input requires grad under grad
    mode, and pass otherwise."""
    a = torch.ones(3, requires_grad=True)
    for name, item in (("tridiag", "11b"), ("fvt_flux", "11b")):
        with pytest.raises(RuntimeError, match=f"{name}.*item {item}"):
            library.refuse_grad(name, f"item {item}", a)
        library.refuse_grad(name, f"item {item}", a.detach())
        with torch.no_grad():
            library.refuse_grad(name, f"item {item}", a)


def _scan_inputs(nc, B, H, N, P, seed, edges=False):
    """states, decay in [0, 1) (with ``edges``, some decays exactly 0 and
    1) and g, float32 from numpy."""
    rng = np.random.default_rng(seed)
    states = rng.standard_normal((nc, B, H, N, P)).astype(np.float32)
    decay = rng.random((nc, B, H)).astype(np.float32)
    if edges:
        flat = decay.reshape(-1)
        flat[::3] = 0.0
        flat[1::3] = 1.0
    g = rng.standard_normal((nc, B, H, N, P)).astype(np.float32)
    return states, decay, g


SCAN = [  # nc, B, H, N, P, edges
    (1, 2, 3, 4, 5, False),
    (5, 2, 3, 4, 4, False),
    (7, 1, 4, 8, 6, True),
    (3, 3, 2, 5, 7, True),
    (16, 1, 2, 16, 16, False),
]


@pytest.mark.parametrize("nc,B,H,N,P,edges", SCAN)
def test_ssm_state_scan_bwd_ref_matches_jax_vjp(nc, B, H, N, P, edges):
    """K10's plain backward against ``jax.vjp`` of the reference's
    ``ssm_state_scan_ref``: d states at rtol = atol = 1e-6; d decay, a sum
    over N P products, within 1e-5 of its largest |value|."""
    states, decay, g = _scan_inputs(nc, B, H, N, P, nc * B + H, edges)
    out, vjp = jax.vjp(RR.ssm_state_scan_ref, states, decay)
    want_ds, want_dd = vjp(jnp.asarray(g))
    got_ds, got_dd = ref.ssm_state_scan_bwd_ref(
        torch.from_numpy(g), torch.from_numpy(np.asarray(out)),
        torch.from_numpy(decay))
    np.testing.assert_allclose(got_ds.numpy(), np.asarray(want_ds),
                               rtol=1e-6, atol=1e-6)
    _close(got_dd, want_dd, tol=1e-5,
           scale=max(np.abs(np.asarray(want_dd)).max(), 1e-30))
    # the last chunk's gradients are 0: the exclusive scan never reads them
    assert not got_ds[-1].any() and not got_dd[-1].any()


@pytest.mark.parametrize("nc,B,H,N,P,edges", SCAN[:3])
def test_ssm_state_scan_function_on_cpu(nc, B, H, N, P, edges):
    """``ops.ssm_state_scan`` under autograd is :class:`SSMStateScan` (the
    plain forward and backward on CPU tensors): its gradients equal torch's
    autograd of ``ssm_state_scan_ref`` at 1e-6; without grad it builds no
    graph; the backward wrapper is the plain version on the CPU."""
    states, decay, g = (torch.from_numpy(x) for x in _scan_inputs(
        nc, B, H, N, P, 2 * nc + H, edges))
    got_leaves = [states.clone().requires_grad_(),
                  decay.clone().requires_grad_()]
    want_leaves = [states.clone().requires_grad_(),
                   decay.clone().requires_grad_()]
    out = ops.ssm_state_scan(*got_leaves)
    assert type(out.grad_fn).__name__ == "SSMStateScanBackward"
    want = ref.ssm_state_scan_ref(*want_leaves)
    assert torch.equal(out, want)
    out.backward(g)
    if want.requires_grad:
        want.backward(g)
        expected = [x.grad for x in want_leaves]
    else:  # one chunk: the plain scan's output is 0, with no graph
        expected = [torch.zeros_like(x) for x in want_leaves]
    for a, b in zip(got_leaves, expected):
        np.testing.assert_allclose(a.grad.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)
    with torch.no_grad():
        assert ops.ssm_state_scan(*got_leaves).grad_fn is None
    assert ops.ssm_state_scan(states, decay).grad_fn is None
    ds, dd = ssm_state_scan_bwd(g, out.detach(), decay)
    wds, wdd = ref.ssm_state_scan_bwd_ref(g, out.detach(), decay)
    assert torch.equal(ds, wds) and torch.equal(dd, wdd)
    with pytest.raises(ValueError, match="gradient of out's shape"):
        ssm_state_scan_bwd(g[..., :1], out.detach(), decay)
