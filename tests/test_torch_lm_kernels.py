"""The port's LM kernels (``repro_torch.kernels.ops.flash_attention``,
``rmsnorm``, ``rmsnorm_residual``) against the reference's
``repro.kernels.ops`` (Pallas in interpret mode), on the shape, dtype and
softcap sweeps and tolerances of the reference's own kernel tests
(``tests/test_kernels.py``).  On the CPU the wrappers run the plain
versions; the kernels themselves are held against those on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Each flash-attention
kernel's own arithmetic (tiles, padding, where it rounds: bf16 P in the
bf16 kernel, 3xTF32 products in the f32 one) is emulated here in torch and
held to the reference's bar before the card runs it."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as R

from repro_torch.kernels import library
from repro_torch.kernels import ops as T
from repro_torch.kernels.flash_attention import check_card_inputs
from repro_torch.kernels import ref as TR

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _pair(a: np.ndarray, dtype):
    """The same float32 draws in both packages, rounded alike to ``dtype``."""
    return jnp.asarray(a, JNP[dtype]), torch.from_numpy(a).to(dtype)


def _close(got: torch.Tensor, want, rtol, atol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("B,S,H,KVH,D", [
    (1, 128, 2, 2, 64), (2, 256, 4, 2, 64), (1, 256, 8, 1, 128),
    (2, 100, 4, 2, 32),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flash_attention_matches_reference(B, S, H, KVH, D, dtype, softcap):
    rng = np.random.default_rng(B * S + H * D)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D))]
    pairs = [_pair(a, dtype) for a in arrs]
    want = R.flash_attention(*(p[0] for p in pairs), softcap=softcap)
    library.reset_launches()
    got = T.flash_attention(*(p[1] for p in pairs), softcap=softcap)
    assert library.LAUNCHES["flash_attention"] == 0  # CPU: the plain version
    assert got.dtype == dtype and got.shape == (B, S, H, D)
    tol = 2e-6 if dtype == torch.float32 else 2e-2
    _close(got, want, tol, tol * 5)


def test_flash_attention_heads_read_their_kv_group():
    """Query head h attends over kv head h // (H / KVH), causally: each head
    against a per-head softmax written out here."""
    rng = np.random.default_rng(7)
    B, S, H, KVH, D = 1, 12, 6, 2, 8
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    got = T.flash_attention(q, k, v)
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    for h in range(H):
        g = h // (H // KVH)
        s = (q[0, :, h] @ k[0, :, g].T) / D ** 0.5
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        torch.testing.assert_close(got[0, :, h], p @ v[0, :, g], rtol=1e-6,
                                   atol=1e-6)


def _key_walk(q0, BQ, BK, S, window):
    """The key tiles a query tile of rows q0 .. q0 + BQ - 1 walks, as the
    kernels compute them (``lm_kernels.cu``: ``key_lo``, ``key_hi``,
    ``edge``): (k0, flags), one flag per 64-row group of the tile, True
    where the group's softmax masks the tile (a key past a row, or at or
    below a row's window edge).  A window of 0, or of S or more, runs the
    kernels' causal instance."""
    windowed = 0 < window < S
    lo = max(0, q0 - window + 1) // BK if windowed else 0
    hi = -(-min(q0 + BQ, S) // BK)
    return [(k0, [k0 + BK - 1 > w0 or (windowed and k0 + window <= w0 + 63)
                  for w0 in range(q0, q0 + BQ, 64)])
            for k0 in range(lo * BK, hi * BK, BK)]


@pytest.mark.parametrize("BQ,BK", [(128, 128), (128, 64), (64, 64),
                                   (64, 32)])
@pytest.mark.parametrize("S", [1, 63, 64, 100, 257, 1000])
@pytest.mark.parametrize("window", [0, 1, 31, 63, 64, 65, 100, 128, 300,
                                    1000, 4096])
def test_key_walk_visits_and_masks_the_window(BQ, BK, S, window):
    """Each kernel's tile walk (bf16: 128-row query tiles, 128 or 64 keys;
    f32: 64 and 64 or 32) against every (query, key) pair: every visible
    pair lies in a walked tile, every walked tile holds a visible pair of
    the query tile's rows below S (tiles wholly below the window are not
    walked), and a 64-row group that meets an invisible pair in a walked
    tile masks it."""
    win = window if window > 0 else S
    for q0 in range(0, S, BQ):
        walk = _key_walk(q0, BQ, BK, S, window)
        tiles = {k0 for k0, _ in walk}
        rows = range(q0, min(q0 + BQ, S))
        for r in rows:
            for key in range(max(0, r - win + 1), r + 1):
                assert key // BK * BK in tiles, (q0, r, key)
        for k0, flags in walk:
            keys = range(k0, min(k0 + BK, S))
            assert any(r - win < key <= r for r in rows for key in keys)
            for g, flag in enumerate(flags):
                group = range(q0 + 64 * g, min(q0 + 64 * g + 64, S))
                hidden = any(not r - win < key <= r for r in group
                             for key in range(k0, k0 + BK))
                assert flag or not hidden, (q0, k0, g)


def _wgmma_kernel_emulation(q, k, v, softcap, window=0):
    """What ``flash_attention_wgmma_kernel`` computes, blockwise, in torch:
    128 query rows a CTA, tiles of BK keys (128, or 64 at D = 256) from the
    window's lower edge to the causal frontier (:func:`_key_walk`), D
    padded with zeros to DP (64, 128 or 256) and rows past S zero-filled,
    as the kernel's TMA boxes fill them; S = Q K^T in f32 from the bf16
    inputs, the scale applied after the product (in the exponent:
    exp(s - m) = 2^(raw c - m c), c = scale log2 e, or log2 e after a
    softcap), masked scores -1e30 on the 64-row groups the walk flags, the
    online softmax in f32 with l summed over the unrounded p (p = 0 in a
    row whose scores are all masked so far), p rounded to bf16 before P V
    (f32 sums), and O / max(l, 1e-20) rounded once to bf16."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    DP = 64 if D <= 64 else 128 if D <= 128 else 256
    BQ, BK = 128, 128 if DP <= 128 else 64
    Sp = -(-S // BQ) * BQ

    def tiles(x):  # (B, S, h, D) -> (B, h, Sp, DP), f32 of the bf16 values
        x = torch.nn.functional.pad(x.float(), (0, DP - D, 0, 0, 0, Sp - S))
        return x.permute(0, 2, 1, 3)

    qp = tiles(q)
    kp = tiles(k).repeat_interleave(rep, dim=1)
    vp = tiles(v).repeat_interleave(rep, dim=1)
    scale = 1.0 / math.sqrt(D)
    log2e = 1.0 / math.log(2.0)
    c = log2e if softcap > 0 else scale * log2e
    out = torch.empty(B, H, Sp, DP)
    for q0 in range(0, Sp, BQ):
        rows = torch.arange(q0, q0 + BQ)
        m = torch.full((B, H, BQ), -1e30)
        l = torch.zeros(B, H, BQ)
        acc = torch.zeros(B, H, BQ, DP)
        for k0, flags in _key_walk(q0, BQ, BK, S, window):
            s = qp[:, :, q0:q0 + BQ] @ kp[:, :, k0:k0 + BK].transpose(-1, -2)
            if softcap > 0:
                s = softcap * torch.tanh(s * (scale / softcap))
            s = _mask_tile(s, rows, k0, BK, flags, window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp2((m - m_new) * c)
            p = _masked_rows_zero(torch.exp2(s * c - (m_new * c)[..., None]),
                                  m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + (p.to(torch.bfloat16).float()
                                            @ vp[:, :, k0:k0 + BK])
            m = m_new
        out[:, :, q0:q0 + BQ] = acc * (1.0 / l.clamp(min=1e-20))[..., None]
    return out[:, :, :S, :D].permute(0, 2, 1, 3).to(torch.bfloat16)


@pytest.mark.parametrize("B,S,H,KVH,D", [
    (1, 128, 2, 2, 64), (2, 256, 4, 2, 64), (1, 256, 8, 1, 128),
    (2, 100, 4, 2, 32), (1, 256, 4, 2, 112),
])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_wgmma_kernel_numerics_meet_reference_bar(B, S, H, KVH, D, softcap):
    """The bf16 kernel's design (bf16 P, the scale after the product, padded
    D, zero-filled rows) against the reference's Pallas kernel, which keeps
    P in f32, and against the plain version the card holds the kernel to:
    the reference's bf16 sweep (tests/test_kernels.py), ragged S = 100 and
    D = 112, at rtol 2e-2 and atol 1e-1 (``chip_smoke.FA_TOL``)."""
    rng = np.random.default_rng(B * S + H * D + 1)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D))]
    pairs = [_pair(a, torch.bfloat16) for a in arrs]
    want = R.flash_attention(*(p[0] for p in pairs), softcap=softcap)
    got = _wgmma_kernel_emulation(*(p[1] for p in pairs), softcap)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, D)
    _close(got, want, 2e-2, 1e-1)
    plain = TR.flash_attention_ref(*(p[1] for p in pairs), softcap=softcap)
    torch.testing.assert_close(got, plain, rtol=2e-2, atol=1e-1)


def _mask_tile(s, rows, k0, BK, flags, window):
    """-1e30 where a key is past a row or at or below its window edge, in
    the 64-row groups that ``flags`` marks (the kernels mask no other)."""
    keys = torch.arange(k0, k0 + BK)
    hidden = keys[None, :] > rows[:, None]
    if window > 0:
        hidden |= keys[None, :] + window <= rows[:, None]
    hidden &= torch.tensor(flags).repeat_interleave(64)[:len(rows), None]
    return torch.where(hidden, -1e30, s)


def _masked_rows_zero(p, m_new):
    """p = 0 in a row whose running max is still -1e30 (every score so far
    masked), as the kernels compute it."""
    return torch.where((m_new == -1e30)[..., None], 0.0, p)


@pytest.mark.parametrize("B,S,H,KVH,D,window", [
    (1, 256, 2, 2, 64, 1), (2, 300, 4, 2, 64, 63), (1, 256, 4, 2, 128, 100),
    (1, 200, 4, 2, 256, 64), (1, 160, 4, 2, 256, 65), (2, 100, 4, 2, 32, 7),
    (1, 256, 4, 2, 112, 256),
])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_wgmma_kernel_window_meets_reference_bar(B, S, H, KVH, D, window,
                                                 softcap):
    """The bf16 kernel's walk and masks with a window (windows below one
    tile, across tile edges, not a multiple of BK, and equal to S) against
    the plain version with the window at the reference's bf16 bar; window
    S gives the causal kernel's arithmetic exactly."""
    rng = np.random.default_rng(B * S + window + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16)
               for s in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    got = _wgmma_kernel_emulation(q, k, v, softcap, window)
    plain = TR.flash_attention_ref(q, k, v, softcap=softcap, window=window)
    torch.testing.assert_close(got, plain, rtol=2e-2, atol=1e-1)
    if window >= S:
        assert torch.equal(got, _wgmma_kernel_emulation(q, k, v, softcap))


@pytest.mark.parametrize("B,S,H,KVH,D,window", [
    (1, 256, 2, 2, 64, 1), (2, 300, 4, 2, 64, 63), (1, 256, 4, 2, 128, 100),
    (1, 200, 4, 2, 256, 64), (1, 160, 4, 2, 256, 33), (2, 100, 4, 2, 32, 7),
    (1, 130, 4, 2, 112, 130),
])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_tf32x3_kernel_window_meets_f32_bar(B, S, H, KVH, D, window,
                                            softcap):
    """The f32 kernel's walk and masks with a window against the plain
    version with the window at the card's f32 bar (2e-5); window S gives
    the causal kernel's arithmetic exactly."""
    rng = np.random.default_rng(B * S + window + D + 1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    got = _tf32x3_kernel_emulation(q, k, v, softcap, window=window)
    plain = TR.flash_attention_ref(q, k, v, softcap=softcap, window=window)
    torch.testing.assert_close(got, plain, rtol=2e-5, atol=2e-5)
    if window >= S:
        assert torch.equal(got, _tf32x3_kernel_emulation(q, k, v, softcap))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: the 13 low
    mantissa bits dropped, to nearest with ties away from zero (the float's
    bits are sign and magnitude, so adding half of the dropped unit to
    them rounds the magnitude up at a tie, whatever the sign)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tensor_core_product(a, b, products):
    """``a @ b`` of f32 operands as the f32 kernel runs it on the tensor
    cores, with f32 sums: 3 products of the split operands (hi = tf32(x),
    lo = tf32(x - hi); ``lo lo`` is dropped), or, for ``products=1``, the
    one TF32 product that the f32 bar rules out."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if products == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


def _tf32x3_kernel_emulation(q, k, v, softcap, products=3, window=0):
    """What ``flash_attention_fwd_kernel`` (float32) computes, blockwise, in
    torch: 64 query rows a CTA, tiles of BK keys (64, or 32 at D = 256)
    from the window's lower edge to the causal frontier
    (:func:`_key_walk`), rows past S zero-filled as the producer fills
    them; q scaled by 1/sqrt(D) in f32 before the product, as the Pallas
    kernel scales it; S = Q K^T and O += P V each as three TF32 products of
    the split operands (:func:`_tensor_core_product`), P split from the
    unrounded f32 probabilities; masked scores -1e30 where the walk flags
    the tile, the online softmax in f32 (exp(s - m) = 2^(s log2 e -
    m log2 e); 0 in a row masked so far), l summed over the unrounded p,
    and O times 1 / max(l, 1e-20).  Its sums round to nearest; the
    tensor cores' truncate, which the kernel's order of sums answers for
    (a float64 check on the card holds it there)."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    BQ, BK = 64, 64 if D <= 128 else 32
    Sp = -(-S // BQ) * BQ

    def rows(x):  # (B, S, h, D) -> (B, h, Sp, D)
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, Sp - S)).permute(
            0, 2, 1, 3)

    qs = rows(q) * torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    kp = rows(k).repeat_interleave(rep, dim=1)
    vp = rows(v).repeat_interleave(rep, dim=1)
    log2e = torch.tensor(1.0 / math.log(2.0), dtype=torch.float32)
    out = torch.empty(B, H, Sp, D)
    for q0 in range(0, Sp, BQ):
        qrows = torch.arange(q0, q0 + BQ)
        m = torch.full((B, H, BQ), -1e30)
        l = torch.zeros(B, H, BQ)
        acc = torch.zeros(B, H, BQ, D)
        for k0, flags in _key_walk(q0, BQ, BK, S, window):
            s = _tensor_core_product(qs[:, :, q0:q0 + BQ],
                                     kp[:, :, k0:k0 + BK].transpose(-1, -2),
                                     products)
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            s = _mask_tile(s, qrows, k0, BK, flags, window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp2((m - m_new) * log2e)
            p = _masked_rows_zero(
                torch.exp2(s * log2e - (m_new * log2e)[..., None]), m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + _tensor_core_product(
                p, vp[:, :, k0:k0 + BK], products)
            m = m_new
        out[:, :, q0:q0 + BQ] = acc * (1.0 / l.clamp(min=1e-20))[..., None]
    return out[:, :, :S].permute(0, 2, 1, 3)


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # the TF32 unit at 1 is 2^-10
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), one + 2 ** -11,
                      1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([one, -one, one + 2 ** -10, 1.0, one, 3.0])
    assert torch.equal(_tf32(x), want)


@pytest.mark.parametrize("B,S,H,KVH,D", [
    (1, 128, 2, 2, 64), (2, 256, 4, 2, 64), (1, 256, 8, 1, 128),
    (2, 100, 4, 2, 32), (1, 256, 4, 2, 112), (1, 96, 2, 1, 256),
])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_tf32x3_kernel_numerics_meet_f32_bar(B, S, H, KVH, D, softcap):
    """The f32 kernel's design (3xTF32 products, 64-row query tiles, q
    scaled before the product) against the reference's Pallas kernel and
    the plain version at the card's f32 bar, rtol = atol = 2e-5
    (``chip_smoke.FA_TOL``); one TF32 product at the same shapes misses
    that bar, so the bar tells the two designs apart."""
    rng = np.random.default_rng(B * S + H * D + 2)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D))]
    pairs = [_pair(a, torch.float32) for a in arrs]
    want = R.flash_attention(*(p[0] for p in pairs), softcap=softcap)
    ins = [p[1] for p in pairs]
    got = _tf32x3_kernel_emulation(*ins, softcap)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, D)
    _close(got, want, 2e-5, 2e-5)
    plain = TR.flash_attention_ref(*ins, softcap=softcap)
    torch.testing.assert_close(got, plain, rtol=2e-5, atol=2e-5)
    one = _tf32x3_kernel_emulation(*ins, softcap, products=1)
    assert not np.allclose(one.numpy(), np.asarray(want), rtol=2e-5,
                           atol=2e-5)
    assert not torch.allclose(one, plain, rtol=2e-5, atol=2e-5)


def test_flash_attention_dispatch_and_checks():
    """The checks the card's kernels need, read from shapes and layouts
    (meta tensors: no data, no card); CPU tensors of either dtype run the
    plain version and launch nothing."""
    def t(shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    q, k = t((2, 300, 4, 128)), t((2, 300, 2, 128))
    check_card_inputs(q, k, k)
    check_card_inputs(*(x.float() for x in (q, k, k)))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        check_card_inputs(*(x.half() for x in (q, k, k)))
    with pytest.raises(ValueError, match="head width 48"):
        check_card_inputs(t((2, 300, 4, 48)), t((2, 300, 2, 48)),
                          t((2, 300, 2, 48)))
    wide = [t((2, 8, 32768, 16)), t((2, 8, 1, 16)), t((2, 8, 1, 16))]
    check_card_inputs(*wide)
    check_card_inputs(*(x.float() for x in wide))  # 2^16 CTAs of 64 rows
    huge = [t((2**12, 2**13, 2**12, 16)), t((2**12, 2**13, 1, 16)),
            t((2**12, 2**13, 1, 16))]
    check_card_inputs(*huge)  # the bf16 kernel is persistent
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        check_card_inputs(*(x.float() for x in huge))  # 2^31 query tiles
    with pytest.raises(ValueError, match="contiguous"):
        check_card_inputs(t((2, 4, 300, 128)).transpose(1, 2), k, k)
    raw = torch.zeros(2 * 300 * 4 * 128 + 1, dtype=torch.bfloat16)
    shifted = raw[1:].view(2, 300, 4, 128)  # 2 bytes past an alignment
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_card_inputs(shifted, k, k)
    rng = np.random.default_rng(11)
    for dtype in (torch.bfloat16, torch.float32):
        qc, kc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  .to(dtype) for s in ((1, 20, 4, 16), (1, 20, 2, 16)))
        library.reset_launches()
        got = T.flash_attention(qc, kc, kc)
        assert library.LAUNCHES["flash_attention"] == 0
        assert torch.equal(got, TR.flash_attention_ref(qc, kc, kc))


@pytest.mark.parametrize("rows,d", [(128, 64), (1024, 256), (96, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_matches_reference(rows, d, dtype):
    rng = np.random.default_rng(rows + d)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    w = (rng.standard_normal(d) * 0.1).astype(np.float32)
    xj, xt = _pair(x, dtype)
    want = R.rmsnorm(xj, jnp.asarray(w))
    got = T.rmsnorm(xt, torch.from_numpy(w))
    assert got.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    _close(got, want, tol, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_residual_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x, r = (rng.standard_normal((64, 128)).astype(np.float32)
            for _ in range(2))
    w = (rng.standard_normal(128) * 0.1).astype(np.float32)
    (xj, xt), (rj, rt) = _pair(x, dtype), _pair(r, dtype)
    n_want, s_want = R.rmsnorm_residual(xj, rj, jnp.asarray(w))
    n_got, s_got = T.rmsnorm_residual(xt, rt, torch.from_numpy(w))
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    _close(n_got, n_want, tol, tol)
    _close(s_got, s_want, tol, tol)
    # the new residual is x + r rounded once; the norm is of the unrounded sum
    assert torch.equal(s_got, (xt.float() + rt.float()).to(dtype))
    assert torch.equal(n_got, TR.rmsnorm_ref(xt.float() + rt.float(),
                                             torch.from_numpy(w)).to(dtype))


def test_ref_backend_is_the_plain_version():
    q = torch.randn(1, 16, 4, 16)
    k = torch.randn(1, 16, 2, 16)
    assert torch.equal(T.flash_attention(q, k, k, backend="ref"),
                       TR.flash_attention_ref(q, k, k))
    assert torch.equal(T.flash_attention(q, k, k, softcap=5.0),
                       TR.flash_attention_ref(q, k, k, softcap=5.0))
    w = torch.randn(16)
    assert torch.equal(T.rmsnorm(q, w, backend="ref"), TR.rmsnorm_ref(q, w))
    n, s = T.rmsnorm_residual(q, q, w, backend="ref")
    n2, s2 = TR.rmsnorm_residual_ref(q, q, w)
    assert torch.equal(n, n2) and torch.equal(s, s2)
    for fn, args in ((T.flash_attention, (q, k, k)), (T.rmsnorm, (q, w)),
                     (T.rmsnorm_residual, (q, q, w))):
        with pytest.raises(ValueError, match="backend"):
            fn(*args, backend="pallas")


def test_wrappers_check_their_inputs():
    q = torch.randn(1, 16, 4, 16)
    k = torch.randn(1, 16, 2, 16)
    with pytest.raises(TypeError):
        T.flash_attention(q.numpy(), k, k)
    with pytest.raises(ValueError, match="multiple of KVH"):
        T.flash_attention(q, torch.randn(1, 16, 3, 16),
                          torch.randn(1, 16, 3, 16))
    with pytest.raises(ValueError, match="do not fit"):
        T.flash_attention(q, k[:, :8], k[:, :8])
    with pytest.raises(ValueError, match="dtype"):
        T.flash_attention(q, k.double(), k.double())
    with pytest.raises(ValueError, match="weight"):
        T.rmsnorm(q, torch.zeros(8))
    with pytest.raises(ValueError, match="one shape"):
        T.rmsnorm_residual(q, q[:, :8], torch.zeros(16))
    with pytest.raises(ValueError, match="no kernel"):
        T.rmsnorm(q.to("meta"), torch.zeros(16, device="meta"))
