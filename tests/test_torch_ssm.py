"""The port's Mamba-2 pieces against the reference's, on the CPU.

K10's plain version (``repro_torch.kernels.ops.ssm_state_scan``, which runs
it for CPU tensors) against the reference's Pallas ``ssm_state_scan_pallas``
in interpret mode, on the shape sweep of the reference's own kernel test
(``tests/test_kernels.py``) and two more; the port's ``Mamba2`` mixer
(chunked prefill regrouped around K10, and the one-token decode) against
``repro.models.ssm.mamba2``/``mamba2_decode`` with the reference's
parameters; and the chunked form against the step-by-step recurrence, as
the reference's ``test_mamba2_chunked_matches_stepwise``.  The kernel
itself is held against its plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.kernels.ssm_scan import ssm_state_scan_pallas
from repro.models import ssm as RS
from repro.parallel.sharding import init_params as ref_init_params

from repro_torch import configs as TC
from repro_torch.kernels import library
from repro_torch.kernels import ops as T
from repro_torch.kernels import ref as TR
from repro_torch.models import ssm as TS

TOL = 1e-5


@pytest.mark.parametrize("nc,B,H,N,P", [
    (4, 1, 8, 4, 8), (8, 2, 16, 8, 16), (16, 1, 4, 16, 32),  # the reference's
    (1, 2, 4, 8, 8), (4, 2, 8, 64, 64)])                    # nc = 1; Zamba2's N, P
def test_ssm_state_scan_matches_reference(nc, B, H, N, P):
    rng = np.random.default_rng(nc * B + H * N + P)
    states = rng.standard_normal((nc, B, H, N, P)).astype(np.float32)
    decay = rng.uniform(0.3, 1.0, (nc, B, H)).astype(np.float32)
    want = np.asarray(ssm_state_scan_pallas(jnp.asarray(states),
                                            jnp.asarray(decay)))
    library.reset_launches()
    got = T.ssm_state_scan(torch.from_numpy(states), torch.from_numpy(decay))
    assert library.LAUNCHES["ssm_state_scan"] == 0  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == states.shape
    assert not got[0].any()  # exclusive: the state before the first chunk
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, T.ssm_state_scan(torch.from_numpy(states),
                                             torch.from_numpy(decay),
                                             backend="ref"))


def test_ssm_state_scan_checks_its_inputs():
    s = torch.randn(3, 2, 4, 8, 8)
    d = torch.rand(3, 2, 4)
    with pytest.raises(TypeError):
        T.ssm_state_scan(s.numpy(), d)
    with pytest.raises(ValueError, match=r"\(nc, B, H\)"):
        T.ssm_state_scan(s, d[:, :1])
    with pytest.raises(ValueError, match=r"\(nc, B, H\)"):
        T.ssm_state_scan(s[0], d[0])
    with pytest.raises(ValueError, match="float32"):
        T.ssm_state_scan(s.double(), d.double())
    with pytest.raises(ValueError, match="float32"):
        T.ssm_state_scan(s.to(torch.bfloat16), d)
    with pytest.raises(ValueError, match="device"):
        T.ssm_state_scan(s, d.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        T.ssm_state_scan(s.to("meta"), d.to("meta"))
    with pytest.raises(ValueError, match="backend"):
        T.ssm_state_scan(s, d, backend="pallas")
    # one step of h <- d h + s from h = 0
    assert torch.equal(TR.ssm_state_scan_ref(s, d)[1], s[0])


def _mixer(name):
    """(reference config, the port's) of a Zamba2 at the smoke width (chunk
    16) or narrow, with Zamba2-7B's SSM widths (N = P = 64, chunk 128)."""
    if name == "narrow":
        return [dataclasses.replace(c.get_config("zamba2_7b"), d_model=256)
                for c in (RC, TC)]
    return [RC.smoke_config("zamba2_7b"), TC.smoke_config("zamba2_7b")]


def _params(cfg, seed):
    """The reference's mixer parameters (``init_params``) with seeded,
    nonzero per-head scalars and gated-norm weights, drawn as Mamba-2
    initialises them (A in [1, 16], dt in [1e-3, 1e-1] through
    ``dt_bias``), so that the float32 scalars are exercised."""
    p = ref_init_params(RS.mamba2_pdefs(cfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    H = cfg.ssm.n_heads(cfg.d_model)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), H))
    p = dict(p, A_log=np.log(rng.uniform(1.0, 16.0, H)),
             D=rng.uniform(0.5, 1.5, H),
             dt_bias=dt + np.log(-np.expm1(-dt)),
             norm_w=0.1 * rng.standard_normal(cfg.ssm.d_inner(cfg.d_model)))
    return {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}


def _port(tcfg, params):
    m = TS.Mamba2(tcfg, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.copy_(torch.tensor(np.asarray(params[name])))
    return m


@pytest.mark.parametrize("name,S", [
    ("smoke", 32),     # L = 16, nc = 2
    ("smoke", 36),     # ragged: L = 12, nc = 3
    ("smoke", 7),      # S < chunk: one chunk
    ("narrow", 256),   # L = 128, nc = 2, N = P = 64
])
def test_mamba2_prefill_and_decode_match_reference(name, S):
    cfg, tcfg = _mixer(name)
    params = _params(cfg, S)
    m = _port(tcfg, params)
    rng = np.random.default_rng(S)
    B, n = 2, 4
    x = (0.5 * rng.standard_normal((B, S + n, cfg.d_model))).astype(
        np.float32)
    want, rcache = RS.mamba2(params, jnp.asarray(x[:, :S]), cfg,
                             return_state=True)
    library.reset_launches()
    got, tcache = m(torch.from_numpy(x[:, :S]), return_state=True)
    assert sum(library.LAUNCHES.values()) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert tcache["ssm"].dtype == torch.float32
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(rcache[k]),
                                   rtol=TOL, atol=TOL)
    for t in range(S, S + n):
        want, rcache = RS.mamba2_decode(params, jnp.asarray(x[:, t:t + 1]),
                                        rcache, cfg)
        got, tcache = m.decode(torch.from_numpy(x[:, t:t + 1]), tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(rcache[k]), rtol=TOL,
                                       atol=TOL)


def test_mamba2_chunked_matches_stepwise():
    """The chunked prefill (through K10's plain version) equals the
    one-token recurrence from a zero cache, token by token; the
    reference's own test of this holds its pair at rtol 2e-2, atol 2e-3,
    the port's pair holds at 1e-5 in float32."""
    cfg, tcfg = _mixer("smoke")
    m = _port(tcfg, _params(cfg, 1))
    B, S = 1, 32
    x = torch.from_numpy((0.5 * np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32))
    y_chunk, last = m(x, return_state=True)
    cache = TS.init_cache(tcfg, B, dtype=torch.float32, device="cpu")
    ys = []
    for t in range(S):
        y, cache = m.decode(x[:, t:t + 1], cache)
        ys.append(y)
    torch.testing.assert_close(y_chunk, torch.cat(ys, 1), rtol=TOL, atol=TOL)
    torch.testing.assert_close(last["ssm"], cache["ssm"], rtol=TOL, atol=TOL)
    torch.testing.assert_close(last["conv"], cache["conv"], rtol=TOL,
                               atol=TOL)


def test_chunk_len_is_the_largest_divisor():
    assert [TS.chunk_len(S, 16) for S in (32, 36, 7, 17, 128)] == \
        [16, 12, 7, 1, 16]
