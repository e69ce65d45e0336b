"""Model state initialization — zonal flow + baroclinic-style perturbation
(paper §IX: Ullrich et al. analytical test case, nondimensionalized on the
simplified metric).

The state is this system's "weights": :func:`init_state` builds it with
numpy exactly as the reference does, and :func:`state_from_reference`
carries a state built by either package onto a device, so both packages can
step the same numbers.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..core.backend import resolve_device
from .dyncore import FV3Config
from .topology import face_frame, sphere_center


def init_state_numpy(cfg: FV3Config, seed: int = 0) -> dict:
    """Global state dict of (6, nk, npx+2h, npx+2h) numpy arrays
    (sequential layout); halos unfilled (zeros) — the first step's exchange
    fills them."""
    N, h, nk = cfg.npx, cfg.halo, cfg.nk
    npad = N + 2 * h
    dtype = np.float32 if cfg.dtype == "float32" else np.float64
    omega = np.array([0.0, 0.3, 1.0])
    omega = 0.15 * omega / np.linalg.norm(omega)

    state = {k: np.zeros((6, nk, npad, npad), dtype)
             for k in ("delp", "pt", "w", "u", "v", *cfg.tracers)}

    for f in range(6):
        n, ex, ey = face_frame(f)
        ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
        p = sphere_center(f, ii.ravel(), jj.ravel(), N).reshape(N, N, 3)
        p = np.swapaxes(p, 0, 1)  # (j, i, 3) layout
        vel = np.cross(np.broadcast_to(omega, p.shape), p)
        u2 = vel @ ex
        v2 = vel @ ey
        z = p[..., 2]
        # stratified temperature + thickness with a smooth pole-to-equator
        # gradient; Gaussian bump on tile 0
        pt0 = 1.0 + 0.05 * z ** 2
        delp0 = 1.0 + 0.02 * (1.0 - z ** 2)
        bump_c = sphere_center(0, N // 2, N // 2, N)
        d2 = ((p - bump_c) ** 2).sum(-1)
        bump = 0.05 * np.exp(-d2 / 0.05)
        kprof = (np.arange(nk, dtype=dtype) + 0.5) / nk

        sl = np.s_[f, :, h:h + N, h:h + N]
        state["u"][sl] = u2[None]
        state["v"][sl] = v2[None]
        state["pt"][sl] = pt0[None] * (1.0 + 0.3 * kprof[:, None, None]) \
            + bump[None]
        state["delp"][sl] = delp0[None] * (0.8 + 0.4 * kprof[:, None, None])
        for t_i, q in enumerate(cfg.tracers):
            c = sphere_center(t_i % 6, N // 3, N // 3, N)
            d2q = ((p - c) ** 2).sum(-1)
            state[q][sl] = np.exp(-d2q / 0.1)[None] * np.ones((nk, 1, 1), dtype)
    return state


def state_from_reference(np_state: Mapping[str, np.ndarray],
                         device: "torch.device | str") -> dict:
    """A state dict of arrays (numpy, or anything ``np.asarray`` takes) as
    contiguous tensors on ``device`` — the carry-over from the reference
    package, or from :func:`init_state_numpy`."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, order="C")).to(dev)
            for k, v in np_state.items()}


def init_state(cfg: FV3Config, seed: int = 0,
               device: "torch.device | str | None" = None) -> dict:
    """:func:`init_state_numpy` on ``device`` (``None`` → the CUDA card)."""
    return state_from_reference(init_state_numpy(cfg, seed), device)


def ensemble_state_numpy(cfg: FV3Config, n_members: int, *,
                         amplitude: float = 1e-3, seed: int = 0) -> dict:
    """M perturbed ensemble members stacked on a leading axis, as numpy
    arrays ``(M, 6, nk, npx+2h, npx+2h)`` per field — the reference's
    ``ensemble_state``, draw for draw.

    Member 0 is the unperturbed :func:`init_state_numpy`; members 1.. add
    small random interior perturbations to ``pt`` and ``delp``
    (``np.random.default_rng(seed + 1)``).  Halos stay zero — the first
    step's exchange fills them, as in the single-member path."""
    base = init_state_numpy(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    N, h = cfg.npx, cfg.halo
    out = {}
    for k, v in base.items():
        arr = np.repeat(v[None], n_members, axis=0)
        if k in ("pt", "delp") and n_members > 1:
            noise = rng.standard_normal(
                (n_members - 1,) + arr.shape[1:]).astype(arr.dtype)
            mask = np.zeros(arr.shape[1:], arr.dtype)
            mask[:, :, h:h + N, h:h + N] = 1.0
            arr[1:] += amplitude * noise * mask
        out[k] = arr
    return out


def ensemble_state(cfg: FV3Config, n_members: int, *,
                   amplitude: float = 1e-3, seed: int = 0,
                   device: "torch.device | str | None" = None) -> dict:
    """:func:`ensemble_state_numpy` on ``device`` (``None`` → the CUDA
    card): the layout :func:`~repro_torch.fv3.dyncore.make_step_ensemble`
    steps."""
    dev = resolve_device(device)
    return state_from_reference(
        ensemble_state_numpy(cfg, n_members, amplitude=amplitude, seed=seed),
        dev)


def blocks_from_global(state: Mapping[str, torch.Tensor],
                       cfg: FV3Config) -> dict:
    """Sequential ``([lead...,] 6, nk, N+2h, N+2h)`` state as distributed
    rank blocks ``([lead...,] 6, py, px, nk, nl+2h, nl+2h)`` — each rank's
    padded window, halos overlapping the neighbours' interiors — as new
    contiguous tensors on the input's device."""
    nl, h = cfg.n_local, cfg.halo
    cfg.decomposition()  # validates the layout
    w = nl + 2 * h
    # (..., 6, nk, py, px, w, w) windows of stride nl along J, then I
    return {k: v.unfold(-2, w, nl).unfold(-2, w, nl).movedim(-5, -3)
            .contiguous() for k, v in state.items()}


def global_from_blocks(blocks: Mapping[str, torch.Tensor],
                       cfg: FV3Config) -> dict:
    """Inverse of :func:`blocks_from_global` on the interiors: sequential
    ``([lead...,] 6, nk, N+2h, N+2h)`` tensors whose halos are zero."""
    py, px = cfg.layout
    nl, h, N = cfg.n_local, cfg.halo, cfg.npx
    out = {}
    for k, v in blocks.items():
        lead = tuple(v.shape[:-6])
        n = len(lead)
        # (..., 6, py, px, nk, nl, nl) -> (..., 6, nk, py, nl, px, nl)
        inner = v[..., h:h + nl, h:h + nl].permute(
            *range(n), *(n + d for d in (0, 3, 1, 4, 2, 5)))
        glob = v.new_zeros(lead + (6, cfg.nk, N + 2 * h, N + 2 * h))
        glob[..., h:h + N, h:h + N] = inner.reshape(lead + (6, cfg.nk, N, N))
        out[k] = glob
    return out


def total_mass(state: Mapping[str, torch.Tensor], cfg: FV3Config) -> float:
    """Global integral of delp (unit cell area) — conserved by the FVT;
    summed in float64."""
    h, N = cfg.halo, cfg.npx
    interior = state["delp"][:, :, h:h + N, h:h + N]
    return float(interior.double().sum())
