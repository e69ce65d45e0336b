"""FV3-lite dynamical core step (paper Fig. 2 structure): sequential,
ensemble and distributed modes.

Sub-stepping hierarchy, exactly the paper's:
  * remapping loop (``k_split``): tracer advection + vertical remap
  * acoustic loop  (``n_split``): c_sw-lite → riem_solver_c → halo exchange
                                  → d_sw-lite (FVT + Smagorinsky) → exchange

The step runs on global ``(6, nk, npx+2h, npx+2h)`` tensors on one device
with the reference halo exchange; the ensemble step on ``(M, 6, nk, ...)``
tensors, the member axis threaded through every program.  Four stencil
programs (c_sw+riem, d_sw, tracer_2d, vertical_remap) compile through
``compile_program`` at the reference's default opt level 3 (pruning,
strength reduction, cost-model-guided fusion and tuned schedules for the
``hardware`` preset); on the ``"cuda"`` backend every stencil runs on the
hand-written Hopper kernels, which take the tile and member axes as
launch-grid dimensions.  The reference's ``lax.scan`` sub-stepping
is a Python loop here: PyTorch runs eagerly and each runner launches its
own kernels.

The distributed step runs the same programs on each rank's subdomain of a
("tile", "y", "x") rank mesh (:mod:`.mesh`); a process holds a block of
ranks on one leading axis, so one launch covers all of them, and the halo
exchanger (:func:`.halo.make_halo_exchanger`) moves strips between ranks
by device copies inside the process and ``torch.distributed``
point-to-point between processes.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np
import torch

from ..core import StencilProgram, compile_program
from ..core.backend import BatchSpec, get_backend, parse_batch, resolve_device
from ..core.backend.batching import scan_chunked
from ..core.backend.compile import register_cache_clear
from ..core.stencil import DomainSpec
from . import stencils as S
from .halo import exchange_reference, make_halo_exchanger
from .overlap import make_overlapped_runner
from .topology import Decomposition

TRACER_NAMES = ("qvapor", "qliquid", "qice", "qrain")


@dataclasses.dataclass(frozen=True)
class FV3Config:
    npx: int = 24            # interior points per tile per dim
    nk: int = 16             # vertical levels (80 in production)
    halo: int = 6
    layout: tuple[int, int] = (1, 1)   # ranks per tile (py, px)
    dt: float = 0.02         # acoustic step (nondimensional units)
    n_split: int = 4         # acoustic substeps per remap step
    k_split: int = 2         # remap steps per physics step
    n_tracers: int = 4
    beta: float = 4.0        # implicit-solver diagonal weight
    smag_coeff: float = 0.02
    ptop: float = 10.0
    dtype: str = "float32"

    @property
    def n_local(self) -> int:
        """Interior points per rank per dim (square subdomains)."""
        if self.layout[0] != self.layout[1] or self.npx % self.layout[1]:
            raise ValueError(f"layout {self.layout} must be square and "
                             f"divide npx={self.npx}")
        return self.npx // self.layout[1]

    @property
    def tracers(self) -> tuple[str, ...]:
        return TRACER_NAMES[: self.n_tracers]

    def decomposition(self) -> Decomposition:
        return Decomposition(self.layout, self.n_local, self.halo)

    def local_dom(self) -> DomainSpec:
        return DomainSpec(ni=self.n_local, nj=self.n_local, nk=self.nk,
                          halo=self.halo)

    def seq_dom(self) -> DomainSpec:
        return DomainSpec(ni=self.npx, nj=self.npx, nk=self.nk, halo=self.halo)


def add_fvtp2d(prog: StencilProgram, q: str, out: str, tag: str) -> None:
    """Lin–Rood 2D transport of field ``q`` → ``out`` (10 stencil nodes —
    the recurring motif transfer tuning exploits)."""
    t = lambda n: f"{tag}_{n}"
    for name in ["alx", "fxi", "qx", "aly2", "fyf",
                 "aly", "fyi", "qy", "alx2", "fxf"]:
        prog.declare(t(name), transient=True)
    prog.add(S.al_x, {"q": q, "al": t("alx")})
    prog.add(S.fx_ppm, {"q": q, "al": t("alx"), "cx": "cx", "fx": t("fxi")})
    prog.add(S.inner_x_update, {"q": q, "fx": t("fxi"), "qx": t("qx")})
    prog.add(S.al_y, {"q": t("qx"), "al": t("aly2")})
    prog.add(S.fy_ppm, {"q": t("qx"), "al": t("aly2"), "cy": "cy", "fy": t("fyf")})
    prog.add(S.al_y, {"q": q, "al": t("aly")})
    prog.add(S.fy_ppm, {"q": q, "al": t("aly"), "cy": "cy", "fy": t("fyi")})
    prog.add(S.inner_y_update, {"q": q, "fy": t("fyi"), "qy": t("qy")})
    prog.add(S.al_x, {"q": t("qy"), "al": t("alx2")})
    prog.add(S.fx_ppm, {"q": t("qy"), "al": t("alx2"), "cx": "cx", "fx": t("fxf")})
    prog.add(S.flux_divergence, {"q": q, "fx": t("fxf"), "fy": t("fyf"),
                                 "qout": out})


def build_csw_program(cfg: FV3Config, dom: DomainSpec) -> StencilProgram:
    """c_sw-lite + riem_solver_c (runs between halo exchanges)."""
    p = StencilProgram("c_sw+riem", dom)
    for f in ["u", "v", "delp", "pt", "w", "cosa", "sina"]:
        p.declare(f)
    # delpc/ptc escape the program (the step exchanges delpc and feeds
    # both into d_sw), so they are not transient
    for f in ["delpc", "ptc"]:
        p.declare(f)
    for f in ["div", "pe", "aa", "bb", "cc", "rhs", "pp", "cflux"]:
        p.declare(f, transient=True)
    p.add(S.divergence, {"u": "u", "v": "v", "div": "div"})
    p.add(S.csw_update, {"delp": "delp", "pt": "pt", "div": "div",
                         "delpc": "delpc", "ptc": "ptc"})
    # the paper's §IV-B region-corrected edge flux (C-grid correction motif)
    p.add(S.edge_flux, {"flux": "cflux", "velocity": "u", "velocity_c": "v",
                        "cosa": "cosa", "sina": "sina"})
    p.add(S.precompute_pe, {"delp": "delpc", "pe": "pe"})
    p.add(S.riem_coeffs, {"delp": "delpc", "ptc": "ptc", "aa": "aa",
                          "bb": "bb", "cc": "cc", "rhs": "rhs", "w": "w"})
    p.add(S.tridiag_solve, {"aa": "aa", "bb": "bb", "cc": "cc", "rhs": "rhs",
                            "pp": "pp"})
    p.add(S.w_update, {"w": "w", "pp": "pp", "delp": "delpc", "dt": "dt2"},
          params={"dt": "dt2"})
    p.propagate_extents()
    return p


def build_dsw_program(cfg: FV3Config, dom: DomainSpec) -> StencilProgram:
    """d_sw-lite: vorticity/KE/Smagorinsky + FVT of delp and pt."""
    p = StencilProgram("d_sw", dom)
    for f in ["u", "v", "delp", "pt", "delpc"]:
        p.declare(f)
    for f in ["vort", "ke", "damp", "pe", "cx", "cy"]:
        p.declare(f, transient=True)
    p.declare("delp_out")
    p.declare("pt_out")
    p.add(S.vorticity, {"u": "u", "v": "v", "vort": "vort"})
    p.add(S.kinetic_energy, {"u": "u", "v": "v", "ke": "ke"})
    p.add(S.smagorinsky_diffusion, {"delpc": "delpc", "vort": "vort",
                                    "damp": "damp", "dt": "smag_dt"},
          params={"dt": "smag_dt"})
    p.add(S.precompute_pe, {"delp": "delp", "pe": "pe"})
    # Courant numbers from the time-centered (pre-update) winds — must
    # precede wind_update, which overwrites u/v in place.
    p.add(S.courant_x, {"u": "u", "cx": "cx"})
    p.add(S.courant_y, {"v": "v", "cy": "cy"})
    p.add(S.wind_update, {"u": "u", "v": "v", "ke": "ke", "vort": "vort",
                          "damp": "damp", "pe": "pe"})
    add_fvtp2d(p, "delp", "delp_out", "dp")
    add_fvtp2d(p, "pt", "pt_out", "pt")
    p.propagate_extents()
    return p


def build_tracer_program(cfg: FV3Config, dom: DomainSpec) -> StencilProgram:
    p = StencilProgram("tracer_2d", dom)
    p.declare("u")
    p.declare("v")
    for f in ["cx", "cy"]:
        p.declare(f, transient=True)
    p.add(S.courant_x, {"u": "u", "cx": "cx"})
    p.add(S.courant_y, {"v": "v", "cy": "cy"})
    for q in cfg.tracers:
        p.declare(q)
        p.declare(f"{q}_out")
        add_fvtp2d(p, q, f"{q}_out", q)
    p.propagate_extents()
    return p


def default_params(cfg: FV3Config) -> dict:
    dtdx = cfg.dt  # unit metric: dx = dy = 1 grid unit
    return {
        "dt": cfg.dt, "dt2": 0.5 * cfg.dt, "smag_dt": cfg.smag_coeff * cfg.dt,
        "dtdx": dtdx, "dtdy": dtdx, "rdx": 1.0, "rdy": 1.0,
        "ptop": cfg.ptop, "beta": cfg.beta, "rk": 1.0 / cfg.nk,
    }


# ---------------------------------------------------------------------------
# Vertical remapping (paper Fig. 2 orange region) — DSL stencil program
# ---------------------------------------------------------------------------


def _interp_rows(x: torch.Tensor, xp: torch.Tensor,
                 fp: torch.Tensor) -> torch.Tensor:
    """Row-wise piecewise-linear interpolation of ``(rows, n)`` tensors,
    ``jnp.interp``'s arithmetic: the right-side search, clamped to
    ``[1, n - 1]``; a bracket no wider than ``spacing(eps)`` takes its left
    value; targets below ``xp[0]`` / above ``xp[-1]`` take ``fp[0]`` /
    ``fp[-1]``."""
    n = xp.shape[-1]
    i = torch.searchsorted(xp.contiguous(), x.contiguous(),
                           right=True).clamp(1, n - 1)
    x0, x1 = xp.gather(-1, i - 1), xp.gather(-1, i)
    f0, f1 = fp.gather(-1, i - 1), fp.gather(-1, i)
    dx, df, delta = x1 - x0, f1 - f0, x - x0
    eps = float(np.spacing(np.finfo(np.float32 if xp.dtype == torch.float32
                                    else np.float64).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, f0, f0 + (delta / torch.where(
        dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def vertical_remap_reference(cfg: FV3Config, delp: torch.Tensor,
                             fields: dict) -> tuple:
    """The pre-DSL hand-written remap, kept as the regression oracle
    (``delp`` and ``fields``: ``(nk, J, I)`` tensors).

    Known flaw (why the DSL path replaced it): the ``maximum(delp_ref,
    1e-10)`` denominator floor violates mass conservation whenever a
    reference layer is thinner than the floor — ``sum(q * delp)`` is no
    longer preserved.  The stencil path divides by the exact interface
    difference instead.  It also bypasses the pass manager, the kernels and
    the tuning cache.
    """
    nk = cfg.nk
    ptop = cfg.ptop
    zero = torch.zeros_like(delp[:1])
    pe = ptop + torch.cat([zero, torch.cumsum(delp, 0)], 0)
    psfc = pe[-1]
    sigma = torch.arange(nk + 1, dtype=delp.dtype, device=delp.device) / nk
    pe_ref = ptop + sigma[:, None, None] * (psfc[None] - ptop)
    delp_ref = pe_ref[1:] - pe_ref[:-1]
    pcols = pe.reshape(nk + 1, -1).T          # (ncol, nk+1)
    prefs = pe_ref.reshape(nk + 1, -1).T

    def remap_one(f):
        # cumulative mass-weighted integral at Lagrangian interfaces
        F = torch.cat([torch.zeros_like(f[:1]), torch.cumsum(f * delp, 0)],
                      0)
        Fi = _interp_rows(prefs, pcols, F.reshape(nk + 1, -1).T)
        Fi = Fi.T.reshape(pe.shape)
        return (Fi[1:] - Fi[:-1]) / torch.clamp(delp_ref, min=1e-10)

    out = {k: remap_one(v) for k, v in fields.items()}
    return delp_ref, out


def build_remap_program(cfg: FV3Config, dom: DomainSpec,
                        fields: tuple[str, ...] | None = None, *,
                        unrolled_interp: bool = False) -> StencilProgram:
    """First-order conservative Lagrangian→reference remap as a stencil
    program on K-interface fields: FORWARD cumulative builds of ``pe`` /
    ``pe_ref`` and the per-field mass integrals, the ``index_search`` level
    search onto the reference interfaces, and exact interface differencing
    for the remapped means.

    ``unrolled_interp=True`` swaps the pre-construct unrolled interpolation
    (:func:`~.stencils.interface_interp_stencil`, O(nk²) IR) back in — the
    A/B baseline of the level search."""
    if fields is None:
        fields = ("pt", "w", "u", "v", *cfg.tracers)
    p = StencilProgram("vertical_remap", dom)
    p.declare("delp")
    p.declare("delp_out")
    for t in ("cum", "total"):
        p.declare(t, transient=True)
    for t in ("pe", "pe_ref"):
        p.declare(t, transient=True, interface=True)
    p.add(S.lagrangian_pe, {"delp": "delp", "pe": "pe"})
    p.add(S.column_total, {"delp": "delp", "cum": "cum", "total": "total"})
    p.add(S.reference_pe, {"total": "total", "pe_ref": "pe_ref"})
    p.add(S.remap_delp, {"pe_ref": "pe_ref", "delp_out": "delp_out"})
    interp = (S.interface_interp_stencil(cfg.nk) if unrolled_interp
              else S.interface_interp)
    for q in fields:
        p.declare(q)
        p.declare(f"{q}_out")
        p.declare(f"{q}_fm", transient=True, interface=True)
        p.declare(f"{q}_fi", transient=True, interface=True)
        p.add(S.cumsum_mass, {"q": q, "delp": "delp", "fm": f"{q}_fm"})
        p.add(interp, {"fm": f"{q}_fm", "pe": "pe", "pe_ref": "pe_ref",
                       "fi": f"{q}_fi"})
        p.add(S.remap_field, {"fi": f"{q}_fi", "pe_ref": "pe_ref",
                              "q_out": f"{q}_out"})
    p.propagate_extents()
    return p


def make_vertical_remap(cfg: FV3Config, dom: DomainSpec,
                        fields: tuple[str, ...], *, backend: str = "cuda",
                        hardware=None, opt_level: int = 0,
                        device: "torch.device | str | None" = None):
    """Compile the remap program; returns ``remap(delp, field_dict, params)
    -> (delp_ref, remapped_dict)`` with the compiled runner as
    ``remap.run`` and the remapped names as ``remap.fields``.  ``device``
    as in :func:`make_step_sequential`."""
    prog = build_remap_program(cfg, dom, fields)
    run = compile_program(prog, backend, hardware=hardware,
                          opt_level=opt_level, device=device)

    def remap(delp, field_dict, params):
        ins = {"delp": delp, **{q: field_dict[q] for q in fields}}
        out = run(ins, params)
        return out["delp_out"], {q: out[f"{q}_out"] for q in fields}

    remap.run = run
    remap.fields = tuple(fields)
    return remap


_REMAP_MEMO: dict[tuple, Callable] = {}
# dropped together with the compile caches, so a clear_compile_cache()
# leaves no stale remap runner behind
register_cache_clear(_REMAP_MEMO.clear)


def vertical_remap(cfg: FV3Config, delp: torch.Tensor, fields: dict
                   ) -> tuple:
    """First-order conservative remap from the deformed Lagrangian levels
    back to reference sigma levels; ``delp``/``fields``: ``(nk, nyp, nxp)``
    tensors, on the device they lie on.

    A thin wrapper over :func:`make_vertical_remap`, memoized per (config,
    field set, shape, device); step factories build their own runner."""
    names = tuple(fields)
    nyp = delp.shape[-2] - 2 * cfg.halo
    nxp = delp.shape[-1] - 2 * cfg.halo
    key = (cfg.nk, cfg.halo, nyp, nxp, names, delp.device)
    fn = _REMAP_MEMO.get(key)
    if fn is None:
        dom = DomainSpec(ni=nxp, nj=nyp, nk=cfg.nk, halo=cfg.halo)
        fn = _REMAP_MEMO[key] = make_vertical_remap(cfg, dom, names,
                                                    device=delp.device)
    return fn(delp, fields, {"ptop": cfg.ptop, "rk": 1.0 / cfg.nk})


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------


STATE_FIELDS = ("delp", "pt", "w", "u", "v")
REMAP_FIELDS = ("pt", "w", "u", "v")


def all_state_fields(cfg: FV3Config) -> list[str]:
    return list(STATE_FIELDS) + list(cfg.tracers)


def _build_programs(cfg: FV3Config, dom: DomainSpec):
    return (build_csw_program(cfg, dom), build_dsw_program(cfg, dom),
            build_tracer_program(cfg, dom),
            build_remap_program(cfg, dom))


def _make_programs(cfg: FV3Config, dom: DomainSpec, backend: str,
                   opt_level: int, device: torch.device, hardware=None,
                   n_members: int | None = None,
                   batch: "str | BatchSpec" = "vmap"):
    """Build the four stencil programs (acoustic c_sw / d_sw, tracer
    transport, vertical remap) and compile each through the automatic
    optimization ladder (the paper's opt pipeline applies to the whole
    dycore — remap included — with no per-program hand-tuning)."""
    progs = _build_programs(cfg, dom)
    runners = tuple(
        compile_program(p, backend, hardware=hardware, opt_level=opt_level,
                        device=device, n_members=n_members, batch=batch)
        for p in progs)
    return progs, runners


def _metric_terms(cfg: FV3Config, shape, device: torch.device,
                  dtype=torch.float32) -> dict:
    """cosa/sina: fixed synthetic grid metric terms, built once per step
    closure."""
    return {"cosa": torch.full(shape, 0.2, dtype=dtype, device=device),
            "sina": torch.full(shape, 0.8, dtype=dtype, device=device)}


def _csw_inputs(src, metrics):
    """c_sw input dict from a state dict + hoisted metric constants."""
    return {"u": src["u"], "v": src["v"], "delp": src["delp"],
            "pt": src["pt"], "w": src["w"],
            "cosa": metrics["cosa"], "sina": metrics["sina"]}


def _reference_halo_fn(cfg: FV3Config):
    """Sequential-mode halo update over global tile tensors."""
    def halo_fn(st, names):
        vec = [("u", "v")] if ("u" in names and "v" in names) else []
        ex = {k: st[k] for k in names}
        return {**st, **exchange_reference(ex, cfg.halo, vector_pairs=vec)}

    return halo_fn


def _acoustic_iteration(cfg, runners, params, halo_fn, state, metrics,
                        overlap=None, skip_delpc_exchange=False):
    """One acoustic substep (paper Fig. 2, blue region): c_sw-lite +
    riem_solver_c, halo update of the C-grid mass, then d_sw-lite with
    FVT.

    With ``overlap`` (the distributed step's split runners) each exchanged
    program computes its full domain from the *pre-exchange* state while
    the exchange runs, and recomputes only its edge strips from the
    exchanged fields (:mod:`.overlap`).  ``skip_delpc_exchange``: c_sw
    already computed ``delpc`` on the one-cell rim d_sw reads (the
    recompute-vs-exchange rewrite), so its exchange is dropped."""
    if overlap is not None:
        ov_csw, ov_dsw, _ = overlap
        st = dict(state)
        ex: dict = {}

        def exchange_state():
            ex.update(halo_fn(st, list(STATE_FIELDS)))
            return _csw_inputs(ex, metrics)

        out = ov_csw(_csw_inputs(st, metrics), exchange_state, params)
        st = ex
        st["w"] = out["w"]
        dsw_stale = {"u": st["u"], "v": st["v"], "delp": st["delp"],
                     "pt": st["pt"], "delpc": out["delpc"]}

        def exchange_delpc():
            delpc = halo_fn({**st, "delpc": out["delpc"]}, ["delpc"])
            return {**dsw_stale, "delpc": delpc["delpc"]}

        out2 = ov_dsw(dsw_stale, exchange_delpc, params)
        st["u"], st["v"] = out2["u"], out2["v"]
        st["delp"], st["pt"] = out2["delp_out"], out2["pt_out"]
        return st

    run_csw, run_dsw = runners[0], runners[1]
    st = halo_fn(dict(state), list(STATE_FIELDS))
    out = run_csw(_csw_inputs(st, metrics), params)
    st["w"] = out["w"]
    if skip_delpc_exchange:
        delpc = out["delpc"]
    else:
        # d_sw's Smagorinsky reads delpc at extent (1,1) — one scalar
        # exchange
        delpc = halo_fn({**st, "delpc": out["delpc"]}, ["delpc"])["delpc"]
    dsw_in = {"u": st["u"], "v": st["v"], "delp": st["delp"],
              "pt": st["pt"], "delpc": delpc}
    out2 = run_dsw(dsw_in, params)
    st["u"], st["v"] = out2["u"], out2["v"]
    st["delp"], st["pt"] = out2["delp_out"], out2["pt_out"]
    return st


def _remap_iteration(cfg, runners, params, halo_fn, state, metrics,
                     counters, overlap=None, skip_delpc_exchange=False):
    run_trc, run_remap = runners[2], runners[3]
    st = dict(state)
    for _ in range(cfg.n_split):
        counters["acoustic_iterations"] += 1
        st = _acoustic_iteration(cfg, runners, params, halo_fn, st, metrics,
                                 overlap=overlap,
                                 skip_delpc_exchange=skip_delpc_exchange)
    names = ["u", "v", *cfg.tracers]
    if overlap is not None:
        ex: dict = {}

        def exchange_tracers():
            ex.update(halo_fn(st, names))
            return {q: ex[q] for q in names}

        out = overlap[2]({q: st[q] for q in names}, exchange_tracers, params)
        st = ex
    else:
        st = halo_fn(st, names)
        out = run_trc({q: st[q] for q in names}, params)
    for q in cfg.tracers:
        st[q] = out[f"{q}_out"]
    # vertical remap back to reference levels — a compiled stencil program
    # like every other motif
    names = (*REMAP_FIELDS, *cfg.tracers)
    rout = run_remap({"delp": st["delp"], **{q: st[q] for q in names}},
                     params)
    st["delp"] = rout["delp_out"]
    for q in names:
        st[q] = rout[f"{q}_out"]
    return st


def _counting_runner(run, counters):
    """Count runner dispatches for the instrumentation."""
    def counting(*args):
        counters["runner_dispatches"] += 1
        return run(*args)

    return counting


def _assemble_step(cfg: FV3Config, progs, runners, metrics, dev,
                   backend: str, member_chunks: tuple[int, int] | None = None
                   ) -> Callable:
    """The step shared by the sequential and ensemble factories: the remap
    loop over the compiled runners, with counters and the introspection
    attributes.  Keeping it in one place keeps the ensemble step
    bit-identical to the sequential one by construction.

    ``member_chunks=(M, C)`` wraps the WHOLE step in a member chunk loop:
    the runners (compiled C-wide) run every substep for one C-member chunk
    before the next chunk starts, so only one chunk's transients and halo
    working set are live at a time."""
    params = default_params(cfg)
    counters = {"acoustic_iterations": 0, "runner_dispatches": 0,
                "step_calls": 0}
    runners_c = tuple(_counting_runner(r, counters) for r in runners)
    halo_fn = _reference_halo_fn(cfg)

    def inner(state: dict, _params=None) -> dict:
        st = dict(state)
        for _ in range(cfg.k_split):
            st = _remap_iteration(cfg, runners_c, params, halo_fn, st,
                                  metrics, counters)
        return st

    run = scan_chunked(inner, *member_chunks) if member_chunks else inner

    def step(state: dict) -> dict:
        counters["step_calls"] += 1
        return run(state)

    step.counters = counters
    step.opt_report = {p.name: r.opt_report for p, r in zip(progs, runners)}
    step.n_kernels = sum(r.n_kernels for r in runners)
    step.programs = progs
    step.device = dev
    step.backend = backend
    return step


def make_step_sequential(cfg: FV3Config, *, backend: str = "cuda",
                         hardware=None, opt_level: int = 3,
                         device: "torch.device | str | None" = None
                         ) -> Callable:
    """Physics step on global (6, nk, npx+2h, npx+2h) tensors, one device.

    ``device=None`` runs on the CUDA card and raises ``RuntimeError`` when
    there is none; ``device="cpu"`` runs the plain versions on the CPU.
    ``backend`` is ``"cuda"`` (the hand-written kernels; the plain versions
    for CPU tensors) or ``"torch"`` (the plain lowering on any device).
    ``opt_level`` (default 3, the reference's default) and ``hardware``
    (a preset name or descriptor; ``"h100"`` when None)
    select the optimization pipeline every program compiles through.

    The returned ``step(state) -> state`` exposes ``n_kernels`` (compiled
    stencil runners over the four programs), ``opt_report`` (per-program
    pipeline reports, ``None`` at opt level 0), ``programs`` and
    ``counters`` (acoustic iterations, runner dispatches and step calls).
    """
    if cfg.dtype != "float32":
        raise NotImplementedError("the port steps float32 states only")
    dev = resolve_device(device)
    dom = cfg.seq_dom()
    progs, runners = _make_programs(cfg, dom, backend, opt_level, dev,
                                    hardware=hardware)
    # cosa/sina hoisted out of the loops: built once per step closure
    metrics = _metric_terms(cfg, (6,) + dom.padded_shape(), dev)
    return _assemble_step(cfg, progs, runners, metrics, dev, backend)


def make_step_ensemble(cfg: FV3Config, n_members: int, *,
                       backend: str = "cuda", hardware=None,
                       opt_level: int = 3,
                       batch: "str | BatchSpec | None" = None,
                       device: "torch.device | str | None" = None
                       ) -> Callable:
    """Ensemble physics step: M perturbed members on one device, state laid
    out ``(M, 6, nk, npx+2h, npx+2h)`` (member outermost).

    :func:`make_step_sequential`'s step with the member axis threaded
    through every program (``compile_program(..., n_members=M,
    batch=...)``) instead of a loop over members; the halo exchange runs
    batched.  The result is bit-identical to M independent sequential
    steps at every opt level.  On the ``"cuda"`` backend the members go on
    the kernels' launch grid, so a step makes the same launches as at
    M = 1.  ``opt_level`` and ``hardware`` as in
    :func:`make_step_sequential`.

    ``batch`` defaults to ``"grid"`` on ``"cuda"`` and ``"vmap"`` on
    ``"torch"``, and takes the chunk grammar of ``compile_program``.  A
    chunked loop spec (``"vmap:C"``, ``"grid:C"``) lifts the chunk loop to
    the *step*: the runners compile C-wide and the whole step — halo
    exchanges, acoustic loop, remap — runs one chunk after another, so only
    one C-member working set is live at a time.  ``"vmap:C,grid"`` keeps
    the step M-wide and runs C-member chunks inside each launch;
    ``"vmap:auto"`` picks C per program through the cost model.  The
    metric terms are broadcast across members (member stride 0).

    ``device`` as in :func:`make_step_sequential`.  The returned step
    exposes ``n_members``, ``batch``, ``member_chunk``, ``n_chunks``,
    ``n_kernels`` (the same for every M), ``opt_report`` and ``counters``.
    """
    if cfg.dtype != "float32":
        raise NotImplementedError("the port steps float32 states only")
    if batch is None:
        batch = "grid" if backend == "cuda" else "vmap"
    spec = parse_batch(batch)
    member_chunks = None
    prog_members, prog_batch = n_members, spec
    if spec.chunk > 0:  # an explicit chunk width (AUTO resolves per program)
        C = spec.chunk_for(n_members)
        grid_loop = spec.loop == "grid" and get_backend(backend).member_grid
        if C < n_members and not grid_loop:
            # step-level chunk loop: compile everything C-wide
            member_chunks = (n_members, C)
            prog_members, prog_batch = C, BatchSpec(mode=spec.mode)
    dev = resolve_device(device)
    dom = cfg.seq_dom()
    progs, runners = _make_programs(cfg, dom, backend, opt_level, dev,
                                    hardware=hardware,
                                    n_members=prog_members, batch=prog_batch)
    base = _metric_terms(cfg, (6,) + dom.padded_shape(), dev)
    metrics = {k: v.expand((prog_members,) + tuple(v.shape))
               for k, v in base.items()}
    step = _assemble_step(cfg, progs, runners, metrics, dev, backend,
                          member_chunks=member_chunks)
    step.n_members = n_members
    step.batch = spec.token
    step.member_chunk = (member_chunks[1] if member_chunks
                         else runners[0].member_chunk)
    step.n_chunks = (-(-n_members // member_chunks[1]) if member_chunks
                     else runners[0].n_chunks)
    return step


def _rank_stack(v: torch.Tensor, lead: int, ml: int) -> torch.Tensor:
    """Block layout ``([M,] 6, py, px, nk, J, I)`` → the rank stack
    ``([ml,] ranks, nk, J, I)``: ranks numbered over the mesh (member group
    outermost), each group's ``ml`` members on a leading member axis."""
    if lead == 3:
        return v.reshape((-1,) + tuple(v.shape[-3:]))
    groups = v.reshape((-1, ml) + tuple(v.shape[1:]))  # (D, ml, 6, py, ...)
    stack = groups.transpose(0, 1).reshape((ml, -1) + tuple(v.shape[-3:]))
    return stack[0] if ml == 1 else stack


def _block_layout(x: torch.Tensor, lead: int, ml: int, layout) -> torch.Tensor:
    """Inverse of :func:`_rank_stack`."""
    tail = (6,) + tuple(layout) + tuple(x.shape[-3:])
    if lead == 3:
        return x.reshape(tail)
    x = x.reshape((ml, -1) + tail)                        # (ml, D, 6, ...)
    return x.transpose(0, 1).reshape((-1,) + tail)


def make_step_distributed(cfg: FV3Config, mesh, *, backend: str = "cuda",
                          hardware=None, opt_level: int = 3,
                          ensemble: bool = False,
                          member_axis: str | None = None,
                          n_members: int | None = None,
                          batch: "str | BatchSpec | None" = None,
                          overlap: bool = True,
                          device: "torch.device | str | None" = None
                          ) -> Callable:
    """Physics step over the rank mesh ``("tile", "y", "x")`` of
    :func:`~.mesh.make_mesh` — or ``(member, "tile", "y", "x")`` with
    independent ensemble members.

    Each rank steps its ``cfg.local_dom()`` subdomain; the ranks this
    process holds (``mesh.local_ranks``) are stacked on one leading axis,
    so each program compiles once and one launch covers all of them, and
    the halo exchanger (:func:`~.halo.make_halo_exchanger`) fills their
    ghosts: device copies between ranks of the process, ``torch.distributed``
    point-to-point to the others.

    ``member_axis`` names an extra *leading* mesh axis members shard over,
    orthogonally to the tile/y/x decomposition; no exchange crosses it.
    The deprecated ``ensemble=True`` is shorthand for ``member_axis="ens"``
    and warns.  Without ``n_members`` the member extent D is the ensemble
    size; ``n_members=M`` (a multiple of D) gives each group ``M // D``
    members, batched per ``batch`` (default ``"grid"`` on ``"cuda"``,
    ``"vmap"`` on ``"torch"``; the chunk grammar of ``compile_program``).

    At ``opt_level >= 4`` without overlap the recompute-vs-exchange rewrite
    (:class:`~repro_torch.core.rewrite.RecomputeVsExchange`) widens c_sw so
    ``delpc`` is valid on the one-cell rim d_sw reads, when the cost model
    prefers it, and the per-substep ``delpc`` exchange is dropped
    (``step.delpc_exchange_skipped``): the same result bit for bit wherever
    a neighbour's interior lies under the rim.  At a tile's corner, where
    three tiles meet, the exchange fills the diagonal ghost from the tile's
    ghost rows as they were, so cells a step reaches from there may differ
    in their last bits.

    ``overlap=True`` splits each exchanged program's domain
    (:mod:`.overlap`): the interior runs from the pre-exchange state while
    the exchange runs (on a second stream on the card), the edge strips
    after it.  It does not apply when the local interior holds no strip-free
    core (``n_local <= 2*halo``) or a group holds more than one member.

    State: the reference's block layout, ``([M,] 6, py, px, nk, nl+2h,
    nl+2h)``; ``blocks_from_global`` makes it.  A process steps the ranks
    it holds and returns the others' blocks as it was given them.
    ``device`` and ``opt_level``/``hardware`` as in
    :func:`make_step_sequential`.  The step exposes ``n_members``,
    ``members_per_group``, ``batch``, ``member_chunk``, ``overlapped``,
    ``delpc_exchange_skipped``, ``local_ranks`` and ``counters`` (those of
    the sequential step, plus ``exchanges``: exchanger calls).
    """
    if ensemble:
        warnings.warn(
            "make_step_distributed(ensemble=True) is deprecated; pass "
            "member_axis='ens' (or your mesh's member axis name) instead",
            DeprecationWarning, stacklevel=2)
        if member_axis is None:
            member_axis = "ens"
    ml = 1
    if n_members is not None:
        if member_axis is None:
            raise ValueError("n_members requires member_axis (an ensemble "
                             "mesh axis to shard members over)")
        d = mesh.shape[member_axis]
        if n_members % d:
            raise ValueError(
                f"n_members={n_members} must be a multiple of the "
                f"member-axis extent {d}")
        ml = n_members // d
    if cfg.dtype != "float32":
        raise NotImplementedError("the port steps float32 states only")
    py, px = cfg.layout
    want = ((member_axis,) if member_axis else ()) + ("tile", "y", "x")
    if tuple(mesh.axis_names) != want or \
            tuple(mesh.axis_sizes[-3:]) != (6, py, px):
        raise ValueError(f"mesh {mesh.shape} does not match axes {want} "
                         f"over (6, {py}, {px}) ranks")
    if batch is None:
        batch = "grid" if backend == "cuda" else "vmap"
    dev = resolve_device(device)
    dom = cfg.local_dom()
    dec = cfg.decomposition()
    progs = _build_programs(cfg, dom)
    exchanger = make_halo_exchanger(dec, mesh)
    nl, h, nk = cfg.n_local, cfg.halo, cfg.nk

    memb = {"n_members": ml, "batch": batch} if ml > 1 else {}
    # the remap program is purely vertical (no horizontal reads), so it
    # never takes part in the overlap — compiled plain
    run_remap = compile_program(progs[3], backend, hardware=hardware,
                                opt_level=opt_level, device=dev, **memb)
    ov = None
    if overlap and ml == 1:
        cands = tuple(make_overlapped_runner(
            p, backend=backend, hardware=hardware, opt_level=opt_level,
            device=dev) for p in progs[:3])
        if all(c is not None for c in cands):
            ov = cands
    skip_delpc = False
    if ov is None and opt_level >= 4:
        # recompute-vs-exchange: widen c_sw so delpc is valid on a one-cell
        # rim (d_sw's widest read) when the cost model prefers redundant rim
        # compute to the exchange rounds.  The rim equals the neighbour's
        # interior bit for bit (c_sw runs on the exchanged inputs and its
        # reads from the widened window stay within the halo), except at a
        # cube corner's diagonal ghost cell, which has no neighbour interior.
        from ..core.rewrite import (ExchangeModel, PassContext,
                                    widen_for_exchange)

        itemsize = np.dtype(cfg.dtype).itemsize
        model = ExchangeModel(n_rounds=len(exchanger.rounds),
                              ring_bytes=4 * nl * h * nk * itemsize)
        ctx = PassContext(backend=get_backend(backend).name,
                          hardware=hardware)
        skip_delpc = widen_for_exchange(progs[0], {"delpc": (1, 1)}, model,
                                        ctx) > 0
    if ov is not None:
        # the split runners hold the full-domain runners: reuse them
        runners = tuple(c.full_run for c in ov) + (run_remap,)
    else:
        runners = tuple(
            compile_program(p, backend, hardware=hardware,
                            opt_level=opt_level, device=dev, **memb)
            for p in progs[:3]) + (run_remap,)

    params = default_params(cfg)
    counters = {"acoustic_iterations": 0, "runner_dispatches": 0,
                "step_calls": 0, "exchanges": 0}
    runners_c = tuple(_counting_runner(r, counters) for r in runners)
    ov_c = (tuple(_counting_runner(r, counters) for r in ov)
            if ov is not None else None)

    def halo_fn(st, names):
        counters["exchanges"] += 1
        vec = [("u", "v")] if ("u" in names and "v" in names) else []
        # a named range: a profiler trace reads the exchange's device time
        with torch.profiler.record_function("halo_exchange"):
            out = exchanger({k: st[k] for k in names}, vector_pairs=vec)
        return {**st, **out}

    ranks = mesh.local_ranks
    every = len(ranks) == mesh.size
    lead = 4 if member_axis else 3
    base = _metric_terms(cfg, (len(ranks),) + dom.padded_shape(), dev)
    metrics = ({k: v.expand((ml,) + tuple(v.shape)) for k, v in base.items()}
               if ml > 1 else base)

    def step(state: dict) -> dict:
        counters["step_calls"] += 1
        stacks = {k: _rank_stack(v, lead, ml) for k, v in state.items()}
        st = {k: v[..., ranks.start:ranks.stop, :, :, :]
              for k, v in stacks.items()}
        for _ in range(cfg.k_split):
            st = _remap_iteration(cfg, runners_c, params, halo_fn, st,
                                  metrics, counters, overlap=ov_c,
                                  skip_delpc_exchange=skip_delpc)
        out = {}
        for k, v in st.items():
            if not every:
                full = stacks[k].clone()
                full[..., ranks.start:ranks.stop, :, :, :] = v
                v = full
            out[k] = _block_layout(v, lead, ml, cfg.layout)
        return out

    step.counters = counters
    step.opt_report = {p.name: r.opt_report for p, r in zip(progs, runners)}
    step.n_kernels = sum(r.n_kernels for r in runners)
    step.programs = progs
    step.device = dev
    step.backend = backend
    step.local_ranks = ranks
    step.n_members = n_members
    step.members_per_group = ml
    step.batch = (parse_batch(batch).token if ml > 1 else None)
    step.member_chunk = runners[0].member_chunk if ml > 1 else None
    step.overlapped = ov is not None
    step.delpc_exchange_skipped = skip_delpc
    return step
