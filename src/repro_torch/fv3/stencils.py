"""FV3 stencil definitions in the DSL (paper §II, §IV).

This is the "user code": declarative, schedule-free, close to the discretized
math.  All performance engineering happens in the toolchain (graph
transformations + schedules), never here — the paper's headline discipline.

Modules mirror the FORTRAN subroutine structure (paper §IV-A):
  * fv_tp_2d  — finite-volume transport (PPM, Lin–Rood 2D) — paper §VIII-C
  * riem_solver_c — vertical semi-implicit Riemann solver — paper §VIII-B
  * c_sw / d_sw  — acoustic-step wind/mass updates incl. the paper's
    edge-region example (§IV-B) and Smagorinsky diffusion (§VI-C.1)
"""

from __future__ import annotations

from repro_torch.core.stencil import (Assign, Computation, Field, FieldAccess,
                                Interval, Param, Stencil, gtstencil, interface)
from repro_torch.core.stencil import ir as _ir

# ---------------------------------------------------------------------------
# fv_tp_2d: PPM finite-volume transport
# ---------------------------------------------------------------------------


@gtstencil
def al_x(q: Field, al: Field):
    """4th-order interface value in x (PPM reconstruction)."""
    with computation(PARALLEL), interval(...):
        al = (7.0 / 12.0) * (q[-1, 0, 0] + q[0, 0, 0]) \
            - (1.0 / 12.0) * (q[-2, 0, 0] + q[1, 0, 0])


@gtstencil
def al_y(q: Field, al: Field):
    with computation(PARALLEL), interval(...):
        al = (7.0 / 12.0) * (q[0, -1, 0] + q[0, 0, 0]) \
            - (1.0 / 12.0) * (q[0, -2, 0] + q[0, 1, 0])


@gtstencil
def fx_ppm(q: Field, al: Field, cx: Field, fx: Field):
    """Monotone-clamped PPM flux in x; ``cx`` is the interface Courant
    number (positive = flow from the left cell)."""
    with computation(PARALLEL), interval(...):
        bl = al[0, 0, 0] - q[0, 0, 0]
        br = al[1, 0, 0] - q[0, 0, 0]
        b0 = bl + br
        fcand = where(
            cx > 0.0,
            q[-1, 0, 0] + (1.0 - cx) * (br[-1, 0, 0] - cx * b0[-1, 0, 0]),
            q[0, 0, 0] - (1.0 + cx) * (bl[0, 0, 0] + cx * b0[0, 0, 0]))
        lo = min(q[-1, 0, 0], q[0, 0, 0])
        hi = max(q[-1, 0, 0], q[0, 0, 0])
        fx = cx * min(max(fcand, lo), hi)


@gtstencil
def fy_ppm(q: Field, al: Field, cy: Field, fy: Field):
    with computation(PARALLEL), interval(...):
        bl = al[0, 0, 0] - q[0, 0, 0]
        br = al[0, 1, 0] - q[0, 0, 0]
        b0 = bl + br
        fcand = where(
            cy > 0.0,
            q[0, -1, 0] + (1.0 - cy) * (br[0, -1, 0] - cy * b0[0, -1, 0]),
            q[0, 0, 0] - (1.0 + cy) * (bl[0, 0, 0] + cy * b0[0, 0, 0]))
        lo = min(q[0, -1, 0], q[0, 0, 0])
        hi = max(q[0, -1, 0], q[0, 0, 0])
        fy = cy * min(max(fcand, lo), hi)


@gtstencil
def inner_x_update(q: Field, fx: Field, qx: Field):
    """Advective inner update (Lin–Rood operator splitting, x first)."""
    with computation(PARALLEL), interval(...):
        qx = q[0, 0, 0] + 0.5 * (fx[0, 0, 0] - fx[1, 0, 0])


@gtstencil
def inner_y_update(q: Field, fy: Field, qy: Field):
    with computation(PARALLEL), interval(...):
        qy = q[0, 0, 0] + 0.5 * (fy[0, 0, 0] - fy[0, 1, 0])


@gtstencil
def flux_divergence(q: Field, fx: Field, fy: Field, qout: Field):
    """Conservative update from interface fluxes (unit cell metric)."""
    with computation(PARALLEL), interval(...):
        qout = q[0, 0, 0] + (fx[0, 0, 0] - fx[1, 0, 0]) \
            + (fy[0, 0, 0] - fy[0, 1, 0])


@gtstencil
def courant_x(u: Field, cx: Field, dtdx: Param):
    """Interface Courant numbers from cell-centered winds."""
    with computation(PARALLEL), interval(...):
        cx = 0.5 * (u[-1, 0, 0] + u[0, 0, 0]) * dtdx


@gtstencil
def courant_y(v: Field, cy: Field, dtdy: Param):
    with computation(PARALLEL), interval(...):
        cy = 0.5 * (v[0, -1, 0] + v[0, 0, 0]) * dtdy


# ---------------------------------------------------------------------------
# c_sw-lite: C-grid winds, divergence, and the paper's edge-region stencil
# ---------------------------------------------------------------------------


@gtstencil
def edge_flux(flux: Field, velocity: Field, velocity_c: Field, cosa: Field,
              sina: Field, dt2: Param):
    """Verbatim structure of the paper's horizontal-region example (§IV-B)."""
    with computation(PARALLEL), interval(...):
        flux = dt2 * (velocity - velocity_c * cosa) / sina
        with horizontal(region[:, 0]):
            flux = dt2 * velocity
        with horizontal(region[:, -1]):
            flux = dt2 * velocity


@gtstencil
def divergence(u: Field, v: Field, div: Field, rdx: Param, rdy: Param):
    with computation(PARALLEL), interval(...):
        div = (0.5 * (u[1, 0, 0] - u[-1, 0, 0])) * rdx \
            + (0.5 * (v[0, 1, 0] - v[0, -1, 0])) * rdy


@gtstencil
def csw_update(delp: Field, pt: Field, div: Field, delpc: Field, ptc: Field,
               dt2: Param):
    """Half-step C-grid mass/temperature update."""
    with computation(PARALLEL), interval(...):
        delpc = delp[0, 0, 0] * (1.0 - dt2 * div[0, 0, 0])
        ptc = pt[0, 0, 0] * (1.0 - dt2 * div[0, 0, 0])


# ---------------------------------------------------------------------------
# d_sw-lite: vorticity, kinetic energy, Smagorinsky, wind update
# ---------------------------------------------------------------------------


@gtstencil
def vorticity(u: Field, v: Field, vort: Field, rdx: Param, rdy: Param):
    with computation(PARALLEL), interval(...):
        vort = (0.5 * (v[1, 0, 0] - v[-1, 0, 0])) * rdx \
            - (0.5 * (u[0, 1, 0] - u[0, -1, 0])) * rdy


@gtstencil
def kinetic_energy(u: Field, v: Field, ke: Field):
    with computation(PARALLEL), interval(...):
        ke = 0.5 * (u[0, 0, 0] * u[0, 0, 0] + v[0, 0, 0] * v[0, 0, 0])


@gtstencil
def smagorinsky_diffusion(delpc: Field, vort: Field, damp: Field, dt: Param):
    """The paper's §VI-C.1 case-study kernel — written with ``**`` exactly as
    in the paper; the toolchain's strength-reduction pass optimizes it."""
    with computation(PARALLEL), interval(...):
        damp = dt * (delpc[0, 0, 0] ** 2.0 + vort[0, 0, 0] ** 2.0) ** 0.5


@gtstencil
def wind_update(u: Field, v: Field, ke: Field, vort: Field, damp: Field,
                pe: Field, dt: Param, rdx: Param, rdy: Param):
    """Rotational + gradient + Smagorinsky-damped wind update."""
    with computation(PARALLEL), interval(...):
        gx = 0.5 * (ke[1, 0, 0] - ke[-1, 0, 0] + pe[1, 0, 0] - pe[-1, 0, 0]) * rdx
        gy = 0.5 * (ke[0, 1, 0] - ke[0, -1, 0] + pe[0, 1, 0] - pe[0, -1, 0]) * rdy
        lapu = u[1, 0, 0] + u[-1, 0, 0] + u[0, 1, 0] + u[0, -1, 0] - 4.0 * u[0, 0, 0]
        lapv = v[1, 0, 0] + v[-1, 0, 0] + v[0, 1, 0] + v[0, -1, 0] - 4.0 * v[0, 0, 0]
        u = u[0, 0, 0] + dt * (vort[0, 0, 0] * v[0, 0, 0] - gx) \
            + damp[0, 0, 0] * lapu
        v = v[0, 0, 0] - dt * (vort[0, 0, 0] * u[0, 0, 0] + gy) \
            + damp[0, 0, 0] * lapv


# ---------------------------------------------------------------------------
# riem_solver_c: semi-implicit vertical solver (tridiagonal, §VIII-B)
# ---------------------------------------------------------------------------


@gtstencil
def precompute_pe(delp: Field, pe: Field, ptop: Param):
    """Hydrostatic interface pressure: forward vertical integration."""
    with computation(FORWARD):
        with interval(0, 1):
            pe = ptop
        with interval(1, None):
            pe = pe[0, 0, -1] + delp[0, 0, -1]


@gtstencil
def riem_coeffs(delp: Field, ptc: Field, aa: Field, bb: Field, cc: Field,
                rhs: Field, w: Field, beta: Param):
    """Tridiagonal coefficients for the implicit w / pressure-perturbation
    solve (structure of riem_solver_c's semi-implicit discretization)."""
    with computation(PARALLEL):
        with interval(1, -1):
            aa = -ptc[0, 0, -1] / (0.5 * (delp[0, 0, -1] + delp[0, 0, 0]))
            cc = -ptc[0, 0, 0] / (0.5 * (delp[0, 0, 0] + delp[0, 0, 1]))
            bb = beta - (aa + cc)
            rhs = w[0, 0, 0] * delp[0, 0, 0]
        with interval(0, 1):
            aa = 0.0
            cc = -ptc[0, 0, 0] / delp[0, 0, 0]
            bb = beta - cc
            rhs = w[0, 0, 0] * delp[0, 0, 0]
        with interval(-1, None):
            aa = -ptc[0, 0, -1] / delp[0, 0, 0]
            cc = 0.0
            bb = beta - aa
            rhs = w[0, 0, 0] * delp[0, 0, 0]


@gtstencil
def tridiag_solve(aa: Field, bb: Field, cc: Field, rhs: Field, pp: Field):
    """Thomas algorithm (FORWARD elimination, BACKWARD substitution)."""
    with computation(FORWARD):
        with interval(0, 1):
            cc = cc / bb
            rhs = rhs / bb
        with interval(1, None):
            cc = cc / (bb - aa * cc[0, 0, -1])
            rhs = (rhs - aa * rhs[0, 0, -1]) / (bb - aa * cc[0, 0, -1])
    with computation(BACKWARD):
        with interval(-1, None):
            pp = rhs
        with interval(0, -1):
            pp = rhs[0, 0, 0] - cc[0, 0, 0] * pp[0, 0, 1]


@gtstencil
def w_update(w: Field, pp: Field, delp: Field, dt: Param):
    """Nonhydrostatic w update from the solved pressure perturbation."""
    with computation(PARALLEL):
        with interval(0, -1):
            w = w[0, 0, 0] + dt * (pp[0, 0, 1] - pp[0, 0, 0]) / delp[0, 0, 0]
        with interval(-1, None):
            w = w[0, 0, 0] - dt * pp[0, 0, 0] / delp[0, 0, 0]


# ---------------------------------------------------------------------------
# vertical remapping (paper Fig. 2 orange region) — K-interface fields
# ---------------------------------------------------------------------------
#
# The Lagrangian-to-reference remap is built from interface-field stencils so
# the whole loop compiles through ``compile_program``: FORWARD cumulative
# builds of the interface pressures / mass integrals, a data-oblivious
# piecewise-linear interpolation of the cumulative mass onto the reference
# interfaces, and *exact interface differencing* for the remapped means
# (conservation telescopes: sum(q_out * delp_ref) == F[nk] - F[0] by
# construction — no denominator floor anywhere).


@gtstencil
def lagrangian_pe(delp: Field, pe: Field[interface], ptop: Param):
    """Deformed (Lagrangian) interface pressures: FORWARD mass integration
    onto the nk+1 interface levels."""
    with computation(FORWARD):
        with interval(0, 1):
            pe = ptop
        with interval(1, None):
            pe = pe[0, 0, -1] + delp[0, 0, -1]


@gtstencil
def column_total(delp: Field, cum: Field, total: Field):
    """Column mass total broadcast to every level: FORWARD running sum,
    then a BACKWARD copy-down of the bottom value (loop-carried)."""
    with computation(FORWARD):
        with interval(0, 1):
            cum = delp
        with interval(1, None):
            cum = cum[0, 0, -1] + delp
    with computation(BACKWARD):
        with interval(-1, None):
            total = cum
        with interval(0, -1):
            total = total[0, 0, 1]


@gtstencil
def reference_pe(total: Field, pe_ref: Field[interface], ptop: Param,
                 rk: Param):
    """Reference sigma-coordinate interfaces: uniform slices of the column
    total (``rk`` = 1/nk), accumulated FORWARD on interface levels."""
    with computation(FORWARD):
        with interval(0, 1):
            pe_ref = ptop
        with interval(1, None):
            pe_ref = pe_ref[0, 0, -1] + total[0, 0, -1] * rk


@gtstencil
def cumsum_mass(q: Field, delp: Field, fm: Field[interface]):
    """Cumulative mass-weighted integral of ``q`` at Lagrangian interfaces."""
    with computation(FORWARD):
        with interval(0, 1):
            fm = 0.0
        with interval(1, None):
            fm = fm[0, 0, -1] + q[0, 0, -1] * delp[0, 0, -1]


@gtstencil
def remap_delp(pe_ref: Field[interface], delp_out: Field):
    """New layer thicknesses by exact interface differencing — the same
    denominators :func:`remap_field` divides by, so mass is conserved
    identically (the old ``maximum(delp_ref, 1e-10)`` floor broke this for
    thin reference layers)."""
    with computation(PARALLEL), interval(...):
        delp_out = pe_ref[0, 0, 1] - pe_ref[0, 0, 0]


@gtstencil
def remap_field(fi: Field[interface], pe_ref: Field[interface], q_out: Field):
    """Remapped layer mean from the interpolated cumulative mass: exact
    interface differencing of both numerator and denominator."""
    with computation(PARALLEL), interval(...):
        q_out = (fi[0, 0, 1] - fi[0, 0, 0]) \
            / (pe_ref[0, 0, 1] - pe_ref[0, 0, 0])


@gtstencil(name="remap_interp")
def interface_interp(fm: Field[interface], pe: Field[interface],
                     pe_ref: Field[interface], fi: Field[interface]):
    """Piecewise-linear interpolation of the cumulative mass ``fm`` (defined
    at the Lagrangian interfaces ``pe``) onto the reference interfaces
    ``pe_ref`` — the remap's monotone level search expressed with the DSL's
    bounded sequential-iteration construct.

    ``index_search`` selects the bracketing Lagrangian layer of each
    reference interface (first/last layers are catch-alls, so ties and
    float drift at the column ends extrapolate linearly); ``at_found``
    reads the layer's bounding interfaces for the linear interpolation.
    The backends lower the search to *real loops* — bisection in the
    plain torch lowering, a marching loop in the CUDA kernels — so the
    stencil's IR is a constant ~20 nodes at any nk, where the unrolled
    variant below pays O(nk²).  The slope guard only fires for
    zero-thickness Lagrangian layers, whose mass increment is itself zero —
    conservation is untouched.
    """
    with computation(PARALLEL), interval(...):
        fi = index_search(
            pe, pe_ref,
            at_found(fm) + (pe_ref - at_found(pe))
            * (at_found(fm, 1) - at_found(fm))
            / max(at_found(pe, 1) - at_found(pe), 1e-30))


def interface_interp_stencil(nk: int,
                             name: str = "remap_interp_unrolled") -> Stencil:
    """The pre-construct variant of :func:`interface_interp`, kept for A/B
    trace-time and equivalence comparison: the level search unrolled into
    static K offsets — built programmatically because the unrolling is
    nk-dependent.

    For each target interface level ``k`` one statement (restricted to
    ``interval(k, k+1)``) selects the bracketing Lagrangian layer with a
    nested ``where`` chain over all nk source layers at *static* K offsets
    ``s - k``.  The price is O(nk²) IR nodes per remapped field — fine at
    nk ≤ 16, a wall at production nk ~ 80, which is exactly why the DSL
    grew ``index_search`` (the same extension GT4Py added for this loop).
    """
    stmts = []
    for k in range(nk + 1):
        def pe(s: int) -> FieldAccess:
            return FieldAccess("pe", (0, 0, s - k))

        def fm(s: int) -> FieldAccess:
            return FieldAccess("fm", (0, 0, s - k))

        p = FieldAccess("pe_ref", (0, 0, 0))

        def term(s: int):
            # linear interp inside source layer s; the slope guard only
            # fires for zero-thickness Lagrangian layers, whose mass
            # increment is itself zero — conservation is untouched
            slope = (fm(s + 1) - fm(s)) \
                / _ir.maximum(pe(s + 1) - pe(s), 1e-30)
            return fm(s) + (p - pe(s)) * slope

        expr = term(nk - 1)  # bottom layer: catch-all
        for s in reversed(range(nk - 1)):
            expr = _ir.where(p < pe(s + 1), term(s), expr)
        stmts.append(Assign("fi", expr, Interval((0, k), (0, k + 1))))
    return Stencil(
        name=name,
        computations=(Computation(_ir.PARALLEL, tuple(stmts)),),
        fields=("fm", "pe", "pe_ref", "fi"),
        outputs=("fi",),
        interface_fields=("fm", "pe", "pe_ref", "fi"),
    )
