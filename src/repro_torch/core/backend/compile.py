"""``compile_program`` — the single entry point of the compilation pipeline.

frontend → IR → graph → **passes** → backend → schedule/tuning: the FV3
dycore and the tests funnel through here; no module outside this package
touches a lowering directly.

``opt_level`` applies the automatic optimization ladder of
:mod:`repro_torch.core.passes` to a clone of the program before lowering:
pruning, strength reduction, cost-model-guided fusion and transfer-tuned
schedule assignment (paper §VI), for the ``hardware`` preset (``"h100"``
when none is named).  At ``opt_level=0`` every
stencil node lowers 1:1 to one runner.  The compiled callable threads only
*live* fields between runners: inputs a node consumes before any node
writes them are auto-allocated when missing, and transient containers
leave the environment after their last reader — after fusion most never
exist as program fields at all, because fused nodes keep them as
temporaries.  ``n_members`` threads an ensemble's member axis through the
program (:mod:`.batching`).

Two backends are registered here:

 * ``"torch"`` — the plain lowering (:mod:`.lowering_torch`) on any device;
 * ``"cuda"`` — the hand-written kernels (:mod:`.cuda`), which take the
   plain lowering for tensors on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Mapping

import torch

from ..hardware import Hardware, resolve_hardware
from ..stencil.domain import DomainSpec
from ..stencil.ir import Stencil
from ..stencil.schedule import Schedule
from .base import Backend, Runner, get_backend, register_backend, resolve_device
from .batching import AUTO, BatchSpec, pad_wrapped, parse_batch, scan_chunked
from .cuda import CudaStencil
from .lowering_torch import compile_torch

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids a circular import
    from ..graph import Node, StencilProgram


class TorchBackend(Backend):
    """The plain PyTorch lowering: the oracle, on whatever device the
    fields lie on.  Schedules are accepted and ignored (a solver always
    marches whole columns)."""

    name = "torch"

    def compile_stencil(self, stencil: Stencil, dom: DomainSpec, *,
                        schedule: Schedule | None = None,
                        dtype=torch.float32, n_members: int | None = None,
                        member_chunk: int = 1) -> Runner:
        # leading dims ride through the plain lowering: a member axis is
        # one more of them
        return compile_torch(stencil, dom, dtype=dtype)


class CudaBackend(Backend):
    """The hand-written Hopper kernels (K1–K4), one launch per PARALLEL
    statement and per solver computation — or one K-blocked launch for a
    single-direction solver under a K-blocked schedule — with the member
    axis on the launch grid (K5)."""

    name = "cuda"
    member_grid = True

    def compile_stencil(self, stencil: Stencil, dom: DomainSpec, *,
                        schedule: Schedule | None = None,
                        dtype=torch.float32, n_members: int | None = None,
                        member_chunk: int = 1) -> Runner:
        return CudaStencil(stencil, dom, schedule=schedule, dtype=dtype,
                           n_members=n_members, member_chunk=member_chunk)


register_backend(TorchBackend())
register_backend(CudaBackend())


def compile_stencil(stencil: Stencil, dom: DomainSpec, *,
                    backend: "str | Backend" = "cuda",
                    schedule: Schedule | None = None,
                    dtype=torch.float32, n_members: int | None = None,
                    member_chunk: int = 1) -> Runner:
    """Compile one stencil through a registered backend, under
    ``schedule`` where the backend reads one."""
    return get_backend(backend).compile_stencil(
        stencil, dom, schedule=schedule, dtype=dtype, n_members=n_members,
        member_chunk=member_chunk)


def _resolve_override(node: "Node", overrides) -> Schedule | None:
    if not overrides:
        return node.schedule
    # per-instance label wins over per-motif base name
    if node.label in overrides:
        return overrides[node.label]
    if node.base_name in overrides:
        return overrides[node.base_name]
    return node.schedule


def _liveness(program: "StencilProgram", runners) -> tuple[list, list]:
    """Static dataflow facts for the run loop.

    ``inputs``: program fields some node consumes before any node writes
    them — the only fields the runner must materialize.

    ``drop_after[i]``: transient fields whose last use is node ``i`` — they
    leave the environment immediately, so their memory returns to the
    allocator as soon as no later node needs it.
    """
    inputs: list[str] = []
    written: set[str] = set()
    last_use: dict[str, int] = {}
    for i, (n, _) in enumerate(runners):
        for f in n.stencil.fields:
            if f not in written and f not in inputs:
                inputs.append(f)
            last_use[f] = i
        written |= set(n.writes())
    drop_after: list[list[str]] = [[] for _ in runners]
    for f, i in last_use.items():
        decl = program.fields.get(f)
        if decl is not None and decl.transient:
            drop_after[i].append(f)
    return inputs, drop_after


def compile_program(program: "StencilProgram",
                    backend: "str | Backend" = "cuda", *,
                    hardware: Hardware | str | None = None,
                    schedule_overrides: Mapping[str, Schedule] | None = None,
                    opt_level: int = 0,
                    n_members: int | None = None,
                    batch: "str | BatchSpec" = "vmap",
                    verify: str | None = None,
                    device: "torch.device | str | None" = None) -> Callable:
    """Compile a whole :class:`StencilProgram` into one callable
    ``fn(fields: dict, params: dict) -> dict`` (live fields threaded).

    ``hardware`` is a descriptor or registered preset name (defaults to
    ``"h100"``); the optimizer tunes for it.
    ``schedule_overrides`` maps node labels (``"al_x#3"``) or motif base
    names (``"al_x"``) to :class:`Schedule` objects, overriding any schedule
    stored on the node.  ``opt_level`` (0–4) selects the automatic
    optimization pipeline (:mod:`repro_torch.core.rewrite`) applied to a
    *clone* of ``program`` — the caller's graph is never mutated.

    ``device`` is where the program runs and where missing inputs are
    allocated: ``None`` means the CUDA card, and raises ``RuntimeError``
    when there is none; the CPU takes ``device="cpu"``.  Supplied fields
    must lie on that device.

    ``n_members=M`` gives every field a leading member axis of extent M,
    lowered per ``batch`` (see :mod:`.batching`):

      * ``"vmap"`` / ``"grid"`` — all M members in each launch (on the
        ``"cuda"`` backend both put one thread per member and point on the
        launch grid; the ``"torch"`` backend broadcasts over the axis);
      * ``"vmap:C"`` / ``"grid:C"`` — a loop over ceil(M/C) chunks of C
        members, one chunk's transients live at a time;
      * ``"vmap:C,grid"`` — C-member chunks inside each launch, one thread
        per chunk (falls back to the chunk loop on the ``"torch"``
        backend, which has no launch grid).

    M not divisible by C replicate-pads the last member to a whole chunk
    and slices the pad off after — bit-identical for the real members.  A
    field broadcast across members (an expanded tensor, member stride 0)
    reaches the kernels without copies.  ``"vmap:auto"`` /
    ``"vmap:auto,grid"`` pick C per program through the cost model
    (:func:`~repro_torch.core.autotune.tune_program_chunk`).  Malformed
    specs raise ``ValueError``.

    ``verify`` selects the static verifier (:mod:`repro_torch.core.analysis`):
    ``"off"`` skips it; ``"passes"`` runs it on the optimizer's input
    program and after every pass (violations raise
    :class:`~repro_torch.core.errors.VerificationError` attributed to the
    responsible pass); ``"full"`` also verifies the program when no pass
    runs (``opt_level=0``).  ``None`` resolves through ``$REPRO_VERIFY``,
    then ``"passes"`` under pytest/CI and ``"off"`` elsewhere.

    The returned callable exposes ``n_kernels`` (number of compiled
    runners, the same for every M and C), ``opt_report`` (the
    :class:`~repro_torch.core.rewrite.PipelineReport`, ``None`` at level 0),
    ``verify_mode``, ``program`` (the graph lowered), ``input_fields``,
    ``transient_inputs`` (fields auto-allocated when the caller omits them
    — empty of transients once fusion has localized them), ``hardware``,
    ``backend`` and ``device``, plus ``n_members`` / ``batch`` /
    ``batch_spec`` / ``member_chunk`` / ``n_chunks`` describing the member
    lowering.
    """
    be = get_backend(backend)
    hw = resolve_hardware(hardware)
    spec = parse_batch(batch)
    if n_members and spec.chunk == AUTO:
        from ..autotune import tune_program_chunk

        spec = dataclasses.replace(spec, chunk=tune_program_chunk(
            program, backend=be.name, hw=hw, n_members=n_members))
    dev = resolve_device(device)
    # effective spec for this M: clamp C, take grid-loop chunks to the
    # chunk loop on backends without a member grid, collapse single-chunk
    # loops
    eff = spec
    if n_members and eff.chunk:
        C = eff.chunk_for(n_members)
        loop = eff.loop if be.member_grid else "scan"
        if loop == "scan" and C >= n_members:
            eff = BatchSpec(mode=eff.mode)
        else:
            eff = BatchSpec(mode=eff.mode, chunk=C, loop=loop)
    chunk_scan = bool(n_members and eff.chunk and eff.loop == "scan")
    chunk_grid = bool(n_members and eff.chunk and eff.loop == "grid")
    Mp = eff.padded_members(n_members) if (chunk_scan or chunk_grid) else \
        (n_members or 0)
    # under loop="scan" each launch sees one C-member chunk; under
    # loop="grid" the launches cover the padded axis, C members a thread
    from ..analysis.verifier import resolve_verify_mode

    verify_mode = resolve_verify_mode(verify)
    opt_report = None
    if opt_level:
        from ..passes import optimize_program

        program, opt_report = optimize_program(
            program, opt_level=opt_level, backend=be.name, hardware=hw,
            n_members=n_members or 1,
            member_chunk=eff.chunk if n_members else 0,
            verify=verify_mode)
    elif verify_mode == "full":
        # no pass runs at level 0, but "full" still audits the program
        # actually being lowered
        from ..analysis import verify_program

        verify_program(program, raise_on_violation=True)
    stencil_members, member_chunk = n_members, 1
    if chunk_scan:
        stencil_members = eff.chunk
    elif chunk_grid:
        stencil_members, member_chunk = Mp, eff.chunk
    runners = []
    for s in program.states:
        for n in s.nodes:
            runners.append((n, compile_stencil(
                n.stencil, program.node_dom(n), backend=be,
                schedule=_resolve_override(n, schedule_overrides),
                n_members=stencil_members or None,
                member_chunk=member_chunk)))

    fields_decl = program.fields
    dom = program.dom
    inputs, drop_after = _liveness(program, runners)

    def _exec(fields: Mapping[str, torch.Tensor],
              params: Mapping[str, float] | None = None) -> dict:
        params = dict(params or {})
        env = dict(fields)
        lead: tuple = ()
        for name, x in env.items():
            if x.device != dev:
                raise ValueError(f"field {name!r} lies on {x.device}, the "
                                 f"program runs on {dev}")
            lead = tuple(x.shape[:-3])
        for name in inputs:
            if name not in env:
                # consumed before any write and not supplied — the backend
                # owns allocation, never the user (paper §IV-A)
                decl = fields_decl[name]
                env[name] = torch.zeros(
                    lead + dom.padded_shape(decl.interface),
                    dtype=decl.dtype, device=dev)
        for i, (n, r) in enumerate(runners):
            ins = {f: env[f] for f in n.stencil.fields}
            ps = {p: params[p] for p in n.stencil.params}
            env.update(r(ins, ps))
            for f in drop_after[i]:
                env.pop(f, None)
        return env

    fn: Callable = _exec
    if chunk_scan:
        fn = scan_chunked(_exec, n_members, eff.chunk)
    elif chunk_grid and Mp != n_members:
        fn = pad_wrapped(_exec, n_members, Mp)
    fn.n_kernels = len(runners)
    fn.opt_report = opt_report
    fn.verify_mode = verify_mode
    fn.program = program
    fn.device = dev
    fn.backend = be.name
    fn.hardware = hw.name
    fn.input_fields = tuple(inputs)
    fn.transient_inputs = tuple(
        f for f in inputs
        if f in fields_decl and fields_decl[f].transient)
    fn.n_members = n_members
    fn.batch = spec.token if n_members else None
    fn.batch_spec = eff if n_members else None
    fn.member_chunk = eff.chunk if (n_members and eff.chunk) else None
    fn.n_chunks = Mp // eff.chunk if (chunk_scan or chunk_grid) else None
    return fn
