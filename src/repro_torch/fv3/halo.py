"""Cubed-sphere halo exchange (paper §IV-A, §IV-C).

Two implementations sharing the topology module:

 * :func:`exchange_reference` — sequential mode: the global field lives on
   one device as ``(6, nk, N+2h, N+2h)``; ghosts are filled by direct
   geometric gathers in two passes: the W/E ghost columns first, then the
   S/N ghost rows over the full padded width, so corner ghosts are
   transported through the neighbour.  The oracle.
 * :func:`make_halo_exchanger` — the distributed halo updater over rank
   blocks ``(..., ranks, nk, nl+2h, nl+2h)``: the rounds of
   :func:`~.topology.build_rounds`, EW rounds before NS rounds (those
   within a tile before those across tiles), each a set of (sender,
   receiver) rank pairs sharing one edge orientation.  Strips
   are transformed into the receiver's frame sender-side.  Pairs whose
   ranks this process holds move by one gather and one placement per round
   and field; pairs across processes by ``torch.distributed``
   point-to-point, one packed buffer per round and peer.

Vector pairs (u, v) additionally apply the 2×2 unfold rotation of the
crossed edge.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import collectives
from .mesh import Mesh
from .topology import LINKS, Decomposition, build_rounds


@functools.lru_cache(maxsize=8)
def _gather_indices(N: int, h: int):
    """Numpy index arrays for the two passes (cached per (N, h))."""
    pass1 = []  # (face, edge): ghost (tile,j,i) positions + source positions
    for f in range(6):
        for e in ("W", "E"):
            link = LINKS[(f, e)]
            t = np.arange(N)
            d = np.arange(h)
            T, D = np.meshgrid(t, d, indexing="ij")
            t2 = (N - 1 - T) if link.reversed else T
            if link.e2 == "W":
                si, sj = h + D, h + t2
            elif link.e2 == "E":
                si, sj = h + N - 1 - D, h + t2
            elif link.e2 == "S":
                si, sj = h + t2, h + D
            else:
                si, sj = h + t2, h + N - 1 - D
            gj = h + T
            gi = (h - 1 - D) if e == "W" else (h + N + D)
            pass1.append((f, link.g, gj, gi, sj, si))
    pass2 = []
    for f in range(6):
        for e in ("S", "N"):
            link = LINKS[(f, e)]
            tp = np.arange(N + 2 * h)  # padded along-edge index
            d = np.arange(h)
            T, D = np.meshgrid(tp, d, indexing="ij")
            t_rel = T - h
            t2 = (N - 1 - t_rel) if link.reversed else t_rel
            along = h + t2  # padded coordinate in the neighbor
            if link.e2 == "W":
                si, sj = h + D, along
            elif link.e2 == "E":
                si, sj = h + N - 1 - D, along
            elif link.e2 == "S":
                sj, si = h + D, along
            else:
                sj, si = h + N - 1 - D, along
            gi = T
            gj = (h - 1 - D) if e == "S" else (h + N + D)
            pass2.append((f, link.g, gj, gi, sj, si))
    return pass1, pass2


@functools.lru_cache(maxsize=8)
def _device_indices(N: int, h: int, device: torch.device):
    """The gather index arrays of both passes as tensors on ``device``."""
    def conv(entries):
        return [(f, g, *(torch.as_tensor(a, dtype=torch.int64, device=device)
                         for a in (gj, gi, sj, si)))
                for f, g, gj, gi, sj, si in entries]

    p1, p2 = _gather_indices(N, h)
    return conv(p1), conv(p2)


def exchange_reference(fields: Mapping[str, torch.Tensor], halo: int,
                       vector_pairs: Sequence[tuple[str, str]] = ()) -> dict:
    """Fill ghosts of global ``([lead...,] 6, nk, N+2h, N+2h)`` fields;
    returns new tensors, the inputs are left as they were.

    The tile axis sits at ``-4`` and the spatial axes at ``-2``/``-1``, so
    leading batch dimensions ride through every gather untouched.
    """
    names = list(fields)
    some = fields[names[0]]
    N = some.shape[-1] - 2 * halo
    pass1, pass2 = _device_indices(N, halo, some.device)
    vecs = {n: p for p in vector_pairs for n in p}

    def gather(arr, g, sj, si):
        # (lead..., nk, T, D): adjacent advanced indices (sj, si) replace
        # the spatial axes in place
        return arr.select(-4, g)[..., sj, si]

    def fill(arrs, entries, edges):
        out = {n: arrs[n].clone() for n in names}
        for (f, g, gj, gi, sj, si), e in zip(entries, edges):
            for n in names:
                if n in vecs:
                    pair = vecs[n]
                    M = LINKS[(f, e)].vec2x2
                    row = 0 if n == pair[0] else 1
                    src = (M[row][0] * gather(arrs[pair[0]], g, sj, si)
                           + M[row][1] * gather(arrs[pair[1]], g, sj, si))
                else:
                    src = gather(arrs[n], g, sj, si)
                out[n].select(-4, f)[..., gj, gi] = src.to(out[n].dtype)
        return out

    edges1 = [e for f in range(6) for e in ("W", "E")]
    edges2 = [e for f in range(6) for e in ("S", "N")]
    arrs = fill(dict(fields), pass1, edges1)
    return fill(arrs, pass2, edges2)


# ---------------------------------------------------------------------------
# Distributed exchange over rank blocks
# ---------------------------------------------------------------------------


def _extract(arr: torch.Tensor, edge: str, h: int, nl: int,
             full_width: bool) -> torch.Tensor:
    """Sender-side oriented strip view: axes (..., t, d), d = 0 nearest the
    boundary, t in the sender's increasing along-edge parameter.  Spatial
    axes are addressed from the end, so leading dims ride through."""
    lo, hi = (0, nl + 2 * h) if full_width else (h, h + nl)
    if edge == "W":
        return arr[..., lo:hi, h:2 * h]
    if edge == "E":
        return arr[..., lo:hi, nl:nl + h].flip(-1)
    if edge == "S":
        return arr[..., h:2 * h, lo:hi].transpose(-2, -1)
    return arr[..., nl:nl + h, lo:hi].flip(-2).transpose(-2, -1)


def _place(arr: torch.Tensor, strip: torch.Tensor, ranks: torch.Tensor,
           edge: str, h: int, nl: int, full_width: bool) -> None:
    """Receiver-side placement of (..., P, nk, t, d) strips into halo slot
    ``edge`` of the ``ranks`` (axis -4) of ``arr``, in place."""
    lo, hi = (0, nl + 2 * h) if full_width else (h, h + nl)
    every = slice(None)
    if edge == "W":
        arr[..., ranks, every, lo:hi, 0:h] = strip.flip(-1)
    elif edge == "E":
        arr[..., ranks, every, lo:hi, nl + h:nl + 2 * h] = strip
    elif edge == "S":
        arr[..., ranks, every, 0:h, lo:hi] = strip.transpose(-2, -1).flip(-2)
    else:
        arr[..., ranks, every, nl + h:nl + 2 * h, lo:hi] = \
            strip.transpose(-2, -1)


_IDENTITY = ((1, 0), (0, 1))


@dataclasses.dataclass
class _RoundPlan:
    """One round as this process sees it: local indices (axis -4) of the
    pairs it holds both ends of, and per peer process the local senders or
    receivers of the pairs that cross to it, in the round's pair order."""

    #: the round's index in ``build_rounds``: the tag of its messages,
    #: the same in every process
    tag: int
    send_edge: str
    recv_edge: str
    reversed: bool
    vec2x2: tuple
    local_src: list
    local_dst: list
    sends: dict      # peer process -> local sender indices
    recvs: dict      # peer process -> local receiver indices


def _plan(rounds, mesh: Mesh, dec: Decomposition,
          same_tile: bool | None) -> list[_RoundPlan]:
    """This process's view of ``rounds`` ((tag, round) pairs), keeping only
    the pairs within one tile (``same_tile=True``), across tiles
    (``False``) or all (``None``); rounds left with no pair of this process
    are dropped."""
    r0 = mesh.local_ranks.start
    mine = set(mesh.local_ranks)
    plans = []
    for tag, rnd in rounds:
        plan = _RoundPlan(tag, rnd.send_edge, rnd.recv_edge, rnd.reversed,
                          rnd.vec2x2, [], [], {}, {})
        pairs = [(s, d) for s, d in rnd.perm if same_tile is None
                 or (dec.pos_of(s)[0] == dec.pos_of(d)[0]) == same_tile]
        for g in range(mesh.size // dec.ranks):
            for src, dst in pairs:
                src, dst = g * dec.ranks + src, g * dec.ranks + dst
                if src in mine and dst in mine:
                    plan.local_src.append(src - r0)
                    plan.local_dst.append(dst - r0)
                elif src in mine:
                    plan.sends.setdefault(mesh.process_of(dst), []).append(
                        src - r0)
                elif dst in mine:
                    plan.recvs.setdefault(mesh.process_of(src), []).append(
                        dst - r0)
        if plan.local_src or plan.sends or plan.recvs:
            plans.append(plan)
    return plans


def make_halo_exchanger(dec: Decomposition, mesh: Mesh | None = None):
    """The distributed halo update over rank blocks.

    Returns ``exchange(fields, vector_pairs=()) -> dict``: ``fields`` map
    names to the blocks of the ranks this process holds,
    ``(..., ranks, nk, nl+2h, nl+2h)`` with the rank axis at -4 (so member
    axes ride in front); the result holds new tensors with every ghost a
    neighbour's strip, and the inputs are never written.

    ``mesh`` (:func:`~.mesh.make_mesh`; ``None``: one process holding the
    ``dec.ranks`` ranks) numbers the ranks: its last ``dec.ranks`` form
    one tile decomposition, repeated once per member group of its leading
    axes, and no round crosses a group.  The rounds run in phases, every
    strip of a phase taken before any of it is placed: the EW rounds over
    the interior rows, then the NS rounds over the full padded width (so
    corners travel through the neighbour) — first their pairs within a
    tile, then those across tiles.  The reference runs the NS rounds as one
    phase, and so reads, at rank corners on tile edges, ghost rows it has
    not filled; with the within-tile pairs first the exchange equals
    :func:`exchange_reference` on the global field.  Per round and field,
    the pairs inside the process move by one gather and one placement,
    whatever their number; pairs across processes go by
    ``torch.distributed.batch_isend_irecv``, one contiguous buffer per round
    and peer, every send and receive of a phase posted before any is
    waited on.  ``exchange.rounds`` lists the tile decomposition's rounds.
    Every strip a rank receives from another counts as a
    collective-permute in :mod:`..parallel.collectives`, at the receiving
    end, whether it came as a copy inside the process or by ``irecv``.
    """
    rounds = build_rounds(dec)
    if mesh is None:
        mesh = Mesh(("tile", "y", "x"), (6,) + tuple(dec.layout))
    if mesh.size % dec.ranks:
        raise ValueError(f"a mesh of {mesh.size} ranks holds no whole "
                         f"number of {dec.ranks}-rank decompositions")
    h, nl = dec.halo, dec.n_local
    ew = [(t, r) for t, r in enumerate(rounds) if r.recv_edge in ("W", "E")]
    ns = [(t, r) for t, r in enumerate(rounds) if r.recv_edge in ("S", "N")]
    # the NS rounds' pairs within a tile go first: a strip sent from a W/E
    # edge across a tile edge runs through the sender's S/N ghost rows
    phases = [(_plan(ew, mesh, dec, None), False),
              (_plan(ns, mesh, dec, True), True),
              (_plan(ns, mesh, dec, False), True)]
    index_cache: dict = {}

    def indices(device, values):
        key = (device, tuple(values))
        idx = index_cache.get(key)
        if idx is None:
            idx = index_cache[key] = torch.tensor(values, dtype=torch.int64,
                                                  device=device)
        return idx

    def strips(snap, plan, rank_idx, names, vector_pairs, full):
        """(name, strip) in the receiver's frame for the pairs whose
        senders are ``rank_idx``."""
        out = []

        def take(n):
            s = _extract(snap[n], plan.send_edge, h, nl, full).index_select(
                -4, rank_idx)
            return s.flip(-2) if plan.reversed else s

        for n in names:
            out.append((n, take(n)))
        M = plan.vec2x2
        for un, vn in vector_pairs:
            su, sv = take(un), take(vn)
            if M != _IDENTITY:
                su, sv = (M[0][0] * su + M[0][1] * sv,
                          M[1][0] * su + M[1][1] * sv)
            out += [(un, su), (vn, sv)]
        return out

    def exchange(fields: Mapping[str, torch.Tensor],
                 vector_pairs: Sequence[tuple[str, str]] = ()) -> dict:
        vecs = {n for p in vector_pairs for n in p}
        scalars = [n for n in fields if n not in vecs]
        out = {n: v.clone() for n, v in fields.items()}
        some = next(iter(out.values()))
        order = scalars + [n for pr in vector_pairs for n in pr]
        for plans, full in phases:
            # every strip of the phase is taken (copied) before any is
            # placed, so ``out`` serves as the phase's snapshot
            local, ops, received = [], [], []
            for plan in plans:
                if plan.local_src:
                    local.append((plan, strips(
                        out, plan, indices(some.device, plan.local_src),
                        scalars, vector_pairs, full)))
                for p, srcs in plan.sends.items():
                    got = strips(out, plan, indices(some.device, srcs),
                                 scalars, vector_pairs, full)
                    buf = torch.cat([s.reshape(-1) for _, s in got])
                    ops.append(dist.P2POp(dist.isend, buf, p, tag=plan.tag))
                for p, dsts in plan.recvs.items():
                    t = (nl + 2 * h) if full else nl
                    shapes = [(n, tuple(out[n].shape[:-4])
                               + (len(dsts), out[n].shape[-3], t, h))
                              for n in order]
                    buf = some.new_empty(sum(int(np.prod(s))
                                             for _, s in shapes))
                    ops.append(dist.P2POp(dist.irecv, buf, p, tag=plan.tag))
                    received.append((plan, dsts, shapes, buf))
            works = dist.batch_isend_irecv(ops) if ops else []
            for plan, got in local:
                dst = indices(some.device, plan.local_dst)
                for n, s in got:
                    _place(out[n], s, dst, plan.recv_edge, h, nl, full)
                    collectives.record("collective-permute", s,
                                       calls=len(plan.local_dst))
            for w in works:
                w.wait()
            for plan, dsts, shapes, buf in received:
                collectives.record("collective-permute", buf,
                                   calls=len(dsts) * len(shapes))
                dst = indices(some.device, dsts)
                at = 0
                for n, shape in shapes:
                    size = int(np.prod(shape))
                    _place(out[n], buf[at:at + size].view(shape), dst,
                           plan.recv_edge, h, nl, full)
                    at += size
        return out

    exchange.rounds = rounds
    return exchange
