"""Cubed-sphere topology, derived geometrically.

Rather than hard-coding FV3's neighbor/rotation tables, we construct the six
gnomonic faces in 3D and *derive* adjacency, index reversal and the vector
(unfold) rotation per shared edge.  This keeps the halo updater provably
consistent: tests compare exchanged ghosts against direct geometric gathers.

Face frames (right-handed, ex × ey = n):
    F0 +x, F1 +y, F2 -x, F3 -y (equatorial band), F4 +z (north), F5 -z.

Local cell (i, j) on face f has cube-surface center
    p = 0.5 n + ((i+0.5)/N - 0.5) ex + ((j+0.5)/N - 0.5) ey,
projected to the unit sphere for physical coordinates (gnomonic grid).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np

EDGES = ("W", "E", "S", "N")

_FACES = [
    # (normal, ex, ey)
    ((1, 0, 0), (0, 1, 0), (0, 0, 1)),
    ((0, 1, 0), (-1, 0, 0), (0, 0, 1)),
    ((-1, 0, 0), (0, -1, 0), (0, 0, 1)),
    ((0, -1, 0), (1, 0, 0), (0, 0, 1)),
    ((0, 0, 1), (0, 1, 0), (-1, 0, 0)),
    ((0, 0, -1), (0, 1, 0), (1, 0, 0)),
]

N_FACES = 6


def face_frame(f: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    n, ex, ey = _FACES[f]
    return np.array(n, float), np.array(ex, float), np.array(ey, float)


def _corner(f: int, a: int, b: int) -> np.ndarray:
    n, ex, ey = face_frame(f)
    return 0.5 * n + (a - 0.5) * ex + (b - 0.5) * ey


def _edge_corners(f: int, e: str) -> tuple[np.ndarray, np.ndarray]:
    """Edge endpoints ordered by increasing along-edge parameter t."""
    if e == "W":
        return _corner(f, 0, 0), _corner(f, 0, 1)  # t = j
    if e == "E":
        return _corner(f, 1, 0), _corner(f, 1, 1)
    if e == "S":
        return _corner(f, 0, 0), _corner(f, 1, 0)  # t = i
    if e == "N":
        return _corner(f, 0, 1), _corner(f, 1, 1)
    raise ValueError(e)


@dataclasses.dataclass(frozen=True)
class EdgeLink:
    """My face-edge (f, e) attaches to neighbor (g, e2); ``reversed`` flips
    the along-edge parameter; ``vec2x2`` maps neighbor-frame (u, v) vector
    components into my frame after unfolding about the shared edge."""

    f: int
    e: str
    g: int
    e2: str
    reversed: bool
    vec2x2: tuple[tuple[float, float], tuple[float, float]]


def _unfold_matrix(f: int, g: int, edge_dir: np.ndarray) -> np.ndarray:
    """Rotation about the shared edge axis mapping face g's plane onto f's."""
    nf, exf, eyf = face_frame(f)
    ng, exg, eyg = face_frame(g)
    axis = edge_dir / np.linalg.norm(edge_dir)
    # angle that rotates ng onto nf about axis
    ngp = ng - axis * (ng @ axis)
    nfp = nf - axis * (nf @ axis)
    c = float(np.clip((ngp @ nfp) / (np.linalg.norm(ngp) * np.linalg.norm(nfp)),
                      -1, 1))
    s_vec = np.cross(ngp, nfp)
    s = float(s_vec @ axis) / (np.linalg.norm(ngp) * np.linalg.norm(nfp))
    theta = np.arctan2(s, c)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
    # express R(exg), R(eyg) in (exf, eyf) basis
    M = np.array([[exf @ (R @ exg), exf @ (R @ eyg)],
                  [eyf @ (R @ exg), eyf @ (R @ eyg)]])
    M = np.round(M)
    assert np.allclose(np.abs(M) @ np.ones(2), np.ones(2)), M
    return M


def build_links() -> dict[tuple[int, str], EdgeLink]:
    """All 24 (face, edge) → neighbor links, derived from geometry."""
    links: dict[tuple[int, str], EdgeLink] = {}
    for f in range(N_FACES):
        for e in EDGES:
            c0, c1 = _edge_corners(f, e)
            match = None
            for g in range(N_FACES):
                if g == f:
                    continue
                for e2 in EDGES:
                    d0, d1 = _edge_corners(g, e2)
                    if np.allclose(c0, d0) and np.allclose(c1, d1):
                        match = (g, e2, False)
                    elif np.allclose(c0, d1) and np.allclose(c1, d0):
                        match = (g, e2, True)
            assert match is not None, (f, e)
            g, e2, rev = match
            M = _unfold_matrix(f, g, c1 - c0)
            links[(f, e)] = EdgeLink(f, e, g, e2, rev,
                                     ((M[0, 0], M[0, 1]), (M[1, 0], M[1, 1])))
    return links


LINKS = build_links()


def cell_center(f: int, i, j, N: int) -> np.ndarray:
    """Cube-surface center(s) of cell (i, j); i/j may be arrays."""
    n, ex, ey = face_frame(f)
    i = np.asarray(i, float)
    j = np.asarray(j, float)
    a = (i + 0.5) / N - 0.5
    b = (j + 0.5) / N - 0.5
    return (0.5 * n + a[..., None] * ex + b[..., None] * ey)


def sphere_center(f: int, i, j, N: int) -> np.ndarray:
    p = cell_center(f, i, j, N)
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


def ghost_source(f: int, e: str, t: int, d: int, N: int
                 ) -> tuple[int, int, int]:
    """Interior cell (g, i, j) that fills ghost (t, d) of face f's edge ``e``.

    ``t``: along-edge index (0..N-1) in *my* frame; ``d``: depth (0 = closest
    ghost row).  Returned indices are in the neighbor's frame.
    """
    link = LINKS[(f, e)]
    t2 = (N - 1 - t) if link.reversed else t
    g, e2 = link.g, link.e2
    if e2 == "W":
        return g, d, t2
    if e2 == "E":
        return g, N - 1 - d, t2
    if e2 == "S":
        return g, t2, d
    if e2 == "N":
        return g, t2, N - 1 - d
    raise ValueError(e2)


# ---------------------------------------------------------------------------
# Rank decomposition: mesh ("tile", "y", "x") with square per-rank subdomains
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Decomposition:
    layout: tuple[int, int]  # (py, px) ranks per tile
    n_local: int             # interior points per rank per dim (square)
    halo: int

    @property
    def n_tile(self) -> int:
        return self.n_local * self.layout[1]

    @property
    def ranks(self) -> int:
        return N_FACES * self.layout[0] * self.layout[1]

    def rank_of(self, tile: int, jy: int, ix: int) -> int:
        py, px = self.layout
        return (tile * py + jy) * px + ix

    def pos_of(self, rank: int) -> tuple[int, int, int]:
        py, px = self.layout
        return rank // (py * px), (rank // px) % py, rank % px


@dataclasses.dataclass(frozen=True)
class Round:
    """One ppermute: every rank in ``perm`` sends its ``send_edge`` strip to
    the partner, who stores it (after ``reversed``/transpose orientation and
    the ``vec2x2`` component map) into its ``recv_edge`` halo slot."""

    send_edge: str
    recv_edge: str
    reversed: bool
    vec2x2: tuple[tuple[float, float], tuple[float, float]]
    perm: tuple[tuple[int, int], ...]       # (src, dst) rank pairs
    recv_mask: tuple[bool, ...]             # per rank


def build_rounds(dec: Decomposition) -> list[Round]:
    """Enumerate communication rounds.  Within-tile neighbors use identity
    links; tile borders use the geometric links.  Rounds are grouped by
    (send_edge, recv_edge, reversed, vec2x2) so each is a valid permutation.
    EW-slot rounds must run before NS-slot rounds (two-pass corner fill)."""
    py, px = dec.layout
    groups: dict[tuple, list[tuple[int, int]]] = {}
    for rank in range(dec.ranks):
        tile, jy, ix = dec.pos_of(rank)
        for e in EDGES:
            # neighbor within tile?
            if e == "W" and ix > 0:
                dst, e2, rev, M = dec.rank_of(tile, jy, ix - 1), "E", False, ((1, 0), (0, 1))
            elif e == "E" and ix < px - 1:
                dst, e2, rev, M = dec.rank_of(tile, jy, ix + 1), "W", False, ((1, 0), (0, 1))
            elif e == "S" and jy > 0:
                dst, e2, rev, M = dec.rank_of(tile, jy - 1, ix), "N", False, ((1, 0), (0, 1))
            elif e == "N" and jy < py - 1:
                dst, e2, rev, M = dec.rank_of(tile, jy + 1, ix), "S", False, ((1, 0), (0, 1))
            else:
                link = LINKS[(tile, e)]
                # my along-edge position within the tile
                pos = jy if e in ("W", "E") else ix
                pos2 = (px - 1 - pos) if link.reversed else pos
                # receiver rank position along their edge e2
                if link.e2 == "W":
                    dst = dec.rank_of(link.g, pos2, 0)
                elif link.e2 == "E":
                    dst = dec.rank_of(link.g, pos2, px - 1)
                elif link.e2 == "S":
                    dst = dec.rank_of(link.g, 0, pos2)
                else:
                    dst = dec.rank_of(link.g, py - 1, pos2)
                e2, rev = link.e2, link.reversed
                # vector map into RECEIVER's frame: inverse of link (which
                # maps neighbor→me); sender f=tile: receiver needs M_recv =
                # (receiver's link to me).vec2x2
                M = LINKS[(link.g, link.e2)].vec2x2
            key = (e, e2, rev, M)
            groups.setdefault(key, []).append((rank, dst))

    rounds = []
    for (e, e2, rev, M), pairs in groups.items():
        mask = [False] * dec.ranks
        for _, dst in pairs:
            assert not mask[dst], "round is not a permutation"
            mask[dst] = True
        rounds.append(Round(e, e2, rev, M, tuple(pairs), tuple(mask)))
    # EW-recv rounds first, then NS-recv (two-pass corner transport)
    rounds.sort(key=lambda r: (r.recv_edge in ("S", "N"), r.send_edge, r.recv_edge))
    return rounds
