"""Cubed-sphere halo exchange, sequential mode (paper §IV-A, §IV-C).

The global field lives on one device as ``(6, nk, N+2h, N+2h)``; ghosts are
filled by direct geometric gathers in two passes: the W/E ghost columns
first, then the S/N ghost rows over the full padded width, so corner ghosts
are transported through the neighbour.  Vector pairs (u, v) additionally
apply the 2×2 unfold rotation of the crossed edge.  This ports the
reference's ``exchange_reference`` as torch index gathers; the distributed
halo updater comes with a later slice.
"""

from __future__ import annotations

import functools
from typing import Mapping, Sequence

import numpy as np
import torch

from .topology import LINKS


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
