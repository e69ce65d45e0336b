"""Compute-domain description shared by all backends.

Array convention: fields are stored ``(K, J, I)`` — I contiguous, matching
the paper's FORTRAN data-layout finding (§VI-A.3); on the GPU neighbouring
threads take neighbouring I, so loads coalesce.  Horizontal allocations carry ``halo`` ghost cells per side;
K is allocated exactly.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DomainSpec:
    """Compute-domain description shared by all backends."""

    ni: int
    nj: int
    nk: int
    halo: int
    extend: tuple[int, int] = (0, 0)  # extra (i, j) cells computed each side

    @property
    def write_window(self):
        ei, ej = self.extend
        h = self.halo
        return (slice(None), slice(h - ej, h + self.nj + ej),
                slice(h - ei, h + self.ni + ei))

    def padded_shape(self, interface: bool = False):
        """Allocated array shape; K-interface fields carry ``nk + 1`` levels
        (vertical staggering), centers exactly ``nk``."""
        nk = self.nk + 1 if interface else self.nk
        return (nk, self.nj + 2 * self.halo, self.ni + 2 * self.halo)

    def shape(self) -> tuple[int, int, int]:
        """(nk, nj, ni) — the interior shape schedule enumeration works on."""
        return (self.nk, self.nj, self.ni)
