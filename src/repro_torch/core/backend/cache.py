"""Content fingerprints of stencils.

At opt level 0 nothing is tuned, so the port keeps only the fingerprint:
the content hash that keys per-node compile memos and, in later slices, the
tuning cache.  It hashes the same payload as the reference package, so a
stencil parsed by either package gets the same fingerprint.
"""

from __future__ import annotations

import hashlib

from ..stencil.ir import Stencil


def stencil_fingerprint(stencil: Stencil) -> str:
    """Content hash of a stencil's IR (name, signature, computations).

    All IR nodes have deterministic reprs (frozen dataclasses / custom
    ``__repr__``), so the repr of the computation tuple is a canonical
    serialization of the algorithm.
    """
    payload = "|".join([
        stencil.name,
        ",".join(stencil.fields),
        ",".join(stencil.outputs),
        ",".join(stencil.params),
        ",".join(stencil.interface_fields),
        repr(stencil.computations),
    ])
    return hashlib.sha256(payload.encode()).hexdigest()[:32]
