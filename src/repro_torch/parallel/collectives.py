"""A record of the collectives the port issues, in the style of
``kernels.library.LAUNCHES``: for each kind, the calls and the bytes of
their results.  The reference reads the same from XLA's partitioned HLO
(``launch/dryrun.py``'s ``collective_bytes``: the result shape of every
collective op); the port has no HLO, so it counts what it issues:

  * ``parallel.sharding``: a gather of a shard (all-gather: the gathered
    tensor), a gradient's reduce-scatter (its part), an all-reduce (the
    reduced tensor);
  * ``fv3.halo``'s exchanger: every strip that crosses ranks, as a
    collective-permute of the strip, whether it moves as a device copy
    inside a process or by ``isend``/``irecv`` between processes.

:func:`summary` returns the reference's ``{"bytes", "counts",
"total_bytes"}``.
"""

from __future__ import annotations

import torch

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
COUNTS = {k: 0 for k in KINDS}
BYTES = {k: 0 for k in KINDS}


def record(kind: str, result: torch.Tensor, calls: int = 1) -> None:
    """Count ``calls`` collectives of ``kind`` whose results together are
    ``result``'s bytes."""
    COUNTS[kind] += calls
    BYTES[kind] += result.numel() * result.element_size()


def reset() -> None:
    for k in KINDS:
        COUNTS[k] = BYTES[k] = 0


def summary() -> dict:
    return {"bytes": dict(BYTES), "counts": dict(COUNTS),
            "total_bytes": sum(BYTES.values())}
