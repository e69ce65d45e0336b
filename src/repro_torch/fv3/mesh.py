"""The rank mesh of the distributed dycore.

The counterpart of the reference's ``jaxcompat.make_mesh`` /
``launch.mesh.make_fv3_mesh``: a descriptor of named axes and their
extents — ``(6, 2, 2)`` over ``("tile", "y", "x")``, or ``(M, 6, 1, 1)``
with a leading member axis — numbered row-major, the last axis fastest, as
the reference's devices are.  There are no devices behind the ranks:
a process holds a contiguous block of them, stacked on one leading tensor
axis, and runs each program once for all of them.

Without ``torch.distributed`` initialised the process holds every rank
(the analogue of the reference's host-platform device count).  With it, the
ranks split evenly over the processes of the default group, in process
order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    #: this process's index in the default group and the number of processes
    process: int = 0
    n_processes: int = 1

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → extent, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def ranks_per_process(self) -> int:
        return self.size // self.n_processes

    @property
    def local_ranks(self) -> range:
        """The ranks this process holds, in order."""
        n = self.ranks_per_process
        return range(self.process * n, (self.process + 1) * n)

    def process_of(self, rank: int) -> int:
        return rank // self.ranks_per_process


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A :class:`Mesh` of ``shape`` over ``axis_names``; the ranks this
    process holds come from ``torch.distributed`` (all of them when it is
    not initialised).  Raises ``ValueError`` when the ranks do not divide
    evenly over the processes."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or min(shape, default=0) < 1:
        raise ValueError(f"mesh shape {shape} does not match axes "
                         f"{axis_names}")
    process, n_processes = 0, 1
    if dist.is_available() and dist.is_initialized():
        process = dist.get_rank()
        n_processes = dist.get_world_size()
    size = math.prod(shape)
    if size % n_processes:
        raise ValueError(f"{size} ranks of mesh {shape} do not divide over "
                         f"{n_processes} processes")
    return Mesh(axis_names, shape, process, n_processes)
