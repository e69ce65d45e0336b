"""Production meshes, as the reference's ``launch/mesh.py``.

``make_production_mesh`` is a function: importing this module touches no
device and no process group.  Single pod: (16, 16) over ("data",
"model"), 256 ranks; multi-pod: (2, 16, 16) with a leading "pod" axis,
512 ranks.  The mesh is a ``torch.distributed`` ``DeviceMesh`` over the
default process group's ranks (one a card), which must be that many.

FV3 uses its own topology-locked mesh, ("tile", "y", "x") with 6 tiles,
and a leading ensemble axis ("ens") across pods: the port's
:func:`..fv3.mesh.make_mesh` descriptor, whose ranks a process holds in
blocks.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..fv3.mesh import make_mesh


def device_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
                device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` on the default process
    group, one rank a device (``device_type``: "cuda" where the card is
    there, else "cpu").  Raises ``ValueError`` unless the group has
    exactly prod(shape) ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if world != n:
        raise ValueError(f"a {shape} mesh over {axes} needs {n} ranks; "
                         f"the process group has {world} (launch with "
                         f"torchrun --nproc-per-node ...)")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return device_mesh(shape, axes, device_type=device_type)


def make_fv3_mesh(*, layout: tuple[int, int] = (8, 8), ensemble: int = 1):
    """Cubed-sphere mesh: 6 x py x px ranks (and a leading ensemble axis)."""
    py, px = layout
    if ensemble > 1:
        return make_mesh((ensemble, 6, py, px), ("ens", "tile", "y", "x"))
    return make_mesh((6, py, px), ("tile", "y", "x"))
