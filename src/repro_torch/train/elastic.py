"""Elastic scaling and straggler policy, as the reference's
``train/elastic.py``: :func:`plan_mesh` picks the largest (data, model)
grid with fixed tensor parallelism that fits the surviving devices, and
:class:`HeartbeatMonitor` is the wall-clock watchdog around the
synchronous train step (a step past the timeout is a strike, and the
launcher checkpoints), and :func:`reshard_state` restores a checkpoint onto
any mesh: fewer or more ranks than wrote it, or one process."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from ..parallel.sharding import param_shardings


def plan_mesh(n_devices: int, *, model_parallel: int = 16
              ) -> tuple[int, int]:
    """Largest (data, model) grid with fixed TP that fits ``n_devices``."""
    data = n_devices // model_parallel
    if data < 1:
        raise ValueError(f"need ≥{model_parallel} devices, got {n_devices}")
    return data, model_parallel


def reshard_state(ckpt_dir, like, new_mesh, *, step=None):
    """Elastic restore: the checkpoint laid out on ``new_mesh`` (None: whole
    tensors on one process), into a state of ``like``'s structure (a
    ``TrainState`` of this process's model; its values are not read).
    Returns (the state, the manifest)."""
    from .checkpoint import restore_checkpoint

    shardings = (None if new_mesh is None
                 else param_shardings(like.params, new_mesh))
    return restore_checkpoint(ckpt_dir, like, step=step, shardings=shardings)


@dataclasses.dataclass
class HeartbeatMonitor:
    """Wall-clock watchdog around the synchronous train step."""

    timeout_s: float = 300.0
    on_straggle: Callable[[int, float], None] | None = None
    _last: float = dataclasses.field(default_factory=time.monotonic)
    strikes: int = 0

    def beat(self, step: int) -> bool:
        """Call after each completed step; returns False if the step
        exceeded the timeout (the caller should checkpoint and resize)."""
        now = time.monotonic()
        dt = now - self._last
        self._last = now
        if dt > self.timeout_s:
            self.strikes += 1
            if self.on_straggle:
                self.on_straggle(step, dt)
            return False
        return True
