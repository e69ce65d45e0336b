"""Ensemble member batching — the ``batch=`` spec of the pipeline.

A :class:`BatchSpec` describes how M ensemble members run:

    mode   how the members inside one chunk batch together ("vmap" → a
           leading batch dimension the plain lowering broadcasts over;
           "grid" → the member axis of the CUDA kernels' launch grid — on
           the card both launch one thread per member and point)
    chunk  C, members per chunk (0 → unchunked, C = M; AUTO → a cost-model
           pick, which needs the optimizer and is not ported)
    loop   how chunks are sequenced ("scan" → a Python loop over ceil(M/C)
           chunks; "grid" → C-member chunks inside each kernel launch, one
           thread looping over the C members of its chunk — backends
           without a member grid fall back to "scan")

Accepted spellings (:func:`parse_batch`):

    "vmap"           one batch of all M
    "grid"           member grid axis, one member per thread
    "vmap:C"         a loop over ceil(M/C) chunks of a C-wide batch
    "vmap:C,scan"    same, explicit
    "vmap:C,grid"    C-member chunks inside each kernel launch
    "grid:C"         a loop over chunks of a C-member grid axis
    "vmap:auto[,..]" C picked by the cost model (raises at compile time)

M not divisible by C is handled by *replicating the last member* up to the
next multiple (never zeros — padded members flow through divisions) and
slicing the pad off after; real members are bit-identical either way since
members never interact.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

#: sentinel chunk value — resolve through the cost model at compile time
AUTO = -1

_MODES = ("vmap", "grid")
_LOOPS = ("scan", "grid")


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """Typed member-batching strategy (see module docstring)."""

    mode: str = "vmap"
    chunk: int = 0
    loop: str = "scan"

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(
                f"batch mode must be one of {_MODES}, got {self.mode!r}")
        if self.loop not in _LOOPS:
            raise ValueError(
                f"batch loop mode must be one of {_LOOPS}, got {self.loop!r}")
        if self.chunk != AUTO and self.chunk < 0:
            raise ValueError(
                f"batch chunk size must be positive, got {self.chunk}")
        if self.mode == "grid" and self.chunk and self.loop == "grid":
            raise ValueError(
                "batch spec 'grid:C,grid' is redundant — the member grid "
                "axis already walks members sequentially; use 'grid' or "
                "'vmap:C,grid'")

    # -- derived quantities --------------------------------------------------
    @property
    def token(self) -> str:
        """Canonical spelling."""
        if not self.chunk:
            return self.mode
        c = "auto" if self.chunk == AUTO else str(self.chunk)
        if self.loop == "grid":
            return f"{self.mode}:{c},grid"
        return f"{self.mode}:{c}"

    def chunk_for(self, n_members: int) -> int:
        """Effective C for an M-member ensemble (clamped; 0 → M)."""
        if not self.chunk:
            return n_members
        if self.chunk == AUTO:
            raise ValueError("batch chunk 'auto' must be resolved before use")
        return min(self.chunk, n_members)

    def n_chunks(self, n_members: int) -> int:
        return -(-n_members // self.chunk_for(n_members))

    def padded_members(self, n_members: int) -> int:
        """M rounded up to a whole number of chunks."""
        return self.n_chunks(n_members) * self.chunk_for(n_members)


def parse_batch(batch: "str | BatchSpec") -> BatchSpec:
    """Parse/validate a ``batch=`` argument into a :class:`BatchSpec`.

    Raises ``ValueError`` (always mentioning ``batch``) on malformed specs:
    unknown modes, non-integer or non-positive chunk sizes, stray commas,
    and the redundant ``grid:C,grid`` combination.
    """
    if isinstance(batch, BatchSpec):
        return batch
    if not isinstance(batch, str):
        raise ValueError(
            f"batch must be a spec string or BatchSpec, got {batch!r}")
    parts = batch.split(",")
    if len(parts) > 2 or any(not p for p in parts):
        raise ValueError(
            f"malformed batch spec {batch!r}: expected "
            "'vmap'|'grid'|'<mode>:<C>[,scan|grid]'")
    head = parts[0].split(":")
    if len(head) > 2 or any(not p for p in head):
        raise ValueError(
            f"malformed batch spec {batch!r}: chunk goes after a single "
            "':' as in 'vmap:4' or 'vmap:auto'")
    mode = head[0]
    if mode not in _MODES:
        raise ValueError(
            f"batch mode must be 'vmap' or 'grid', got {mode!r} "
            f"(in {batch!r})")
    chunk = 0
    if len(head) == 2:
        if head[1] == "auto":
            chunk = AUTO
        else:
            try:
                chunk = int(head[1])
            except ValueError:
                raise ValueError(
                    f"batch chunk size must be an integer or 'auto', got "
                    f"{head[1]!r} (in {batch!r})") from None
            if chunk <= 0:
                raise ValueError(
                    f"batch chunk size must be positive, got {chunk} "
                    f"(in {batch!r})")
    loop = "scan"
    if len(parts) == 2:
        if not chunk:
            raise ValueError(
                f"batch loop mode {parts[1]!r} requires a chunk size "
                f"('vmap:C,{parts[1]}'), got {batch!r}")
        loop = parts[1]
        if loop not in _LOOPS:
            raise ValueError(
                f"batch loop mode must be 'scan' or 'grid', got {loop!r} "
                f"(in {batch!r})")
    return BatchSpec(mode=mode, chunk=chunk, loop=loop)


# ---------------------------------------------------------------------------
# Ragged-M padding and the chunk loop
# ---------------------------------------------------------------------------


def pad_members(x: torch.Tensor, n_members: int, padded: int) -> torch.Tensor:
    """Pad the leading member axis from M to ``padded`` by replicating the
    last member (zeros would send NaN through divisions in padded columns;
    replicated real data streams through every kernel unchanged)."""
    if padded == n_members:
        return x
    rep = x[n_members - 1:n_members].expand(
        (padded - n_members,) + tuple(x.shape[1:]))
    return torch.cat([x, rep], dim=0)


def pad_wrapped(runner: Callable, n_members: int, padded: int) -> Callable:
    """Wrap an Mp-member runner for ragged-M callers: replicate-pad the
    member axis on the way in, slice the pad off on the way out."""
    def run(fields: Mapping[str, Any], params=None) -> dict:
        out = runner({k: pad_members(v, n_members, padded)
                      for k, v in fields.items()}, params)
        return {k: v[:n_members] for k, v in out.items()}
    return run


def scan_chunked(runner: Callable, n_members: int, chunk: int) -> Callable:
    """Run M members as a loop over ceil(M/C) chunks of a C-member
    ``runner``.  Each chunk's results are written into M-member outputs
    allocated at the first chunk, so only one chunk's transients are live
    at a time; a ragged last chunk is replicate-padded (:func:`pad_members`)
    and its pad dropped."""
    n_chunks = -(-n_members // chunk)

    def run(fields: Mapping[str, torch.Tensor], params=None) -> dict:
        out: dict[str, torch.Tensor] = {}
        for c in range(n_chunks):
            lo, hi = c * chunk, min((c + 1) * chunk, n_members)
            res = runner({k: pad_members(v[lo:hi], hi - lo, chunk)
                          for k, v in fields.items()}, params)
            for k, v in res.items():
                if k not in out:
                    out[k] = v.new_empty((n_members,) + tuple(v.shape[1:]))
                out[k][lo:hi] = v[:hi - lo]
        return out

    return run
