"""Persistent tuning cache and stencil fingerprints (paper §VI-B workflow
support).

Schedule search is a pure function of (stencil IR, domain, backend,
hardware), so its results are cached on disk and survive process restarts:
a second ``autotune.tune_stencil`` or ``transfer_tuning.tune_cutouts`` run
with the same inputs skips the search entirely.  Keys are content hashes —
``(stencil fingerprint, schedule, backend name, hardware name)`` — never
object identities, so entries are valid across runs and machines.  Writes
re-read and merge the on-disk state first, so concurrent processes append
rather than clobber (last writer wins only on the same key).

The store is a single JSON file, ``./.repro_cache/torch_tuning.json`` by
default (the directory is overridable via ``$REPRO_CACHE_DIR`` or
:func:`set_default_cache`), written atomically.  It sits beside the
reference package's ``tuning.json`` under its own name, so the two packages
never write one file.  Hit/miss counters make cache behavior observable in
tests and benchmarks.

:func:`stencil_fingerprint` hashes the same payload as the reference
package, so a stencil parsed by either package gets the same fingerprint.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Any

from ..stencil.ir import Stencil
from ..stencil.schedule import Schedule

_CACHE_VERSION = 1

#: file name of the port's store inside the cache directory
CACHE_FILE = "torch_tuning.json"

#: Version of the analytical cost/schedule model — the reference package's
#: (``model_cost``, ``node_bound_seconds``, schedule enumeration and the
#: fusion transforms are ported unchanged).  Folded into every tuning key by
#: tune_stencil / tune_cutouts, so persisted results of another model are
#: never served.  Bump it whenever any of those change behavior.
COST_MODEL_VERSION = 8


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


def make_key(*parts: Any) -> str:
    """Stable hash of arbitrary JSON-encodable key parts."""
    def norm(p):
        if isinstance(p, Stencil):
            return stencil_fingerprint(p)
        if isinstance(p, Schedule):
            return p.to_dict()
        if dataclasses.is_dataclass(p) and not isinstance(p, type):
            return dataclasses.asdict(p)
        if isinstance(p, (tuple, list)):
            return [norm(x) for x in p]
        return p

    blob = json.dumps([norm(p) for p in parts], sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    puts: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def reset(self) -> None:
        self.hits = self.misses = self.puts = 0


class TuningCache:
    """On-disk key→JSON store with hit/miss accounting."""

    def __init__(self, path: str | os.PathLike | None = None):
        if path is None:
            root = os.environ.get("REPRO_CACHE_DIR", ".repro_cache")
            path = os.path.join(root, CACHE_FILE)
        self.path = Path(path)
        if self.path.is_dir():
            self.path = self.path / CACHE_FILE
        self.stats = CacheStats()
        self._data: dict[str, Any] | None = None

    # -- persistence ---------------------------------------------------------
    def _read_disk(self) -> dict[str, Any]:
        try:
            raw = json.loads(self.path.read_text())
            if raw.get("version") == _CACHE_VERSION:
                return raw.get("entries", {})
        except (OSError, ValueError):
            pass
        return {}

    def _load(self) -> dict[str, Any]:
        if self._data is None:
            self._data = self._read_disk()
        return self._data

    def _persist(self) -> None:
        # the cache is a pure optimization: any write failure (read-only
        # checkout, unwritable $REPRO_CACHE_DIR) degrades to uncached
        tmp = None
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            # merge over the latest on-disk state: another process may have
            # added entries since we loaded; don't clobber them
            merged = self._read_disk()
            merged.update(self._data or {})
            self._data = merged
            blob = json.dumps({"version": _CACHE_VERSION, "entries": merged},
                              indent=0)
            fd, tmp = tempfile.mkstemp(dir=self.path.parent,
                                       prefix=self.path.name, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                f.write(blob)
            os.replace(tmp, self.path)
        except OSError:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    # -- API -----------------------------------------------------------------
    def get(self, key: str) -> Any | None:
        val = self._load().get(key)
        if val is None:
            self.stats.misses += 1
        else:
            self.stats.hits += 1
        return val

    def put(self, key: str, value: Any) -> None:
        self._load()[key] = value
        self.stats.puts += 1
        self._persist()

    def clear(self) -> None:
        self._data = {}
        try:
            self.path.unlink()
        except OSError:
            pass

    def __len__(self) -> int:
        return len(self._load())


_default_cache: TuningCache | None = None


def default_cache() -> TuningCache:
    global _default_cache
    if _default_cache is None:
        _default_cache = TuningCache()
    return _default_cache


def set_default_cache(cache: TuningCache | None) -> None:
    """Swap the process-wide cache (tests point it at a tmp path)."""
    global _default_cache
    _default_cache = cache
