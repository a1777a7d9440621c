"""The content-addressed service cache: fingerprint → compiled Executable.

A copy of ``repro/serve/cache.py``.

The service-level extension of the :mod:`repro_torch.api` derive cache: where
that LRU absorbs re-derivations *within* one plan's schedule/lower chain,
this one makes whole compiled artifacts addressable *across* submissions —
``submit`` once, then every ``run`` against the returned
:meth:`~repro_torch.api.Plan.fingerprint` skips trace/optimize/lower/compile
entirely.  Two levels of addressing:

* **source digest** — SHA-256 of the canonical submission body.  A
  resubmission of byte-identical source is a cache hit without even
  parsing the workflow.
* **fingerprint** — :meth:`Plan.fingerprint`, the content address of the
  compiled plan.  Different sources that compile to the same plan (e.g. a
  DAG-JSON and the ``.swirl`` text of its encoding) converge on one entry;
  every source digest that led to an entry is kept as an alias and evicted
  with it.

Thread-safe; eviction is LRU on the fingerprint level with hit / miss /
eviction counters exposed via :meth:`PlanCache.stats` (served by the
gateway's ``GET /v1/stats``).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any

from repro_torch.api import Executable, Plan

__all__ = ["CacheEntry", "PlanCache"]

logger = logging.getLogger("repro_torch.serve.cache")


@dataclass
class CacheEntry:
    """One compiled workflow held by the service cache."""

    fingerprint: str
    plan: Plan
    executable: Executable
    meta: dict[str, Any] = field(default_factory=dict)
    compile_seconds: float = 0.0
    created_unix: float = field(default_factory=time.time)
    #: Serialises whole runs when the backend's compiled program does not
    #: support overlapping batches (e.g. ``inprocess``); the threaded
    #: backend never takes it.
    run_lock: threading.Lock = field(default_factory=threading.Lock)
    hits: int = 0

    def summary(self) -> dict[str, Any]:
        return {
            "fingerprint": self.fingerprint,
            "steps": list(self.plan.steps()),
            "locations": sorted(self.plan.system.locations()),
            "actions": self.plan.system.total_actions(),
            "communications": self.plan.system.comm_count(),
            "compile_seconds": round(self.compile_seconds, 6),
            "hits": self.hits,
            **self.meta,
        }


class PlanCache:
    """Bounded LRU of :class:`CacheEntry`, addressed two ways (see module).

    ``capacity`` bounds the number of *compiled plans* held live (each
    entry pins a lowered program and a backend artifact); least recently
    *used* (submitted to or run against) is evicted first.
    """

    def __init__(self, capacity: int = 128):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, CacheEntry]" = OrderedDict()
        self._by_source: dict[str, str] = {}  # source digest → fingerprint
        self._aliases: dict[str, set[str]] = {}  # fingerprint → digests
        self._stats = {
            "hits": 0,
            "misses": 0,
            "evictions": 0,
            "compile_seconds_saved": 0.0,
        }

    # -- lookups -------------------------------------------------------------
    def get(self, fingerprint: str) -> CacheEntry | None:
        """Entry for ``fingerprint``, counting the hit/miss."""
        with self._lock:
            entry = self._entries.get(fingerprint)
            if entry is None:
                self._stats["misses"] += 1
                return None
            self._entries.move_to_end(fingerprint)
            self._stats["hits"] += 1
            self._stats["compile_seconds_saved"] += entry.compile_seconds
            entry.hits += 1
            return entry

    def peek(self, fingerprint: str) -> CacheEntry | None:
        """Entry for ``fingerprint`` without touching LRU order or stats."""
        with self._lock:
            return self._entries.get(fingerprint)

    def lookup_source(self, source_digest: str) -> CacheEntry | None:
        """Entry previously compiled from this exact source, if any."""
        with self._lock:
            fp = self._by_source.get(source_digest)
            entry = self._entries.get(fp) if fp is not None else None
            if entry is None:
                self._stats["misses"] += 1
                return None
            self._entries.move_to_end(entry.fingerprint)
            self._stats["hits"] += 1
            self._stats["compile_seconds_saved"] += entry.compile_seconds
            entry.hits += 1
            return entry

    # -- insertion -----------------------------------------------------------
    def put(
        self, entry: CacheEntry, *, source_digest: str | None = None
    ) -> CacheEntry:
        """Insert ``entry`` (or alias onto an existing equal fingerprint).

        Returns the entry actually cached — when another source already
        compiled to the same fingerprint, the existing artifact wins and
        the new digest becomes an alias for it.
        """
        with self._lock:
            existing = self._entries.get(entry.fingerprint)
            if existing is not None:
                self._entries.move_to_end(entry.fingerprint)
                entry = existing
            else:
                self._entries[entry.fingerprint] = entry
                while len(self._entries) > self.capacity:
                    fp, _ = self._entries.popitem(last=False)
                    for digest in self._aliases.pop(fp, ()):
                        self._by_source.pop(digest, None)
                    self._stats["evictions"] += 1
                    logger.info("evicted %s (LRU, capacity %d)",
                                fp[:12], self.capacity)
            if source_digest is not None:
                self._by_source[source_digest] = entry.fingerprint
                self._aliases.setdefault(entry.fingerprint, set()).add(
                    source_digest
                )
            return entry

    # -- maintenance ---------------------------------------------------------
    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._by_source.clear()
            self._aliases.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def fingerprints(self) -> list[str]:
        with self._lock:
            return list(self._entries)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            total = self._stats["hits"] + self._stats["misses"]
            return {
                **{
                    k: (round(v, 6) if isinstance(v, float) else v)
                    for k, v in self._stats.items()
                },
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hit_rate": (
                    round(self._stats["hits"] / total, 4) if total else 0.0
                ),
            }
