"""The content-addressed staged-table cache (LRU over a byte budget).

Counterpart of ``avenir_tpu/plan/cache.py``. Process-global: the CLI
verbs run in one process in tests, smokes and notebook chains, so a
``BayesianDistribution`` followed by a ``NearestNeighbor`` shares one
staged train table. A hit hands out the same tensors again, so no node
may modify a cached table in place (none does).

Hits, misses, bytes and evictions publish as hub gauges (``plan.cache.*``)
through ``set_hub_gauges_if_live``. The budget is ``plan.cache.budget.bytes``
(default 512 MiB, or ``AVENIR_TPU_TORCH_PLAN_CACHE_BYTES``).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional

# sentinel distinguishing "absent" from a cached None
MISS = object()

_DEFAULT_BUDGET = int(os.environ.get("AVENIR_TPU_TORCH_PLAN_CACHE_BYTES",
                                     512 << 20))


def nbytes_of(value: Any) -> int:
    """Rough byte accounting for the LRU budget: exact for torch tensors
    on any device and numpy arrays (the staged tables and binned catalogs
    are arrays all the way down), small fixed overheads for the host-side
    scaffolding."""
    seen = set()

    def walk(v) -> int:
        if v is None or isinstance(v, (bool, int, float)):
            return 16
        if isinstance(v, str):
            return 56 + len(v)
        if isinstance(v, bytes):
            return 56 + len(v)
        nb = getattr(v, "nbytes", None)
        if nb is not None:
            try:
                return int(nb)
            except Exception:
                pass
        if id(v) in seen:
            return 0
        seen.add(id(v))
        if isinstance(v, (list, tuple, set, frozenset)):
            return 56 + sum(walk(x) for x in v)
        if isinstance(v, dict):
            return 64 + sum(walk(k) + walk(x) for k, x in v.items())
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return 64 + sum(walk(getattr(v, f.name))
                            for f in dataclasses.fields(v))
        d = getattr(v, "__dict__", None)
        if d is not None:
            return 64 + walk(d)
        return 64

    return walk(value)


class StagedTableCache:
    """LRU keyed by content fingerprint, bounded by a byte budget."""

    def __init__(self, budget_bytes: int = _DEFAULT_BUDGET):
        self.budget_bytes = int(budget_bytes)
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.oversize_skips = 0

    # -- lookup -------------------------------------------------------------
    def contains(self, key: str) -> bool:
        """NON-mutating probe (no stats, no LRU touch) — what --explain
        and the scheduler's skip pre-pass use."""
        with self._lock:
            return key in self._entries

    def get(self, key: str) -> Any:
        """Value on hit (moved to MRU), :data:`MISS` otherwise."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return MISS
            self._entries.move_to_end(key)
            self.hits += 1
            return entry[0]

    # -- insertion ----------------------------------------------------------
    def put(self, key: str, value: Any,
            nbytes: Optional[int] = None) -> bool:
        """Insert (True) unless the single entry exceeds the whole budget
        (False — caching it would just evict everything else)."""
        size = nbytes_of(value) if nbytes is None else int(nbytes)
        with self._lock:
            if size > self.budget_bytes:
                self.oversize_skips += 1
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, size)
            self._bytes += size
            while self._bytes > self.budget_bytes and self._entries:
                _, (_, evicted_size) = self._entries.popitem(last=False)
                self._bytes -= evicted_size
                self.evictions += 1
            return True

    # -- management ---------------------------------------------------------
    def set_budget(self, budget_bytes: int) -> None:
        with self._lock:
            self.budget_bytes = int(budget_bytes)
            while self._bytes > self.budget_bytes and self._entries:
                _, (_, evicted_size) = self._entries.popitem(last=False)
                self._bytes -= evicted_size
                self.evictions += 1

    def clear(self) -> None:
        """Drop entries AND counters — the tests'/benches' cold-cache
        reset."""
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self.hits = self.misses = 0
            self.evictions = self.oversize_skips = 0

    # -- introspection ------------------------------------------------------
    @property
    def hit_fraction(self) -> float:
        total = self.hits + self.misses
        return (self.hits / total) if total else 0.0

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "oversize_skips": self.oversize_skips,
                "entries": len(self._entries),
                "bytes": self._bytes,
                "budget_bytes": self.budget_bytes,
                "hit_fraction": self.hit_fraction,
            }

    def publish_gauges(self) -> None:
        from avenir_tpu_torch.obs.exporters import set_hub_gauges_if_live
        set_hub_gauges_if_live({f"plan.cache.{k}": float(v)
                                for k, v in self.stats().items()})


_CACHE: Optional[StagedTableCache] = None
_CACHE_LOCK = threading.Lock()


def staged_cache() -> StagedTableCache:
    global _CACHE
    with _CACHE_LOCK:
        if _CACHE is None:
            _CACHE = StagedTableCache()
        return _CACHE


def reset_cache() -> None:
    """Forget everything (entries + stats) — the cold-cache boundary."""
    staged_cache().clear()
