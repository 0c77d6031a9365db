"""Scan-resistant segmented LRU (SLRU) cache — the paper's cache policy
(§5.1: "scan-resistant LRU eviction policy [50]").

Two segments, both LRU-ordered:
* probation — first-time entries land here; a scan can only ever pollute
  this segment.
* protected — entries re-referenced while in probation are promoted;
  protected evictions demote back to probation (not out of the cache).

Capacities are in bytes (cache sizes in the paper are 1/4/8 GB).

The port's own copy of ``repro.cache.slru``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable, Iterable

CACHE_POLICIES = ("none", "slru", "pinned")


def make_cache(policy: str, capacity_bytes: int = 0,
               pinned_keys: Iterable | None = None):
    """Instantiate the segment cache for a policy name (or None for no
    cache).  The single construction point shared by the serving engine and
    the fleet shard servers — unknown policies fail here, loudly.
    """
    if policy == "none":
        return None
    if policy == "slru":
        return SLRUCache(capacity_bytes) if capacity_bytes > 0 else None
    if policy == "pinned":
        if pinned_keys is None:
            raise ValueError(
                "cache_policy='pinned' requires pinned_keys (a set of "
                "object keys to pin)")
        keys = set(pinned_keys)
        return PinnedCache(keys) if keys else None
    raise ValueError(
        f"unknown cache policy {policy!r}; one of {CACHE_POLICIES}")


class SLRUCache:
    def __init__(self, capacity_bytes: int, protected_frac: float = 0.8):
        assert capacity_bytes >= 0
        self.capacity = int(capacity_bytes)
        self.protected_frac = float(protected_frac)
        self.protected_cap = int(capacity_bytes * protected_frac)
        self.probation: OrderedDict[Hashable, int] = OrderedDict()
        self.protected: OrderedDict[Hashable, int] = OrderedDict()
        self.probation_bytes = 0
        self.protected_bytes = 0
        self.hits = 0
        self.misses = 0
        #: optional ``fn(key, nbytes)`` fired on every *capacity* eviction
        #: (not on explicit remove/invalidate) — the hook ghost lists and
        #: other second-chance structures attach to.
        self.on_evict: Callable[[Hashable, int], None] | None = None
        #: optional pure observer of the access stream: ``record_get(key,
        #: hit)`` on every lookup, ``record_put(key, nbytes)`` on every
        #: miss-fill.  The sampled-ghost MRC estimator
        #: (:mod:`repro_torch.obs.mrc`) attaches here; observers read, never
        #: mutate, so cache behaviour is byte-identical with one attached.
        self.observer = None

    # ------------------------------------------------------------ stats --
    @property
    def used_bytes(self) -> int:
        return self.probation_bytes + self.protected_bytes

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def reset_stats(self) -> None:
        self.hits = 0
        self.misses = 0

    def __contains__(self, key: Hashable) -> bool:
        return key in self.probation or key in self.protected

    def __len__(self) -> int:
        return len(self.probation) + len(self.protected)

    # ------------------------------------------------------------ logic --
    def get(self, key: Hashable) -> bool:
        """Lookup; promotes on probation hit.  Returns hit/miss."""
        hit = self._get(key)
        if self.observer is not None:
            self.observer.record_get(key, hit)
        return hit

    def _get(self, key: Hashable) -> bool:
        if self.capacity == 0:
            self.misses += 1
            return False
        if key in self.protected:
            self.protected.move_to_end(key)
            self.hits += 1
            return True
        if key in self.probation:
            size = self.probation.pop(key)
            self.probation_bytes -= size
            self._insert_protected(key, size)
            self.hits += 1
            return True
        self.misses += 1
        return False

    def put(self, key: Hashable, nbytes: int) -> None:
        """Insert after a miss-fetch.  New entries go to probation."""
        if self.observer is not None:
            self.observer.record_put(key, nbytes)
        if self.capacity == 0 or nbytes > self.capacity:
            return
        if key in self.protected or key in self.probation:
            return
        self.probation[key] = nbytes
        self.probation_bytes += nbytes
        self._evict_probation()

    def _insert_protected(self, key: Hashable, nbytes: int) -> None:
        self.protected[key] = nbytes
        self.protected_bytes += nbytes
        # demote protected LRU back to probation until it fits
        while self.protected_bytes > self.protected_cap and self.protected:
            k, s = self.protected.popitem(last=False)
            self.protected_bytes -= s
            self.probation[k] = s
            self.probation_bytes += s
        self._evict_probation()

    def _evict_probation(self) -> None:
        while self.used_bytes > self.capacity and self.probation:
            k, s = self.probation.popitem(last=False)
            self.probation_bytes -= s
            if self.on_evict is not None:
                self.on_evict(k, s)

    # ---------------------------------------------------------- resizing --
    def set_capacity(self, capacity_bytes: int) -> None:
        """Resize the byte budget in place (the weighted-quota policy's
        reallocation step).  A shrink demotes protected overflow and then
        evicts probation LRU-first until the cache fits the new budget;
        a grow simply raises the ceilings — content is preserved."""
        if capacity_bytes < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity_bytes}")
        self.capacity = int(capacity_bytes)
        self.protected_cap = int(capacity_bytes * self.protected_frac)
        while self.protected_bytes > self.protected_cap and self.protected:
            k, s = self.protected.popitem(last=False)
            self.protected_bytes -= s
            self.probation[k] = s
            self.probation_bytes += s
        self._evict_probation()

    # ----------------------------------------------------- invalidation --
    def remove(self, key: Hashable) -> int:
        """Drop ``key`` from whichever segment holds it (compaction
        rewrote the object, so the cached copy is stale).  Returns the
        bytes freed (0 when the key was not cached); byte accounting is
        adjusted on the segment the entry actually occupied."""
        if key in self.protected:
            size = self.protected.pop(key)
            self.protected_bytes -= size
            return size
        if key in self.probation:
            size = self.probation.pop(key)
            self.probation_bytes -= size
            return size
        return 0

    def invalidate(self, key: Hashable) -> bool:
        """``remove`` as a hit/miss predicate (True when a stale copy
        was actually dropped)."""
        present = key in self
        self.remove(key)
        return present


class PinnedCache:
    """Fixed-content cache: always hits on the pinned key set.

    Models the paper's A3 suggestion for DiskANN under non-IOPS-saturated
    settings: pin the entry-point neighbourhood (Fig 23 shows those rounds
    carry near-1 hit rates) instead of running a general LRU.
    """

    def __init__(self, keys: set):
        self.keys = set(keys)
        self.hits = 0
        self.misses = 0

    @property
    def used_bytes(self) -> int:  # bookkeeping parity with SLRUCache
        return 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def reset_stats(self) -> None:
        self.hits = 0
        self.misses = 0

    def __contains__(self, key) -> bool:
        return key in self.keys

    def get(self, key) -> bool:
        if key in self.keys:
            self.hits += 1
            return True
        self.misses += 1
        return False

    def put(self, key, nbytes: int) -> None:
        pass                     # contents are fixed

    # ----------------------------------------------------- invalidation --
    def remove(self, key) -> int:
        """Un-pin a rewritten object: its pinned copy is stale and the
        policy cannot refresh content, so the key stops hitting."""
        self.keys.discard(key)
        return 0                 # pinned bookkeeping carries no bytes

    def invalidate(self, key) -> bool:
        present = key in self.keys
        self.keys.discard(key)
        return present
