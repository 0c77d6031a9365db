"""Tiered storage data path: DRAM cache -> per-shard local NVMe ->
remote object store.

The flat hierarchy (segment cache over one remote :class:`StorageSim`)
cannot reach the billion-scale operating points the paper's cloud-vs-
disk analysis turns on — index far larger than DRAM, where a second
local tier breaks the performance/size tradeoff.  This module inserts
that tier: each shard instance may own a local NVMe device, modeled as
a second :class:`StorageSim` (its own IOPS token bucket, its own
bandwidth pipe, ~100 us base latency — :data:`repro_torch.storage.spec.NVME`)
plus a byte-accounted LRU *residency map* deciding which objects live
on the device.

Promotion/demotion is a policy axis, mirroring ``tenancy/policy.py``:

* ``admit-always`` — every remote miss-fetch is admitted on completion;
  simple, but one scan can wash the device.
* ``second-hit`` — a remote fetch is admitted only if its key is on the
  ghost list (it has missed before); first touches only leave a ghost
  entry.  The ghost list is key metadata only, byte-bounded to the
  device capacity — the same second-chance structure the weighted
  tenant-cache policy uses.

Demotion is eviction: NVMe content is a clean copy of remote data, so
dropping the LRU resident is free.  Compaction output placement is a
second policy axis (``writeback``): write-through sends compaction PUTs
straight to the object store as before; write-back lands them on the
local device first — readable at local latency immediately — and
flushes to the object store asynchronously (the PUT bill is deferred,
not avoided).

The contract that keeps the tier safe: capacity 0 builds no tier at
all — no second ``StorageSim`` is constructed, so kernel RNG stream
names and event sequences are byte-identical to the flat hierarchy and
every pre-tier golden still reproduces bit-exactly.

The port's own copy of ``repro.storage.tier``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Hashable

from repro_torch.sim.kernel import Kernel
from repro_torch.storage.simulator import StorageSim
from repro_torch.storage.spec import NVME, StorageSpec

TIER_POLICIES = ("admit-always", "second-hit")


@dataclasses.dataclass(frozen=True)
class TierConfig:
    """Per-instance NVMe tier knobs (``--nvme-gb`` and friends)."""

    capacity_bytes: int
    policy: str = "second-hit"
    writeback: bool = False
    spec: StorageSpec = NVME

    def __post_init__(self):
        if self.capacity_bytes < 0:
            raise ValueError(f"capacity_bytes must be >= 0, got "
                             f"{self.capacity_bytes}")
        if self.policy not in TIER_POLICIES:
            raise ValueError(f"unknown tier policy {self.policy!r}; "
                             f"one of {TIER_POLICIES}")


class NVMeTier:
    """One shard instance's local NVMe device + residency policy.

    The device itself is a :class:`StorageSim`; this class owns what is
    *on* it.  Residency is an LRU over keys with exact byte accounting
    (``used_bytes <= capacity`` always); the promotion policy decides
    which remote fetches earn a copy.
    """

    def __init__(self, cfg: TierConfig, kernel: Kernel, *, seed: int = 0):
        assert cfg.capacity_bytes > 0, \
            "capacity 0 means no tier — construct nothing"
        self.cfg = cfg
        self.capacity = int(cfg.capacity_bytes)
        self.writeback = cfg.writeback
        self.sim = StorageSim(cfg.spec, kernel, seed=seed)
        self._resident: OrderedDict[Hashable, int] = OrderedDict()
        self.used_bytes = 0
        #: second-hit ghost list: key -> nbytes, byte-bounded to capacity
        self._ghost: OrderedDict[Hashable, int] = OrderedDict()
        self._ghost_bytes = 0
        # cumulative accounting (survives cold restarts — billing and
        # gauges want totals, not the live residency)
        self.hits = 0                 # requests served from the device
        self.misses = 0               # requests that fell through to remote
        self.nvme_bytes = 0           # bytes served from the device
        self.promotions = 0
        self.promoted_bytes = 0
        self.evictions = 0
        self.writeback_admits = 0
        self.writeback_fallbacks = 0  # device full -> write-through

    # ---------------------------------------------------------- lookup --
    def split(self, requests):
        """Partition one batch's cache misses by residency.

        Returns ``(nvme_reqs, remote_reqs)``.  Resident keys are touched
        (LRU) and counted as tier hits; the rest fall through to the
        remote store and are counted as tier misses.
        """
        nvme_reqs, remote_reqs = [], []
        for rq in requests:
            if rq.key in self._resident:
                self._resident.move_to_end(rq.key)
                self.hits += 1
                self.nvme_bytes += rq.nbytes
                nvme_reqs.append(rq)
            else:
                self.misses += 1
                remote_reqs.append(rq)
        return nvme_reqs, remote_reqs

    # ------------------------------------------------------- promotion --
    def note_remote_fetch(self, key: Hashable, nbytes: int) -> None:
        """A remote miss-fetch for ``key`` completed: apply the
        promotion policy."""
        if key in self._resident:          # raced in via write-back
            self._resident.move_to_end(key)
            return
        if self.cfg.policy == "admit-always":
            self._admit(key, nbytes)
            return
        # second-hit: promote only keys that already ghost-missed once
        if key in self._ghost:
            self._ghost_bytes -= self._ghost.pop(key)
            self._admit(key, nbytes)
        else:
            self._ghost[key] = nbytes
            self._ghost_bytes += nbytes
            while self._ghost_bytes > self.capacity and self._ghost:
                _, s = self._ghost.popitem(last=False)
                self._ghost_bytes -= s

    def _admit(self, key: Hashable, nbytes: int) -> None:
        if nbytes > self.capacity:
            return
        self._resident[key] = nbytes
        self.used_bytes += nbytes
        self.promotions += 1
        self.promoted_bytes += nbytes
        while self.used_bytes > self.capacity and self._resident:
            k, s = self._resident.popitem(last=False)
            self.used_bytes -= s
            self.evictions += 1

    def admit_writeback(self, key: Hashable, nbytes: int) -> bool:
        """Place compaction output on the device (write-back policy).

        Returns False when the object cannot fit — the caller's flush
        already went (or goes) straight to the object store, so a full
        device degrades to write-through, never to data loss."""
        if nbytes > self.capacity:
            self.writeback_fallbacks += 1
            return False
        self._ghost_bytes -= self._ghost.pop(key, 0)
        if key in self._resident:
            self.used_bytes -= self._resident.pop(key)
        self._resident[key] = nbytes
        self.used_bytes += nbytes
        self.writeback_admits += 1
        while self.used_bytes > self.capacity and len(self._resident) > 1:
            k, s = self._resident.popitem(last=False)
            self.used_bytes -= s
            self.evictions += 1
        return True

    # ----------------------------------------------------- invalidation --
    def invalidate(self, key: Hashable) -> bool:
        """Drop a rewritten object's stale device copy (and its ghost
        entry — staleness is not a reuse signal).  Neither a tier hit
        nor a tier miss, mirroring the cache invalidation contract."""
        present = key in self._resident
        if present:
            self.used_bytes -= self._resident.pop(key)
        self._ghost_bytes -= self._ghost.pop(key, 0)
        return present

    # ------------------------------------------------- faults / restart --
    def reset(self) -> None:
        """Instance restart: the replacement node's device starts empty
        (cumulative counters survive — they price the whole run)."""
        self._resident.clear()
        self.used_bytes = 0
        self._ghost.clear()
        self._ghost_bytes = 0

    # ------------------------------------------------------------ stats --
    @property
    def resident_keys(self) -> int:
        return len(self._resident)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._resident

    def stats_dict(self) -> dict:
        return dict(
            capacity_bytes=self.capacity,
            used_bytes=self.used_bytes,
            resident_keys=len(self._resident),
            hits=self.hits, misses=self.misses,
            nvme_bytes=self.nvme_bytes,
            promotions=self.promotions,
            promoted_bytes=self.promoted_bytes,
            evictions=self.evictions,
            writeback_admits=self.writeback_admits,
            writeback_fallbacks=self.writeback_fallbacks,
            device_bytes=self.sim.total_bytes,
            device_requests=self.sim.total_requests,
        )


class TieredWritePath:
    """The ingest data plane of a tiered engine.

    :class:`repro.ingest.compaction.IngestAgent` talks to one object
    with ``submit_batch(nbytes, n_requests, on_done, put=...)``.  On a
    write-back tier, compaction PUTs land on the local device first —
    ``on_done`` fires at *local* completion, so the install (and the
    rewritten objects' visibility) precedes the object-store flush —
    and the remote flush PUT is issued asynchronously at that instant.
    Reads (compaction re-reads of sealed objects) and write-through
    PUTs pass through to the remote sim unchanged.
    """

    def __init__(self, tier: NVMeTier, remote: StorageSim):
        self.tier = tier
        self.remote = remote
        self.flush_pending = 0         # remote flush batches in flight
        self.flushes_done = 0

    def submit_batch(self, nbytes: int, n_requests: int,
                     on_done=None, *, put: bool = False):
        if not put or self.tier is None or not self.tier.writeback:
            return self.remote.submit_batch(nbytes, n_requests,
                                            on_done=on_done, put=put)

        def _local_done(tk):
            # install happens now; flush to the object store async
            self.flush_pending += 1
            self.remote.submit_batch(nbytes, n_requests,
                                     on_done=self._flush_done, put=True)
            if on_done is not None:
                on_done(tk)

        return self.tier.sim.submit_batch(nbytes, n_requests,
                                          on_done=_local_done, put=True)

    def _flush_done(self, tk) -> None:
        self.flush_pending -= 1
        self.flushes_done += 1
