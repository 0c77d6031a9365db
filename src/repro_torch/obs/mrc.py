"""Online miss-ratio curves via SHARDS spatial sampling.

The cache-split tuner (``repro.tuning.tenancy``) prices candidate
splits from each tenant's **miss-ratio curve** (MRC).  Offline it
builds one from an exact object-access profile; this module estimates
the same curve **online**, from the live cache access stream, using the
SHARDS idea (Waldspurger et al., FAST'15): hash every key into [0, 1)
and track reuse distances only for keys below a fixed sampling
threshold ``R``, then scale each measured stack distance by ``1/R``.
Spatial (per-key) sampling keeps every sampled key's *complete* reuse
sequence, which is what makes the scaled distances unbiased — temporal
sampling would not.

Determinism and the observer contract:

* the sampling decision is a pure hash (``crc32(repr(key))``) — no RNG
  anywhere, so two identical runs produce identical curves;
* the estimator attaches to :class:`repro_torch.cache.slru.SLRUCache` via its
  ``observer`` hook (a *sampled ghost list*: key metadata only, no
  payload bytes) and reads the stream without mutating the cache, so
  MRC-profiled runs stay bit-exact against the goldens.

Memory is bounded: per tenant, one ordered dict over *sampled* keys
plus a ~200-bucket log histogram of scaled distances, independent of
run length at a fixed sampling rate.

Accuracy (documented tolerance, asserted in
``tests/test_explain.py``): against the exact Che-approximation curve
on a synthetic zipf profile the SHARDS estimate is within **0.05 mean /
0.10 max** absolute miss-ratio error at ``sample_rate=1.0`` (exact
stack distances; residual error is LRU-vs-Che model difference) and
within **0.08 mean / 0.15 max** at ``sample_rate=0.25``.

The port's own copy of ``repro.obs.mrc``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from collections import OrderedDict

__all__ = ["MRCConfig", "TenantMRC", "MRCProfiler", "default_size_grid",
           "mrc_miss_ratio"]

#: log2 sub-buckets per octave for the distance histogram (~19% bucket
#: width — finer than the tolerance above, so bucketing is not the
#: accuracy bottleneck).
_BUCKETS_PER_OCTAVE = 4


@dataclasses.dataclass(frozen=True)
class MRCConfig:
    """Knobs for online MRC profiling."""

    sample_rate: float = 0.5
    #: curve evaluation grid in bytes; None derives a geometric grid
    #: around the fleet's per-instance cache budget.
    sizes: tuple[int, ...] | None = None

    def __post_init__(self) -> None:
        if not (0.0 < self.sample_rate <= 1.0):
            raise ValueError(f"sample_rate must be in (0, 1], got "
                             f"{self.sample_rate}")
        if self.sizes is not None and not self.sizes:
            raise ValueError("sizes grid must be non-empty when given")

    def to_dict(self) -> dict:
        return dict(sample_rate=self.sample_rate,
                    sizes=list(self.sizes) if self.sizes else None)


def default_size_grid(ref_bytes: int) -> tuple[int, ...]:
    """Geometric grid around a reference cache size: ref/16 .. 8*ref."""
    ref = max(int(ref_bytes), 1024)
    return tuple(ref * 2 ** i // 16 * 16 or 16 for i in range(-4, 4))


def _key_hash01(key) -> float:
    """Deterministic spatial hash of a cache key into [0, 1).

    crc32 alone is linear in GF(2), so near-identical keys (``(tid, i)``
    tuples differing in one digit) land on correlated values; the
    murmur3 fmix32 finalizer avalanches the bits so the sampled key set
    is unbiased even over tiny structured key spaces."""
    h = zlib.crc32(repr(key).encode()) & 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h / 2 ** 32


class TenantMRC:
    """SHARDS reuse-distance estimator for one tenant's access stream."""

    def __init__(self, sample_rate: float = 0.5):
        self.sample_rate = float(sample_rate)
        #: sampled keys, LRU order (MRU last) -> last-known size in bytes
        self._stack: OrderedDict = OrderedDict()
        #: log2 bucket index -> count of scaled reuse distances
        self._dist: dict[int, int] = {}
        self.accesses = 0           # every access, sampled or not
        self.sampled = 0
        self.cold = 0               # sampled first-touches (inf distance)
        self.size_sum = 0.0         # over sampled sized accesses
        self.size_n = 0

    # ------------------------------------------------------------ intake --
    def access(self, key, nbytes: int | None = None) -> None:
        """One cache lookup.  ``nbytes`` may be unknown (None) at lookup
        time; :meth:`learn_size` backfills it from the put path."""
        self.accesses += 1
        if _key_hash01(key) >= self.sample_rate:
            return
        self.sampled += 1
        stack = self._stack
        if key in stack:
            # byte stack distance: this key + every sampled key touched
            # more recently than its previous access (MRU side of the
            # ordered dict, walked until we meet the key itself)
            dist = 0.0
            for k2 in reversed(stack):
                if k2 == key:
                    break
                dist += stack[k2]
            size = stack.pop(key)
            if nbytes is not None:
                size = nbytes
            dist += size
            self._record(dist / self.sample_rate)
            stack[key] = size
        else:
            self.cold += 1
            stack[key] = nbytes if nbytes is not None else 0
        if nbytes is not None:
            self.size_sum += nbytes
            self.size_n += 1

    def learn_size(self, key, nbytes: int) -> None:
        """Backfill a sampled key's size from the cache fill path."""
        if key in self._stack and self._stack[key] == 0:
            self._stack[key] = nbytes
        if _key_hash01(key) < self.sample_rate:
            self.size_sum += nbytes
            self.size_n += 1

    def _record(self, dist: float) -> None:
        if dist <= 0:
            b = 0
        else:
            b = max(0, int(math.log2(dist) * _BUCKETS_PER_OCTAVE))
        self._dist[b] = self._dist.get(b, 0) + 1

    # ------------------------------------------------------------- curve --
    @property
    def mean_obj_bytes(self) -> float:
        return self.size_sum / self.size_n if self.size_n else 0.0

    def miss_ratio(self, cache_bytes: int) -> float:
        """Estimated miss ratio of an LRU-ish cache of ``cache_bytes``
        for this stream: fraction of sampled accesses whose scaled
        reuse distance exceeds the size, plus all cold misses."""
        if self.sampled == 0:
            return 1.0
        if cache_bytes <= 0:
            return 1.0
        misses = float(self.cold)
        log_c = math.log2(cache_bytes) * _BUCKETS_PER_OCTAVE
        for b, n in self._dist.items():
            if b > log_c:
                misses += n
            elif b + 1 > log_c:
                # C falls inside this bucket: log-uniform interpolation
                misses += n * (b + 1 - log_c)
        return min(1.0, misses / self.sampled)

    def curve(self, sizes) -> list[float]:
        return [round(self.miss_ratio(int(s)), 6) for s in sizes]

    def to_dict(self, sizes) -> dict:
        return dict(
            accesses=self.accesses, sampled=self.sampled,
            cold=self.cold, sampled_keys=len(self._stack),
            mean_obj_bytes=round(self.mean_obj_bytes, 3),
            sizes=[int(s) for s in sizes],
            miss_ratio=self.curve(sizes))


class MRCProfiler:
    """Per-tenant online MRC over a fleet's cache access stream.

    Implements the :class:`~repro_torch.cache.slru.SLRUCache` observer
    protocol (``record_get`` / ``record_put``); one profiler instance
    observes every instance cache in the fleet, so the estimated curve
    models the *aggregate* cache — the same operating point the
    cache-split tuner prices.  Tenant identity comes from the fleet's
    namespaced fetch keys ``(tid, *native_key)``.
    """

    def __init__(self, cfg: MRCConfig | None = None, *,
                 ref_bytes: int = 0,
                 tenant_names: dict[int, str] | None = None):
        self.cfg = cfg or MRCConfig()
        self.ref_bytes = int(ref_bytes)
        self.sizes = tuple(self.cfg.sizes) if self.cfg.sizes \
            else default_size_grid(self.ref_bytes)
        self.tenant_names = dict(tenant_names or {})
        self._tenants: dict[int, TenantMRC] = {}

    # -------------------------------------------------- observer protocol --
    @staticmethod
    def _tid(key) -> int:
        if isinstance(key, tuple) and key and isinstance(key[0], int):
            return key[0]
        return 0

    def _est(self, tid: int) -> TenantMRC:
        est = self._tenants.get(tid)
        if est is None:
            est = self._tenants[tid] = TenantMRC(self.cfg.sample_rate)
        return est

    def record_get(self, key, hit: bool) -> None:
        self._est(self._tid(key)).access(key)

    def record_put(self, key, nbytes: int) -> None:
        self._est(self._tid(key)).learn_size(key, nbytes)

    # ------------------------------------------------------------- wiring --
    def install(self, cache) -> None:
        """Attach to a cache object: a bare :class:`SLRUCache`, or a
        tenancy assembly (``.inner`` shared SLRU / ``.parts`` per-tenant
        SLRUs).  Unknown cache shapes (PinnedCache, None) are skipped —
        MRC needs an LRU-family access stream."""
        if cache is None:
            return
        if hasattr(cache, "set_observer"):
            cache.set_observer(self)
        elif hasattr(cache, "observer"):
            cache.observer = self
        elif hasattr(cache, "inner"):
            self.install(cache.inner)
        elif hasattr(cache, "parts"):
            for part in cache.parts.values():
                self.install(part)

    def wrap_factory(self, factory):
        """Wrap a cache factory so rebuilt caches (cold-cache fault
        recovery, autoscale scale-up) come back with the profiler
        already attached."""
        def _make():
            cache = factory()
            self.install(cache)
            return cache
        return _make

    # ---------------------------------------------------------- reporting --
    def _name(self, tid: int) -> str:
        return self.tenant_names.get(tid) or f"t{tid}"

    def publish(self, registry) -> None:
        """Live gauges: ``cache.mrc.<tenant>.mr`` (miss ratio at the
        reference size), ``.mr_half`` / ``.mr_double`` (curve slope
        around the operating point) and ``.samples``."""
        ref = self.ref_bytes
        for tid in sorted(self._tenants):
            est = self._tenants[tid]
            name = self._name(tid)
            registry.gauge(f"cache.mrc.{name}.mr").set(
                est.miss_ratio(ref))
            registry.gauge(f"cache.mrc.{name}.mr_half").set(
                est.miss_ratio(ref // 2))
            registry.gauge(f"cache.mrc.{name}.mr_double").set(
                est.miss_ratio(ref * 2))
            registry.gauge(f"cache.mrc.{name}.samples").set(est.sampled)

    def to_dict(self, wall_s: float | None = None) -> dict:
        """The ``mrc`` report block (and the ``--mrc`` artifact schema
        ``tune_cache_split`` accepts): per-tenant curves plus the demand
        rate the split screen prices misses against."""
        tenants = []
        for tid in sorted(self._tenants):
            est = self._tenants[tid]
            row = dict(tid=tid, name=self._name(tid),
                       **est.to_dict(self.sizes))
            if wall_s and wall_s > 0:
                row["demand_bytes_per_s"] = round(
                    est.accesses * est.mean_obj_bytes / wall_s, 3)
            tenants.append(row)
        return dict(sample_rate=self.cfg.sample_rate,
                    ref_bytes=self.ref_bytes,
                    sizes=[int(s) for s in self.sizes],
                    tenants=tenants)


def mrc_miss_ratio(sizes, miss_ratio, cache_bytes: float) -> float:
    """Interpolate a sampled miss-ratio curve at ``cache_bytes``
    (log-linear in size, clamped at the grid ends) — how the cache-split
    tuner reads ``--mrc`` artifacts."""
    pts = sorted(zip((float(s) for s in sizes),
                     (float(m) for m in miss_ratio)))
    if not pts:
        raise ValueError("empty miss-ratio curve")
    c = float(cache_bytes)
    if c <= pts[0][0]:
        return pts[0][1]
    if c >= pts[-1][0]:
        return pts[-1][1]
    for (s0, m0), (s1, m1) in zip(pts, pts[1:]):
        if s0 <= c <= s1:
            if s1 <= s0:
                return m1
            f = (math.log(c) - math.log(s0)) / \
                (math.log(s1) - math.log(s0))
            return m0 + f * (m1 - m0)
    return pts[-1][1]
