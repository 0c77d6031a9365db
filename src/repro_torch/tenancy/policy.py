"""Cache-sharing policies: how one shard instance's byte budget is split
across tenants.

The paper's final study shows cache behaviour dominates cloud-native
search economics; a provider amortises one cache fleet across many
tenants, so the *sharing policy* decides who actually receives those
gains.  Three first-class strategies, all built from the same
:class:`repro_torch.cache.slru.SLRUCache` primitive and all speaking the
engine's cache protocol (``get``/``put``/``remove``/``invalidate``),
keyed by tenant-namespaced fetch keys ``(tid, *native_key)``:

* **shared** — one fleet-wide SLRU per instance; tenants compete freely.
  Best aggregate hit rate when working sets are complementary, worst
  isolation: a scan-heavy tenant evicts everyone (the same failure mode
  §5.1's scan-resistance defends against, now across tenants).  A
  single-tenant ``shared`` assembly degenerates to the plain SLRU —
  that degeneracy is what extends the golden-parity chain.
* **static** — hard byte partitions, one SLRU per tenant sized
  ``total × weight_t / Σ weights``.  Perfect isolation (tenant hit
  rates are independent by construction) at the price of stranded
  bytes: an idle tenant's partition helps nobody.
* **weighted** — static quotas plus **ghost-list-driven adaptive
  reallocation**: each tenant tracks the keys it recently evicted
  (a ghost list holds metadata only — no payload bytes); a miss that
  hits the ghost list means "this tenant would have hit with more
  quota".  Every ``realloc_every`` lookups the policy moves one
  ``step_frac`` slice of the total from the lowest-pressure tenant to
  the highest-pressure one, floored at ``min_frac`` of each tenant's
  weighted fair share so a bursty neighbour can never starve a steady
  tenant below a documented bound.  Each ghost list is byte-bounded to
  ``ghost_frac ×`` the tenant's *current quota* (the ARC shadow-cache
  rule): a tenant whose working set is slightly bigger than its quota
  re-references its ghosts before they age out (high marginal utility
  of more bytes), while a scan tenant's ghosts churn through unseen —
  raw miss volume alone earns no quota.

Quota invariant (property-tested): Σ per-tenant capacities == total at
all times, and no tenant's SLRU ever holds more bytes than its quota.

The port's own copy of ``repro.tenancy.policy``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

from collections import OrderedDict

from repro_torch.cache.slru import SLRUCache

TENANT_CACHE_POLICIES = ("shared", "static", "weighted")

#: adaptive-reallocation defaults (weighted policy)
REALLOC_EVERY = 256          # lookups between reallocation decisions
REALLOC_STEP_FRAC = 0.05     # slice of the total budget moved per step
MIN_QUOTA_FRAC = 0.5         # floor: fraction of weighted fair share
GHOST_FRAC = 1.0             # ghost-list byte bound vs current quota


def _normalized_weights(weights: dict[int, float]) -> dict[int, float]:
    total = sum(weights.values())
    if total <= 0:
        raise ValueError(f"tenant weights must sum > 0, got {weights}")
    return {tid: w / total for tid, w in weights.items()}


class TenantCacheBase:
    """Engine-facing protocol shared by the three assemblies."""

    policy = "base"

    def get(self, key) -> bool:
        raise NotImplementedError

    def put(self, key, nbytes: int) -> None:
        raise NotImplementedError

    def remove(self, key) -> int:
        raise NotImplementedError

    def invalidate(self, key) -> bool:
        return self.remove(key) > 0

    # ------------------------------------------------------ introspection --
    @property
    def used_bytes(self) -> int:
        raise NotImplementedError

    def tenant_used_bytes(self, tid: int) -> int:
        raise NotImplementedError

    def tenant_quota_bytes(self, tid: int) -> int | None:
        """Current byte quota for ``tid`` (None: no per-tenant bound)."""
        return None

    def set_observer(self, observer) -> None:
        """Attach a read-only access-stream observer (the sampled-ghost
        MRC estimator, :mod:`repro_torch.obs.mrc`) to every underlying SLRU.
        Observers see the tenant-namespaced key stream exactly as the
        segments do; they never mutate cache state."""
        inner = getattr(self, "inner", None)
        if inner is not None:
            inner.observer = observer
        for part in getattr(self, "parts", {}).values():
            part.observer = observer


class SharedTenantCache(TenantCacheBase):
    """One fleet-wide SLRU; tenant keys compete in the same segments."""

    policy = "shared"

    def __init__(self, capacity_bytes: int, weights: dict[int, float]):
        self.inner = SLRUCache(capacity_bytes)
        self.tenants = tuple(sorted(weights))

    def get(self, key) -> bool:
        return self.inner.get(key)

    def put(self, key, nbytes: int) -> None:
        self.inner.put(key, nbytes)

    def remove(self, key) -> int:
        return self.inner.remove(key)

    def invalidate(self, key) -> bool:
        return self.inner.invalidate(key)

    @property
    def used_bytes(self) -> int:
        return self.inner.used_bytes

    @property
    def hit_rate(self) -> float:
        return self.inner.hit_rate

    def tenant_used_bytes(self, tid: int) -> int:
        return (sum(s for k, s in self.inner.probation.items()
                    if k[0] == tid)
                + sum(s for k, s in self.inner.protected.items()
                      if k[0] == tid))


class StaticTenantCache(TenantCacheBase):
    """Hard byte partitions: one SLRU per tenant, no trespassing."""

    policy = "static"

    def __init__(self, capacity_bytes: int, weights: dict[int, float]):
        shares = _normalized_weights(weights)
        self.parts: dict[int, SLRUCache] = {}
        remaining = int(capacity_bytes)
        order = sorted(shares)
        for i, tid in enumerate(order):
            quota = remaining if i == len(order) - 1 else \
                int(capacity_bytes * shares[tid])
            self.parts[tid] = SLRUCache(quota)
            remaining -= quota

    def _part(self, key) -> SLRUCache:
        return self.parts[key[0]]

    def get(self, key) -> bool:
        return self._part(key).get(key)

    def put(self, key, nbytes: int) -> None:
        self._part(key).put(key, nbytes)

    def remove(self, key) -> int:
        return self._part(key).remove(key)

    def invalidate(self, key) -> bool:
        return self._part(key).invalidate(key)

    @property
    def used_bytes(self) -> int:
        return sum(p.used_bytes for p in self.parts.values())

    @property
    def hit_rate(self) -> float:
        hits = sum(p.hits for p in self.parts.values())
        total = hits + sum(p.misses for p in self.parts.values())
        return hits / total if total else 0.0

    def tenant_used_bytes(self, tid: int) -> int:
        return self.parts[tid].used_bytes

    def tenant_quota_bytes(self, tid: int) -> int:
        return self.parts[tid].capacity


class WeightedTenantCache(StaticTenantCache):
    """Weighted quotas with ghost-list-driven adaptive reallocation.

    The ghost list is the classic second-chance structure (ARC/2Q
    lineage): per-tenant metadata of recently evicted keys.  A miss
    found in the ghost list is *reclaimable* — evidence the tenant's
    quota is the binding constraint rather than its working set.  The
    reallocation loop compares ghost pressure across tenants and moves
    quota from the least- to the most-pressured, bounded below by
    ``min_frac × fair_share`` so isolation survives adaptation.
    """

    policy = "weighted"

    def __init__(self, capacity_bytes: int, weights: dict[int, float], *,
                 realloc_every: int = REALLOC_EVERY,
                 step_frac: float = REALLOC_STEP_FRAC,
                 min_frac: float = MIN_QUOTA_FRAC,
                 ghost_frac: float = GHOST_FRAC):
        super().__init__(capacity_bytes, weights)
        if not 0.0 < step_frac < 1.0:
            raise ValueError(f"step_frac must be in (0, 1), got {step_frac}")
        if not 0.0 <= min_frac <= 1.0:
            raise ValueError(f"min_frac must be in [0, 1], got {min_frac}")
        if ghost_frac <= 0.0:
            raise ValueError(f"ghost_frac must be > 0, got {ghost_frac}")
        self.total = int(capacity_bytes)
        shares = _normalized_weights(weights)
        self.floors = {tid: int(min_frac * capacity_bytes * shares[tid])
                       for tid in shares}
        self.realloc_every = int(realloc_every)
        self.step_bytes = max(1, int(step_frac * capacity_bytes))
        self.ghost_frac = float(ghost_frac)
        self.ghosts: dict[int, OrderedDict] = {
            tid: OrderedDict() for tid in shares}
        self.ghost_bytes = {tid: 0 for tid in shares}
        self.ghost_hits = {tid: 0 for tid in shares}   # epoch counters
        self.epoch_lookups = {tid: 0 for tid in shares}
        self.reallocations = 0
        self._lookups = 0
        for tid, part in self.parts.items():
            part.on_evict = (lambda key, nbytes, tid=tid:
                             self._note_evict(tid, key, nbytes))

    # ------------------------------------------------------- ghost lists --
    def _ghost_pop(self, tid: int, key) -> bool:
        nbytes = self.ghosts[tid].pop(key, None)
        if nbytes is None:
            return False
        self.ghost_bytes[tid] -= nbytes
        return True

    def _trim_ghost(self, tid: int) -> None:
        g = self.ghosts[tid]
        cap = int(self.ghost_frac * self.parts[tid].capacity)
        while self.ghost_bytes[tid] > cap and g:
            _, s = g.popitem(last=False)
            self.ghost_bytes[tid] -= s

    def _note_evict(self, tid: int, key, nbytes: int) -> None:
        self._ghost_pop(tid, key)
        self.ghosts[tid][key] = nbytes
        self.ghost_bytes[tid] += nbytes
        self._trim_ghost(tid)

    def get(self, key) -> bool:
        tid = key[0]
        hit = self.parts[tid].get(key)
        if not hit and self._ghost_pop(tid, key):
            self.ghost_hits[tid] += 1
        self.epoch_lookups[tid] += 1
        self._lookups += 1
        if self._lookups % self.realloc_every == 0:
            self._reallocate()
        return hit

    def put(self, key, nbytes: int) -> None:
        self._ghost_pop(key[0], key)
        self.parts[key[0]].put(key, nbytes)

    def remove(self, key) -> int:
        # a rewritten object's ghost must die with its cached copy —
        # its old content hitting the ghost list is not quota pressure
        self._ghost_pop(key[0], key)
        return self.parts[key[0]].remove(key)

    def invalidate(self, key) -> bool:
        self._ghost_pop(key[0], key)
        return self.parts[key[0]].invalidate(key)

    # ------------------------------------------------------ reallocation --
    def _pressure(self, tid: int) -> float:
        """Reclaimable-miss *rate*: ghost hits per lookup this epoch.
        Normalising by the tenant's own lookup volume keeps a
        high-fan-out scanner (many lookups per query) from out-shouting
        a low-fan-out tenant whose every miss is reclaimable."""
        return self.ghost_hits[tid] / max(1, self.epoch_lookups[tid])

    def _reallocate(self) -> None:
        """Move one quota slice from the least- to the most-pressured
        tenant (ghost-hit rate this epoch; deterministic tid
        tie-break)."""
        if len(self.parts) < 2:
            self._reset_epoch()
            return
        order = sorted(self.parts)
        recipient = max(order, key=lambda t: (self._pressure(t), -t))
        donors = [t for t in order
                  if t != recipient
                  and self.parts[t].capacity - self.step_bytes
                  >= self.floors[t]]
        if donors and self.ghost_hits[recipient] > 0:
            donor = min(donors, key=lambda t: (self._pressure(t), t))
            if self._pressure(donor) < self._pressure(recipient):
                self.parts[donor].set_capacity(
                    self.parts[donor].capacity - self.step_bytes)
                self.parts[recipient].set_capacity(
                    self.parts[recipient].capacity + self.step_bytes)
                self._trim_ghost(donor)      # shadow shrinks with quota
                self.reallocations += 1
        self._reset_epoch()

    def _reset_epoch(self) -> None:
        for tid in self.ghost_hits:
            self.ghost_hits[tid] = 0
            self.epoch_lookups[tid] = 0


def make_tenant_cache(policy: str, capacity_bytes: int,
                      weights: dict[int, float], **kwargs):
    """Build one instance's cache assembly (None when no budget)."""
    if policy not in TENANT_CACHE_POLICIES:
        raise ValueError(
            f"unknown tenant cache policy {policy!r}; one of "
            f"{TENANT_CACHE_POLICIES}")
    if capacity_bytes <= 0:
        return None
    cls = {"shared": SharedTenantCache, "static": StaticTenantCache,
           "weighted": WeightedTenantCache}[policy]
    return cls(capacity_bytes, weights, **kwargs)
