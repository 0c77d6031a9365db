"""Cache-split tuning for multi-tenant fleets (the tenancy axis).

Question: given N tenants sharing one fleet's ``cache_bytes``, how
should the bytes be split?  Same discipline as every other axis in
``repro_torch.tuning`` — an **analytic screen** prunes the candidate space,
then **simulation refinement** runs the few survivors on the real
multi-tenant fleet:

1. **Per-tenant miss curves.**  Each tenant's object-access profile
   (which store keys its query set touches, how often, how many bytes)
   is extracted by replaying its probe selection against its own index
   — exact for cluster tenants (``select_lists`` per query), sampled
   beam traces for graph tenants.  The profile feeds **Che's
   approximation** for LRU: the characteristic time ``T`` solves
   ``Σ_i s_i·(1 − e^{−λ_i T}) = C`` and each object hits with
   probability ``1 − e^{−λ_i T}`` — the standard closed-form miss
   curve ``miss_t(C)``, concave in C, exact in the large-cache limit.
2. **Screen.**  Candidate splits (a simplex grid over per-tenant
   fractions) are priced as weighted miss *bytes per second*:
   ``Σ_t rate_t · miss_t(f_t·C) · bytes_per_query_t`` — miss bytes are
   what the shared NIC pipe and GET buckets actually charge for.
3. **Refine.**  The top ``refine_top`` splits run as real
   ``static``-policy fleet evaluations (quota weights = the split);
   the recommendation is the split with the best measured aggregate
   goodput, with the analytic ranking reported alongside.

The screen's closed form is also the **documented tuning rule** of
``docs/tenancy.md``: give each tenant cache proportional to where its
miss-curve knee sits, not to its traffic share.

The port's own copy of ``repro.tuning.tenancy``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code apart from its ``device`` lines. The tenants are materialised where
``device`` says (default: the card).
"""
from __future__ import annotations

import dataclasses
import itertools
import json

import numpy as np

from repro_torch.fleet.router import FleetConfig
from repro_torch.tenancy.fleet import Tenant, materialize_tenant, run_tenant_fleet
from repro_torch.tenancy.spec import TenantSpec


# ----------------------------------------------------- access profiles --

def object_access_profile(tenant: Tenant, max_probe_queries: int = 16
                          ) -> dict:
    """(key -> [nbytes, access_count]) over the tenant's query set.

    Cluster tenants are profiled exactly: the probed posting lists of
    every query.  Graph tenants are sampled: full beam traces of up to
    ``max_probe_queries`` queries (block-touch skew comes from the
    entry-point neighbourhood, which sampling preserves — Fig 23)."""
    index = tenant.index
    profile: dict = {}

    def touch(key, nbytes):
        ent = profile.get(key)
        if ent is None:
            profile[key] = [int(nbytes), 1]
        else:
            ent[1] += 1

    if tenant.spec.index == "cluster":
        for q in tenant.queries:
            lids, _ = index.select_lists(q, tenant.params.nprobe)
            for li in lids:
                touch(("list", int(li)),
                      int(index.meta.list_nbytes[int(li)]))
    else:
        sample = tenant.queries[:max_probe_queries]
        for q in sample:
            from repro_torch.core.types import QueryMetrics
            gen = index.search_plan(q, tenant.params, QueryMetrics())
            try:
                batch = next(gen)
                while True:
                    payloads = {}
                    for rq in batch.requests:
                        touch(rq.key, rq.nbytes)
                        payloads[rq.key] = index.store.get(rq.key)
                    batch = gen.send(payloads)
            except StopIteration:
                pass
    return profile


def che_hit_rate(profile: dict, cache_bytes: int) -> float:
    """Byte-weighted LRU hit rate under Che's approximation.

    Solves ``Σ_i s_i (1 − e^{−λ_i T}) = C`` for the characteristic time
    ``T`` by bisection, then returns the access-weighted hit rate
    ``Σ_i λ_i (1 − e^{−λ_i T}) / Σ_i λ_i``."""
    if not profile or cache_bytes <= 0:
        return 0.0
    sizes = np.array([v[0] for v in profile.values()], dtype=np.float64)
    lam = np.array([v[1] for v in profile.values()], dtype=np.float64)
    lam /= max(lam.sum(), 1e-12)
    total_bytes = sizes.sum()
    if cache_bytes >= total_bytes:
        return 1.0

    def occupied(T: float) -> float:
        return float((sizes * -np.expm1(-lam * T)).sum())

    lo, hi = 0.0, 1.0
    while occupied(hi) < cache_bytes and hi < 1e18:
        hi *= 2.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if occupied(mid) < cache_bytes:
            lo = mid
        else:
            hi = mid
    T = 0.5 * (lo + hi)
    p_hit = -np.expm1(-lam * T)
    return float((lam * p_hit).sum())


def miss_curve(tenant: Tenant, sizes: list[int] | np.ndarray,
               profile: dict | None = None) -> list[tuple[int, float]]:
    """``[(cache_bytes, miss_rate)]`` for one tenant — its isolated
    LRU miss curve over the candidate quota sizes."""
    prof = profile if profile is not None else \
        object_access_profile(tenant)
    return [(int(c), 1.0 - che_hit_rate(prof, int(c))) for c in sizes]


# ------------------------------------------------------------- screen --

@dataclasses.dataclass(frozen=True)
class CacheSplit:
    """One candidate split: per-tenant fractions of the total budget."""

    fractions: tuple[float, ...]

    def __post_init__(self):
        if not self.fractions or any(f < 0 for f in self.fractions):
            raise ValueError(f"fractions must be >= 0, got "
                             f"{self.fractions}")
        if abs(sum(self.fractions) - 1.0) > 1e-6:
            raise ValueError(f"fractions must sum to 1, got "
                             f"{self.fractions}")

    def label(self) -> str:
        return "/".join(f"{f:.2f}" for f in self.fractions)


@dataclasses.dataclass
class SplitPrediction:
    """Analytic screen output for one candidate split."""

    split: CacheSplit
    miss_rates: tuple[float, ...]      # per-tenant at its quota
    miss_bytes_per_s: float            # Σ rate·miss·bytes-per-query

    def to_dict(self) -> dict:
        return dict(split=list(self.split.fractions),
                    miss_rates=[round(m, 4) for m in self.miss_rates],
                    miss_bytes_per_s=round(self.miss_bytes_per_s, 2))


def enumerate_splits(n_tenants: int, steps: int = 8) -> list[CacheSplit]:
    """The simplex grid of per-tenant fractions at ``1/steps``
    resolution (every tenant gets at least one slice)."""
    if n_tenants == 1:
        return [CacheSplit((1.0,))]
    if steps < n_tenants:
        raise ValueError(
            f"steps={steps} cannot give each of {n_tenants} tenants a "
            f"1/{steps} slice — raise steps to >= the tenant count")
    out = []
    for combo in itertools.product(range(1, steps), repeat=n_tenants - 1):
        rest = steps - sum(combo)
        if rest < 1:
            continue
        out.append(CacheSplit(tuple(c / steps for c in combo)
                              + (rest / steps,)))
    return out


def _mrc_rows(tenants: list[Tenant], mrc: dict) -> list[dict]:
    """Match an ``repro_torch.obs.mrc`` artifact's per-tenant curves to the
    tenant list by name, loudly."""
    rows = {r.get("name"): r for r in mrc.get("tenants", [])}
    missing = [t.spec.name for t in tenants if t.spec.name not in rows]
    if missing:
        raise ValueError(
            f"mrc curves missing tenants {missing}; artifact has "
            f"{sorted(k for k in rows if k)}")
    return [rows[t.spec.name] for t in tenants]


def screen_cache_splits(tenants: list[Tenant], total_cache_bytes: int,
                        splits: list[CacheSplit] | None = None,
                        steps: int = 8,
                        mrc: dict | None = None) -> list[SplitPrediction]:
    """Rank candidate splits by predicted aggregate miss bytes/s
    (ascending — the screen's best candidate first).

    ``mrc`` swaps the analytic model out for **measured** curves: an
    ``repro_torch.obs.mrc`` artifact (``MRCProfiler.to_dict()`` — the
    ``--mrc`` output of a monitored fleet run) supplies each tenant's
    online miss-ratio curve and demand rate, and the screen prices
    splits by interpolating those curves instead of replaying probe
    selection through Che's approximation."""
    if total_cache_bytes <= 0:
        raise ValueError("total_cache_bytes must be > 0 to tune a split")
    cands = splits if splits is not None else \
        enumerate_splits(len(tenants), steps=steps)
    if mrc is not None:
        from repro_torch.obs.mrc import mrc_miss_ratio
        rows = _mrc_rows(tenants, mrc)
        # miss bytes/s = demand bytes/s × miss ratio; fall back to raw
        # access volume when the artifact carries no wall time (scale
        # is global, so the ranking is unchanged)
        demand = [r.get("demand_bytes_per_s")
                  or r["accesses"] * r.get("mean_obj_bytes", 1.0)
                  for r in rows]

        def miss_at(i: int, cache_bytes: int) -> float:
            return mrc_miss_ratio(rows[i]["sizes"],
                                  rows[i]["miss_ratio"], cache_bytes)
    else:
        profiles = [object_access_profile(t) for t in tenants]
        rates = [t.spec.rate_qps
                 if t.spec.scenario not in ("closed", "rw") else 1.0
                 for t in tenants]
        bytes_per_query = [
            sum(v[0] * v[1] for v in prof.values())
            / max(1, sum(v[1] for v in prof.values()))
            * (t.params.nprobe if t.spec.index == "cluster"
               else t.params.search_len)
            for t, prof in zip(tenants, profiles)]
        demand = [r * b for r, b in zip(rates, bytes_per_query)]

        def miss_at(i: int, cache_bytes: int) -> float:
            return 1.0 - che_hit_rate(profiles[i], cache_bytes)
    preds = []
    for split in cands:
        miss = tuple(
            miss_at(i, int(split.fractions[i] * total_cache_bytes))
            for i in range(len(tenants)))
        cost = sum(d * m for d, m in zip(demand, miss))
        preds.append(SplitPrediction(split, miss, cost))
    preds.sort(key=lambda p: (p.miss_bytes_per_s,
                              p.split.fractions))
    return preds


# ------------------------------------------------------------- refine --

@dataclasses.dataclass
class SplitOutcome:
    """One candidate split measured on the real multi-tenant fleet."""

    split: CacheSplit
    aggregate_goodput_qps: float
    aggregate_hit_rate: float
    per_tenant_p99_s: tuple[float, ...]

    def to_dict(self) -> dict:
        return dict(split=list(self.split.fractions),
                    aggregate_goodput_qps=round(
                        self.aggregate_goodput_qps, 3),
                    aggregate_hit_rate=round(self.aggregate_hit_rate, 4),
                    per_tenant_p99_s=[round(p, 6)
                                      for p in self.per_tenant_p99_s])


@dataclasses.dataclass
class CacheSplitRecommendation:
    """The tuner's answer: the best measured split + the full ranking."""

    split: CacheSplit
    screened: list[SplitPrediction]
    outcomes: list[SplitOutcome]
    total_cache_bytes: int

    def to_dict(self) -> dict:
        return dict(
            recommendation=list(self.split.fractions),
            total_cache_bytes=self.total_cache_bytes,
            screened=[p.to_dict() for p in self.screened[:12]],
            refined=[o.to_dict() for o in self.outcomes])

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)


def tune_cache_split(specs: list[TenantSpec], cfg: FleetConfig, *,
                     steps: int = 8, refine_top: int = 3,
                     mrc: dict | None = None, device=None,
                     ) -> CacheSplitRecommendation:
    """Screen the split simplex analytically, then refine the top
    candidates on real ``static``-policy fleet runs; recommend the
    split with the best measured aggregate goodput.

    ``mrc`` (an ``repro_torch.obs.mrc`` artifact from a live profiled run)
    replaces the analytic screen's access profiles with measured
    miss-ratio curves — the online path from a running fleet straight
    into the tuner."""
    if len(specs) < 2:
        raise ValueError("cache-split tuning needs >= 2 tenants")
    if cfg.cache_bytes <= 0:
        raise ValueError("FleetConfig.cache_bytes must be > 0 to tune a "
                         "cache split")
    tenants = [materialize_tenant(s, base_seed=cfg.seed, tid=i,
                                  device=device)
               for i, s in enumerate(specs)]
    preds = screen_cache_splits(tenants, cfg.cache_bytes, steps=steps,
                                mrc=mrc)
    outcomes = []
    for pred in preds[:max(1, refine_top)]:
        quota = {i: f for i, f in enumerate(pred.split.fractions)}
        # read-only tenants are not mutated by a run (caches and
        # partitions live outside the Tenant) — only write-stream
        # tenants need a fresh materialisation per candidate
        fresh = [t if t.updates is None
                 else materialize_tenant(specs[i], base_seed=cfg.seed,
                                         tid=i, device=device)
                 for i, t in enumerate(tenants)]
        rep = run_tenant_fleet(fresh, cfg, "static", quota_weights=quota)
        outcomes.append(SplitOutcome(
            split=pred.split,
            aggregate_goodput_qps=rep.aggregate_goodput_qps,
            aggregate_hit_rate=rep.fleet.hit_rate,
            per_tenant_p99_s=tuple(t.sojourn_percentile(99)
                                   for t in rep.tenants)))
    best = max(outcomes, key=lambda o: (o.aggregate_goodput_qps,
                                        o.aggregate_hit_rate))
    return CacheSplitRecommendation(
        split=best.split, screened=preds, outcomes=outcomes,
        total_cache_bytes=cfg.cache_bytes)
