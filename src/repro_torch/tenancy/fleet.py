"""Multi-tenant fleet serving: N tenant workloads over one shard fleet.

Each tenant brings its own corpus, sealed index and partition, its own
arrival process (any :mod:`repro_torch.sim.arrivals` kind, independent RNG
stream per tenant) and optionally its own update stream + compaction
schedule.  The fleet's *hardware* is shared: every shard instance's
segment cache (arbitrated by a :mod:`repro_torch.tenancy.policy` sharing
strategy), NIC bandwidth pipe and GET-rate bucket serve all tenants'
jobs interleaved on one deterministic kernel.

Fairness mechanisms:

* **per-tenant admission windows** — each tenant's in-service query
  window is its weighted share of ``FleetConfig.concurrency``
  (:func:`fair_share_windows`), so a bursty tenant backlogs in its *own*
  queue instead of occupying the whole fleet window;
* **cache policy** — ``shared`` / ``static`` / ``weighted`` per-instance
  byte arbitration (see :mod:`repro_torch.tenancy.policy`);
* **fair-share backpressure** — shard-level sheds are retried per
  sub-job exactly as in the single-tenant router; per-tenant shed
  retries are reported so a noisy tenant's pressure is attributable.

A **single closed-loop tenant under the ``shared`` policy is the
degenerate case** and reproduces the plain
:class:`repro_torch.fleet.FleetRouter` reports bit-exactly — the tenancy
layer extends the repo's golden-parity chain rather than forking the
serving path.  (Stochastic arrival kinds draw from tenant-named RNG
streams — identical solo vs shared, but not sample-identical to the
plain path's ``"arrivals"`` stream.)

The port's own copy of ``repro.tenancy.fleet``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable

import numpy as np

from repro_torch.core.cluster_index import ClusterIndex
from repro_torch.core.graph_index import GraphIndex
from repro_torch.core.types import (ClusterIndexParams, GraphIndexParams,
                                    SearchParams)
from repro_torch.data.synth import DatasetSpec, make_dataset
from repro_torch.fleet.partition import partition_for_index
from repro_torch.fleet.router import FleetConfig, FleetRouter, _TenantCtx
from repro_torch.tenancy.metrics import MultiTenantReport, TenantSlice
from repro_torch.tenancy.policy import (TENANT_CACHE_POLICIES, TenantCacheBase,
                                        make_tenant_cache)
from repro_torch.tenancy.spec import TenantSpec


def fair_share_windows(concurrency: int,
                       weights: list[float]) -> list[int]:
    """Apportion the fleet admission window across tenants by weight.

    Largest-remainder apportionment with a floor of 1: the windows sum
    to exactly ``concurrency`` (so the multi-tenant fleet never admits
    more concurrent work than a single-tenant run could — independent
    rounding would oversubscribe), except when there are more tenants
    than window slots, where every tenant still gets its minimum of 1.
    """
    total_w = sum(weights)
    if total_w <= 0:
        raise ValueError(f"weights must sum > 0, got {weights}")
    quotas = [concurrency * w / total_w for w in weights]
    out = [int(q) for q in quotas]
    remainders = [q - b for q, b in zip(quotas, out)]
    # hand out the leftover slots by largest remainder (ties: lower idx)
    for i in sorted(range(len(out)),
                    key=lambda i: (-remainders[i], i)):
        if sum(out) >= concurrency:
            break
        out[i] += 1
    # floor of 1: steal from the largest window (never below 1)
    for i, w in enumerate(out):
        if w < 1:
            donor = max(range(len(out)),
                        key=lambda j: (out[j], -j))
            if out[donor] > 1:
                out[donor] -= 1
            out[i] = 1
    return out


def tenant_seed(spec: TenantSpec, base_seed: int) -> int:
    """A tenant's derived seed, keyed by its *name*, never its position
    in the tenant list — so a tenant's dataset, trace and arrival
    randomness are identical whether it runs solo or shared (the
    property interference ratios depend on)."""
    if spec.seed is not None:
        return spec.seed
    return base_seed + (zlib.crc32(spec.name.encode()) & 0xFFFF)


@dataclasses.dataclass
class Tenant:
    """A materialised tenant: spec + built index + query stream.

    A tenant whose run applies updates is *consumed* by that run (its
    index is mutated); use a fresh materialisation per run —
    :func:`measure_interference` takes a factory for exactly this
    reason.
    """

    spec: TenantSpec
    index: object
    queries: np.ndarray
    params: SearchParams
    data: np.ndarray | None = None
    updates: object | None = None
    ingest_cfg: object | None = None
    query_ids: list[int] | None = None


def materialize_tenant(spec: TenantSpec, base_seed: int = 0,
                       tid: int = 0, device=None) -> Tenant:
    """Build one tenant's synthetic corpus, index and update stream.

    ``tid`` is accepted for call-site symmetry but deliberately does
    not enter the seed: a tenant's corpus must not depend on where it
    sits in the tenant list (see :func:`tenant_seed`).  ``device`` is
    where the index build runs (default: the card)."""
    seed = tenant_seed(spec, base_seed)
    ds = DatasetSpec(f"tenant-{spec.name}", spec.dim, "float32", spec.n,
                     spec.n_queries,
                     n_clusters=max(8, min(64, spec.n // 16)),
                     intrinsic_dim=min(32, spec.dim), seed=seed)
    data, queries = make_dataset(ds)
    if spec.index == "cluster":
        index = ClusterIndex.build(data, ClusterIndexParams(
            kmeans_iters=4, seed=seed), device=device)
        params = SearchParams(k=spec.k, nprobe=spec.nprobe)
    else:
        from repro_torch.core.pq import default_pq_dims
        index = GraphIndex.build(data, GraphIndexParams(
            R=24, L_build=48, build_passes=1,
            pq_dims=default_pq_dims(spec.dim), seed=seed), device=device)
        params = SearchParams(k=spec.k, search_len=spec.search_len,
                              beamwidth=spec.beamwidth)
    scenario = spec.scenario_obj()
    updates = None
    ingest_cfg = None
    if scenario.kind == "rw" and scenario.write_rate_qps > 0:
        from repro_torch.ingest.compaction import IngestConfig
        protected = frozenset([index.meta.medoid]) \
            if spec.index == "graph" else None
        updates = scenario.make_updates(data, seed=seed,
                                        protected=protected)
        ingest_cfg = IngestConfig(
            delta_cap_bytes=int(spec.delta_kb * 1024),
            flush_frac=spec.flush_frac,
            compaction_parallelism=spec.compaction_par)
    return Tenant(spec=spec, index=index, queries=queries, params=params,
                  data=data, updates=updates, ingest_cfg=ingest_cfg)


class MultiTenantRouter(FleetRouter):
    """The N-context fleet run (shares every mechanism with the
    single-tenant :class:`FleetRouter` — scatter/gather, po2c, hedging,
    backpressure, faults, autoscaling — via the tenant contexts)."""

    def __init__(self, tenants: list[Tenant], cfg: FleetConfig,
                 cache_policy: str = "shared",
                 policy_kwargs: dict | None = None,
                 quota_weights: dict[int, float] | None = None):
        """``quota_weights`` overrides the cache-quota weighting only
        (tid -> weight; default: the tenants' spec weights) — the hook
        :func:`repro_torch.tuning.tenancy.tune_cache_split` evaluates
        candidate splits through, leaving admission fair shares alone."""
        if not tenants:
            raise ValueError("need at least one tenant")
        names = [t.spec.name for t in tenants]
        if len(set(names)) != len(names):
            # duplicate names would alias the name-keyed seeds and RNG
            # streams (and slice lookup), silently coupling "two" tenants
            raise ValueError(f"duplicate tenant names: {names}")
        if cache_policy not in TENANT_CACHE_POLICIES:
            raise ValueError(
                f"unknown cache policy {cache_policy!r}; one of "
                f"{TENANT_CACHE_POLICIES}")
        self.tenants = tenants
        self.cfg = cfg
        self.cache_policy = cache_policy
        weights = quota_weights if quota_weights is not None else \
            {tid: t.spec.weight for tid, t in enumerate(tenants)}
        kw = policy_kwargs or {}
        self._cache_factory = (
            lambda: make_tenant_cache(cache_policy, cfg.cache_bytes,
                                      weights, **kw))
        self.partitions = [
            partition_for_index(t.index, cfg.n_shards, cfg.replication,
                                seed=cfg.seed)
            for t in tenants]

    def run_tenants(self, *, faults=None, autoscale=None,
                    series_dt: float | None = None,
                    tracer=None, monitor=None,
                    pricebook=None, explain=False,
                    mrc=False) -> MultiTenantReport:
        cfg = self.cfg
        windows = fair_share_windows(
            cfg.concurrency, [t.spec.weight for t in self.tenants])
        ctxs: list[_TenantCtx] = []
        for tid, t in enumerate(self.tenants):
            window = windows[tid]
            # arrival randomness is keyed by tenant *name* (seed for
            # trace construction, kernel stream for poisson/burst), so
            # a tenant's arrival sample is identical solo vs shared —
            # closed-loop arrivals use neither, which is what keeps the
            # single-tenant run on the golden-parity chain
            arr = t.spec.scenario_obj().make_arrivals(
                len(t.queries), window,
                seed=tenant_seed(t.spec, cfg.seed))
            arr.rng_stream = f"arrivals.{t.spec.name}"
            qids = list(t.query_ids) if t.query_ids is not None \
                else list(range(len(t.queries)))
            ctxs.append(_TenantCtx(
                tid, t.index, self.partitions[tid], t.queries, t.params,
                qids, arr, arr.window if arr.window is not None else window,
                slo_s=t.spec.slo_s, weight=t.spec.weight,
                name=t.spec.name, updates=t.updates,
                ingest_cfg=t.ingest_cfg))
        wall = self._execute(ctxs, faults=faults, autoscale=autoscale,
                             series_dt=series_dt, tracer=tracer,
                             monitor=monitor, pricebook=pricebook,
                             explain=explain, mrc=mrc)
        return self._build_report(ctxs, wall, faults)

    # ------------------------------------------------------------ report --
    def _cache_assemblies(self) -> list[TenantCacheBase]:
        out = []
        for g in self.groups:
            for srv in g.all_servers():
                if isinstance(srv.engine.cache, TenantCacheBase):
                    out.append(srv.engine.cache)
        return out

    def _build_report(self, ctxs, wall: float, faults) -> MultiTenantReport:
        from repro_torch.fleet.metrics import FleetReport
        cfg = self.cfg
        stats = [srv.finalize_stats() for g in self.groups
                 for srv in g.all_servers()]
        shards_seconds = sum(srv.active_seconds(wall) for g in self.groups
                             for srv in g.all_servers())
        assemblies = self._cache_assemblies()
        slices = []
        for ctx in ctxs:
            used = sum(a.tenant_used_bytes(ctx.tid) for a in assemblies)
            quotas = [a.tenant_quota_bytes(ctx.tid) for a in assemblies]
            quota = sum(q for q in quotas if q is not None) \
                if any(q is not None for q in quotas) else None
            ingest_dict = None
            if ctx.ingest_report is not None:
                ingest_dict = ctx.ingest_report.to_dict(ctx.records)
            slices.append(TenantSlice(
                name=ctx.name, tid=ctx.tid, records=ctx.records,
                n_arrivals=ctx.adm.arrivals_total,
                offered_qps=ctx.adm.offered_qps(wall),
                slo_s=ctx.slo_s, good_total=ctx.good_total,
                wall_time_s=wall, cache_bytes_used=used,
                cache_quota_bytes=quota, weight=ctx.weight,
                window=ctx.window, ingest=ingest_dict))
        all_records = [r for ctx in ctxs for r in ctx.records]
        fleet = FleetReport(
            records=all_records, shard_stats=stats, wall_time_s=wall,
            n_shards=cfg.n_shards, replication=cfg.replication,
            concurrency=cfg.concurrency, jobs_total=self._jobs_total,
            hedges_launched=self._hedges, hedge_wins=self._hedge_wins,
            sheds_total=sum(s.sheds for s in stats),
            submissions_total=sum(s.submissions for s in stats),
            scenario="multi-tenant",
            n_arrivals=sum(c.adm.arrivals_total for c in ctxs),
            offered_qps=sum(c.adm.offered_qps(wall) for c in ctxs),
            series=self._series, shards_seconds=shards_seconds,
            scale_events=(self._autoscaler.events
                          if self._autoscaler is not None else None),
            fault_log=self._fault_log if faults is not None else None)
        self.attach_obs(fleet)
        showback = None
        if self._pricebook is not None:
            from repro_torch.obs.cost import tenant_showback
            showback = tenant_showback(slices, fleet, cfg,
                                       self._pricebook)
            for sl, row in zip(slices, showback["rows"]):
                sl.cost = row
        reallocs = sum(getattr(a, "reallocations", 0) for a in assemblies)
        return MultiTenantReport(tenants=slices, fleet=fleet,
                                 cache_policy=self.cache_policy,
                                 reallocations=reallocs,
                                 showback=showback)


def run_tenant_fleet(tenants: list[Tenant] | list[TenantSpec],
                     cfg: FleetConfig, cache_policy: str = "shared", *,
                     faults=None, autoscale=None,
                     series_dt: float | None = None,
                     policy_kwargs: dict | None = None,
                     quota_weights: dict[int, float] | None = None,
                     tracer=None, monitor=None,
                     pricebook=None, explain=False,
                     mrc=False) -> MultiTenantReport:
    """One-call multi-tenant evaluation (the tenancy analogue of
    :func:`repro_torch.fleet.run_fleet`).  Accepts either materialised
    :class:`Tenant` s or bare :class:`TenantSpec` s (materialised with
    the fleet seed)."""
    mats = [t if isinstance(t, Tenant)
            else materialize_tenant(t, base_seed=cfg.seed, tid=i)
            for i, t in enumerate(tenants)]
    router = MultiTenantRouter(mats, cfg, cache_policy,
                               policy_kwargs=policy_kwargs,
                               quota_weights=quota_weights)
    return router.run_tenants(faults=faults, autoscale=autoscale,
                              series_dt=series_dt, tracer=tracer,
                              monitor=monitor, pricebook=pricebook,
                              explain=explain, mrc=mrc)


def measure_interference(make_tenants: Callable[[], list[Tenant]],
                         cfg: FleetConfig, cache_policy: str = "shared",
                         *, policy_kwargs: dict | None = None,
                         series_dt: float | None = None,
                         tracer=None, monitor=None,
                         pricebook=None, explain=False,
                         mrc=False) -> MultiTenantReport:
    """Run the shared fleet, then each tenant **solo** on an identical
    fleet, and attach the solo p99 sojourns so every slice reports its
    interference ratio (p99 shared / p99 solo).  ``make_tenants`` is a
    factory because a run with updates consumes its tenants.  Name-keyed
    arrival seeding guarantees the solo run replays the tenant's exact
    shared-run arrival sample, so the ratio measures contention, not
    seed noise."""
    # only the shared run is traced (and monitored/priced): solo reruns
    # are per-tenant controls
    shared = run_tenant_fleet(make_tenants(), cfg, cache_policy,
                              policy_kwargs=policy_kwargs,
                              series_dt=series_dt, tracer=tracer,
                              monitor=monitor, pricebook=pricebook,
                              explain=explain, mrc=mrc)
    fresh = make_tenants()
    for i, sl in enumerate(shared.tenants):
        solo = run_tenant_fleet([fresh[i]], cfg, cache_policy,
                                policy_kwargs=policy_kwargs)
        sl.solo_p99_s = solo.tenants[0].sojourn_percentile(99)
    return shared
