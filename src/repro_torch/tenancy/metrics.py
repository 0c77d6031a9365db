"""Per-tenant report slices over one shared fleet run.

The fleet-level :class:`repro_torch.fleet.metrics.FleetReport` answers "how did
the hardware do"; a provider also owes each tenant an answer to "how did
*my* traffic do".  A :class:`TenantSlice` carries the per-tenant cut:
hit rate (from the tenant's own query metrics), p50/p99 latency and
sojourn, goodput against the tenant's SLO, bytes of shared cache its
objects occupy, and — when a solo baseline is attached — *interference*:
p99 shared over p99 solo, the number the isolation policies exist to
bound.

The port's own copy of ``repro.tenancy.metrics``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.fleet.metrics import FleetQueryRecord, FleetReport


def _pct(vals: list[float], p: float) -> float:
    return float(np.percentile(vals, p)) if vals else 0.0


@dataclasses.dataclass
class TenantSlice:
    """One tenant's view of a shared fleet run."""

    name: str
    tid: int
    records: list[FleetQueryRecord]
    n_arrivals: int
    offered_qps: float
    slo_s: float | None
    good_total: int
    wall_time_s: float
    cache_bytes_used: int          # Σ over instances at run end
    cache_quota_bytes: int | None  # Σ per-instance quota (partitioned)
    weight: float
    window: int                    # admission fair share
    solo_p99_s: float | None = None    # attached by interference probes
    ingest: dict | None = None
    cost: dict | None = None       # this tenant's show-back row ($)

    # ------------------------------------------------------------ stats --
    @property
    def qps(self) -> float:
        return len(self.records) / max(self.wall_time_s, 1e-12)

    def latency_percentile(self, p: float) -> float:
        return _pct([r.latency for r in self.records], p)

    def sojourn_percentile(self, p: float) -> float:
        return _pct([r.sojourn for r in self.records], p)

    @property
    def hit_rate(self) -> float:
        hits = sum(r.metrics.cache_hits for r in self.records)
        lookups = sum(r.metrics.cache_lookups for r in self.records)
        return hits / lookups if lookups else 0.0

    @property
    def bytes_read(self) -> int:
        return sum(r.metrics.bytes_storage for r in self.records)

    @property
    def goodput_qps(self) -> float:
        if self.slo_s is None:
            return self.qps
        return self.good_total / max(self.wall_time_s, 1e-12)

    @property
    def goodput_frac(self) -> float:
        if self.slo_s is None or not self.n_arrivals:
            return 1.0
        return self.good_total / self.n_arrivals

    @property
    def interference_ratio(self) -> float | None:
        """p99 sojourn shared / p99 sojourn solo (1.0 = no interference;
        None until a solo baseline is attached)."""
        if self.solo_p99_s is None or self.solo_p99_s <= 0:
            return None
        return self.sojourn_percentile(99) / self.solo_p99_s

    @property
    def shed_retries(self) -> int:
        return sum(r.shed_retries for r in self.records)

    def recall_against(self, gt_ids: np.ndarray) -> float:
        from repro_torch.core.types import recall_at_k
        recs = [recall_at_k(r.ids[r.ids >= 0], gt_ids[r.qid])
                for r in self.records]
        return float(np.mean(recs)) if recs else 0.0

    def to_dict(self) -> dict:
        out = dict(
            name=self.name, tid=self.tid, weight=self.weight,
            window=self.window,
            n_queries=len(self.records), n_arrivals=self.n_arrivals,
            offered_qps=round(self.offered_qps, 4),
            qps=round(self.qps, 4),
            p50_latency_s=round(self.latency_percentile(50), 9),
            p99_latency_s=round(self.latency_percentile(99), 9),
            p50_sojourn_s=round(self.sojourn_percentile(50), 9),
            p99_sojourn_s=round(self.sojourn_percentile(99), 9),
            hit_rate=round(self.hit_rate, 4),
            bytes_read=self.bytes_read,
            cache_bytes_used=self.cache_bytes_used,
            shed_retries=self.shed_retries)
        if self.cache_quota_bytes is not None:
            out["cache_quota_bytes"] = self.cache_quota_bytes
        if self.slo_s is not None:
            out.update(slo_s=self.slo_s,
                       goodput_qps=round(self.goodput_qps, 4),
                       goodput_frac=round(self.goodput_frac, 4))
        if self.solo_p99_s is not None and \
                self.interference_ratio is not None:
            out.update(
                solo_p99_sojourn_s=round(self.solo_p99_s, 9),
                interference_ratio=round(self.interference_ratio, 4))
        if self.ingest is not None:
            out["ingest"] = self.ingest
        if self.cost is not None:
            out["cost"] = self.cost
        return out


@dataclasses.dataclass
class MultiTenantReport:
    """N tenant slices plus the fleet-level aggregate they share."""

    tenants: list[TenantSlice]
    fleet: FleetReport             # aggregate (all records, shard stats)
    cache_policy: str
    reallocations: int = 0         # weighted-policy quota moves (Σ inst.)
    showback: dict | None = None   # per-tenant $ table (repro_torch.obs.cost)

    def tenant(self, name: str) -> TenantSlice:
        for t in self.tenants:
            if t.name == name:
                return t
        raise KeyError(f"no tenant named {name!r}; have "
                       f"{[t.name for t in self.tenants]}")

    @property
    def aggregate_goodput_qps(self) -> float:
        """Σ per-tenant goodput — the provider's sellable throughput."""
        return sum(t.goodput_qps for t in self.tenants)

    @property
    def aggregate_goodput_frac(self) -> float:
        good = sum(t.good_total for t in self.tenants
                   if t.slo_s is not None)
        arr = sum(t.n_arrivals for t in self.tenants
                  if t.slo_s is not None)
        return good / arr if arr else 1.0

    def summary(self) -> dict:
        out = dict(
            cache_policy=self.cache_policy,
            n_tenants=len(self.tenants),
            aggregate_goodput_qps=round(self.aggregate_goodput_qps, 4),
            aggregate_goodput_frac=round(self.aggregate_goodput_frac, 4),
            tenants=[t.to_dict() for t in self.tenants],
            fleet=self.fleet.summary())
        if self.cache_policy == "weighted":
            out["reallocations"] = self.reallocations
        if self.showback is not None:
            out["showback"] = self.showback
        return out

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.summary(), indent=indent)
