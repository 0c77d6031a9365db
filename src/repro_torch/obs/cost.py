"""Dollar-denominated cost metering: price books, fleet cost folding,
and per-tenant show-back.

The simulator already counts every billable quantity — object-store GET
and PUT requests and bytes (``StorageSim``), instance-seconds
(``ShardServer.active_seconds``), and the cache DRAM each instance
reserves (``FleetConfig.cache_bytes``).  A :class:`PriceBook` turns
those counts into dollars *after* the run: costing is pure arithmetic
over the report, never a kernel event, so pricing a run cannot perturb
it (the bit-exactness tests in ``tests/test_monitor_cost.py`` enforce
this).

Two folds are provided:

* :func:`fleet_cost` — one fleet run → component dollars, total, and
  per-query unit economics (``usd_per_1k_queries``, ``queries_per_usd``).
* :func:`tenant_showback` — a multi-tenant run → a show-back table.
  Directly attributable costs (a tenant's storage GETs, egress bytes
  and ingest I/O) are charged to the tenant that caused them; shared
  costs (instance-hours and cache DRAM) are apportioned by each
  tenant's share of executed shard jobs.  I/O the per-query records
  cannot attribute (fault-aborted jobs whose metrics never merged back)
  lands in an explicit ``(unattributed)`` row, so the table sums to the
  fleet total *by construction* within float error.

Prices are config, not physics: ship presets live in
:data:`PRICEBOOKS` and ``--pricebook PATH`` accepts a JSON file with
the same fields (see ``docs/cost.md``).

The port's own copy of ``repro.obs.cost``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
import json
import os

GiB = float(1 << 30)

#: dollars are rounded for JSON emission only; sums are checked on the
#: unrounded values.
_USD_DECIMALS = 9


def _usd(v: float) -> float:
    return round(float(v), _USD_DECIMALS)


@dataclasses.dataclass(frozen=True)
class PriceBook:
    """Unit prices for everything the simulator meters.

    Defaults are deliberately in the ballpark of published cloud list
    prices (object-store GETs ~$0.40/M, PUTs ~$5/M, intra-region
    egress, a mid-size cache-carrying instance) so the *ratios* — PUTs
    ~12x GETs, requests vs bytes vs compute — are realistic even though
    absolute dollars depend on the provider.
    """

    name: str = "default"
    get_per_million_usd: float = 0.40
    put_per_million_usd: float = 5.00
    egress_per_gib_usd: float = 0.02
    instance_per_hour_usd: float = 0.50
    cache_dram_per_gib_hour_usd: float = 0.05
    #: local NVMe tier reservation (repro_torch.storage.tier) — roughly an
    #: order of magnitude under DRAM, which is the whole point of the tier
    nvme_per_gib_hour_usd: float = 0.005

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            if f.name == "name":
                continue
            v = getattr(self, f.name)
            if not (isinstance(v, (int, float)) and v >= 0):
                raise ValueError(f"PriceBook.{f.name} must be >= 0, "
                                 f"got {v!r}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PriceBook":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown PriceBook fields: {sorted(extra)} "
                             f"(known: {sorted(known)})")
        return cls(**d)

    def components(self, *, get_requests: float = 0,
                   put_requests: float = 0, read_bytes: float = 0,
                   instance_seconds: float = 0.0,
                   cache_byte_seconds: float = 0.0,
                   nvme_byte_seconds: float = 0.0) -> dict:
        """Raw metered quantities -> unrounded component dollars."""
        return dict(
            get_usd=get_requests / 1e6 * self.get_per_million_usd,
            put_usd=put_requests / 1e6 * self.put_per_million_usd,
            egress_usd=read_bytes / GiB * self.egress_per_gib_usd,
            instance_usd=(instance_seconds / 3600.0
                          * self.instance_per_hour_usd),
            cache_usd=(cache_byte_seconds / GiB / 3600.0
                       * self.cache_dram_per_gib_hour_usd),
            nvme_usd=(nvme_byte_seconds / GiB / 3600.0
                      * self.nvme_per_gib_hour_usd),
        )


#: Ship presets.  ``egress-heavy`` models serving results across an
#: AZ/region boundary (egress dominates); ``dense-cache`` models a
#: memory-optimized tier where DRAM, not requests, is the spend.
PRICEBOOKS: dict[str, PriceBook] = {
    "default": PriceBook(),
    "egress-heavy": PriceBook(name="egress-heavy",
                              egress_per_gib_usd=0.09,
                              instance_per_hour_usd=0.40),
    "dense-cache": PriceBook(name="dense-cache",
                             instance_per_hour_usd=1.00,
                             cache_dram_per_gib_hour_usd=0.25),
}


def resolve_pricebook(spec: str) -> PriceBook:
    """``--pricebook NAME|PATH``: a preset name, or a JSON file whose
    keys are :class:`PriceBook` fields."""
    if spec in PRICEBOOKS:
        return PRICEBOOKS[spec]
    if os.path.exists(spec):
        with open(spec) as f:
            d = json.load(f)
        d.setdefault("name", os.path.basename(spec))
        return PriceBook.from_dict(d)
    raise KeyError(f"unknown price book {spec!r}: not a preset "
                   f"({sorted(PRICEBOOKS)}) and not a file")


def _fleet_quantities(report, cfg) -> dict:
    """Pull the billable counts out of a finished ``FleetReport``."""
    stats = report.shard_stats or []
    put_requests = sum(getattr(s, "storage_put_requests", 0)
                       for s in stats)
    put_bytes = sum(getattr(s, "storage_put_bytes", 0) for s in stats)
    instance_seconds = report.shards_seconds or 0.0
    return dict(
        get_requests=report.storage_requests - put_requests,
        put_requests=put_requests,
        read_bytes=report.storage_bytes - put_bytes,
        instance_seconds=instance_seconds,
        cache_byte_seconds=cfg.cache_bytes * instance_seconds,
        nvme_byte_seconds=(getattr(cfg, "nvme_bytes", 0)
                           * instance_seconds),
    )


def fleet_cost(report, cfg, book: PriceBook) -> dict:
    """Fold one fleet run down to dollars.

    ``get/put`` charge object-store requests (PUTs are compaction
    writes, metered separately by ``StorageSim``), ``egress`` charges
    storage-served bytes (remote only — the NVMe tier's device traffic
    never crosses the NIC), ``instance`` charges shard-instance uptime
    in *simulated* hours (autoscaled instances bill only while active),
    ``cache`` charges the DRAM reservation per active instance, and
    ``nvme`` the local-tier reservation (``FleetConfig.nvme_bytes``).
    """
    q = _fleet_quantities(report, cfg)
    comp = book.components(**q)
    total = sum(comp.values())
    n = len(report.records)
    out = dict(pricebook=book.name)
    out.update({k: _usd(v) for k, v in comp.items()})
    out["total_usd"] = _usd(total)
    out["usd_per_1k_queries"] = _usd(total / n * 1000.0) if n else 0.0
    out["queries_per_usd"] = (round(n / total, 2) if total > 0 else None)
    good = getattr(report, "good_total", None)
    if good is not None and total > 0:
        out["good_queries_per_usd"] = round(good / total, 2)
    return out


def _tenant_quantities(sl) -> dict:
    """Directly attributable counts for one ``TenantSlice``.

    Storage GETs per query are ``cache_lookups - cache_hits`` (every
    planned fetch probes the cache; each miss is one object-store
    request) and egress bytes are ``bytes_storage`` — both merged from
    the jobs that completed for this tenant.  Ingest adds the tenant's
    own compaction reads (GETs) and writes (PUTs).
    """
    get_requests = sum(r.metrics.cache_lookups - r.metrics.cache_hits
                       for r in sl.records)
    read_bytes = sum(r.metrics.bytes_storage for r in sl.records)
    put_requests = 0
    ing = sl.ingest or {}
    get_requests += ing.get("compaction_read_requests", 0)
    read_bytes += ing.get("compaction_read_bytes", 0)
    put_requests += ing.get("compaction_write_requests", 0)
    return dict(get_requests=get_requests, put_requests=put_requests,
                read_bytes=read_bytes)


def tenant_showback(tenants, fleet_report, cfg, book: PriceBook) -> dict:
    """Multi-tenant show-back table; rows sum to the fleet total.

    ``tenants`` is the list of ``TenantSlice``s, ``fleet_report`` the
    aggregate ``FleetReport`` from the same run.  Shared instance +
    cache dollars are apportioned by each tenant's share of executed
    shard jobs (the unit the autoscaler and queues actually contend
    on); request/egress dollars are charged to the causing tenant.  The
    ``(unattributed)`` row carries I/O the records cannot pin on a
    tenant (fault-aborted jobs) plus any unapportioned shared residue.
    """
    q = _fleet_quantities(fleet_report, cfg)
    fleet_comp = book.components(**q)
    fleet_total = sum(fleet_comp.values())

    jobs = {sl.name: sum(r.n_jobs for r in sl.records) for sl in tenants}
    jobs_total = sum(jobs.values())
    # instance-hours, cache DRAM and the NVMe tier reservation are all
    # per-instance capacity every tenant contends on -> one shared pool
    shared_usd = (fleet_comp["instance_usd"] + fleet_comp["cache_usd"]
                  + fleet_comp["nvme_usd"])

    rows = []
    sum_usd = 0.0
    rem = dict(get_requests=q["get_requests"],
               put_requests=q["put_requests"],
               read_bytes=q["read_bytes"])
    rem_share = 1.0
    for sl in tenants:
        tq = _tenant_quantities(sl)
        for k in rem:
            rem[k] -= tq[k]
        share = (jobs[sl.name] / jobs_total) if jobs_total else 0.0
        rem_share -= share
        comp = book.components(**tq)
        direct = comp["get_usd"] + comp["put_usd"] + comp["egress_usd"]
        total = direct + share * shared_usd
        sum_usd += total
        n = len(sl.records)
        rows.append(dict(
            tenant=sl.name,
            get_usd=_usd(comp["get_usd"]),
            put_usd=_usd(comp["put_usd"]),
            egress_usd=_usd(comp["egress_usd"]),
            shared_usd=_usd(share * shared_usd),
            shared_share=round(share, 6),
            total_usd=_usd(total),
            usd_per_1k_queries=_usd(total / n * 1000.0) if n else 0.0,
        ))

    # The residual is charged as-is (it can only be negative if a
    # tenant's records double-count fleet-level I/O, which would be a
    # bug worth seeing): sum(rows) == fleet total must hold exactly.
    un_comp = book.components(get_requests=rem["get_requests"],
                              put_requests=rem["put_requests"],
                              read_bytes=rem["read_bytes"])
    un_total = (un_comp["get_usd"] + un_comp["put_usd"]
                + un_comp["egress_usd"] + rem_share * shared_usd)
    sum_usd += un_total
    rows.append(dict(
        tenant="(unattributed)",
        get_usd=_usd(un_comp["get_usd"]),
        put_usd=_usd(un_comp["put_usd"]),
        egress_usd=_usd(un_comp["egress_usd"]),
        shared_usd=_usd(rem_share * shared_usd),
        shared_share=round(rem_share, 6),
        total_usd=_usd(un_total),
        usd_per_1k_queries=0.0,
    ))

    return dict(pricebook=book.name,
                fleet_total_usd=_usd(fleet_total),
                sum_usd=_usd(sum_usd),
                rows=rows)


def format_showback(showback: dict) -> str:
    """Render the show-back table for terminal / CI artifact output."""
    cols = ("tenant", "get_usd", "put_usd", "egress_usd", "shared_usd",
            "total_usd", "usd_per_1k_queries")
    lines = ["  ".join(f"{c:>18}" for c in cols)]
    for row in showback["rows"]:
        cells = [f"{row['tenant']:>18}"]
        cells += [f"{row[c]:>18.9f}" for c in cols[1:]]
        lines.append("  ".join(cells))
    lines.append(f"# pricebook={showback['pricebook']} "
                 f"fleet_total_usd={showback['fleet_total_usd']:.9f} "
                 f"sum_usd={showback['sum_usd']:.9f}")
    return "\n".join(lines)
