"""Fleet-level measurement: tail latency, balance, hedging, backpressure,
and — under open-loop scenarios — offered-vs-achieved load, goodput,
queue depth and capacity over time.

Extends the single-node §5.1 instrumentation with the quantities that only
exist at fleet scale: p99.9 (hedging's target), per-shard load imbalance
(partitioning quality), hedge rate (how often the tail deadline fired),
shed rate (admission-queue backpressure), and the scenario axes: a
time-sliced :class:`FleetSeries` (achieved vs offered QPS, goodput, queue
depth, instance count) plus shards·seconds cost when the autoscaler runs.

The port's own copy of ``repro.fleet.metrics``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.core.types import QueryMetrics
from repro_torch.fleet.server import ShardStats


@dataclasses.dataclass
class FleetQueryRecord:
    """One query's fleet-side lifecycle."""

    qid: int
    start_t: float                 # service start (left the router backlog)
    end_t: float
    ids: np.ndarray
    dists: np.ndarray
    metrics: QueryMetrics          # aggregated over router + shard jobs
    rounds: int                    # scatter-gather rounds
    n_jobs: int                    # shard jobs issued (incl. hedges)
    shards_touched: int
    hedged: bool = False
    shed_retries: int = 0
    arrive_t: float | None = None  # open-loop arrival (None => start_t)

    @property
    def latency(self) -> float:
        return self.end_t - self.start_t

    @property
    def sojourn(self) -> float:
        """Arrival-to-completion time (includes router backlog wait)."""
        t0 = self.start_t if self.arrive_t is None else self.arrive_t
        return self.end_t - t0


@dataclasses.dataclass
class FleetSeries:
    """Per-slice counters sampled by the fleet's monitor process."""

    dt: float
    t: list = dataclasses.field(default_factory=list)
    arrived: list = dataclasses.field(default_factory=list)
    completed: list = dataclasses.field(default_factory=list)
    good: list = dataclasses.field(default_factory=list)
    queue_depth: list = dataclasses.field(default_factory=list)
    instances: list = dataclasses.field(default_factory=list)

    def append(self, *, t: float, arrived: int, completed: int, good: int,
               queue_depth: int, instances: int) -> None:
        self.t.append(round(t, 9))
        self.arrived.append(arrived)
        self.completed.append(completed)
        self.good.append(good)
        self.queue_depth.append(queue_depth)
        self.instances.append(instances)

    def to_dict(self) -> dict:
        """Per-slice rates (QPS) alongside the raw counters."""
        dts = np.diff([0.0] + self.t)
        dts = np.maximum(dts, 1e-12)
        return dict(
            dt=self.dt, t=self.t,
            offered_qps=[round(a / d, 3)
                         for a, d in zip(self.arrived, dts)],
            achieved_qps=[round(c / d, 3)
                          for c, d in zip(self.completed, dts)],
            goodput_qps=[round(g / d, 3) for g, d in zip(self.good, dts)],
            queue_depth=self.queue_depth,
            instances=self.instances)


@dataclasses.dataclass
class FleetReport:
    """Aggregates for one fleet run (the fleet analogue of
    :class:`repro_torch.serving.metrics.WorkloadReport`)."""

    records: list[FleetQueryRecord]
    shard_stats: list[ShardStats]
    wall_time_s: float
    n_shards: int
    replication: int
    concurrency: int
    jobs_total: int                # accepted shard jobs (incl. hedges)
    hedges_launched: int
    hedge_wins: int
    sheds_total: int
    submissions_total: int         # accepted + shed submission attempts
    # -------------------------------------------------- scenario fields --
    scenario: str = "closed"
    n_arrivals: int = 0
    offered_qps: float = 0.0       # arrival rate (== qps when closed-loop)
    slo_s: float | None = None
    good_total: int | None = None  # completions with sojourn <= slo
    series: FleetSeries | None = None
    shards_seconds: float | None = None   # ∫ active instances dt (cost)
    scale_events: list | None = None      # autoscaler decision log
    fault_log: list | None = None         # fail/recover events observed
    ingest: dict | None = None            # repro.ingest accounting (rw)
    # ------------------------------------------- live obs (PR 7) fields --
    alerts: dict | None = None            # repro_torch.obs.monitor summary
    cost: dict | None = None              # repro_torch.obs.cost fleet_cost
    # ------------------------------------------ tail obs (PR 9) fields --
    explain: dict | None = None           # repro_torch.obs.explain tail report
    mrc: dict | None = None               # repro_torch.obs.mrc curves

    # ------------------------------------------------------- throughput --
    @property
    def qps(self) -> float:
        return len(self.records) / max(self.wall_time_s, 1e-12)

    @property
    def goodput_qps(self) -> float:
        """Completions that met the SLO, per second of wall time."""
        if self.good_total is None:
            return self.qps
        return self.good_total / max(self.wall_time_s, 1e-12)

    @property
    def goodput_frac(self) -> float:
        """Fraction of arrivals served within the SLO."""
        if self.good_total is None or not self.n_arrivals:
            return 1.0
        return self.good_total / self.n_arrivals

    # ---------------------------------------------------------- latency --
    def _sorted(self, kind: str) -> np.ndarray:
        """Sorted per-record values, computed once per report.

        ``summary()`` asks for five percentiles plus the mean; sorting
        the record list on every call made that O(5 · n log n) — on a
        million-record replay the sort dominates.  The cache keeps one
        sorted float64 array per kind (latency/sojourn) for the life of
        the report; records are append-only once the run finishes, so
        invalidation is a non-problem.
        """
        cache = self.__dict__.setdefault("_pctl_cache", {})
        arr = cache.get(kind)
        if arr is None:
            arr = np.sort(np.asarray([getattr(r, kind)
                                      for r in self.records],
                                     dtype=np.float64))
            cache[kind] = arr
        return arr

    @staticmethod
    def _percentile(arr: np.ndarray, p: float) -> float:
        """``np.percentile(..., method="linear")`` over a pre-sorted
        array, bit-identical to numpy (same two-branch lerp)."""
        n = arr.size
        if n == 1:
            return float(arr[0])
        pos = (p / 100.0) * (n - 1)
        i = int(pos)
        t = pos - i
        a = float(arr[i])
        if t == 0.0:
            return a
        b = float(arr[min(i + 1, n - 1)])
        d = b - a
        lerp = a + d * t
        if t >= 0.5:
            lerp = b - d * (1.0 - t)
        return lerp

    def latency_percentile(self, p: float) -> float:
        if not self.records:
            return 0.0
        return self._percentile(self._sorted("latency"), p)

    def sojourn_percentile(self, p: float) -> float:
        if not self.records:
            return 0.0
        return self._percentile(self._sorted("sojourn"), p)

    @property
    def mean_latency(self) -> float:
        if not self.records:
            return 0.0
        return float(np.mean(self._sorted("latency")))

    # ---------------------------------------------------------- balance --
    @property
    def load_imbalance(self) -> float:
        """max/mean of per-shard jobs served (1.0 = perfectly even)."""
        jobs = np.array([s.jobs_done for s in self.shard_stats],
                        dtype=np.float64)
        return float(jobs.max() / max(jobs.mean(), 1e-12))

    @property
    def bytes_imbalance(self) -> float:
        """max/mean of per-shard bytes actually served from storage."""
        b = np.array([s.storage_bytes for s in self.shard_stats],
                     dtype=np.float64)
        return float(b.max() / max(b.mean(), 1e-12))

    # ------------------------------------------------- hedging/shedding --
    @property
    def hedge_rate(self) -> float:
        return self.hedges_launched / max(1, self.jobs_total)

    @property
    def hedge_win_rate(self) -> float:
        return self.hedge_wins / max(1, self.hedges_launched)

    @property
    def shed_rate(self) -> float:
        return self.sheds_total / max(1, self.submissions_total)

    # ----------------------------------------------------------- totals --
    @property
    def storage_bytes(self) -> int:
        return sum(s.storage_bytes for s in self.shard_stats)

    @property
    def storage_requests(self) -> int:
        return sum(s.storage_requests for s in self.shard_stats)

    @property
    def hit_rate(self) -> float:
        hits = sum(r.metrics.cache_hits for r in self.records)
        lookups = sum(r.metrics.cache_lookups for r in self.records)
        return hits / lookups if lookups else 0.0

    def recall_against(self, gt_ids: np.ndarray) -> float:
        from repro_torch.core.types import recall_at_k
        recs = [recall_at_k(r.ids[r.ids >= 0], gt_ids[r.qid])
                for r in self.records]
        return float(np.mean(recs))

    # ------------------------------------------------------------- JSON --
    def summary(self) -> dict:
        out = dict(
            n_queries=len(self.records),
            n_shards=self.n_shards,
            replication=self.replication,
            concurrency=self.concurrency,
            qps=round(self.qps, 4),
            mean_latency_s=round(self.mean_latency, 9),
            p50_latency_s=round(self.latency_percentile(50), 9),
            p99_latency_s=round(self.latency_percentile(99), 9),
            p999_latency_s=round(self.latency_percentile(99.9), 9),
            load_imbalance=round(self.load_imbalance, 4),
            bytes_imbalance=round(self.bytes_imbalance, 4),
            hedge_rate=round(self.hedge_rate, 4),
            hedge_win_rate=round(self.hedge_win_rate, 4),
            shed_rate=round(self.shed_rate, 4),
            jobs_total=self.jobs_total,
            hedges_launched=self.hedges_launched,
            sheds_total=self.sheds_total,
            storage_bytes=self.storage_bytes,
            storage_requests=self.storage_requests,
            hit_rate=round(self.hit_rate, 4),
            wall_time_s=round(self.wall_time_s, 9),
            shards=[s.to_dict() for s in self.shard_stats],
        )
        if self.scenario != "closed" or self.slo_s is not None:
            out["scenario"] = dict(
                kind=self.scenario,
                n_arrivals=self.n_arrivals,
                offered_qps=round(self.offered_qps, 4),
                achieved_qps=round(self.qps, 4),
                p50_sojourn_s=round(self.sojourn_percentile(50), 9),
                p99_sojourn_s=round(self.sojourn_percentile(99), 9))
            if self.slo_s is not None:
                out["scenario"].update(
                    slo_s=self.slo_s,
                    goodput_qps=round(self.goodput_qps, 4),
                    goodput_frac=round(self.goodput_frac, 4))
        if self.series is not None:
            out["series"] = self.series.to_dict()
        if self.shards_seconds is not None:
            out["shards_seconds"] = round(self.shards_seconds, 6)
        if self.scale_events is not None:
            out["autoscale"] = dict(
                events=self.scale_events,
                final_instances=(self.series.instances[-1]
                                 if self.series and self.series.instances
                                 else None))
        if self.fault_log is not None:
            out["faults"] = self.fault_log
        if self.ingest is not None:
            out["ingest"] = self.ingest
        # live-obs blocks last: bit-exactness tests compare a monitored
        # run's summary minus these keys against the plain run.
        if self.alerts is not None:
            out["alerts"] = self.alerts
        if self.cost is not None:
            out["cost"] = self.cost
        if self.explain is not None:
            out["explain"] = self.explain
        if self.mrc is not None:
            out["mrc"] = self.mrc
        return out

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.summary(), indent=indent)
