"""Scatter-gather fleet routing on one shared event kernel.

The router owns the compute-node-resident index metadata (BKT centroids /
PQ codes — what the paper's single node caches, §2.1) and serves queries
across N :class:`ShardGroup` s, all registered on one deterministic
:class:`repro_torch.sim.Kernel`:

* **Cluster queries** — centroid search runs at the router; the selected
  posting lists scatter to shard-local *scan jobs* (fetch + distance scan
  + local top-k, priced on the shard's compute), and the router merges the
  local top-ks into the global result.  One scatter round per query
  (paper §2.3.1's single dependency-free roundtrip, now fanned out).
* **Graph queries** — beam-search state stays at the router (the PQ/ADC
  frontier is metadata-resident); each expansion round's W node-block
  fetches scatter to the owning shards and gather before the next round,
  preserving the ``rt × TTFB`` floor per shard.

Routing policies:

* **power-of-two-choices** replica selection: among a key's R live
  replica owners, sample two and pick the shorter queue — the classic
  load-balance result, and the reason replication pays beyond fault
  tolerance.
* **hedged requests**: once enough job latencies are observed, a slot
  whose job outlives the fleet's p-th latency percentile is re-issued to
  the other replicas; first completion wins (kernel timers, cancellable).
* **backpressure**: a shed submission (admission queue full) is retried
  after ``shed_retry_s`` with fresh replica choice — sheds delay queries
  and show up in shed_rate, they never drop data.

Scenario axes (all deterministic for a given seed):

* **arrivals** (:mod:`repro_torch.sim.arrivals`): closed loop (default — the
  regime under which this file reproduces the pre-kernel reports
  exactly), open-loop Poisson with diurnal/burst modulation, or trace
  replay.  Open-loop arrivals queue in a router backlog behind a window
  of ``concurrency`` in-service queries.
* **faults** (:mod:`repro_torch.sim.faults`): shard kill/revive schedules; the
  victims' jobs are re-routed to surviving replica owners (recall is
  unchanged when R >= 2); unroutable keys back off until recovery.
* **autoscaling** (:mod:`repro_torch.sim.autoscale`): an SLO controller adds /
  drains shard instances; the report prices the run in shards·seconds.

**Tenancy**: the router serves any number of *tenant contexts*
(:class:`_TenantCtx`) over the same shard groups — each tenant has its
own index, partition, arrival process, admission window (its fair share
of ``concurrency``) and SLO accounting, while caches, NIC bandwidth and
GET tokens are shared fleet-wide.  Fetch keys are namespaced by tenant
id, so one instance cache can hold (and a sharing policy can arbitrate)
every tenant's objects.  The single-tenant :meth:`FleetRouter.run` is
the degenerate one-context case and reproduces the pre-tenancy reports
bit-exactly; :mod:`repro.tenancy` builds the N-context runs.

Determinism: one event kernel, (time, seq) total order, per-component
seeded RNG streams — identical seeds give bit-identical
:class:`FleetReport` JSON.

The port's own copy of ``repro.fleet.router``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import deque
from typing import Iterable

import numpy as np

from repro_torch.cache.slru import CACHE_POLICIES
from repro_torch.core.cluster_index import dedup_topk, scan_posting_lists
from repro_torch.core.cost_model import ComputeSpec, plan_compute_seconds
from repro_torch.core.types import (FetchBatch, FetchRequest, QueryMetrics,
                              SearchParams, SearchResult, recall_at_k)
from repro_torch.fleet.metrics import FleetQueryRecord, FleetReport, FleetSeries
from repro_torch.fleet.partition import partition_for_index
from repro_torch.fleet.server import ShardGroup, ShardServer
from repro_torch.obs.cost import PriceBook, fleet_cost
from repro_torch.obs.explain import ExplainCollector, ExplainConfig
from repro_torch.obs.monitor import FleetMonitor, MonitorConfig
from repro_torch.obs.mrc import MRCConfig, MRCProfiler
from repro_torch.obs.trace import NULL_TRACER, Tracer, emit_job_spans
from repro_torch.serving.engine import EngineConfig, JobRecord
from repro_torch.sim.admission import AdmissionWindow
from repro_torch.sim.arrivals import ArrivalProcess, ClosedLoop
from repro_torch.sim.autoscale import AutoscaleConfig, Autoscaler
from repro_torch.sim.faults import FaultSchedule
from repro_torch.sim.kernel import Kernel
from repro_torch.storage.spec import TOS, StorageSpec
from repro_torch.storage.tier import TIER_POLICIES, TierConfig

#: A slot that cannot be routed (all owners down) retries on a backoff
#: timer; past this many retries the scenario is declared unservable.
RETRY_LIMIT = 100_000


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Everything that defines a serving fleet (the tuner's new axis)."""

    n_shards: int = 4
    replication: int = 1
    storage: StorageSpec = TOS
    concurrency: int = 8           # in-service fleet queries (window)
    shard_concurrency: int = 4     # jobs executing per shard
    queue_depth: int = 16          # shard admission queue bound
    cache_bytes: int = 0           # per-shard segment cache budget
    cache_policy: str = "none"     # "none" | "slru"
    hedge: bool = False
    hedge_percentile: float = 95.0
    hedge_min_samples: int = 24
    shed_retry_s: float = 1e-3
    hit_latency_s: float = 100e-6
    compute: ComputeSpec = dataclasses.field(default_factory=ComputeSpec)
    #: "analytic" prices compute from the ComputeSpec constants;
    #: "kernel" routes every shard's compute through a repro_torch.exec
    #: KernelBackend — batch-coalesced and priced from a measured
    #: CalibrationTable (see docs/execution.md)
    backend: str = "analytic"
    batch_window_s: float = 0.0    # kernel backend: coalescing window
    calibration: str | None = None  # table path; None = committed default
    #: per-instance local NVMe tier (repro_torch.storage.tier); 0 keeps the
    #: flat DRAM -> remote hierarchy bit-exact (no tier is constructed)
    nvme_bytes: int = 0
    tier_policy: str = "second-hit"  # "second-hit" | "admit-always"
    nvme_writeback: bool = False   # compaction output lands on NVMe first
    seed: int = 0

    def __post_init__(self):
        if self.backend not in ("analytic", "kernel"):
            raise ValueError(
                f"backend must be 'analytic' or 'kernel', got "
                f"{self.backend!r}")
        if self.batch_window_s < 0:
            raise ValueError(f"batch_window_s must be >= 0, got "
                             f"{self.batch_window_s}")
        if self.backend == "analytic" and (self.batch_window_s
                                           or self.calibration):
            raise ValueError(
                "batch_window_s/calibration are kernel-backend knobs "
                "(set backend='kernel')")
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if not 1 <= self.replication <= self.n_shards:
            raise ValueError(
                f"replication must be in [1, n_shards={self.n_shards}], "
                f"got {self.replication}")
        if self.cache_policy not in CACHE_POLICIES or \
                self.cache_policy == "pinned":
            raise ValueError(
                f"fleet cache_policy must be 'none' or 'slru', "
                f"got {self.cache_policy!r}")
        if self.concurrency < 1 or self.shard_concurrency < 1:
            raise ValueError("concurrency and shard_concurrency must be "
                             ">= 1")
        if self.queue_depth < 0:
            raise ValueError(f"queue_depth must be >= 0, got "
                             f"{self.queue_depth}")
        if self.hedge and not 50.0 <= self.hedge_percentile < 100.0:
            raise ValueError(
                f"hedge_percentile must be in [50, 100), got "
                f"{self.hedge_percentile}")
        if self.nvme_bytes < 0:
            raise ValueError(f"nvme_bytes must be >= 0, got "
                             f"{self.nvme_bytes}")
        if self.tier_policy not in TIER_POLICIES:
            raise ValueError(
                f"tier_policy must be one of {TIER_POLICIES}, got "
                f"{self.tier_policy!r}")
        if self.nvme_bytes == 0 and (self.tier_policy != "second-hit"
                                     or self.nvme_writeback):
            raise ValueError(
                "tier_policy/nvme_writeback are NVMe-tier knobs "
                "(set nvme_bytes > 0)")

    def to_dict(self) -> dict:
        d = dict(n_shards=self.n_shards, replication=self.replication,
                 storage=self.storage.name,
                 concurrency=self.concurrency,
                 shard_concurrency=self.shard_concurrency,
                 queue_depth=self.queue_depth,
                 cache_bytes=self.cache_bytes,
                 cache_policy=self.cache_policy, hedge=self.hedge,
                 hedge_percentile=self.hedge_percentile, seed=self.seed)
        # keys appear only off the default so analytic config dicts stay
        # byte-identical to pre-backend goldens/baselines
        if self.backend != "analytic":
            d.update(backend=self.backend,
                     batch_window_us=round(self.batch_window_s * 1e6, 3),
                     calibration=self.calibration or "default")
        if self.nvme_bytes > 0:
            d.update(nvme_bytes=self.nvme_bytes,
                     tier_policy=self.tier_policy,
                     nvme_writeback=self.nvme_writeback)
        return d


def merge_topk(results: list[SearchResult], k: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """Global top-k over shard-local top-ks, deduplicating replica ids.

    Every member of the true global top-k is necessarily inside its own
    shard's local top-k, so the merge is lossless — same kernel as the
    single-node scan (``dedup_topk``).
    """
    ids = np.concatenate([r.ids for r in results])
    d = np.concatenate([r.dists for r in results])
    valid = ids >= 0
    return dedup_topk(ids[valid], d[valid], k)


class _TenantCtx:
    """One tenant's serving state inside a fleet run.

    The router itself is tenant-agnostic: every query belongs to a
    context carrying the tenant's index, partition, workload, admission
    window and SLO bookkeeping.  Fetch keys are namespaced
    ``(tid, *native_key)`` so stores and caches shared across tenants
    cannot collide.
    """

    __slots__ = ("tid", "name", "index", "partition", "kind", "dim",
                 "pq_m", "queries", "params", "qids", "arrivals", "window",
                 "weight", "slo_s", "updates", "ingest_cfg", "adm",
                 "records", "good_total", "ingest_agents", "ingest_report")

    def __init__(self, tid: int, index, partition, queries: np.ndarray,
                 params: SearchParams, qids: list[int],
                 arrivals: ArrivalProcess, window: int,
                 slo_s: float | None = None, weight: float = 1.0,
                 name: str | None = None, updates=None, ingest_cfg=None):
        self.tid = tid
        self.name = name if name is not None else f"tenant{tid}"
        self.index = index
        self.partition = partition
        self.kind = partition.kind
        self.dim = index.meta.dim
        pq = getattr(index.meta, "pq", None)
        self.pq_m = pq.m if pq is not None else 0
        self.queries = queries
        self.params = params
        self.qids = qids
        self.arrivals = arrivals
        self.window = window
        self.weight = weight
        self.slo_s = slo_s
        self.updates = updates
        self.ingest_cfg = ingest_cfg
        self.adm: AdmissionWindow | None = None
        self.records: list[FleetQueryRecord] = []
        self.good_total = 0
        self.ingest_agents: dict[int, object] = {}
        self.ingest_report = None


class _TenantStore:
    """Key-dispatching view over the tenants' object stores: the shard
    engines see one store whose keys are ``(tid, *native_key)``."""

    __slots__ = ("ctxs",)

    def __init__(self, ctxs: list[_TenantCtx]):
        self.ctxs = ctxs

    def get(self, key):
        return self.ctxs[key[0]].index.store.get(key[1:])


class _Slot:
    """One shard-destined sub-request of one scatter round."""

    __slots__ = ("slot_id", "reqs", "shard", "done", "hedge_launched",
                 "outstanding", "collected")

    def __init__(self, slot_id: int, reqs: list[FetchRequest], shard: int):
        self.slot_id = slot_id
        self.reqs = reqs
        self.shard = shard
        self.done = False
        self.hedge_launched = False
        self.outstanding: dict[int, set] = {}     # attempt -> open tags
        self.collected: dict[int, list] = {}      # attempt -> job results


class _FleetQuery:
    """Router-side state machine for one in-flight query."""

    __slots__ = ("ctx", "idx", "qid", "q", "k", "kind", "gen", "metrics",
                 "start_t", "arrive_t", "snapshot", "rounds", "n_jobs",
                 "shards", "hedged", "shed_retries", "slots", "open_slots",
                 "local_results", "payloads", "done", "span", "round_span")

    def __init__(self, ctx: _TenantCtx, idx: int, qid: int, q: np.ndarray,
                 k: int, start_t: float, arrive_t: float):
        self.ctx = ctx
        self.idx = idx
        self.qid = qid
        self.q = q
        self.k = k
        self.kind = ctx.kind
        self.gen = None
        self.metrics = QueryMetrics()
        self.start_t = start_t
        self.arrive_t = arrive_t
        self.snapshot = (0, 0)
        self.rounds = 0
        self.n_jobs = 0
        self.shards: set[int] = set()
        self.hedged = False
        self.shed_retries = 0
        self.slots: dict[int, _Slot] = {}
        self.open_slots = 0
        self.local_results: list[SearchResult] = []
        self.payloads: dict = {}
        self.done = False
        self.span = None               # root "query" span when tracing
        self.round_span = None         # open "round" span when tracing


def _scan_plan(q: np.ndarray, reqs: list[FetchRequest], k: int,
               metrics: QueryMetrics, delta_fn=None, dead_fn=None):
    """Shard-local cluster job: fetch my lists, scan, return local top-k.

    ``delta_fn``/``dead_fn`` (live-ingest runs) are evaluated at scan
    time — after the fetch completes — so the job sees the shard's delta
    points for the probed lists and its tombstones *as of the scan
    instant*, not as of scatter: freshness is measured where it happens.
    """
    payloads = yield FetchBatch(list(reqs))
    metrics.roundtrips += 1
    metrics.requests += len(reqs)
    metrics.bytes_read += sum(r.nbytes for r in reqs)
    items = [payloads[rq.key] for rq in reqs]
    if delta_fn is not None:
        ids, vecs = delta_fn()
        if len(ids):
            items.append((ids, vecs))
    exclude = dead_fn() if dead_fn is not None else None
    return scan_posting_lists(q, items, k, metrics, exclude=exclude)


def _fetch_plan(reqs: list[FetchRequest]):
    """Shard-local graph job: fetch my node blocks, return the payloads."""
    payloads = yield FetchBatch(list(reqs))
    return payloads


def _merge_metrics(dst: QueryMetrics, src: QueryMetrics) -> None:
    for f in dataclasses.fields(QueryMetrics):
        setattr(dst, f.name, getattr(dst, f.name) + getattr(src, f.name))


class FleetRouter:
    """Scatter-gather serving over N shard groups on one event kernel."""

    def __init__(self, index, cfg: FleetConfig, partition=None):
        self.index = index
        self.cfg = cfg
        self.partition = partition if partition is not None else \
            partition_for_index(index, cfg.n_shards, cfg.replication,
                                seed=cfg.seed)
        if self.partition.n_shards != cfg.n_shards:
            raise ValueError(
                f"partition has {self.partition.n_shards} shards, config "
                f"says {cfg.n_shards}")
        self.kind = self.partition.kind
        self.dim = index.meta.dim
        pq = getattr(index.meta, "pq", None)
        self.pq_m = pq.m if pq is not None else 0
        #: tenancy installs a per-instance cache-assembly factory here
        #: (None -> each ShardServer builds cfg.make_cache())
        self._cache_factory = None

    @functools.cached_property
    def _exec_table(self):
        """--backend kernel: the calibration table, resolved once per
        router (lazy so subclasses with their own __init__ — the
        tenancy router — get it too); every shard instance gets its own
        coalescer over this shared table."""
        if self.cfg.backend != "kernel":
            return None
        from repro_torch.exec import load_table
        return load_table(self.cfg.calibration)

    def _shard_engine_cfg(self, shard_id: int, instance: int
                          ) -> EngineConfig:
        cfg = self.cfg
        tier = None
        if cfg.nvme_bytes > 0:
            tier = TierConfig(capacity_bytes=cfg.nvme_bytes,
                              policy=cfg.tier_policy,
                              writeback=cfg.nvme_writeback)
        return EngineConfig(
            storage=cfg.storage, concurrency=1,
            cache_bytes=cfg.cache_bytes, cache_policy=cfg.cache_policy,
            hit_latency_s=cfg.hit_latency_s, compute=cfg.compute,
            seed=cfg.seed + shard_id * 7919 + instance * 104729,
            tier=tier)

    def _spawn_server(self, shard_id: int, instance: int) -> ShardServer:
        cfg = self.cfg
        backend_factory = None
        if self._exec_table is not None:
            from repro_torch.exec import KernelBackend
            backend_factory = lambda: KernelBackend(  # noqa: E731
                self._exec_table, window_s=cfg.batch_window_s,
                shard_id=shard_id, instance=instance)
        return ShardServer(
            shard_id, self._shard_engine_cfg(shard_id, instance),
            self._store, kernel=self.kernel, dim=self.ctxs[0].dim,
            pq_m=self.ctxs[0].pq_m, instance=instance,
            max_inflight=cfg.shard_concurrency,
            queue_depth=cfg.queue_depth, on_complete=self._job_done,
            cache_factory=self._cache_factory,
            backend_factory=backend_factory)

    # ------------------------------------------------------------- run ---
    def run(self, queries: np.ndarray, params: SearchParams,
            query_ids: Iterable[int] | None = None, *,
            arrivals: ArrivalProcess | None = None,
            faults: FaultSchedule | None = None,
            autoscale: AutoscaleConfig | None = None,
            slo_s: float | None = None,
            series_dt: float | None = None,
            updates=None, ingest=None,
            tracer: Tracer | None = None,
            monitor: MonitorConfig | None = None,
            pricebook: PriceBook | None = None,
            explain: bool | ExplainConfig = False,
            mrc: bool | MRCConfig = False) -> FleetReport:
        """``updates`` (an :class:`repro.ingest.stream.UpdateStream`)
        turns the run into a read-write workload: the router forwards
        each update to the shard groups owning its keys, every owner
        group ingests independently (its own delta tier, freshness lag
        and compaction schedule, with compaction I/O charged to its own
        instances' storage sims), and rewritten objects are invalidated
        from every instance cache.  With no updates the run is
        byte-identical to the pure-query path.

        ``monitor`` attaches live SLO monitors with burn-rate alerting
        (``repro_torch.obs.monitor``); unless ``monitor.actions`` is set they
        only observe, and the run stays bit-exact.  ``pricebook``
        prices the run (``repro_torch.obs.cost``) into the report's ``cost``
        block — pure post-hoc arithmetic, never a kernel event.

        ``explain`` attaches the tail-explanation collector
        (``repro_torch.obs.explain``; requires ``tracer``) and ``mrc`` the
        online miss-ratio-curve profiler (``repro_torch.obs.mrc``).  Both are
        pure observers — explained/profiled runs stay bit-exact — and
        land in the report's ``explain`` / ``mrc`` blocks."""
        cfg = self.cfg
        qids = list(query_ids) if query_ids is not None else list(
            range(len(queries)))
        arr = arrivals if arrivals is not None else ClosedLoop(
            cfg.concurrency, n_total=len(queries))
        window = arr.window if arr.window is not None else cfg.concurrency
        ctx = _TenantCtx(
            0, self.index, self.partition, queries, params, qids, arr,
            window,
            slo_s=(autoscale.slo_p99_s if autoscale is not None
                   and slo_s is None else slo_s),
            updates=updates, ingest_cfg=ingest)
        wall = self._execute([ctx], faults=faults, autoscale=autoscale,
                             series_dt=series_dt, tracer=tracer,
                             monitor=monitor, pricebook=pricebook,
                             explain=explain, mrc=mrc)
        self.index = ctx.index          # make_mutable may have wrapped it
        stats = [srv.finalize_stats() for g in self.groups
                 for srv in g.all_servers()]
        shards_seconds = sum(srv.active_seconds(wall) for g in self.groups
                             for srv in g.all_servers())
        ingest_dict = None
        if ctx.ingest_report is not None:
            ingest_dict = ctx.ingest_report.to_dict(ctx.records)
        report = FleetReport(
            records=ctx.records, shard_stats=stats, wall_time_s=wall,
            n_shards=cfg.n_shards, replication=cfg.replication,
            concurrency=cfg.concurrency, jobs_total=self._jobs_total,
            hedges_launched=self._hedges, hedge_wins=self._hedge_wins,
            sheds_total=sum(s.sheds for s in stats),
            submissions_total=sum(s.submissions for s in stats),
            scenario=arr.kind, n_arrivals=ctx.adm.arrivals_total,
            offered_qps=ctx.adm.offered_qps(wall), slo_s=ctx.slo_s,
            good_total=ctx.good_total if ctx.slo_s is not None else None,
            series=self._series, shards_seconds=shards_seconds,
            scale_events=(self._autoscaler.events
                          if self._autoscaler is not None else None),
            fault_log=self._fault_log if faults is not None else None,
            ingest=ingest_dict)
        self.attach_obs(report)
        return report

    def attach_obs(self, report: FleetReport) -> None:
        """Attach the monitor's alert block and the priced ``cost``
        block to a finished report.  Costing reads the report's own
        aggregates, so it must run after construction; both land in
        dedicated fields so bit-exactness checks can compare everything
        else unchanged."""
        if self._slo_monitor is not None:
            report.alerts = self._slo_monitor.summary()
            report.alerts["actions"] = list(self._alert_actions)
        if self._pricebook is not None:
            report.cost = fleet_cost(report, self.cfg, self._pricebook)
        if self._explain is not None:
            report.explain = self._explain.explain_tail()
        if self._mrc is not None:
            report.mrc = self._mrc.to_dict(wall_s=report.wall_time_s)

    def _execute(self, ctxs: list[_TenantCtx], *,
                 faults: FaultSchedule | None = None,
                 autoscale: AutoscaleConfig | None = None,
                 series_dt: float | None = None,
                 tracer: Tracer | None = None,
                 monitor: MonitorConfig | None = None,
                 pricebook: PriceBook | None = None,
                 explain: bool | ExplainConfig = False,
                 mrc: bool | MRCConfig = False) -> float:
        """Drive the shared kernel over all tenant contexts; returns the
        run's wall time.  One context reproduces the pre-tenancy event
        sequence exactly (same RNG streams, same scheduling order).

        ``tracer`` records the run's span trees and metrics.  Tracing
        never perturbs the schedule — spans are written from state the
        router already has — so traced and untraced runs are bit-exact.
        """
        cfg = self.cfg
        self.ctxs = ctxs
        self._store = _TenantStore(ctxs)
        self.kernel = Kernel(seed=cfg.seed)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.tracer.attach(self.kernel)
        # Tail-explanation collector: folds every finished query's span
        # tree into exemplar reservoirs + windowed attribution.  Pure
        # observer — it reads spans the tracer already holds.
        self._explain = None
        if explain:
            if not self.tracer.enabled:
                raise ValueError("explain requires a tracer")
            self._explain = ExplainCollector(
                self.tracer,
                explain if isinstance(explain, ExplainConfig) else None)
        # Online MRC profiler: attaches to every instance cache as a
        # read-only access-stream observer.  Wrapping the cache factory
        # (rather than the built caches) keeps the observer attached
        # across cold-cache fault recovery and autoscale spawns.
        self._mrc = None
        if mrc:
            names = {c.tid: ("fleet" if len(ctxs) == 1 else c.name)
                     for c in ctxs}
            self._mrc = MRCProfiler(
                mrc if isinstance(mrc, MRCConfig) else None,
                ref_bytes=cfg.cache_bytes, tenant_names=names)
            base_factory = self._cache_factory
            if base_factory is None:
                base_factory = self._shard_engine_cfg(0, 0).make_cache
            self._cache_factory = self._mrc.wrap_factory(base_factory)
        self.groups = [ShardGroup(s, self._spawn_server)
                       for s in range(cfg.n_shards)]
        for ctx in ctxs:
            ctx.adm = AdmissionWindow(
                self.kernel, ctx.window,
                lambda item, t, ctx=ctx: self._begin_query(
                    ctx, item[0], item[1], t))
        self._ctx: dict[int, tuple] = {}   # tag -> (query, slot, attempt, t)
        self._live_queries: set[_FleetQuery] = set()
        self._tag_seq = 0
        self._slot_seq = 0
        self._lat: deque = deque(maxlen=256)
        self._rng = self.kernel.rng("router", seed=cfg.seed ^ 0xF1EE7)
        self._jobs_total = 0
        self._hedges = 0
        self._hedge_wins = 0
        self._retry_pending = 0
        self._fault_log: list[dict] = []
        self.recent_sojourns: deque = deque(
            maxlen=autoscale.window if autoscale is not None else 256)
        # monitor + controller processes
        self._series: FleetSeries | None = None
        self._monitor = None
        self._slice_counts = [0, 0, 0]     # arrived, completed, good
        need_monitor = (series_dt is not None or autoscale is not None
                        or faults is not None or len(ctxs) > 1
                        or any(c.arrivals.kind != "closed" for c in ctxs))
        if need_monitor:
            dt = series_dt if series_dt is not None else 0.05
            self._series = FleetSeries(dt=dt)
            self._monitor = self.kernel.every(dt, self._sample_slice)
        # Periodic metrics snapshots for the trace's counter tracks.  The
        # ticker only *reads* router state; its events consume sequence
        # numbers, which shifts later seqs uniformly and so preserves the
        # relative order of every other event pair — goldens stay exact.
        self._obs_ticker = None
        if self.tracer.enabled:
            self._obs_ticker = self.kernel.every(
                series_dt if series_dt is not None else 0.05,
                self._obs_snapshot)
        # Live SLO monitors (repro_torch.obs.monitor).  Like the obs ticker,
        # the evaluation tick only reads router state and shifts later
        # event seqs uniformly, so monitoring keeps runs bit-exact;
        # only the (opt-in) action bus may perturb the schedule.
        self._pricebook = pricebook
        self._slo_monitor = None
        self._monitor_ticker = None
        self._alert_actions: list[dict] = []
        if monitor is not None:
            self._slo_monitor = FleetMonitor(monitor, tracer=self.tracer)
            if self._explain is not None:
                # every fired alert snapshots its own root-cause bundle
                self._slo_monitor.forensics_provider = (
                    lambda now: self._explain.forensics(
                        now, self.tracer.metrics))
            for ctx in ctxs:
                if ctx.slo_s is not None:
                    self._slo_monitor.monitor(
                        f"{self._mon_name(ctx)}.latency", kind="latency",
                        tenant=ctx.name)
            self._monitor_ticker = self.kernel.every(
                monitor.interval_s, self._monitor_tick)
        # Instance-count limits for scale_up_one/scale_down_one: the
        # autoscaler's bounds when it runs, else the monitor's cap for
        # alert-driven scale-out.
        self._scale_min = 1
        self._scale_max = 4
        if autoscale is not None:
            self._scale_min = autoscale.min_instances
            self._scale_max = autoscale.max_instances
        elif monitor is not None:
            self._scale_max = monitor.max_instances
        self._autoscaler = None
        if autoscale is not None:
            self._autoscaler = Autoscaler(autoscale, self)
            self._autoscaler.start(self.kernel)
        if self._slo_monitor is not None and monitor.actions:
            self._slo_monitor.bus.subscribe(self._alert_scale_out)
            self._slo_monitor.bus.subscribe(self._alert_admission)
        if faults is not None:
            faults.install(self.kernel, self)
        for ctx in ctxs:
            if ctx.updates is not None and len(ctx.updates):
                self._setup_ingest(ctx)
                ctx.updates.start(
                    self.kernel,
                    lambda op, ctx=ctx: self._deliver_update(ctx, op))

        for ctx in ctxs:
            ctx.arrivals.start(
                self.kernel,
                lambda ai, wi, ctx=ctx: self._arrive(ctx, ai, wi),
                len(ctx.queries),
                done=lambda ctx=ctx: self._arrivals_exhausted(ctx))
        self.kernel.run()

        wall = max((r.end_t for ctx in ctxs for r in ctx.records),
                   default=0.0)
        if self._series is not None:
            self._flush_slice(wall)
        for ctx in ctxs:
            if ctx.ingest_report is not None:
                for agent in ctx.ingest_agents.values():
                    agent.finalize()
        return wall

    # ----------------------------------------------------------- ingest --
    def _setup_ingest(self, ctx: _TenantCtx) -> None:
        """One :class:`IngestAgent` per shard group: independent delta
        tier, apply queue and compaction schedule, with compaction I/O
        charged through the group's live instances' storage sims."""
        from repro_torch.ingest.compaction import IngestAgent, IngestConfig
        from repro_torch.ingest.metrics import IngestReport
        from repro_torch.ingest.mutable import make_mutable
        ctx.index = make_mutable(ctx.index)
        ctx.ingest_report = IngestReport()
        cfg = ctx.ingest_cfg if ctx.ingest_cfg is not None else \
            IngestConfig()
        for g in self.groups:
            owned = None
            if ctx.kind == "cluster":
                owned = {li for li in range(ctx.index.meta.n_lists)
                         if g.shard_id in
                         ctx.partition.owners(("list", li))}

            def provider(g=g):
                # write_path IS the remote sim on flat instances; on a
                # write-back tier it lands compaction PUTs locally first
                srv = g.pick()
                return srv.engine.write_path if srv is not None else None

            ctx.ingest_agents[g.shard_id] = IngestAgent(
                ctx.index, site_id=g.shard_id, kernel=self.kernel,
                cfg=cfg, compute=self.cfg.compute, sim_provider=provider,
                report=ctx.ingest_report,
                invalidate=lambda key, ctx=ctx: self._invalidate_key(
                    ctx.tid, key),
                on_new_list=lambda new_li, parent_li, ctx=ctx:
                    self._on_new_list(ctx, new_li, parent_li),
                owned_lists=owned, inflight_floor=self.inflight_floor)
        if (self._slo_monitor is not None
                and self._slo_monitor.cfg.freshness_slo_s is not None):
            bound = self._slo_monitor.cfg.freshness_slo_s
            mname = self._mon_name(ctx)
            ctx.ingest_report.on_apply = (
                lambda kind, lag, ctx=ctx, mname=mname, bound=bound:
                    self._slo_monitor.observe_freshness(
                        self.kernel.now, f"{mname}.freshness", lag,
                        bound, tenant=ctx.name))

    def _invalidate_key(self, tid: int, key) -> None:
        """Broadcast a rewritten object's staleness to every instance
        cache and NVMe tier (non-owners never cached the key; dropping
        is a no-op).  On a write-back tier the owning shards' instances
        additionally admit the rewritten object to NVMe residency at its
        new size — the compaction PUT just landed on their device."""
        wrapped = (tid,) + key
        wb_nbytes = None
        owners: tuple[int, ...] = ()
        if self.cfg.nvme_writeback:
            wb_nbytes = self._key_nbytes(self.ctxs[tid], key)
            if wb_nbytes is not None:
                owners = self.ctxs[tid].partition.owners(key)
        for g in self.groups:
            wb = wb_nbytes if g.shard_id in owners else None
            for srv in g.all_servers():
                srv.invalidate(wrapped, writeback_nbytes=wb)

    @staticmethod
    def _key_nbytes(ctx: _TenantCtx, key) -> int | None:
        """Current (post-install) size of a native fetch key."""
        if key[0] == "list":
            meta = ctx.index.meta
            if key[1] < len(meta.list_nbytes):
                return int(meta.list_nbytes[key[1]])
            return None
        node_nbytes = getattr(ctx.index, "node_nbytes", None)
        return int(node_nbytes()) if callable(node_nbytes) else None

    def _on_new_list(self, ctx: _TenantCtx, new_li: int,
                     parent_li: int) -> None:
        """A re-cluster split: the new posting list inherits the parent's
        replica owners (no data movement) and joins owned-list sets."""
        ctx.partition.inherit(new_li, parent_li)
        owners = set(ctx.partition.owners(("list", new_li)))
        for sid, agent in ctx.ingest_agents.items():
            if agent.owned_lists is not None and sid in owners:
                agent.owned_lists.add(new_li)

    def _deliver_update(self, ctx: _TenantCtx, op) -> None:
        """Route one update to the shard groups owning its keys.  Each
        owner group applies its own copy — delta-tier replication
        mirroring the sealed replication, so any replica owner can serve
        a probed list's fresh points."""
        if ctx.kind == "cluster":
            if op.kind == "insert":
                lists, ndist = ctx.index.assign_lists(op.vec)
            else:
                lists, ndist = ctx.index.lists_of(op.id), 0
            owner_set = {s for li in lists
                         for s in ctx.partition.owners(("list", li))}
            if op.kind == "delete":
                # the victim may still be delta-only on some sites
                for sid, mem in ctx.index.sites.items():
                    if op.id in mem.entries:
                        owner_set.add(sid)
                if not owner_set:
                    # the insert is still in some apply queue (delivered
                    # but not applied): broadcast — per-site FIFO apply
                    # order serializes the delete behind its insert at
                    # the sites that will hold it, and a spurious
                    # tombstone elsewhere clears at that site's next
                    # flush
                    owner_set = set(ctx.ingest_agents)
            for s in sorted(owner_set):
                agent = ctx.ingest_agents[s]
                mine = tuple(li for li in lists if agent.owned_lists
                             is None or li in agent.owned_lists)
                agent.deliver(op, lists=mine, ndist=ndist)
        else:
            # graph delta is single-homed on the primary hash owner; the
            # router's merged search reads every site, so placement does
            # not affect visibility.
            owner = ctx.partition.owners(("node", op.id))[0]
            ctx.ingest_agents[owner].deliver(op, lists=(), ndist=0)

    # ------------------------------------------------- arrivals / window --
    def _arrive(self, ctx: _TenantCtx, arrival_idx: int,
                workload_idx: int) -> None:
        self._slice_counts[0] += 1
        ctx.adm.offer((arrival_idx, workload_idx), key=arrival_idx)

    def _arrivals_exhausted(self, ctx: _TenantCtx) -> None:
        ctx.adm.mark_exhausted()
        self._maybe_shutdown()

    def _maybe_shutdown(self) -> None:
        """Stop the monitor/controller tickers once every tenant's
        workload drains — they would otherwise keep the kernel alive
        forever."""
        if not all(ctx.adm.drained for ctx in self.ctxs):
            return
        if self._monitor is not None:
            self._monitor.cancel()
        if self._obs_ticker is not None:
            self._obs_ticker.cancel()
        if self._monitor_ticker is not None:
            self._monitor_ticker.cancel()
        if self._autoscaler is not None:
            self._autoscaler.stop()

    # ----------------------------------------------------- query driver --
    def _price(self, fq: _FleetQuery) -> float:
        """Charge router-side compute since the last checkpoint.

        On the kernel backend the router's own work (list selection,
        merges) is priced from the same calibration table as the shards
        — at batch-of-one, since router work is per-query."""
        m = fq.metrics
        d0, p0 = fq.snapshot
        fq.snapshot = (m.dist_comps, m.pq_dist_comps)
        if self._exec_table is not None:
            return self._exec_table.plan_seconds(
                m.dist_comps - d0, m.pq_dist_comps - p0,
                fq.ctx.dim, fq.ctx.pq_m)
        return plan_compute_seconds(m.dist_comps - d0,
                                    m.pq_dist_comps - p0,
                                    fq.ctx.dim, fq.ctx.pq_m,
                                    self.cfg.compute)

    def _begin_query(self, ctx: _TenantCtx, arrival_idx: int,
                     workload_idx: int, t: float) -> None:
        q = ctx.queries[workload_idx]
        fq = _FleetQuery(ctx, arrival_idx, ctx.qids[workload_idx], q,
                         ctx.params.k, t,
                         ctx.adm.pop_arrive_t(arrival_idx))
        self._live_queries.add(fq)
        tr = self.tracer
        if tr.enabled:
            fq.span = tr.begin("query", fq.arrive_t, parent=None,
                               qid=fq.qid, tenant=ctx.name, tid=ctx.tid,
                               kind=ctx.kind)
            if t > fq.arrive_t:
                tr.record("admission", fq.arrive_t, t, parent=fq.span)
            tr.metrics.counter("fleet.queries").inc()
            tr.metrics.counter(f"tenant.{ctx.name}.queries").inc()
        meta = ctx.index.meta
        if ctx.kind == "cluster":
            lids, ndist = ctx.index.select_lists(q, ctx.params.nprobe)
            fq.metrics.dist_comps += ndist
            fq.metrics.lists_visited = len(lids)
            reqs = [FetchRequest((ctx.tid, "list", int(i)),
                                 int(meta.list_nbytes[i])) for i in lids]
        else:
            fq.gen = ctx.index.search_plan(q, ctx.params, fq.metrics)
            batch = next(fq.gen)
            reqs = [FetchRequest((ctx.tid,) + rq.key, rq.nbytes)
                    for rq in batch.requests]
        dt = self._price(fq)
        if tr.enabled:
            tr.record("route", t, t + dt, parent=fq.span)
        self.kernel.at(t + dt, self._scatter, fq, reqs)

    # ---------------------------------------------------------- scatter --
    def _owners(self, fq: _FleetQuery, key) -> tuple[int, ...]:
        """Replica owners of a tenant-namespaced fetch key."""
        return fq.ctx.partition.owners(key[1:])

    def _group_has_capacity(self, shard: int) -> bool:
        srv = self.groups[shard].pick()
        return srv is not None and srv.has_capacity

    def _pick_replica(self, owners: tuple[int, ...],
                      exclude: int | None = None) -> int | None:
        """Power-of-two-choices by shard queue depth over live shards.

        Returns None when no owner is alive (the caller backs off and
        retries — the keys become routable again at recovery)."""
        cand = [s for s in owners if s != exclude and self.groups[s].alive]
        if not cand:
            cand = [s for s in owners if self.groups[s].alive]
            if not cand:
                return None
        if len(cand) == 1:
            return cand[0]
        if len(cand) == 2:
            a, b = cand
        else:
            i, j = self._rng.choice(len(cand), size=2, replace=False)
            a, b = cand[int(i)], cand[int(j)]
        la, lb = self.groups[a].load, self.groups[b].load
        if la != lb:
            return a if la < lb else b
        return min(a, b)

    def _scatter(self, fq: _FleetQuery, reqs: list[FetchRequest]) -> None:
        """Fan one round's requests out by replica-chosen owner."""
        t = self.kernel.now
        fq.rounds += 1
        if self.tracer.enabled:
            fq.round_span = self.tracer.begin("round", t, parent=fq.span,
                                              idx=fq.rounds)
        fq.slots = {}
        fq.payloads = {}
        groups: dict[int | None, list[FetchRequest]] = {}
        for rq in reqs:
            shard = self._pick_replica(self._owners(fq, rq.key))
            groups.setdefault(shard, []).append(rq)
        order = sorted(groups, key=lambda s: (s is None, s))
        for shard in order:
            slot = _Slot(self._slot_seq, groups[shard],
                         shard if shard is not None else -1)
            self._slot_seq += 1
            fq.slots[slot.slot_id] = slot
        fq.open_slots = len(fq.slots)
        for slot in fq.slots.values():
            if slot.shard < 0:                 # no live owner right now
                fq.shed_retries += 1
                self._schedule_retry(fq, slot)
            else:
                self._submit_primary(fq, slot, t)

    def _make_plan(self, fq: _FleetQuery, reqs: list[FetchRequest],
                   metrics: QueryMetrics, shard: int):
        ctx = fq.ctx
        if ctx.kind == "cluster":
            delta_fn = dead_fn = None
            if ctx.ingest_agents:
                mem = ctx.index.sites.get(shard)
                lids = tuple(int(rq.key[2]) for rq in reqs)
                if mem is not None:
                    delta_fn = lambda: mem.live_items(lids)  # noqa: E731
                dead_fn = ctx.index.deleted_array
            return _scan_plan(fq.q, reqs, fq.k, metrics,
                              delta_fn=delta_fn, dead_fn=dead_fn)
        return _fetch_plan(reqs)

    def _schedule_retry(self, fq: _FleetQuery, slot: _Slot) -> None:
        if fq.shed_retries > RETRY_LIMIT:
            raise RuntimeError(
                f"query {fq.qid} retried {fq.shed_retries} times — keys "
                f"unroutable (every replica owner down with no recovery?)")
        self._retry_pending += 1
        self.kernel.after(self.cfg.shed_retry_s, self._retry_fire, fq, slot)

    def _retry_fire(self, fq: _FleetQuery, slot: _Slot) -> None:
        self._retry_pending -= 1
        self._retry_slot(fq, slot, self.kernel.now)

    def _retry_slot(self, fq: _FleetQuery, slot: _Slot, t: float) -> None:
        """A shed or orphaned slot comes back with fresh per-key replica
        choice, avoiding the shard that rejected (or lost) it.  Keys that
        re-group onto several shards split into new slots."""
        if slot.done or fq.done:
            return
        groups: dict[int, list[FetchRequest]] = {}
        for rq in slot.reqs:
            owners = self._owners(fq, rq.key)
            shard = self._pick_replica(
                owners, exclude=slot.shard if len(owners) > 1 else None)
            if shard is None:                  # every owner is down
                fq.shed_retries += 1
                self._schedule_retry(fq, slot)
                return
            groups.setdefault(shard, []).append(rq)
        if len(groups) == 1:
            slot.shard = next(iter(groups))
            self._submit_primary(fq, slot, t)
            return
        # The slot splits across shards: retire the old slot object so a
        # hedge timer still holding it cannot resurrect it (which would
        # double-decrement open_slots via ghost hedge jobs).
        slot.done = True
        del fq.slots[slot.slot_id]
        fq.open_slots -= 1
        for shard in sorted(groups):
            ns = _Slot(self._slot_seq, groups[shard], shard)
            self._slot_seq += 1
            fq.slots[ns.slot_id] = ns
            fq.open_slots += 1
            self._submit_primary(fq, ns, t)

    def _submit_primary(self, fq: _FleetQuery, slot: _Slot,
                        t: float) -> None:
        """Submit a slot to its chosen shard; shed -> backoff retry."""
        cfg = self.cfg
        if slot.done or fq.done:
            return
        shard = slot.shard
        srv = self.groups[shard].pick()
        metrics = QueryMetrics()
        tag = self._tag_seq
        self._tag_seq += 1
        plan = self._make_plan(fq, slot.reqs, metrics, shard)
        if srv is not None and srv.try_submit(t, plan, metrics, tag,
                                              dim=fq.ctx.dim,
                                              pq_m=fq.ctx.pq_m):
            slot.outstanding.setdefault(0, set()).add(tag)
            slot.collected.setdefault(0, [])
            self._ctx[tag] = (fq, slot, 0, t)
            self._jobs_total += 1
            fq.n_jobs += 1
            fq.shards.add(shard)
            if (cfg.hedge and cfg.replication > 1
                    and not slot.hedge_launched
                    and len(self._lat) >= cfg.hedge_min_samples):
                deadline = float(np.percentile(
                    np.asarray(self._lat), cfg.hedge_percentile))
                self.kernel.at(t + deadline, self._maybe_hedge, fq, slot)
        else:
            fq.shed_retries += 1
            self._schedule_retry(fq, slot)

    def _maybe_hedge(self, fq: _FleetQuery, slot: _Slot) -> None:
        """Deadline fired: re-issue the slot's keys on the other replicas."""
        t = self.kernel.now
        if fq.done or slot.done or slot.hedge_launched:
            return
        slot.hedge_launched = True
        groups: dict[int, list[FetchRequest]] = {}
        for rq in slot.reqs:
            owners = self._owners(fq, rq.key)
            alt = [s for s in owners
                   if s != slot.shard and self.groups[s].alive]
            if not alt:
                return                     # un-hedgeable key (R=1 / faults)
            shard = self._pick_replica(tuple(alt))
            if shard is None:
                return
            groups.setdefault(shard, []).append(rq)
        # hedge only when every target replica would admit the duplicate
        # right now — a loaded fleet gets no speculative extra work, and
        # no hedge sub-job is ever orphaned by a partial shed.
        if any(not self._group_has_capacity(s) for s in groups):
            return
        self._hedges += 1
        fq.hedged = True
        if self.tracer.enabled:
            self.tracer.metrics.counter("fleet.hedges").inc()
        slot.outstanding[1] = set()
        slot.collected[1] = []
        for shard in sorted(groups):
            metrics = QueryMetrics()
            tag = self._tag_seq
            self._tag_seq += 1
            plan = self._make_plan(fq, groups[shard], metrics, shard)
            self.groups[shard].pick().try_submit(t, plan, metrics, tag,
                                                 dim=fq.ctx.dim,
                                                 pq_m=fq.ctx.pq_m)
            slot.outstanding[1].add(tag)
            self._ctx[tag] = (fq, slot, 1, t)
            self._jobs_total += 1
            fq.n_jobs += 1
            fq.shards.add(shard)

    # ----------------------------------------------------------- gather --
    def _record_job_span(self, fq: _FleetQuery, attempt: int,
                         t_submit: float, server: ShardServer,
                         job: JobRecord, *, stale: bool) -> None:
        """Synthesize a completed shard job's span sub-tree.

        Consumed jobs hang off the query's current round; work the
        query did not wait for (hedge-race losers, post-abort
        completions) is parentless with ``wasted=True`` — it ends after
        the round closed, so parenting it would break the child-within-
        parent tree invariant.  A flow arrow still ties hedges back to
        the round that launched them.
        """
        tr = self.tracer
        attrs = dict(shard=server.shard_id, instance=server.instance,
                     attempt=attempt, qid=fq.qid, tid=fq.ctx.tid)
        if stale:
            attrs["wasted"] = True
        sp = tr.record("shard_job", t_submit, job.end_t,
                       parent=None if stale else fq.round_span, **attrs)
        emit_job_spans(tr, sp, t_submit, job)
        if attempt > 0 and fq.round_span is not None:
            tr.flow(fq.round_span, sp)
        tr.metrics.counter("fleet.jobs").inc()
        if stale:
            tr.metrics.counter("fleet.jobs_wasted").inc()
        tr.metrics.histogram("shard.job_sojourn_s").observe(
            job.end_t - t_submit)

    def _job_done(self, server: ShardServer, job: JobRecord) -> None:
        ctx = self._ctx.pop(job.tag, None)
        if ctx is None:
            return
        fq, slot, attempt, t_submit = ctx
        self._lat.append(job.end_t - t_submit)
        _merge_metrics(fq.metrics, job.metrics)
        stale = fq.done or slot.done or attempt not in slot.outstanding
        if self.tracer.enabled:
            self._record_job_span(fq, attempt, t_submit, server, job,
                                  stale=stale)
        if stale:
            return                          # stale (hedge race loser)
        open_tags = slot.outstanding[attempt]
        open_tags.discard(job.tag)
        slot.collected[attempt].append(job.result)
        if open_tags:
            return                          # more sub-jobs of this attempt
        slot.done = True
        if attempt > 0:
            self._hedge_wins += 1
        if fq.kind == "cluster":
            fq.local_results.extend(slot.collected[attempt])
        else:
            for payloads in slot.collected[attempt]:
                for key, val in payloads.items():
                    fq.payloads[key[1:]] = val     # un-namespace for plan
        fq.open_slots -= 1
        if fq.open_slots == 0:
            self._round_done(fq, job.end_t)

    def _round_done(self, fq: _FleetQuery, t: float) -> None:
        tr = self.tracer
        if tr.enabled and fq.round_span is not None:
            tr.end(fq.round_span, t)
        if fq.kind == "cluster":
            ids, dists = merge_topk(fq.local_results, fq.k)
            if tr.enabled:
                tr.record("merge", t, t, parent=fq.span)
            self._finish_query(fq, t, ids, dists)
            return
        # graph: resume the beam-search generator with this round's blocks
        # (router-side snapshot excludes shard-merged counters, so compute
        # pricing charges only the plan's own ADC/exact work)
        fq.snapshot = (fq.metrics.dist_comps, fq.metrics.pq_dist_comps)
        try:
            batch = fq.gen.send(fq.payloads)
        except StopIteration as stop:
            res = stop.value
            if fq.ctx.ingest_agents:
                # router-side delta merge + tombstone filter: the graph
                # delta lives in site memtables the beam never traversed
                res = fq.ctx.index.merge_result(fq.q, fq.k, res,
                                                fq.metrics)
            dt = self._price(fq)
            if tr.enabled:
                tr.record("merge", t, t + dt, parent=fq.span)
            self._finish_query(fq, t + dt, res.ids, res.dists)
            return
        reqs = [FetchRequest((fq.ctx.tid,) + rq.key, rq.nbytes)
                for rq in batch.requests]
        dt = self._price(fq)
        if tr.enabled:
            tr.record("route", t, t + dt, parent=fq.span)
        self.kernel.at(t + dt, self._scatter, fq, reqs)

    def inflight_floor(self) -> float:
        """Earliest start time among in-flight queries (inf when idle) —
        the reclamation safety line: no corpse unlinked before it can
        still be referenced by any live sub-request."""
        return min((fq.start_t for fq in self._live_queries),
                   default=float("inf"))

    def _finish_query(self, fq: _FleetQuery, t: float, ids: np.ndarray,
                      dists: np.ndarray) -> None:
        fq.done = True
        self._live_queries.discard(fq)
        ctx = fq.ctx
        ctx.records.append(FleetQueryRecord(
            qid=fq.qid, start_t=fq.start_t, end_t=t, ids=ids, dists=dists,
            metrics=fq.metrics, rounds=fq.rounds, n_jobs=fq.n_jobs,
            shards_touched=len(fq.shards), hedged=fq.hedged,
            shed_retries=fq.shed_retries, arrive_t=fq.arrive_t))
        sojourn = t - fq.arrive_t
        tr = self.tracer
        if tr.enabled and fq.span is not None:
            tr.end(fq.span, t)
            tr.metrics.histogram("fleet.sojourn_s").observe(sojourn)
            tr.metrics.histogram("fleet.latency_s").observe(t - fq.start_t)
            if self._explain is not None:
                self._explain.on_query(fq.span)
        self.recent_sojourns.append(sojourn)
        self._slice_counts[1] += 1
        if ctx.slo_s is not None and sojourn <= ctx.slo_s:
            ctx.good_total += 1
            self._slice_counts[2] += 1
        if self._slo_monitor is not None:
            mon = self._slo_monitor
            mname = self._mon_name(ctx)
            if ctx.slo_s is not None:
                mon.observe_latency(t, f"{mname}.latency", sojourn,
                                    ctx.slo_s, tenant=ctx.name)
            mcfg = mon.cfg
            if mcfg.recall_target is not None and mcfg.gt_ids is not None:
                gt = mcfg.gt_ids
                if isinstance(gt, dict):
                    gt = gt.get(ctx.name)
                if gt is not None and fq.qid < len(gt):
                    rec = recall_at_k(ids[ids >= 0], gt[fq.qid])
                    mon.observe_recall(t, f"{mname}.recall", rec,
                                       mcfg.recall_target,
                                       tenant=ctx.name)
        if not ctx.adm.release(t):
            self._maybe_shutdown()

    # ------------------------------------------------- faults / scaling --
    def fail_shard(self, shard: int) -> None:
        t = self.kernel.now
        tags = self.groups[shard].fail_all(t)
        self._fault_log.append(dict(t=round(t, 6), event="fail",
                                    shard=shard, jobs_aborted=len(tags)))
        if self.tracer.enabled:
            self.tracer.instant("shard_fail", t, shard=shard,
                                jobs_aborted=len(tags))
        for tag in tags:
            self._job_aborted(tag, shard)

    def recover_shard(self, shard: int) -> None:
        t = self.kernel.now
        self.groups[shard].recover_all(t)
        self._fault_log.append(dict(t=round(t, 6), event="recover",
                                    shard=shard))
        if self.tracer.enabled:
            self.tracer.instant("shard_recover", t, shard=shard)

    def _job_aborted(self, tag: int, shard: int) -> None:
        """A shard died under this sub-job: re-route its slot to the
        surviving replica owners (or back off until one recovers)."""
        ctx = self._ctx.pop(tag, None)
        if ctx is None:
            return
        fq, slot, attempt, t_submit = ctx
        if self.tracer.enabled:
            # no JobRecord exists for an aborted job; record the doomed
            # interval as parentless wasted work ending at the fault
            self.tracer.record("shard_job", t_submit, self.kernel.now,
                               parent=None, shard=shard, attempt=attempt,
                               qid=fq.qid, tid=fq.ctx.tid, wasted=True,
                               aborted=True)
            self.tracer.metrics.counter("fleet.jobs_aborted").inc()
        if fq.done or slot.done:
            return
        if attempt not in slot.outstanding:
            return
        # The attempt lost one of its sub-jobs, so it can never gather a
        # complete key set again — drop it wholesale.  Surviving sibling
        # tags become stale (their completions are ignored in _job_done),
        # exactly like hedge-race losers; any other attempt still covers
        # every key of the slot.
        slot.outstanding.pop(attempt)
        slot.collected.pop(attempt, None)
        if not slot.outstanding:           # no live attempt remains
            self._retry_slot(fq, slot, self.kernel.now)

    @property
    def total_instances(self) -> int:
        return sum(len(g.routable) for g in self.groups)

    def scale_up_one(self) -> bool:
        cands = [g for g in self.groups
                 if g.alive and len(g.routable) < self._scale_max]
        if not cands:
            return False
        grp = max(cands, key=lambda g: (
            sum(s.load for s in g.routable) / len(g.routable),
            -g.shard_id))
        grp.scale_up()
        return True

    def scale_down_one(self) -> bool:
        cands = [g for g in self.groups
                 if len(g.routable) > self._scale_min]
        if not cands:
            return False
        grp = min(cands, key=lambda g: (
            sum(s.load for s in g.routable) / len(g.routable),
            g.shard_id))
        return grp.begin_drain(self.kernel.now) is not None

    # -------------------------------------------- live SLO monitoring --
    def _mon_name(self, ctx: _TenantCtx) -> str:
        """Monitor namespace: ``fleet`` for the single-tenant run,
        the tenant name otherwise."""
        return "fleet" if len(self.ctxs) == 1 else ctx.name

    def _monitor_tick(self, now: float) -> None:
        """Rule-evaluation tick: reads monitor state, fires/clears
        alerts.  With the action bus disabled this is read-only."""
        self._slo_monitor.tick(now)

    def _alert_scale_out(self, event: str, alert, now: float) -> None:
        """Action-bus subscriber: a *page* (fast-burn) latency alert
        adds an instance to the most loaded shard.  Routed through the
        autoscaler when one is running so both policies share a
        cooldown and an event log; standalone otherwise, capped by
        ``MonitorConfig.max_instances``."""
        if event != "fired" or alert.severity != "page":
            return
        if not alert.monitor.endswith(".latency"):
            return
        if self._autoscaler is not None:
            acted = self._autoscaler.alert_scale_up(now, alert)
        else:
            acted = self.scale_up_one()
        if acted:
            self._alert_actions.append(dict(
                t=round(now, 6), action="scale_up",
                monitor=alert.monitor, rule=alert.rule,
                instances=self.total_instances))
            if self.tracer.enabled:
                self.tracer.instant("alert_action_scale_up", now,
                                    monitor=alert.monitor,
                                    instances=self.total_instances)

    def _alert_admission(self, event: str, alert, now: float) -> None:
        """Action-bus subscriber: a *ticket* (slow sustained burn)
        latency alert from one tenant of a multi-tenant fleet shrinks
        that tenant's admission window by one (floor 1), restored on
        clear.  The over-budget tenant's excess queries wait in its own
        backlog instead of occupying shared shard queues — its burn
        becomes backlog wait it already owns, and the other tenants'
        queues drain."""
        if len(self.ctxs) <= 1 or alert.tenant is None:
            return
        if alert.severity != "ticket" or \
                not alert.monitor.endswith(".latency"):
            return
        ctx = next((c for c in self.ctxs if c.name == alert.tenant),
                   None)
        if ctx is None or ctx.adm is None:
            return
        if event == "fired":
            if ctx.adm.window <= 1:
                return
            ctx.adm.window -= 1
            action = "deprioritize"
        else:
            if ctx.adm.window >= ctx.window:
                return
            ctx.adm.window += 1
            action = "restore"
        self._alert_actions.append(dict(
            t=round(now, 6), action=action, tenant=ctx.name,
            monitor=alert.monitor, rule=alert.rule,
            window=ctx.adm.window))
        if self.tracer.enabled:
            self.tracer.instant(f"alert_action_{action}", now,
                                tenant=ctx.name, window=ctx.adm.window)

    def _running_cost(self, now: float) -> dict:
        """Dollars accrued so far (read-only; feeds the trace's cost
        counter tracks — the final report uses :func:`fleet_cost`)."""
        get_req = put_req = read_bytes = 0
        inst_s = 0.0
        for g in self.groups:
            for srv in g.all_servers():
                sim = srv.engine.sim
                get_req += sim.total_requests - sim.total_put_requests
                put_req += sim.total_put_requests
                read_bytes += sim.total_bytes - sim.total_put_bytes
                inst_s += srv.active_seconds(now)
        comp = self._pricebook.components(
            get_requests=get_req, put_requests=put_req,
            read_bytes=read_bytes, instance_seconds=inst_s,
            cache_byte_seconds=self.cfg.cache_bytes * inst_s,
            nvme_byte_seconds=self.cfg.nvme_bytes * inst_s)
        comp["total_usd"] = sum(comp.values())
        return comp

    # ----------------------------------------------------------- monitor --
    def _queue_depth(self) -> int:
        depth = self._retry_pending + sum(c.adm.depth for c in self.ctxs)
        for g in self.groups:
            depth += sum(s.load for s in g.instances)
        return depth

    def _sample_slice(self, now: float) -> None:
        self._flush_slice(now)

    def _obs_snapshot(self, now: float) -> None:
        """Read-only metrics tick: gauges + one time-series row."""
        m = self.tracer.metrics
        m.gauge("fleet.queue_depth").set(self._queue_depth())
        m.gauge("fleet.instances").set(self.total_instances)
        if self.cfg.nvme_bytes > 0:
            # per-tier hit/byte gauges (flat runs emit none of these,
            # keeping pre-tier metric exports byte-identical)
            hits = misses = nvme_b = used = 0
            for g in self.groups:
                for srv in g.all_servers():
                    tier = srv.engine.tier
                    if tier is None:
                        continue
                    hits += tier.hits
                    misses += tier.misses
                    nvme_b += tier.nvme_bytes
                    used += tier.used_bytes
            m.gauge("tier.nvme.hits").set(hits)
            m.gauge("tier.nvme.misses").set(misses)
            m.gauge("tier.nvme.bytes").set(nvme_b)
            m.gauge("tier.nvme.used_bytes").set(used)
        if self._pricebook is not None:
            for k, v in self._running_cost(now).items():
                m.gauge(f"cost.{k}").set(round(v, 9))
        if self._explain is not None:
            self._explain.publish(m)
        if self._mrc is not None:
            self._mrc.publish(m)
        m.snapshot(now)

    def _flush_slice(self, now: float) -> None:
        a, c, g = self._slice_counts
        self._slice_counts = [0, 0, 0]
        self._series.append(t=now, arrived=a, completed=c, good=g,
                            queue_depth=self._queue_depth(),
                            instances=self.total_instances)


def run_fleet(index, queries: np.ndarray, params: SearchParams,
              cfg: FleetConfig,
              query_ids: Iterable[int] | None = None, *,
              arrivals: ArrivalProcess | None = None,
              faults: FaultSchedule | None = None,
              autoscale: AutoscaleConfig | None = None,
              slo_s: float | None = None,
              series_dt: float | None = None,
              updates=None, ingest=None,
              tracer: Tracer | None = None,
              monitor: MonitorConfig | None = None,
              pricebook: PriceBook | None = None,
              explain: bool | ExplainConfig = False,
              mrc: bool | MRCConfig = False) -> FleetReport:
    """One-call fleet evaluation (the fleet analogue of run_workload)."""
    return FleetRouter(index, cfg).run(
        queries, params, query_ids=query_ids, arrivals=arrivals,
        faults=faults, autoscale=autoscale, slo_s=slo_s,
        series_dt=series_dt, updates=updates, ingest=ingest,
        tracer=tracer, monitor=monitor, pricebook=pricebook,
        explain=explain, mrc=mrc)
