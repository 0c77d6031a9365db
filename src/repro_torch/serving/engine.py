"""The cloud-native query engine: index × storage simulator × cache.

Serving (paper §5.1): each query runs its index ``search_plan``
generator, whose fetch batches flow through the cache and the
discrete-event storage simulator.  Compute phases are priced from the
metrics deltas the plan records (distance comps × ComputeSpec) —
reproducing the CPU/I/O split of Fig 2/3.

Two layers, both components of a :class:`repro_torch.sim.Kernel`:

* :class:`SteppableEngine` — the plan executor.  ``submit()`` starts a
  plan generator; every subsequent step (compute completion, cache-hit
  service, storage completion) is a kernel event, so N engines sharing a
  kernel (``repro_torch.fleet``) interleave exactly by virtual time.
* :class:`QueryEngine` — the driver process: an admission window of
  ``concurrency`` jobs over a FIFO backlog, fed by an arrival process
  (:mod:`repro_torch.sim.arrivals`).  The default :class:`ClosedLoop` arrivals
  reproduce the paper's fixed-concurrency harness; open-loop processes
  (Poisson, trace) turn the same engine into an M/G/c-style service.

Everything is virtual-time deterministic for a given seed.

The port's own copy of ``repro.serving.engine``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

import numpy as np

from repro_torch.cache.slru import CACHE_POLICIES, make_cache
from repro_torch.core.cost_model import (DEFAULT_COMPUTE, ComputeSpec,
                                   plan_compute_seconds)
from repro_torch.core.types import QueryMetrics, SearchParams
from repro_torch.obs.trace import NULL_TRACER, Tracer, emit_job_spans
from repro_torch.serving.metrics import BatchTrace, QueryRecord, WorkloadReport
from repro_torch.sim.admission import AdmissionWindow
from repro_torch.sim.arrivals import ArrivalProcess, ClosedLoop
from repro_torch.sim.kernel import Event, Kernel
from repro_torch.storage.simulator import StorageSim
from repro_torch.storage.spec import StorageSpec
from repro_torch.storage.tier import NVMeTier, TierConfig, TieredWritePath


@dataclasses.dataclass
class EngineConfig:
    storage: StorageSpec
    concurrency: int = 1
    cache_bytes: int = 0
    cache_policy: str = "slru"         # "slru" | "pinned" | "none"
    pinned_keys: frozenset | None = None
    hit_latency_s: float = 100e-6      # local (memory/SSD) cache service
    compute: ComputeSpec = dataclasses.field(default_factory=ComputeSpec)
    seed: int = 0
    #: local NVMe middle tier (repro_torch.storage.tier); None (or capacity 0)
    #: keeps the flat DRAM -> remote hierarchy event-for-event identical
    tier: TierConfig | None = None

    def __post_init__(self):
        if self.cache_policy not in CACHE_POLICIES:
            raise ValueError(
                f"unknown cache_policy {self.cache_policy!r}; "
                f"one of {CACHE_POLICIES}")
        if self.cache_policy == "pinned" and self.pinned_keys is None:
            raise ValueError(
                "cache_policy='pinned' requires pinned_keys (the fixed "
                "key set to pin; see repro.tuning.evaluate.hot_keys)")
        if self.cache_policy != "pinned" and self.pinned_keys:
            raise ValueError(
                f"pinned_keys given but cache_policy is "
                f"{self.cache_policy!r} (use cache_policy='pinned')")
        if self.cache_bytes < 0:
            raise ValueError(f"cache_bytes must be >= 0, got "
                             f"{self.cache_bytes}")
        if self.concurrency < 1:
            raise ValueError(f"concurrency must be >= 1, got "
                             f"{self.concurrency}")

    def make_cache(self):
        """The single cache construction path for every engine in the
        system (serving and fleet): policy/pinned validation happened at
        config construction, so a cache can only be built from a config
        that passed it."""
        return make_cache(self.cache_policy, self.cache_bytes,
                          self.pinned_keys)


@dataclasses.dataclass
class _JobState:
    tag: Any
    gen: object
    metrics: QueryMetrics
    start_t: float
    batches: list[BatchTrace]
    dim: int = 0                        # compute-pricing dims for this job
    pq_m: int = 0
    round_idx: int = 0
    last_snapshot: tuple = (0, 0)
    pending_batch: object = None        # FetchBatch in flight
    pending_submit_t: float = 0.0
    pending_hits: int = 0
    pending_total_bytes: int = 0
    pending_nvme_n: int = 0             # tier-resident misses this round
    pending_nvme_bytes: int = 0
    pending_parts: int = 0              # device sub-batches still in flight
    pending_remote_done: tuple = (0, 0)
    pending_ev: Event | None = None     # next engine event for this job
    alive: bool = True                  # False once aborted (shard death)
    #: [enq_t, flush_t] intervals spent waiting in a KernelBackend batch
    #: window (empty on the analytic backend)
    coalesce: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class JobRecord:
    """One completed plan execution on a :class:`SteppableEngine`.

    ``result`` is whatever the plan generator returned — a
    :class:`SearchResult` for full searches, a payload dict for fleet
    fetch sub-jobs.
    """

    tag: Any
    start_t: float
    end_t: float
    result: Any
    metrics: QueryMetrics
    batches: list[BatchTrace]
    #: batch-coalescing waits ([enq_t, flush_t] pairs) when the job ran
    #: on a kernel backend; tiled as "batching" legs in the span tree
    coalesce: list = dataclasses.field(default_factory=list)

    @property
    def latency(self) -> float:
        return self.end_t - self.start_t


class SteppableEngine:
    """Plan executor registered on a (possibly shared) event kernel.

    ``submit()`` starts a plan generator (optionally at a virtual time
    ``at`` >= now — completion chains schedule follow-on work at the
    completing job's ``end_t``); every fetch round's cache split, storage
    I/O and compute pricing then advances through kernel events.
    ``on_complete(JobRecord)`` fires synchronously at each job's
    completion so a driver can start the next query, or a shard server
    can pop its admission queue, at exactly that virtual instant.
    """

    def __init__(self, cfg: EngineConfig, store, cache=None, *,
                 kernel: Kernel | None = None, dim: int, pq_m: int = 0,
                 on_complete: Callable[[JobRecord], None] | None = None,
                 backend=None):
        self.cfg = cfg
        self.store = store
        self.cache = cache
        self.dim = dim
        self.pq_m = pq_m
        self.on_complete = on_complete
        self.kernel = kernel if kernel is not None else Kernel(seed=cfg.seed)
        self.sim = StorageSim(cfg.storage, self.kernel, seed=cfg.seed)
        # NVMe tier: constructed ONLY when capacity > 0 — a zero-capacity
        # tier must not even allocate a second StorageSim, or the kernel's
        # unique_name/RNG-stream sequence (and every flat golden) shifts.
        self.tier = (NVMeTier(cfg.tier, self.kernel, seed=cfg.seed)
                     if cfg.tier is not None and cfg.tier.capacity_bytes > 0
                     else None)
        #: ingest data plane: compaction PUTs go through here so a
        #: write-back tier can land them locally first (flat engines hand
        #: out the remote sim itself — identical object, identical path)
        self.write_path = (TieredWritePath(self.tier, self.sim)
                           if self.tier is not None and self.tier.writeback
                           else self.sim)
        # Optional repro_torch.exec.KernelBackend: compute is then batch-
        # coalesced and priced from a measured CalibrationTable instead
        # of the analytic ComputeSpec.  None keeps the analytic path
        # event-for-event identical to before the backend existed.
        self.backend = backend.attach(self) if backend is not None else None
        self._jobs: list[_JobState] = []
        self.in_flight = 0
        self.jobs_done = 0

    # ------------------------------------------------------------- jobs --
    def submit(self, plan, metrics: QueryMetrics, tag: Any = None,
               at: float | None = None, dim: int | None = None,
               pq_m: int | None = None) -> _JobState:
        """Start a plan generator (at virtual time ``at``, default now).

        ``dim``/``pq_m`` override the engine-level compute-pricing
        constants for this job (multi-tenant fleets run jobs of several
        index geometries through one shard engine)."""
        t = self.kernel.now if at is None else max(at, self.kernel.now)
        st = _JobState(tag=tag, gen=plan, metrics=metrics, start_t=t,
                       batches=[],
                       dim=self.dim if dim is None else dim,
                       pq_m=self.pq_m if pq_m is None else pq_m)
        self._jobs.append(st)
        self.in_flight += 1
        self._advance_job(st, t, first=True)
        return st

    def abort_all(self) -> list[Any]:
        """Kill every in-flight job (the node died): cancel their pending
        events, drop their storage transfers, return the aborted tags."""
        tags = []
        for st in self._jobs:
            st.alive = False
            if st.pending_ev is not None:
                self.kernel.cancel(st.pending_ev)
                st.pending_ev = None
            tags.append(st.tag)
        self._jobs.clear()
        self.sim.abort_all()
        if self.tier is not None:
            self.tier.sim.abort_all()
        self.in_flight = 0
        return tags

    # ---------------------------------------------------------- internal --
    def _work_delta(self, st: _JobState) -> tuple[int, int]:
        """Distance comps / PQ lookups the plan did since the last yield."""
        m = st.metrics
        d0, p0 = st.last_snapshot
        st.last_snapshot = (m.dist_comps, m.pq_dist_comps)
        return m.dist_comps - d0, m.pq_dist_comps - p0

    def _compute_seconds(self, st: _JobState) -> float:
        """Price the compute the plan did since the last yield."""
        d_dist, d_pq = self._work_delta(st)
        return plan_compute_seconds(d_dist, d_pq,
                                    st.dim, st.pq_m, self.cfg.compute)

    def _advance_job(self, st: _JobState, t: float, first: bool = False,
                     payloads: dict | None = None) -> None:
        """Resume the generator; charge compute; schedule the next batch.

        On the analytic backend compute is priced inline and the next
        step scheduled at ``t + dt``.  On a kernel backend the work
        delta is handed to the batch coalescer, which calls back (at
        flush + calibrated batch time) with the completion instant."""
        try:
            if first:
                batch = next(st.gen)
            else:
                batch = st.gen.send(payloads)
        except StopIteration as stop:
            if self.backend is not None:
                d_dist, d_pq = self._work_delta(st)
                self.backend.submit(
                    st, t, d_dist, d_pq,
                    lambda td, st=st, v=stop.value:
                        self._finish_job(st, td, v))
                return
            self._finish_job(st, t + self._compute_seconds(st), stop.value)
            return
        if self.backend is not None:
            d_dist, d_pq = self._work_delta(st)
            self.backend.submit(
                st, t, d_dist, d_pq,
                lambda td, st=st, b=batch: self._dispatch_batch(st, b, td))
            return
        dt = self._compute_seconds(st)
        st.pending_ev = self.kernel.at(t + dt, self._submit_batch, st, batch)

    def _finish_job(self, st: _JobState, end_t: float, value: Any) -> None:
        """Retire a completed plan and fire ``on_complete`` synchronously."""
        self.in_flight -= 1
        self.jobs_done += 1
        self._jobs.remove(st)
        record = JobRecord(tag=st.tag, start_t=st.start_t,
                           end_t=end_t, result=value,
                           metrics=st.metrics, batches=st.batches,
                           coalesce=st.coalesce)
        if self.on_complete is not None:
            self.on_complete(record)

    def _dispatch_batch(self, st: _JobState, batch, t: float) -> None:
        """Kernel-backend continuation: fetch round starts at batch end."""
        if not st.alive:
            return
        st.pending_ev = self.kernel.at(t, self._submit_batch, st, batch)

    def _submit_batch(self, st: _JobState, batch) -> None:
        """Cache-split the batch, then tier-split the misses.

        Up to two device sub-batches go out concurrently — NVMe-resident
        misses to the tier device, the rest to the remote store — and the
        round completes when the slower one does (a join).  Without a
        tier the remote sub-batch is the whole miss set and the path is
        event-for-event what it was in the flat hierarchy."""
        st.pending_ev = None
        t = self.kernel.now
        hits = 0
        miss = []
        for rq in batch.requests:
            st.metrics.cache_lookups += 1
            if self.cache is not None and self.cache.get(rq.key):
                hits += 1
                st.metrics.cache_hits += 1
            else:
                miss.append(rq)
        if self.tier is not None and miss:
            nvme_reqs, remote_reqs = self.tier.split(miss)
        else:
            nvme_reqs, remote_reqs = [], miss
        miss_bytes = sum(rq.nbytes for rq in remote_reqs)
        miss_n = len(remote_reqs)
        nvme_bytes = sum(rq.nbytes for rq in nvme_reqs)
        # bytes_storage stays remote-only: it feeds egress attribution,
        # and tier-served bytes never cross the NIC
        st.metrics.bytes_storage += miss_bytes
        tr = self.kernel.tracer
        if tr.enabled:
            tr.metrics.counter("cache.hits").inc(hits)
            tr.metrics.counter("cache.misses").inc(len(miss))
            tr.metrics.counter("storage.bytes").inc(miss_bytes)
            if self.tier is not None:
                tr.metrics.counter("nvme.hits").inc(len(nvme_reqs))
                tr.metrics.counter("nvme.bytes").inc(nvme_bytes)
        st.pending_batch = batch
        st.pending_submit_t = t
        st.pending_hits = hits
        st.pending_total_bytes = batch.nbytes
        st.pending_nvme_n = len(nvme_reqs)
        st.pending_nvme_bytes = nvme_bytes
        st.pending_remote_done = (0, 0)
        if miss_n == 0 and not nvme_reqs:
            st.pending_ev = self.kernel.at(t + self.cfg.hit_latency_s,
                                           self._on_fetched, st, 0, 0)
            return
        st.pending_parts = (1 if nvme_reqs else 0) + (1 if miss_n else 0)
        if nvme_reqs:
            self.tier.sim.submit_batch(
                nvme_bytes, len(nvme_reqs),
                on_done=lambda tk, st=st: self._part_done(st, None))
        if miss_n:
            self.sim.submit_batch(
                miss_bytes, miss_n,
                on_done=lambda tk, st=st, reqs=remote_reqs:
                    self._part_done(st, reqs, tk))

    def _part_done(self, st: _JobState, remote_reqs, ticket=None) -> None:
        """One device sub-batch finished; the round resumes at the join."""
        if not st.alive:
            return
        if ticket is not None:
            st.pending_remote_done = (ticket.n_requests, ticket.nbytes)
            if self.tier is not None and remote_reqs:
                # promotion happens the instant the remote bytes land
                for rq in remote_reqs:
                    self.tier.note_remote_fetch(rq.key, rq.nbytes)
        st.pending_parts -= 1
        if st.pending_parts == 0:
            n, b = st.pending_remote_done
            self._on_fetched(st, n, b)

    def _on_fetched(self, st: _JobState, n_storage_req: int,
                    storage_bytes: int) -> None:
        st.pending_ev = None
        t = self.kernel.now
        batch = st.pending_batch
        st.batches.append(BatchTrace(
            round_idx=st.round_idx, submit_t=st.pending_submit_t,
            done_t=t, n_requests=n_storage_req,
            n_hits=st.pending_hits, nbytes_storage=storage_bytes,
            nbytes_total=st.pending_total_bytes,
            n_nvme=st.pending_nvme_n,
            nbytes_nvme=st.pending_nvme_bytes))
        st.round_idx += 1
        if self.cache is not None:
            for rq in batch.requests:
                self.cache.put(rq.key, rq.nbytes)
        payloads = {rq.key: self.store.get(rq.key) for rq in batch.requests}
        st.pending_batch = None
        self._advance_job(st, t, payloads=payloads)


class QueryEngine:
    """Driver process: an admission window over an arrival stream.

    With the default :class:`ClosedLoop` arrivals this is the paper's
    closed loop (all queries backlogged at t=0, ``concurrency`` in
    service); with open-loop arrivals queries wait in the backlog when
    the window is full, and per-query ``arrive_t``/sojourn make
    queue-delay visible in the report.
    """

    def __init__(self, index, config: EngineConfig):
        self.index = index
        self.cfg = config
        self.cache = config.make_cache()
        # compute-pricing constants from the index
        self.dim = index.meta.dim
        pq = getattr(index.meta, "pq", None)
        self.pq_m = pq.m if pq is not None else 0

    def run(self, queries: np.ndarray, params: SearchParams,
            query_ids: Iterable[int] | None = None,
            arrivals: ArrivalProcess | None = None,
            updates=None, ingest=None,
            tracer: Tracer | None = None) -> WorkloadReport:
        """``updates`` (an :class:`repro.ingest.stream.UpdateStream`)
        interleaves live inserts/deletes with the query stream; the
        index is wrapped mutable on first use and an
        :class:`repro.ingest.compaction.IngestAgent` applies the stream
        and runs background compaction whose I/O contends with query
        I/O on this engine's storage simulator.  ``ingest`` is its
        :class:`repro.ingest.compaction.IngestConfig`.  With no updates
        the run is byte-identical to the pure-query path."""
        cfg = self.cfg
        qids = list(query_ids) if query_ids is not None else list(
            range(len(queries)))
        arr = arrivals if arrivals is not None else ClosedLoop(
            cfg.concurrency, n_total=len(queries))
        window = arr.window if arr.window is not None else cfg.concurrency

        kernel = Kernel(seed=cfg.seed)
        tr = tracer if tracer is not None else NULL_TRACER
        tr.attach(kernel)
        records: list[QueryRecord] = []
        core = SteppableEngine(cfg, self.index.store, self.cache,
                               kernel=kernel, dim=self.dim, pq_m=self.pq_m)

        def start_query(item: tuple[int, int], t: float) -> None:
            ai, wi = item
            metrics = QueryMetrics()
            gen = self.index.search_plan(queries[wi], params, metrics)
            core.submit(gen, metrics, tag=(ai, qids[wi]), at=t)

        adm = AdmissionWindow(kernel, window, start_query)

        def on_complete(job: JobRecord) -> None:
            ai, qid = job.tag
            res = job.result
            arrive_t = adm.pop_arrive_t(ai)
            if tr.enabled:
                # the single-engine span tree: query root with the job's
                # fetch/compute legs directly under it (no rounds)
                sp = tr.record("query", arrive_t, job.end_t, parent=None,
                               qid=qid, tid=0, kind="engine")
                if job.start_t > arrive_t:
                    tr.record("admission", arrive_t, job.start_t,
                              parent=sp)
                emit_job_spans(tr, sp, job.start_t, job)
                tr.metrics.counter("engine.queries").inc()
                tr.metrics.histogram("engine.sojourn_s").observe(
                    job.end_t - arrive_t)
            records.append(QueryRecord(
                qid=qid, start_t=job.start_t, end_t=job.end_t,
                ids=res.ids, dists=res.dists, metrics=job.metrics,
                batches=job.batches, arrive_t=arrive_t))
            adm.release(job.end_t)

        core.on_complete = on_complete
        agent = None
        if updates is not None and len(updates):
            from repro_torch.ingest.compaction import IngestAgent, IngestConfig
            from repro_torch.ingest.metrics import IngestReport
            from repro_torch.ingest.mutable import make_mutable
            self.index = make_mutable(self.index)
            inval = None
            if self.cache is not None or core.tier is not None:
                def inval(key, _c=self.cache, _t=core.tier):
                    if _c is not None:
                        _c.remove(key)
                    if _t is not None:
                        _t.invalidate(key)
            agent = IngestAgent(
                self.index, site_id=0, kernel=kernel,
                cfg=ingest if ingest is not None else IngestConfig(),
                compute=cfg.compute, sim_provider=lambda: core.write_path,
                report=IngestReport(),
                invalidate=inval,
                inflight_floor=lambda: min(
                    (st.start_t for st in core._jobs),
                    default=float("inf")))
            updates.start(kernel, agent.deliver)
        arr.start(kernel, lambda ai, wi: adm.offer((ai, wi), key=ai),
                  len(queries))
        kernel.run()

        wall = max((r.end_t for r in records), default=0.0)
        ingest_dict = None
        if agent is not None:
            agent.finalize()
            ingest_dict = agent.report.to_dict(records)
        return WorkloadReport(
            records=records, wall_time_s=wall,
            storage_bytes=core.sim.total_bytes,
            storage_requests=core.sim.total_requests,
            concurrency=cfg.concurrency, scenario=arr.kind,
            n_arrivals=adm.arrivals_total,
            offered_qps=adm.offered_qps(wall),
            ingest=ingest_dict)


def run_workload(index, queries: np.ndarray, params: SearchParams,
                 storage: StorageSpec | EngineConfig, concurrency: int = 1,
                 cache_bytes: int = 0, seed: int = 0,
                 compute: ComputeSpec = DEFAULT_COMPUTE,
                 cache_policy: str = "slru",
                 pinned_keys: frozenset | None = None,
                 query_ids: Iterable[int] | None = None,
                 arrivals: ArrivalProcess | None = None,
                 updates=None, ingest=None,
                 tracer: Tracer | None = None) -> WorkloadReport:
    """The one-call evaluation hook: run ``queries`` through the engine.

    Accepts either a bare :class:`StorageSpec` plus knobs (the benchmark
    harness style) or a fully-formed :class:`EngineConfig` as the fourth
    argument (the ``repro_torch.tuning`` style — every cache/seed/compute knob in
    one value).  ``query_ids`` maps repeated/reordered workload queries
    back to ground-truth rows (see ``serving.workload``); ``arrivals``
    selects the arrival process (default: the paper's closed loop).
    """
    if isinstance(storage, EngineConfig):
        cfg = storage
    else:
        cfg = EngineConfig(
            storage=storage, concurrency=concurrency,
            cache_bytes=cache_bytes, cache_policy=cache_policy,
            pinned_keys=pinned_keys, compute=compute, seed=seed)
    eng = QueryEngine(index, cfg)
    return eng.run(queries, params, query_ids=query_ids, arrivals=arrivals,
                   updates=updates, ingest=ingest, tracer=tracer)
