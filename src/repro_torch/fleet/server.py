"""Shard servers: the compute nodes of the fleet (paper §2.1's
one-node-to-one-bucket unit, replicated N times).

Each :class:`ShardServer` is one *instance*: an independent
:class:`SteppableEngine` — its own segment cache and its own
discrete-event storage simulator (own NIC bandwidth pipe, own GET-rate
bucket) — registered on the fleet's shared :class:`repro_torch.sim.Kernel`.

Admission control: at most ``max_inflight`` jobs execute concurrently;
further submissions wait in a bounded FIFO queue; when the queue is full
the submission is **shed** (rejected back to the router, which retries a
replica or backs off).  Shed accounting is the backpressure signal the
fleet report surfaces.

Because storage is disaggregated, a logical shard can be served by any
number of stateless instances over the same data.  :class:`ShardGroup`
holds the instances of one shard: fault injection kills and revives them
(cold cache on recovery — the re-warm shows up as a hit-rate dip), and
the autoscaler adds instances under SLO pressure and drains them when
load subsides.  Per-instance activation intervals price the fleet in
shards·seconds.

The port's own copy of ``repro.fleet.server``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

from repro_torch.serving.engine import EngineConfig, JobRecord, SteppableEngine
from repro_torch.sim.kernel import Kernel


@dataclasses.dataclass
class ShardStats:
    """Per-instance accounting for the fleet report."""

    shard_id: int
    instance: int = 0
    jobs_done: int = 0
    submissions: int = 0           # accepted + shed
    sheds: int = 0
    peak_queue: int = 0
    peak_inflight: int = 0
    busy_s: float = 0.0            # sum of job service times (no queue wait)
    storage_bytes: int = 0
    storage_requests: int = 0
    storage_put_bytes: int = 0     # compaction writes (subset of totals)
    storage_put_requests: int = 0
    failures: int = 0
    jobs_aborted: int = 0
    #: NVMe tier accounting (repro_torch.storage.tier); None on flat instances
    #: so their to_dict stays byte-identical to the pre-tier layout
    nvme: dict | None = None

    def to_dict(self) -> dict:
        d = dict(shard=self.shard_id, instance=self.instance,
                 jobs=self.jobs_done,
                 submissions=self.submissions, sheds=self.sheds,
                 peak_queue=self.peak_queue,
                 peak_inflight=self.peak_inflight,
                 busy_s=round(self.busy_s, 9),
                 storage_bytes=self.storage_bytes,
                 storage_requests=self.storage_requests,
                 storage_put_bytes=self.storage_put_bytes,
                 storage_put_requests=self.storage_put_requests)
        if self.failures:
            d.update(failures=self.failures, jobs_aborted=self.jobs_aborted)
        if self.nvme is not None:
            d["nvme"] = self.nvme
        return d


class ShardServer:
    """A bounded admission queue in front of one kernel-resident engine."""

    def __init__(self, shard_id: int, cfg: EngineConfig, store, *,
                 kernel: Kernel, dim: int, pq_m: int = 0, instance: int = 0,
                 max_inflight: int = 4, queue_depth: int = 16,
                 on_complete: Callable[["ShardServer", JobRecord], None]
                 | None = None,
                 cache_factory: Callable[[], object] | None = None,
                 backend_factory: Callable[[], object] | None = None):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if queue_depth < 0:
            raise ValueError(f"queue_depth must be >= 0, got {queue_depth}")
        self.shard_id = shard_id
        self.instance = instance
        self.cfg = cfg
        self.max_inflight = max_inflight
        self.queue_depth = queue_depth
        self.on_complete = on_complete
        self.on_retired: Callable[["ShardServer"], None] | None = None
        # tenancy hands in a factory building tenant-aware cache
        # assemblies; default is the config's single-tenant cache path
        self._cache_factory = cache_factory if cache_factory is not None \
            else cfg.make_cache
        # --backend kernel hands in a factory building this instance's
        # batch coalescer (repro_torch.exec.KernelBackend); None = analytic
        backend = backend_factory() if backend_factory is not None else None
        self.engine = SteppableEngine(cfg, store, self._cache_factory(),
                                      kernel=kernel, dim=dim, pq_m=pq_m,
                                      on_complete=self._job_done,
                                      backend=backend)
        self._queue: deque = deque()       # (plan, metrics, tag, dim, pq_m)
        self.stats = ShardStats(shard_id=shard_id, instance=instance)
        self.alive = True
        self.draining = False
        # [on, off] activation intervals for shards·seconds pricing
        self.active_intervals: list[list[float | None]] = [[kernel.now, None]]

    # ---------------------------------------------------------- routing --
    @property
    def load(self) -> int:
        """Queue depth the router balances on: running + waiting jobs."""
        return self.engine.in_flight + len(self._queue)

    @property
    def routable(self) -> bool:
        return self.alive and not self.draining

    @property
    def idle(self) -> bool:
        return self.engine.in_flight == 0 and not self._queue

    @property
    def has_capacity(self) -> bool:
        """Would a submission right now be admitted (not shed)?"""
        return self.routable and (
            self.engine.in_flight < self.max_inflight
            or len(self._queue) < self.queue_depth)

    def try_submit(self, t: float, plan, metrics, tag,
                   dim: int | None = None, pq_m: int | None = None) -> bool:
        """Admit a job at virtual time ``t``; False means shed.

        ``dim``/``pq_m``: per-job compute-pricing geometry (tenants of
        different index shapes share one shard engine)."""
        if not self.routable:
            return False
        self.stats.submissions += 1
        if self.engine.in_flight < self.max_inflight:
            self.engine.submit(plan, metrics, tag=tag, at=t,
                               dim=dim, pq_m=pq_m)
            self.stats.peak_inflight = max(self.stats.peak_inflight,
                                           self.engine.in_flight)
            return True
        if len(self._queue) < self.queue_depth:
            self._queue.append((plan, metrics, tag, dim, pq_m))
            self.stats.peak_queue = max(self.stats.peak_queue,
                                        len(self._queue))
            return True
        self.stats.sheds += 1
        tr = self.engine.kernel.tracer
        if tr.enabled:
            tr.instant("shed", t, shard=self.shard_id,
                       instance=self.instance)
            tr.metrics.counter("fleet.sheds").inc()
        return False

    def invalidate(self, key, writeback_nbytes: int | None = None) -> None:
        """Drop a rewritten object's stale cached copy (compaction).

        Invalidation is neither a hit nor a miss in any tier's stats.
        ``writeback_nbytes`` is set by the router only on owning shards
        of a write-back tier: the rewritten object just landed on local
        NVMe, so it is admitted to residency at its new size."""
        if self.engine.cache is not None:
            self.engine.cache.remove(key)
        tier = self.engine.tier
        if tier is not None:
            tier.invalidate(key)
            if writeback_nbytes is not None and tier.writeback:
                tier.admit_writeback(key, writeback_nbytes)

    def _job_done(self, job: JobRecord) -> None:
        self.stats.jobs_done += 1
        self.stats.busy_s += job.latency
        if self._queue and self.engine.in_flight < self.max_inflight:
            plan, metrics, tag, dim, pq_m = self._queue.popleft()
            self.engine.submit(plan, metrics, tag=tag, at=job.end_t,
                               dim=dim, pq_m=pq_m)
        if self.on_complete is not None:
            self.on_complete(self, job)
        if self.draining and self.idle and self.on_retired is not None:
            self.on_retired(self)

    # ------------------------------------------------- faults / scaling --
    def fail(self, t: float) -> list:
        """The node dies: abort every queued and running job; returns the
        aborted tags so the router can re-route them to replicas."""
        if not self.alive:
            return []
        self.alive = False
        self.stats.failures += 1
        tags = [item[2] for item in self._queue]
        self._queue.clear()
        tags = self.engine.abort_all() + tags
        self.stats.jobs_aborted += len(tags)
        self._close_interval(t)
        return tags

    def recover(self, t: float) -> None:
        """The node comes back **cold**: its cache restarts empty and
        re-warms from traffic (the post-recovery hit-rate dip).  An
        instance that was already draining stays retired — recovery
        revives capacity, not scale-down decisions."""
        if self.alive or self.draining:
            return
        self.alive = True
        self.engine.cache = self._cache_factory()
        if self.engine.tier is not None:
            # the replacement node's local NVMe starts empty too
            self.engine.tier.reset()
        self.active_intervals.append([t, None])

    def retire(self, t: float) -> None:
        """Close the instance's billing interval (autoscale drain done)."""
        self._close_interval(t)

    def _close_interval(self, t: float) -> None:
        if self.active_intervals and self.active_intervals[-1][1] is None:
            self.active_intervals[-1][1] = t

    def active_seconds(self, horizon: float) -> float:
        """Billed seconds in [0, horizon] (open intervals run to horizon)."""
        total = 0.0
        for on, off in self.active_intervals:
            end = horizon if off is None else min(off, horizon)
            total += max(0.0, end - on)
        return total

    def finalize_stats(self) -> ShardStats:
        self.stats.storage_bytes = self.engine.sim.total_bytes
        self.stats.storage_requests = self.engine.sim.total_requests
        self.stats.storage_put_bytes = self.engine.sim.total_put_bytes
        self.stats.storage_put_requests = (
            self.engine.sim.total_put_requests)
        if self.engine.tier is not None:
            nv = self.engine.tier.stats_dict()
            wp = self.engine.write_path
            if wp is not self.engine.sim:       # write-back data plane
                nv["flushes_done"] = wp.flushes_done
                nv["flush_pending"] = wp.flush_pending
            self.stats.nvme = nv
        return self.stats


class ShardGroup:
    """The serving instances of one logical shard.

    Data placement (which shard owns which keys) is the partition's job;
    this is purely the *capacity* dimension: 1..N stateless instances
    serving the same keys, each with its own cache and NIC.
    """

    def __init__(self, shard_id: int,
                 spawn: Callable[[int, int], ShardServer]):
        self.shard_id = shard_id
        self._spawn = spawn
        self._next_instance = 1
        self.instances: list[ShardServer] = [spawn(shard_id, 0)]
        self.retired: list[ShardServer] = []

    # ---------------------------------------------------------- routing --
    @property
    def routable(self) -> list[ShardServer]:
        return [s for s in self.instances if s.routable]

    @property
    def alive(self) -> bool:
        return bool(self.routable)

    @property
    def load(self) -> float:
        """Best-case admission load (what po2c balances on)."""
        inst = self.routable
        return min(s.load for s in inst) if inst else float("inf")

    def pick(self) -> ShardServer | None:
        """Least-loaded routable instance (ties: oldest instance)."""
        best = None
        for s in self.instances:
            if s.routable and (best is None or s.load < best.load):
                best = s
        return best

    # ------------------------------------------------- faults / scaling --
    def fail_all(self, t: float) -> list:
        tags = []
        for s in self.instances:
            tags.extend(s.fail(t))
        return tags

    def recover_all(self, t: float) -> None:
        for s in self.instances:
            s.recover(t)

    def scale_up(self) -> ShardServer:
        srv = self._spawn(self.shard_id, self._next_instance)
        self._next_instance += 1
        self.instances.append(srv)
        return srv

    def begin_drain(self, t: float) -> ShardServer | None:
        """Mark the least-loaded extra instance draining: no new routes;
        it retires (stops billing) once its queue and engine are idle."""
        cands = [s for s in self.routable if s.instance != 0]
        if not cands:
            return None
        srv = min(cands, key=lambda s: (s.load, -s.instance))
        srv.draining = True
        if srv.idle:
            self._retire(srv, t)
        else:
            srv.on_retired = lambda s: self._retire(s, s.engine.kernel.now)
        return srv

    def _retire(self, srv: ShardServer, t: float) -> None:
        srv.retire(t)
        srv.on_retired = None
        if srv in self.instances:
            self.instances.remove(srv)
            self.retired.append(srv)

    def all_servers(self) -> list[ShardServer]:
        return self.instances + self.retired
