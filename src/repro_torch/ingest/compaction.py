"""Background maintenance under live traffic, as discrete events.

An :class:`IngestAgent` owns one site's write path end to end:

* **apply** — update arrivals run through an :class:`AdmissionWindow`
  of width 1 (the third consumer of the shared admission helper): each
  apply costs ``apply_latency_s`` plus the priced assignment compute,
  so a write burst queues and *visibility lag* becomes measurable.
* **flush** — when the memtable crosses ``flush_frac × delta_cap_bytes``
  a flush job enters the compaction window (width
  ``compaction_parallelism``).  A flush reads the affected sealed
  objects, rewrites them with the delta folded in and tombstones
  dropped, and writes them back — **all bytes and requests go through
  the same** :class:`repro_torch.storage.simulator.StorageSim` **that serves
  queries**, so compaction storms steal NIC bandwidth and GET tokens
  from live traffic and the p99 cost shows up in the report.
* **re-cluster** — a posting list that overflowed past
  ``overflow_factor ×`` the build-time average is split in two with a
  local 2-means (SPANN's balance repair), the BKT growing a level.
* **stitch / repair** (graph) — flushed inserts are Vamana-stitched:
  candidate discovery over the metadata-resident PQ+adjacency, exact
  vectors read from candidate blocks, ``_robust_prune`` for the new
  node and every back-edge-overflowed or delete-wounded neighbour,
  rewritten blocks written back.

Every job is a chain of kernel events (compute delays priced through
``plan_compute_seconds``); nothing polls, everything is deterministic.

The port's own copy of ``repro.ingest.compaction``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.cost_model import ComputeSpec, plan_compute_seconds
from repro_torch.ingest.metrics import IngestReport
from repro_torch.ingest.mutable import MutableClusterIndex, MutableGraphIndex
from repro_torch.ingest.stream import UpdateOp
from repro_torch.sim.admission import AdmissionWindow
from repro_torch.sim.kernel import Kernel

#: a compaction job that finds no live storage sim (its shard is down)
#: backs off this long before retrying
SIM_RETRY_S = 1e-3


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """The compaction knobs (also the tuner's ingest axis)."""

    delta_cap_bytes: int = 256 * 1024   # memtable capacity per site
    flush_frac: float = 0.5             # flush trigger (fraction of cap)
    compaction_parallelism: int = 1     # concurrent maintenance jobs
    apply_latency_s: float = 20e-6      # fixed per-update apply cost
    overflow_factor: float = 2.0        # list length vs build avg
    recluster: bool = True              # split overflowed lists
    graph_stitch_L: int = 32            # candidate pool per stitched node
    #: retired graph blocks stay readable (unlinked, unbilled) this many
    #: virtual seconds before a flush install may purge them — must
    #: exceed the longest a query sub-request can stay parked (shed
    #: backoff, fault windows) while holding a pre-compaction reference
    reclaim_grace_s: float = 1.0

    def __post_init__(self):
        if self.delta_cap_bytes <= 0:
            raise ValueError(f"delta_cap_bytes must be > 0, got "
                             f"{self.delta_cap_bytes}")
        if not 0.0 < self.flush_frac <= 1.0:
            raise ValueError(f"flush_frac must be in (0, 1], got "
                             f"{self.flush_frac}")
        if self.compaction_parallelism < 1:
            raise ValueError(f"compaction_parallelism must be >= 1, got "
                             f"{self.compaction_parallelism}")
        if self.overflow_factor <= 1.0:
            raise ValueError(f"overflow_factor must be > 1, got "
                             f"{self.overflow_factor}")
        if self.reclaim_grace_s < 0:
            raise ValueError(f"reclaim_grace_s must be >= 0, got "
                             f"{self.reclaim_grace_s}")

    def to_dict(self) -> dict:
        return dict(delta_cap_bytes=self.delta_cap_bytes,
                    flush_frac=self.flush_frac,
                    compaction_parallelism=self.compaction_parallelism,
                    apply_latency_s=self.apply_latency_s,
                    overflow_factor=self.overflow_factor,
                    recluster=self.recluster)


class IngestAgent:
    """One site's apply + compaction driver on the shared kernel."""

    def __init__(self, mutable, site_id: int, kernel: Kernel,
                 cfg: IngestConfig, compute: ComputeSpec,
                 sim_provider: Callable[[], object],
                 report: IngestReport,
                 invalidate: Callable[[object], None] | None = None,
                 on_new_list: Callable[[int, int], None] | None = None,
                 owned_lists: set | None = None,
                 inflight_floor: Callable[[], float] | None = None):
        self.mutable = mutable
        self.site_id = site_id
        self.kernel = kernel
        self.cfg = cfg
        self.compute = compute
        self.sim_provider = sim_provider
        self.report = report
        self.invalidate = invalidate or (lambda key: None)
        self.on_new_list = on_new_list
        self.owned_lists = owned_lists
        # earliest start time of any in-flight query (the serving
        # driver's view); corpses younger than it may still be
        # referenced by a parked sub-request, however long it parks
        self.inflight_floor = inflight_floor
        self.mem = mutable.site(site_id)
        self.dim = mutable.meta.dim
        pq = getattr(mutable.meta, "pq", None)
        self.pq_m = pq.m if pq is not None else 0
        self._apply_adm = AdmissionWindow(kernel, 1, self._start_apply)
        self._compact_adm = AdmissionWindow(
            kernel, cfg.compaction_parallelism, self._start_job)
        self._flush_outstanding = False
        self._job_seq = 0

    # ------------------------------------------------------------- apply --
    def deliver(self, op: UpdateOp, lists: tuple[int, ...] | None = None,
                ndist: int = 0) -> None:
        """An update reaches this site at the kernel's current time.
        ``lists``/``ndist``: a precomputed (router-side) posting-list
        assignment; otherwise the apply computes — and is charged — it."""
        self.report.ops_delivered += 1
        self._apply_adm.offer((op, lists, ndist), key=("op", op.seq))

    def _start_apply(self, item, t: float) -> None:
        op, lists, ndist = item
        if (op.kind == "insert" and lists is None
                and isinstance(self.mutable, MutableClusterIndex)):
            lists, ndist = self.mutable.assign_lists(op.vec)
        dt = self.cfg.apply_latency_s + plan_compute_seconds(
            ndist, 0, self.dim, self.pq_m, self.compute)
        self.kernel.at(t + dt, self._finish_apply, op, lists)

    def _finish_apply(self, op: UpdateOp,
                      lists: tuple[int, ...] | None) -> None:
        now = self.kernel.now
        self._apply_adm.pop_arrive_t(("op", op.seq))
        if op.kind == "insert":
            self.mem.insert(op.id, op.vec, lists or (), op.t, now)
            self.mutable.note_insert(op.id)
            nbytes = self.mem.entry_nbytes
        else:
            self.mem.delete(op.id, op.t)
            self.mutable.note_delete(op.id)
            nbytes = 0
        self.report.record_apply(op.kind, now - op.t, nbytes)
        tr = self.kernel.tracer
        if tr.enabled:
            tr.metrics.counter("ingest.applies").inc()
            tr.metrics.histogram("ingest.apply_lag_s").observe(now - op.t)
        if self.mem.used_bytes > self.cfg.delta_cap_bytes:
            self.report.overflow_applies += 1
        self._apply_adm.release(now)
        self._maybe_flush()

    # ----------------------------------------------------------- triggers --
    def _maybe_flush(self, force: bool = False) -> None:
        if self._flush_outstanding:
            return
        trigger = self.cfg.flush_frac * self.cfg.delta_cap_bytes
        if not (self.mem.entries or self.mem.tombstones):
            return
        if force or self.mem.used_bytes >= trigger:
            self._flush_outstanding = True
            self._job_seq += 1
            self._compact_adm.offer(("flush", self._job_seq))

    def flush_now(self) -> None:
        """Force a flush regardless of the trigger (drain / tests)."""
        self._maybe_flush(force=True)

    def _sim(self):
        return self.sim_provider()

    def _start_job(self, item, t: float) -> None:
        # claim the arrival record (jobs have no per-item sojourn
        # metric; unclaimed records would accumulate across a run)
        self._compact_adm.arrive_t.pop(item, None)
        kind = item[0]
        if self._sim() is None:            # shard down: back off
            self.kernel.after(SIM_RETRY_S, self._retry_job, item)
            return
        if kind == "flush":
            if isinstance(self.mutable, MutableGraphIndex):
                self._flush_graph(t)
            else:
                self._flush_cluster(t)
        else:
            self._recluster(item[1], t)

    def _retry_job(self, item) -> None:
        self._start_job(item, self.kernel.now)

    def _job_done(self, t0: float, kind: str = "flush") -> None:
        now = self.kernel.now
        tr = self.kernel.tracer
        if tr.enabled:
            # recorded retrospectively as one complete span: the job's
            # I/O runs through the shared storage sim, where ambient
            # kernel span context is not reliably this job's
            tr.record("compaction", t0, now, parent=None, kind=kind,
                      shard=self.site_id, instance=0)
            tr.metrics.counter(f"ingest.jobs.{kind}").inc()
        self.report.intervals.append((t0, now))
        self._compact_adm.release(now)
        self._maybe_flush()

    # ----------------------------------------------------- cluster flush --
    def _owned(self, lists) -> set[int]:
        s = set(int(li) for li in lists)
        return s if self.owned_lists is None else s & self.owned_lists

    def _flush_cluster(self, t0: float) -> None:
        meta = self.mutable.meta
        entries = dict(self.mem.entries)
        tombs = dict(self.mem.tombstones)
        affected: set[int] = set()
        for e in entries.values():
            affected |= self._owned(e.lists)
        for id_ in tombs:
            affected |= self._owned(self.mutable.lists_of(id_))
        affected_l = sorted(affected)
        if not affected_l:                 # nothing sealed to rewrite
            self._install_cluster([], entries, tombs, t0)
            return
        read_bytes = int(sum(meta.list_nbytes[li] for li in affected_l))
        self.report.compaction_read_bytes += read_bytes
        self.report.compaction_read_requests += len(affected_l)
        self._sim().submit_batch(
            read_bytes, len(affected_l),
            on_done=lambda tk: self._flush_cluster_write(
                affected_l, entries, tombs, t0))

    def _flush_cluster_write(self, affected, entries, tombs,
                             t0: float) -> None:
        tomb_ids = set(tombs)
        write_bytes = sum(self.mutable.rewrite_size(li, entries,
                                                    tomb_ids)
                          for li in affected)
        self.report.compaction_write_bytes += write_bytes
        self.report.compaction_write_requests += len(affected)
        self._sim().submit_batch(
            write_bytes, len(affected), put=True,
            on_done=lambda tk: self._install_cluster(
                affected, entries, tombs, t0))

    def _install_cluster(self, affected, entries, tombs,
                         t0: float) -> None:
        now = self.kernel.now
        tomb_ids = set(tombs)
        for li in affected:
            ids, vecs, nb = self.mutable.rewrite_list(li, entries,
                                                      tomb_ids)
            self.mutable.install_list(li, ids, vecs, nb)
            self.invalidate(("list", li))
        self.mem.clear_flushed(entries, tombs)
        self.report.record_seal(
            [now - e.arrive_t for _, e in sorted(entries.items())]
            + [now - at for _, at in sorted(tombs.items())])
        self.report.flushes += 1
        self.report.lists_rewritten += len(affected)
        self._flush_outstanding = False
        self._job_done(t0, "flush")
        if self.cfg.recluster:
            for li in affected:
                if self.mutable.overflowed(li, self.cfg.overflow_factor):
                    self.mutable.reclustering.add(li)
                    self._job_seq += 1
                    self._compact_adm.offer(
                        ("recluster", li, self._job_seq))

    # -------------------------------------------------------- re-cluster --
    def _recluster(self, li: int, t0: float) -> None:
        meta = self.mutable.meta
        if meta.list_lengths[li] <= self.cfg.overflow_factor \
                * self.mutable.base_avg_len:
            self.mutable.reclustering.discard(li)
            self._compact_adm.release(self.kernel.now)
            return
        nb = int(meta.list_nbytes[li])
        self.report.compaction_read_bytes += nb
        self.report.compaction_read_requests += 1
        self._sim().submit_batch(
            nb, 1, on_done=lambda tk: self._recluster_compute(li, t0))

    def _recluster_compute(self, li: int, t0: float) -> None:
        n = int(self.mutable.meta.list_lengths[li])
        dt = plan_compute_seconds(2 * n * 4, 0, self.dim, self.pq_m,
                                  self.compute)    # 2-means, 4 iters
        self.kernel.after(dt, self._recluster_write, li, t0)

    def _recluster_write(self, li: int, t0: float) -> None:
        nb = int(self.mutable.meta.list_nbytes[li])
        self.report.compaction_write_bytes += nb
        self.report.compaction_write_requests += 2
        self._sim().submit_batch(
            nb, 2, put=True,
            on_done=lambda tk: self._recluster_install(li, t0))

    def _recluster_install(self, li: int, t0: float) -> None:
        res = self.mutable.split_list(li)
        self.mutable.reclustering.discard(li)
        if res is not None:
            new_li, _moved, _payloads, _nb = res
            self.report.reclusters += 1
            # register the split before broadcasting staleness: the
            # invalidate consumer may need the new list's placement
            # (write-back tiers admit the rewritten object on its owners)
            if self.on_new_list is not None:
                self.on_new_list(new_li, li)
            self.invalidate(("list", li))
            self.invalidate(("list", new_li))
        self._job_done(t0, "recluster")

    # ------------------------------------------------------- graph flush --
    def _flush_graph(self, t0: float) -> None:
        mut: MutableGraphIndex = self.mutable
        entries = dict(self.mem.entries)
        tombs = dict(self.mem.tombstones)
        dels = [i for i in sorted(tombs) if i in mut._adj]
        cand_map: dict[int, np.ndarray] = {}
        n_pq = 0
        for id_ in sorted(entries):
            cands, npq = mut.graph_candidates(
                entries[id_].vec, L=self.cfg.graph_stitch_L)
            cands = cands[~np.isin(cands, dels)] if dels else cands
            cand_map[id_] = cands
            n_pq += npq
        # blocks the stitch/repair must read for exact vectors:
        # candidates + their adjacency (back-edge prune pools), deleted
        # nodes + their in-neighbours + both sides' adjacency.
        read_ids: set[int] = set()
        for cands in cand_map.values():
            for c in cands:
                read_ids.add(int(c))
                read_ids.update(int(x) for x in mut.adjacency(int(c)))
        for d in dels:
            read_ids.add(d)
            read_ids.update(int(x) for x in mut.adjacency(d))
            for u in mut.in_neighbors(d):
                read_ids.add(u)
                read_ids.update(int(x) for x in mut.adjacency(u))
        read_ids -= set(int(i) for i in mut.dead)
        dt = plan_compute_seconds(0, n_pq, self.dim, self.pq_m,
                                  self.compute)
        self.kernel.after(dt, self._flush_graph_read, entries, tombs,
                          dels, cand_map, sorted(read_ids), t0)

    def _flush_graph_read(self, entries, tombs, dels, cand_map,
                          read_ids, t0: float) -> None:
        nb = self.mutable.node_nbytes()
        if read_ids:
            self.report.compaction_read_bytes += nb * len(read_ids)
            self.report.compaction_read_requests += len(read_ids)
            self._sim().submit_batch(
                nb * len(read_ids), len(read_ids),
                on_done=lambda tk: self._flush_graph_stitch(
                    entries, tombs, dels, cand_map, t0))
        else:
            self._flush_graph_stitch(entries, tombs, dels, cand_map, t0)

    def _flush_graph_stitch(self, entries, tombs, dels, cand_map,
                            t0: float) -> None:
        mut: MutableGraphIndex = self.mutable
        del_set = set(dels)
        new_nodes: dict[int, tuple] = {}
        rewrites: dict[int, np.ndarray] = {}
        d_dist = 0

        def vec_of(i: int) -> np.ndarray:
            if i in new_nodes:
                return np.asarray(new_nodes[i][0], dtype=np.float32)
            if i in entries:
                return np.asarray(entries[i].vec, dtype=np.float32)
            return np.asarray(self.mutable.store.get(("node", i))[0],
                              dtype=np.float32)

        def adj_of(i: int) -> np.ndarray:
            if i in rewrites:
                return rewrites[i]
            if i in new_nodes:
                return np.asarray(new_nodes[i][1], dtype=np.int64)
            return mut.adjacency(i)

        # ---- stitch inserts ----
        for id_ in sorted(entries):
            e = entries[id_]
            cands = cand_map[id_]
            cands = cands[[int(c) not in del_set for c in cands]] \
                if len(cands) else cands
            if len(cands) == 0:
                cands = np.asarray([mut.meta.medoid], dtype=np.int64)
            cvecs = np.stack([vec_of(int(c)) for c in cands])
            sel = mut.stitch_insert(id_, e.vec, cands, cvecs)
            d_dist += len(cands) * (len(cands) + 1)
            new_nodes[id_] = (e.vec, sel)
            for tgt in sorted(int(x) for x in sel):
                merged = np.unique(np.append(adj_of(tgt), id_))
                merged = merged[[int(x) not in del_set for x in merged]]
                mvecs = np.stack([vec_of(int(x)) for x in merged])
                rep = mut.repair_adjacency(tgt, vec_of(tgt), merged,
                                           mvecs)
                if tgt in new_nodes:       # back-edge onto a sibling
                    new_nodes[tgt] = (new_nodes[tgt][0], rep)
                else:
                    rewrites[tgt] = rep
                d_dist += len(merged) * (len(merged) + 1)
                self.report.repairs += 1
        # ---- repair around deletes (stitch through the hole) ----
        for d in dels:
            d_adj = mut.adjacency(d)
            d_adj = d_adj[[int(x) not in del_set for x in d_adj]]
            for u in mut.in_neighbors(d):
                if u in del_set or u in new_nodes:
                    continue
                cur = adj_of(u)
                merged = np.unique(np.concatenate(
                    [cur[cur != d], d_adj]))
                merged = merged[[int(x) not in del_set for x in merged]]
                mvecs = (np.stack([vec_of(int(x)) for x in merged])
                         if len(merged) else
                         np.zeros((0, self.dim), np.float32))
                rewrites[u] = mut.repair_adjacency(
                    u, vec_of(u), merged, mvecs)
                d_dist += len(merged) * (len(merged) + 1)
                self.report.repairs += 1
        dt = plan_compute_seconds(d_dist, 0, self.dim, self.pq_m,
                                  self.compute)
        self.kernel.after(dt, self._flush_graph_write, entries, tombs,
                          new_nodes, rewrites, dels, t0)

    def _flush_graph_write(self, entries, tombs, new_nodes, rewrites,
                           dels, t0: float) -> None:
        nb = self.mutable.node_nbytes()
        n_blocks = len(new_nodes) + len(
            [r for r in rewrites if r not in new_nodes])
        n_writes = n_blocks + len(dels)
        if n_writes == 0:
            self._flush_graph_install(entries, tombs, new_nodes,
                                      rewrites, dels, t0)
            return
        self.report.compaction_write_bytes += nb * n_blocks
        self.report.compaction_write_requests += n_writes
        self._sim().submit_batch(
            max(1, nb * n_blocks), n_writes, put=True,
            on_done=lambda tk: self._flush_graph_install(
                entries, tombs, new_nodes, rewrites, dels, t0))

    def _flush_graph_install(self, entries, tombs, new_nodes, rewrites,
                             dels, t0: float) -> None:
        now = self.kernel.now
        # reclaim corpses no in-flight query can reference: a query that
        # started after a block's unlink can never reach it (its wounded
        # neighbours were rewritten in the same install), so purge up to
        # the oldest in-flight query's start — parked sub-requests (shed
        # backoff, fault windows) keep their query in flight and their
        # corpses alive however long they park.  The grace window is a
        # belt-and-braces cap for drivers that supply no floor.
        floor = self.inflight_floor() if self.inflight_floor is not None \
            else now
        self.mutable.store.purge_lingering(
            before=min(now - self.cfg.reclaim_grace_s, floor))
        stale = self.mutable.install_graph(new_nodes, rewrites, dels,
                                           t=now)
        self.mem.clear_flushed(entries, tombs)
        self.report.record_seal(
            [now - e.arrive_t for _, e in sorted(entries.items())]
            + [now - at for _, at in sorted(tombs.items())])
        self.report.flushes += 1
        self.report.blocks_rewritten += len(stale)
        for key in stale:
            self.invalidate(key)
        self._flush_outstanding = False
        self._job_done(t0, "flush")

    # ---------------------------------------------------------- finalize --
    def finalize(self) -> None:
        self.report.unsealed += (len(self.mem.entries)
                                 + len(self.mem.tombstones))
        self.report.peak_delta_bytes = max(self.report.peak_delta_bytes,
                                           self.mem.peak_bytes)
        self.report.final_delta_bytes += self.mem.used_bytes
