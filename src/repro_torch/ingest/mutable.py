"""Mutable views over the two sealed index families.

A wrapper owns the *reconciliation* between the immutable sealed tier
(posting-list / node-block objects on the store, built once) and the
delta tier (:mod:`repro_torch.ingest.memtable`):

* it exposes the same serving surface as the wrapped index (``meta``,
  ``store``, ``search_plan``, ``select_lists``), so every engine, shard
  server, partitioner and tuner path works unchanged;
* merged search = sealed search ∪ brute-force delta scan, unified
  through :func:`repro_torch.core.cluster_index.dedup_topk` with tombstone
  filtering — the invariant under test is that a deleted id can never
  surface and a zero-delta search is bit-identical to the sealed one;
* it provides the *pure* mutation kernels (assignment, list rewrite,
  list split, graph stitch/repair via ``_robust_prune``) that
  :mod:`repro_torch.ingest.compaction` drives as kernel events, charging the
  I/O to a :class:`repro_torch.storage.simulator.StorageSim`.

Sites: update application is per *site* (the single engine, or one
fleet shard group).  Each site holds its own memtable + tombstones —
delta-tier replication, mirroring the sealed replication — and flushes
independently; rewrites are computed at install time from current
sealed content, so replica flushes are idempotent.

The port's own copy of ``repro.ingest.mutable``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import kmeans as km
from repro_torch.core.cluster_index import ClusterIndex, dedup_topk
from repro_torch.core.distances import np_sq_l2
from repro_torch.core.graph_index import GraphIndex, _robust_prune
from repro_torch.core.types import QueryMetrics, SearchParams, SearchResult
from repro_torch.ingest.memtable import ID_BYTES, Memtable


def _merge_results(base: SearchResult, extra_ids: np.ndarray,
                   extra_d: np.ndarray, dead: np.ndarray, k: int
                   ) -> SearchResult:
    """Union the sealed top-k with delta hits; drop tombstoned ids; pad
    back to k through the same ``dedup_topk`` kernel every other merge in
    the repo uses."""
    ids = base.ids[base.ids >= 0]
    d = base.dists[: len(ids)]
    if len(dead):
        keep = ~np.isin(ids, dead)
        ids, d = ids[keep], d[keep]
    if len(extra_ids):
        ids = np.concatenate([ids, extra_ids])
        d = np.concatenate([d, extra_d.astype(np.float32)])
    out_ids, out_d = dedup_topk(ids, d.astype(np.float32), k)
    return SearchResult(out_ids, out_d, base.metrics)


class _MutableBase:
    """Shared site/tombstone bookkeeping for both index families."""

    def __init__(self, base):
        self.base = base
        self.meta = base.meta
        self.store = base.store
        self.sites: dict[int, Memtable] = {}
        # applied deletes, not re-inserted.  Append-only by design: a
        # plan in flight may still hold a pre-compaction payload that
        # contains a flushed-out victim, so the filter must outlive the
        # install.  The sorted-array mirror keeps the per-scan filter a
        # single vectorised isin instead of a per-query set walk.
        self.deleted: set[int] = set()
        self._deleted_arr: np.ndarray | None = None
        self.live_count = base.meta.n_data

    def site(self, site_id: int) -> Memtable:
        if site_id not in self.sites:
            self.sites[site_id] = Memtable(self._vec_nbytes())
        return self.sites[site_id]

    @property
    def delta_bytes(self) -> int:
        return sum(m.used_bytes for m in self.sites.values())

    @property
    def has_delta(self) -> bool:
        return any(m.entries or m.tombstones for m in self.sites.values())

    def _delta_scan(self, q: np.ndarray, k: int, m: QueryMetrics
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Brute-force scan across every site's live delta (sites in id
        order for determinism), charging comps to ``m``."""
        all_ids, all_d = [], []
        for sid in sorted(self.sites):
            ids, d, nc = self.sites[sid].search(q, k)
            m.dist_comps += nc
            if len(ids):
                all_ids.append(ids)
                all_d.append(d)
        if not all_ids:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        return np.concatenate(all_ids), np.concatenate(all_d)

    def search_plan(self, q, params: SearchParams,
                    metrics: QueryMetrics | None = None):
        """Merged plan: the sealed plan's fetches pass through untouched
        (same batches, same event sequence), the delta merge happens in
        the final compute step.  With no delta and no tombstones the
        sealed result is returned as-is — bit-exact with the wrapped
        index."""
        m = metrics if metrics is not None else QueryMetrics()
        base_res = yield from self.base.search_plan(q, params, m)
        if not self.has_delta and not self.deleted:
            return base_res
        return self.merge_result(q, params.k, base_res, m)

    def merge_result(self, q, k: int, base_res: SearchResult,
                     m: QueryMetrics) -> SearchResult:
        """Delta-merge + tombstone-filter a sealed result (also the hook
        the fleet router calls after its scatter-gather plan finishes)."""
        extra_ids, extra_d = self._delta_scan(q, k, m)
        return _merge_results(base_res, extra_ids, extra_d,
                              self.deleted_array(), k)

    def deleted_array(self) -> np.ndarray:
        """Sorted array mirror of ``deleted`` (cached between deletes)."""
        if self._deleted_arr is None:
            self._deleted_arr = np.fromiter(
                sorted(self.deleted), dtype=np.int64,
                count=len(self.deleted))
        return self._deleted_arr

    def search(self, q, params: SearchParams) -> SearchResult:
        gen = self.search_plan(q, params)
        try:
            batch = next(gen)
            while True:
                payloads = {r.key: self.store.get(r.key)
                            for r in batch.requests}
                batch = gen.send(payloads)
        except StopIteration as stop:
            return stop.value

    # ---------------------------------------------------------- applies --
    def note_insert(self, id_: int) -> None:
        if id_ in self.deleted:
            self.deleted.discard(id_)
            self._deleted_arr = None

    def note_delete(self, id_: int) -> None:
        if id_ not in self.deleted:
            self.deleted.add(id_)
            self._deleted_arr = None


class MutableClusterIndex(_MutableBase):
    """SPANN-style index with a delta tier and rewriting compaction."""

    kind = "cluster"

    def __init__(self, base: ClusterIndex):
        super().__init__(base)
        self.use_bkt = base.use_bkt
        # sealed membership: id -> set of posting lists currently holding
        # a copy (delete routing + idempotent flush accounting)
        self._id_lists: dict[int, set[int]] = {}
        for li in range(self.meta.n_lists):
            ids, _ = self.store.get(("list", li))
            for i in ids:
                self._id_lists.setdefault(int(i), set()).add(li)
        # overflow reference: the build-time average list length
        self.base_avg_len = max(1.0, float(self.meta.list_lengths.mean()))
        self._leaf_node: dict[int, int] = {
            node.leaf_id: ni for ni, node in enumerate(self.meta.tree.nodes)
            if not node.children}
        self.reclustering: set[int] = set()

    def _vec_nbytes(self) -> int:
        return self.meta.dim * np.dtype(self.meta.dtype).itemsize

    @property
    def entry_nbytes(self) -> int:
        return self._vec_nbytes() + ID_BYTES

    # ---------------------------------------------------------- serving --
    def select_lists(self, q, nprobe):
        return self.base.select_lists(q, nprobe)

    # ------------------------------------------------------- assignment --
    def assign_lists(self, vec: np.ndarray) -> tuple[tuple[int, ...], int]:
        """Closure-replicated assignment of one vector against the
        current leaf centroids (the build rule, applied incrementally).
        Returns (list ids, distance comps to charge)."""
        cents = self.meta.tree.centroids
        d = np_sq_l2(np.asarray(vec, dtype=np.float32), cents)
        p = self.meta.params
        r = min(p.num_replica, len(cents))
        idx = np.argsort(d, kind="stable")[:r]
        thresh = (1.0 + p.closure_eps) ** 2 * d[idx[0]] + 1e-12
        keep = idx[d[idx] <= thresh]
        if len(keep) == 0:
            keep = idx[:1]
        return tuple(int(i) for i in keep), len(cents)

    def lists_of(self, id_: int) -> tuple[int, ...]:
        """Sealed posting lists currently holding ``id_``."""
        return tuple(sorted(self._id_lists.get(id_, ())))

    # -------------------------------------------------------- compaction --
    def list_nbytes_of(self, ids_len: int) -> int:
        return max(1, ids_len * self.entry_nbytes)

    def rewrite_size(self, li: int, entries: dict,
                     tombstones: set) -> int:
        """Billable size of the rewrite — the flush's I/O sizing pass.
        Count-only: the content itself is materialised once, at
        install."""
        old_ids, _ = self.store.get(("list", li))
        delta_ids = [id_ for id_, e in entries.items() if li in e.lists]
        drop = tombstones | set(delta_ids)
        n_keep = len(old_ids)
        if drop and len(old_ids):
            n_keep -= int(np.isin(
                old_ids, np.fromiter(drop, dtype=np.int64)).sum())
        return self.list_nbytes_of(n_keep + len(delta_ids))

    def rewrite_list(self, li: int, entries: dict, tombstones: set
                     ) -> tuple[np.ndarray, np.ndarray, int]:
        """Pure rewrite kernel: sealed content − tombstones + the delta
        entries destined for ``li`` (delta copy wins on id collision).
        Idempotent — a replica site flushing the same entries later
        reproduces the same content."""
        old_ids, old_vecs = self.store.get(("list", li))
        delta = {id_: e for id_, e in entries.items() if li in e.lists}
        drop = tombstones | set(delta)
        if drop and len(old_ids):
            keep = ~np.isin(old_ids, np.fromiter(drop, dtype=np.int64))
            old_ids, old_vecs = old_ids[keep], old_vecs[keep]
        if delta:
            add_ids = np.array(sorted(delta), dtype=np.int64)
            add_vecs = np.stack([delta[i].vec for i in sorted(delta)]
                                ).astype(old_vecs.dtype if len(old_vecs)
                                         else self.meta.dtype)
            new_ids = np.concatenate([old_ids, add_ids])
            new_vecs = np.concatenate([
                old_vecs if len(old_vecs) else
                np.zeros((0, self.meta.dim), add_vecs.dtype), add_vecs])
        else:
            new_ids, new_vecs = old_ids, old_vecs
        return new_ids, new_vecs, self.list_nbytes_of(len(new_ids))

    def install_list(self, li: int, ids: np.ndarray, vecs: np.ndarray,
                     nbytes: int) -> None:
        """Swap in a rewritten posting list and reconcile membership and
        live-count bookkeeping (idempotent across replica flushes)."""
        old_ids, _ = self.store.get(("list", li))
        self.store.put(("list", li), (ids, vecs), nbytes)
        self.meta.list_lengths[li] = len(ids)
        self.meta.list_nbytes[li] = nbytes
        removed = set(int(i) for i in old_ids) - set(int(i) for i in ids)
        added = set(int(i) for i in ids) - set(int(i) for i in old_ids)
        for i in removed:
            s = self._id_lists.get(i)
            if s is not None:
                s.discard(li)
                if not s:
                    del self._id_lists[i]
                    self.live_count -= 1
        for i in added:
            s = self._id_lists.get(i)
            if s is None:
                self._id_lists[i] = {li}
                self.live_count += 1
            else:
                s.add(li)
        self.meta.n_data = self.live_count

    # --------------------------------------------------------- overflow --
    def overflowed(self, li: int, factor: float) -> bool:
        return (li not in self.reclustering
                and self.meta.list_lengths[li] > factor * self.base_avg_len)

    def split_list(self, li: int
                   ) -> tuple[int, dict[int, int], list, int] | None:
        """Split an overflowed posting list in two with a local 2-means
        (the SPANN re-cluster step).  Returns (new list id, moved id →
        new list, [payloads for (li, new_li)], write bytes), or None when
        the list refuses to split (degenerate geometry).

        The caller owns scheduling, I/O pricing and cache invalidation;
        this method only installs the new sealed state + tree surgery:
        the overflowed leaf becomes an internal node with two leaf
        children, so BKT descent and flat centroid search both route to
        the halves."""
        ids, vecs = self.store.get(("list", li))
        if len(ids) < 4:
            return None
        rng = np.random.default_rng((int(li), 0x5EED))
        cents, assign = km.kmeans_np(
            np.asarray(vecs, dtype=np.float32), 2, iters=4, rng=rng)
        if (assign == 0).all() or (assign == 1).all():
            return None
        new_li = self.meta.n_lists
        keep_ids, keep_vecs = ids[assign == 0], vecs[assign == 0]
        move_ids, move_vecs = ids[assign == 1], vecs[assign == 1]
        tree = self.meta.tree
        old_node_i = self._leaf_node[li]
        old_node = tree.nodes[old_node_i]
        n_a = km._Node(center=cents[0], children=[], leaf_id=li)
        n_b = km._Node(center=cents[1], children=[], leaf_id=new_li)
        tree.nodes.append(n_a)
        tree.nodes.append(n_b)
        ia, ib = len(tree.nodes) - 2, len(tree.nodes) - 1
        old_node.children = [ia, ib]
        old_node.leaf_id = -1
        self._leaf_node[li] = ia
        self._leaf_node[new_li] = ib
        tree.centroids = np.concatenate(
            [tree.centroids, cents[1][None]], axis=0)
        tree.centroids[li] = cents[0]
        # sealed state
        nb_a = self.list_nbytes_of(len(keep_ids))
        nb_b = self.list_nbytes_of(len(move_ids))
        self.store.put(("list", li), (keep_ids, keep_vecs), nb_a)
        self.store.put(("list", new_li), (move_ids, move_vecs), nb_b)
        self.meta.list_lengths = np.concatenate(
            [self.meta.list_lengths,
             np.array([len(move_ids)], dtype=np.int32)])
        self.meta.list_lengths[li] = len(keep_ids)
        self.meta.list_nbytes = np.concatenate(
            [self.meta.list_nbytes, np.array([nb_b], dtype=np.int64)])
        self.meta.list_nbytes[li] = nb_a
        moved = {int(i): new_li for i in move_ids}
        for i in move_ids:
            s = self._id_lists.get(int(i))
            if s is not None and li in s:
                s.discard(li)
                s.add(new_li)
        for mem in self.sites.values():
            mem.remap_list(li, moved)
        return new_li, moved, [(keep_ids, keep_vecs), (move_ids, move_vecs)], \
            nb_a + nb_b


class MutableGraphIndex(_MutableBase):
    """DiskANN-style index with delta nodes and stitch/repair compaction.

    The adjacency mirror + reverse-edge map live in compute-node memory
    alongside the PQ codes (the same metadata class the paper's §2.1
    node caches); the node *blocks* on the object store remain the
    truth the compactor reads (for exact vectors) and rewrites.
    """

    kind = "graph"

    def __init__(self, base: GraphIndex):
        super().__init__(base)
        n = self.meta.n_data
        self._adj: dict[int, np.ndarray] = {}
        self._rev: dict[int, set[int]] = {}
        for i in range(n):
            _, nbrs = self.store.get(("node", i))
            nbrs = nbrs[nbrs >= 0].astype(np.int64)
            self._adj[i] = nbrs
            for t in nbrs:
                self._rev.setdefault(int(t), set()).add(i)
        self.dead: set[int] = set()         # flushed (sealed) deletes

    def _vec_nbytes(self) -> int:
        return self.meta.dim * np.dtype(self.meta.dtype).itemsize

    def adjacency(self, id_: int) -> np.ndarray:
        return self._adj.get(id_, np.zeros(0, dtype=np.int64))

    def in_neighbors(self, id_: int) -> tuple[int, ...]:
        return tuple(sorted(self._rev.get(id_, ())))

    # ------------------------------------------------------- candidates --
    def graph_candidates(self, vec: np.ndarray, L: int = 48
                         ) -> tuple[np.ndarray, int]:
        """Metadata-resident greedy search (PQ distances over the
        adjacency mirror) producing the candidate pool an insert's
        RobustPrune consumes.  Returns (candidate ids, pq comps)."""
        meta = self.meta
        table = meta.pq.adc_table(np.asarray(vec, dtype=np.float32))
        start = meta.medoid
        dists = {start: float(meta.pq.adc_lookup(
            meta.codes[start][None], table)[0])}
        n_pq = 1
        expanded: set[int] = set()
        frontier = {start}
        for _ in range(L + 8):
            cand = [(d, i) for i, d in dists.items() if i not in expanded]
            if not cand or len(expanded) >= L:
                break
            cand.sort()
            _, node = cand[0]
            expanded.add(node)
            nbrs = [int(t) for t in self._adj.get(node, ())
                    if int(t) not in dists and int(t) not in self.dead]
            if nbrs:
                codes = meta.codes[np.asarray(nbrs, dtype=np.int64)]
                dd = meta.pq.adc_lookup(codes, table)
                n_pq += len(nbrs)
                for t, d in zip(nbrs, dd):
                    dists[t] = float(d)
        out = np.asarray(sorted(expanded), dtype=np.int64)
        return out, n_pq

    # -------------------------------------------------------- compaction --
    def stitch_insert(self, id_: int, vec: np.ndarray,
                      cand_ids: np.ndarray, cand_vecs: np.ndarray
                      ) -> np.ndarray:
        """RobustPrune the candidate pool into the new node's adjacency
        (the Vamana insert rule, run incrementally)."""
        p = self.meta.params
        keep = cand_ids != id_
        cand_ids, cand_vecs = cand_ids[keep], cand_vecs[keep]
        if len(cand_ids) == 0:
            return np.zeros(0, dtype=np.int64)
        return _robust_prune(np.asarray(vec, dtype=np.float32),
                             cand_ids.astype(np.int64),
                             cand_vecs.astype(np.float32),
                             p.R, p.alpha)

    def repair_adjacency(self, node: int, node_vec: np.ndarray,
                         merged: np.ndarray, vecs: np.ndarray
                         ) -> np.ndarray:
        """Re-run RobustPrune over a node whose neighbourhood changed
        (back-edge overflow, or a deleted neighbour stitched around)."""
        p = self.meta.params
        keep = merged != node
        merged, vecs = merged[keep], vecs[keep]
        if len(merged) <= p.R:
            return merged.astype(np.int64)
        return _robust_prune(np.asarray(node_vec, dtype=np.float32),
                             merged.astype(np.int64),
                             vecs.astype(np.float32), p.R, p.alpha)

    def node_nbytes(self) -> int:
        return self.meta.node_nbytes

    def install_graph(self, new_nodes: dict[int, tuple[np.ndarray,
                                                       np.ndarray]],
                      rewrites: dict[int, np.ndarray],
                      removed: list[int], t: float = 0.0) -> list:
        """Atomically swap in a compaction round's sealed graph state.

        ``new_nodes``: id → (vector, adjacency); ``rewrites``: existing
        id → new adjacency; ``removed``: deleted ids whose blocks retire
        (``t``: the install's virtual time, stamped on the unlinked
        corpses for grace-based purging).
        Returns the store keys whose cached copies are now stale.
        """
        meta = self.meta
        p = meta.params
        stale = []
        # grow the PQ code matrix to cover the new id range
        max_id = max([meta.codes.shape[0] - 1]
                     + [i for i in new_nodes]) + 1
        if max_id > meta.codes.shape[0]:
            pad = np.zeros((max_id - meta.codes.shape[0], meta.pq.m),
                           dtype=meta.codes.dtype)
            meta.codes = np.concatenate([meta.codes, pad], axis=0)
        for id_ in sorted(new_nodes):
            vec, adj = new_nodes[id_]
            meta.codes[id_] = meta.pq.encode(
                np.asarray(vec, dtype=np.float32)[None])[0]
            self._set_adj(id_, adj)
            self.store.put(("node", id_), (vec, self._padded(adj, p.R)),
                           meta.node_nbytes)
            stale.append(("node", id_))
            self.live_count += 1
            self.dead.discard(id_)
        for id_ in sorted(rewrites):
            if id_ in new_nodes:
                continue
            adj = rewrites[id_]
            vec, _ = self.store.get(("node", id_))
            self._set_adj(id_, adj)
            self.store.put(("node", id_), (vec, self._padded(adj, p.R)),
                           meta.node_nbytes)
            stale.append(("node", id_))
        for id_ in sorted(removed):
            if ("node", id_) in self.store:
                self._retire(id_, t)
                stale.append(("node", id_))
        meta.n_data = max(meta.n_data, max_id)
        return stale

    def _padded(self, adj: np.ndarray, R: int) -> np.ndarray:
        out = np.full(R, -1, dtype=np.int32)
        adj = np.asarray(adj, dtype=np.int32)[:R]
        out[: len(adj)] = adj
        return out

    def _set_adj(self, id_: int, adj: np.ndarray) -> None:
        old = self._adj.get(id_)
        if old is not None:
            for t in old:
                self._rev.get(int(t), set()).discard(id_)
        adj = np.asarray(adj, dtype=np.int64)
        self._adj[id_] = adj
        for t in adj:
            self._rev.setdefault(int(t), set()).add(id_)

    def _retire(self, id_: int, t: float = 0.0) -> None:
        """Retire a repaired-around node: adjacency and reverse edges go,
        and the block is **unlinked** from the store — its bytes are
        reclaimed immediately, while the payload lingers readable for
        queries already in flight (a plan may hold a pre-compaction
        adjacency that still points at the victim; tombstone filtering
        keeps it out of their results).  Lingering corpses are purged by
        later flush installs once they outlive the reclaim grace window
        (covering readers parked by shed backoff or fault windows).
        Re-elects the medoid if the entry point died."""
        self.store.unlink(("node", id_), t=t)
        old = self._adj.pop(id_, None)
        if old is not None:
            for t in old:
                self._rev.get(int(t), set()).discard(id_)
        self._rev.pop(id_, None)
        self.dead.add(id_)
        self.live_count -= 1
        if id_ == self.meta.medoid:
            live_nbrs = [int(t) for t in (old if old is not None else ())
                         if int(t) in self._adj]
            if live_nbrs:
                self.meta.medoid = min(live_nbrs)
            else:
                self.meta.medoid = min(self._adj)


def make_mutable(index):
    """Wrap a sealed index in its mutable counterpart."""
    if isinstance(index, (MutableClusterIndex, MutableGraphIndex)):
        return index
    if isinstance(index, ClusterIndex):
        return MutableClusterIndex(index)
    if isinstance(index, GraphIndex):
        return MutableGraphIndex(index)
    raise TypeError(f"cannot make {type(index).__name__} mutable")
