"""SPANN-style cluster index (paper §2.3.1, §3, §5.3).

Counterpart of ``repro.core.cluster_index``.

Build: hierarchically balanced k-means partitions the dataset into posting
lists (leaf centers = centroids; the hierarchy is the in-memory BKT), on
the host in numpy exactly as the reference does.  Boundary vectors are
*closure-replicated* into up to ``num_replica`` lists (a point joins list j
iff d(p,c_j) <= (1+eps) * d(p,c_1)); the top-``num_replica`` centroids of
every point come from the fused ``l2_topk`` kernel on the card.

Search: BKT (or flat) centroid search picks the top-``nprobe`` lists; all
lists are fetched in ONE dependency-free roundtrip, then scanned with full-
precision distance computations.

Two serving paths:
* ``search_plan`` — generator yielding :class:`FetchBatch` for a
  discrete-event cloud simulator (host numpy, as in the reference).
* ``device_search_batch`` — the resident-array path on the card, with
  padded posting lists: the probe runs the ``l2_distance`` kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Generator

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import kmeans as km
from repro_torch.core.distances import np_sq_l2, pairwise_sq_l2, topk_smallest
from repro_torch.core.types import (ClusterIndexParams, FetchBatch,
                                    FetchRequest, QueryMetrics, SearchParams,
                                    SearchResult)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import full_f32_matmul
from repro_torch.storage.object_store import ObjectStore


@dataclasses.dataclass
class ClusterIndexMeta:
    """Compute-node-resident metadata (what TurboPuffer caches, §2.1)."""

    tree: km.BKTree
    list_lengths: np.ndarray      # (n_lists,) int32
    list_nbytes: np.ndarray       # (n_lists,) int64 billable object sizes
    n_data: int
    dim: int
    dtype: np.dtype
    params: ClusterIndexParams

    @property
    def n_lists(self) -> int:
        return len(self.list_lengths)

    @property
    def index_bytes(self) -> int:
        return int(self.list_nbytes.sum())

    @property
    def avg_list_bytes(self) -> float:
        return float(self.list_nbytes.mean())


def closure_pairs(dd: np.ndarray, idx: np.ndarray, thresh: float,
                  first_point: int) -> tuple[np.ndarray, np.ndarray]:
    """Closure rule on one chunk's top-r centroids (sorted by distance).

    ``dd``/``idx`` are (rows, r) float32 distances and list ids of points
    ``first_point + row``.  A point keeps its nearest list and every list
    within ``thresh`` (= (1+eps)^2 on squared distances) of it.  Returns
    ``(list ids, point ids)`` int64, row-major — the reference's arithmetic
    (``cluster_index.py:164-168``) to the bit.
    """
    keep = dd <= (thresh * dd[:, :1] + 1e-12)
    keep[:, 0] = True
    rows, cols = np.nonzero(keep)
    return (idx[rows, cols].astype(np.int64),
            (rows + first_point).astype(np.int64))


def dedup_topk(ids: np.ndarray, d: np.ndarray, k: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """Top-``k`` of (ids, distances) with replica dedup, padded to k.

    Stable distance order + first-occurrence id dedup keeps the nearest
    copy of every closure-replicated point.
    """
    order = np.argsort(d, kind="stable")
    ids_sorted = ids[order]
    _, first = np.unique(ids_sorted, return_index=True)
    first.sort()
    sel = order[first[:k]]
    # re-sort final k by distance
    sel = sel[np.argsort(d[sel], kind="stable")]
    out_ids = ids[sel]
    out_d = d[sel].astype(np.float32)
    if len(out_ids) < k:
        out_ids = np.pad(out_ids, (0, k - len(out_ids)),
                         constant_values=-1)
        out_d = np.pad(out_d, (0, k - len(out_d)),
                       constant_values=np.inf)
    return out_ids, out_d


def scan_posting_lists(q: np.ndarray, payload_items, k: int,
                       metrics: QueryMetrics,
                       exclude: set | None = None) -> SearchResult:
    """Scan fetched posting lists and return the top-``k``.

    ``payload_items`` is an iterable of ``(ids, vecs)`` posting-list
    payloads.  Closure-replicated points are deduplicated by keeping the
    first (nearest) occurrence.  ``exclude`` (a set or int64 array) drops
    tombstoned ids.
    """
    all_ids = []
    all_vecs = []
    for ids, vecs in payload_items:
        if len(ids):
            all_ids.append(ids)
            all_vecs.append(vecs)
    if not all_ids:
        return SearchResult(np.full(k, -1, np.int64),
                            np.full(k, np.inf, np.float32), metrics)
    ids = np.concatenate(all_ids)
    vecs = np.concatenate(all_vecs)
    if exclude is not None and len(exclude):
        excl = exclude if isinstance(exclude, np.ndarray) else \
            np.fromiter(exclude, dtype=np.int64)
        keep = ~np.isin(ids, excl)
        ids, vecs = ids[keep], vecs[keep]
        if not len(ids):
            return SearchResult(np.full(k, -1, np.int64),
                                np.full(k, np.inf, np.float32), metrics)
    d = np_sq_l2(q, vecs)
    metrics.dist_comps += len(ids)
    out_ids, out_d = dedup_topk(ids, d, k)
    return SearchResult(out_ids, out_d, metrics)


class ClusterIndex:
    def __init__(self, meta: ClusterIndexMeta, store: ObjectStore,
                 use_bkt: bool = True):
        self.meta = meta
        self.store = store
        self.use_bkt = use_bkt

    # ------------------------------------------------------------- build --
    @staticmethod
    def build(data: np.ndarray, params: ClusterIndexParams,
              store: ObjectStore | None = None,
              chunk: int = 4096, *,
              device: str | torch.device | None = None) -> "ClusterIndex":
        dev = resolve_device(device)
        store = store if store is not None else ObjectStore()
        data = np.ascontiguousarray(data)
        n, dim = data.shape
        n_leaves = max(1, int(round(params.centroid_frac * n)))
        data32 = data.astype(np.float32)
        with spans.span("repro_torch.build.bkt"):
            tree, _ = km.hierarchical_partition(
                data32, n_leaves, branch=params.branch,
                iters=params.kmeans_iters,
                balance_penalty=max(params.balance_penalty, 1.0),
                seed=params.seed)
        with spans.span("repro_torch.build.closure"):
            cents = torch.from_numpy(tree.centroids).to(dev)
            points = torch.from_numpy(data32).to(dev)
            n_lists = len(tree.centroids)
            r = min(params.num_replica, n_lists)

            # closure replication: top-r centroids per point from the fused
            # kernel, keep those within (1+eps) of the nearest (squared
            # distances -> (1+eps)^2).
            thresh = (1.0 + params.closure_eps) ** 2
            pair_list: list[np.ndarray] = []
            pair_point: list[np.ndarray] = []
            for s in range(0, n, chunk):
                dd, idx = ops.l2_topk(points[s:s + chunk], cents, r)
                lists, pts = closure_pairs(dd.cpu().numpy(), idx.cpu().numpy(),
                                           thresh, s)
                pair_list.append(lists)
                pair_point.append(pts)
            lists_flat = np.concatenate(pair_list)
            points_flat = np.concatenate(pair_point)
            order = np.argsort(lists_flat, kind="stable")
            lists_flat, points_flat = lists_flat[order], points_flat[order]
            starts = np.searchsorted(lists_flat, np.arange(n_lists))
            ends = np.searchsorted(lists_flat, np.arange(n_lists) + 1)

            itemsize = data.dtype.itemsize
            lengths = (ends - starts).astype(np.int32)
            # billable size: raw vectors + 8-byte ids (paper's posting lists
            # store full vectors inline)
            nbytes = lengths.astype(np.int64) * (dim * itemsize + 8)
            for li in range(n_lists):
                ids_arr = points_flat[starts[li]:ends[li]]
                vecs = data[ids_arr] if len(ids_arr) else np.zeros(
                    (0, dim), data.dtype)
                store.put(("list", li), (ids_arr, vecs), int(max(nbytes[li], 1)))

        meta = ClusterIndexMeta(
            tree=tree, list_lengths=lengths, list_nbytes=nbytes,
            n_data=n, dim=dim, dtype=data.dtype, params=params)
        return ClusterIndex(meta, store)

    # ------------------------------------------------------------ search --
    def select_lists(self, q: np.ndarray, nprobe: int
                     ) -> tuple[np.ndarray, int]:
        nprobe = min(nprobe, self.meta.n_lists)
        if self.use_bkt:
            return self.meta.tree.search(q, nprobe)
        ids = self.meta.tree.flat_search(q, nprobe)
        return ids, self.meta.n_lists

    def search_plan(
        self, q: np.ndarray, params: SearchParams,
        metrics: QueryMetrics | None = None,
    ) -> Generator[FetchBatch, dict, SearchResult]:
        """Generator protocol: yields one FetchBatch; the engine sends back
        {key: payload}; returns SearchResult."""
        m = metrics if metrics is not None else QueryMetrics()
        lids, ndist = self.select_lists(q, params.nprobe)
        m.dist_comps += ndist                      # BKT centroid comps
        m.lists_visited = len(lids)
        reqs = [FetchRequest(("list", int(i)), int(self.meta.list_nbytes[i]))
                for i in lids]
        payloads = yield FetchBatch(reqs)
        m.roundtrips += 1
        m.requests += len(reqs)
        m.bytes_read += sum(r.nbytes for r in reqs)
        return scan_posting_lists(q, (payloads[rq.key] for rq in reqs),
                                  params.k, m)

    def search(self, q: np.ndarray, params: SearchParams) -> SearchResult:
        """Drive search_plan directly against the store (no timing)."""
        gen = self.search_plan(q, params)
        batch = next(gen)
        try:
            while True:
                payloads = {r.key: self.store.get(r.key)
                            for r in batch.requests}
                batch = gen.send(payloads)
        except StopIteration as stop:
            return stop.value

    # ----------------------------------------------------- device arrays --
    def device_arrays(self, max_len: int | None = None) -> dict[str, np.ndarray]:
        """Padded resident layout for the device serving path.

        Returns centroids (L, D), list_vecs (L, maxlen, D),
        list_ids (L, maxlen) int32 (-1 pad), list_len (L,) int32, as numpy;
        the caller moves them to the card.
        """
        L = self.meta.n_lists
        dim = self.meta.dim
        ml = int(max_len or self.meta.list_lengths.max())
        with spans.span("repro_torch.build.device_arrays"):
            vecs = np.zeros((L, ml, dim), dtype=np.float32)
            ids = np.full((L, ml), -1, dtype=np.int32)
            for li in range(L):
                pids, pv = self.store.get(("list", li))
                cnt = min(len(pids), ml)
                if cnt:
                    vecs[li, :cnt] = pv[:cnt].astype(np.float32)
                    ids[li, :cnt] = pids[:cnt]
        return dict(
            centroids=self.meta.tree.centroids.astype(np.float32),
            list_vecs=vecs, list_ids=ids,
            list_len=np.minimum(self.meta.list_lengths, ml).astype(np.int32))


def device_search_batch(
    centroids: torch.Tensor,     # (L, D)
    list_vecs: torch.Tensor,     # (L, maxlen, D)
    list_ids: torch.Tensor,      # (L, maxlen) int32, -1 padded
    queries: torch.Tensor,       # (B, D)
    *, nprobe: int, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Resident-array batched cluster search on the tensors' device.

    Centroid probe (``l2_distance`` kernel) -> stable top-nprobe ->
    posting-list gather -> masked distance -> top-4k window -> replica
    dedup -> top-k: the reference's pipeline (``cluster_index.py:270-291``)
    step for step, with "fetch" an HBM gather.  The scan is plain batched
    tensor code in full f32, as the reference's is XLA outside any kernel.
    Returns ``(ids (B, k) int32, dists (B, k) f32)``.

    Each stage runs in a span of :mod:`repro_torch.spans`
    (``repro_torch.search.{probe,select,gather,scan,merge}`` inside
    ``repro_torch.search``); while the recorder is on, a last span,
    ``repro_torch.search.count``, counts the queries, the padded rows the
    gather reads and those that hold an entry, and the answers with fewer
    than ``k`` results.
    """
    B, D = queries.shape
    with spans.span("repro_torch.search",
                    batch=spans.next_batch("search.batches")):
        with spans.span("repro_torch.search.probe"):
            cd = pairwise_sq_l2(queries, centroids)          # (B, L)
        with spans.span("repro_torch.search.select"):
            _, probe = topk_smallest(cd, nprobe)             # (B, nprobe)
        with spans.span("repro_torch.search.gather"):
            vecs = list_vecs[probe].reshape(B, -1, D)        # (B, np*ml, D)
            ids = list_ids[probe].reshape(B, -1)             # (B, np*ml)
        with spans.span("repro_torch.search.scan"):
            # per query: |q|^2 + |x|^2 - 2 q.x, clamped (pairwise_sq_l2's
            # formula)
            qf = queries.float()
            qn = (qf * qf).sum(-1)[:, None]
            xn = (vecs * vecs).sum(-1)
            with full_f32_matmul():
                ip = torch.bmm(vecs, qf[:, :, None])[..., 0]
            d = torch.clamp_min(qn + xn - 2.0 * ip, 0.0)
            d = torch.where(ids < 0, torch.inf, d)
        with spans.span("repro_torch.search.merge"):
            # dedup replicas: a duplicated id appears with identical
            # distance; sort by distance and mask repeated ids within the
            # top window.
            dd, ii = topk_smallest(d, min(4 * k, d.shape[-1]))
            cand_ids = torch.gather(ids, 1, ii)              # (B, 4k)
            same = cand_ids[:, :, None] == cand_ids[:, None, :]
            w = cand_ids.shape[1]
            earlier = torch.ones((w, w), dtype=torch.bool,
                                 device=ids.device).tril(-1)[None]
            dup = torch.any(same & earlier, dim=-1)
            dd = torch.where(dup, torch.inf, dd)
            vals, sel = topk_smallest(dd, k)
            out_ids = torch.gather(cand_ids, 1, sel)
        if spans.enabled():
            with spans.span("repro_torch.search.count"):
                spans.count("search.queries", B)
                spans.count("search.rows_gathered", ids.numel())
                spans.count("search.rows_filled", (ids >= 0).sum())
                spans.count("search.short_answers",
                            torch.isinf(vals).any(-1).sum())
    return out_ids, vals
