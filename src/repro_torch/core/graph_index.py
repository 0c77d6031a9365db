"""DiskANN-style graph index (paper §2.3.2, §3, §5.3).

Counterpart of ``repro.core.graph_index``.

Build (Vamana): batched greedy-search + α-robust-prune passes over the
dataset; fixed max out-degree R (the graph-density knob of Fig 17).  The
greedy search runs in torch on the device, batched over 256 points as the
reference's numpy is, against the data resident on the device and a copy
of the adjacency made once per batch (the host prune rewrites it between
batches).  RobustPrune and the reverse-edge pass stay host numpy, as the
reference has them; the init graph and the insertion order come from the
same ``np.random.default_rng(seed)`` draws, so integer-valued data (exact
distances) gives the reference's adjacency.

Storage layout: one block per node holding the full-precision vector and
the padded adjacency list, rounded up to ``sector_bytes`` (4KB).

Memory-resident metadata: PQ codes of every vector + codebooks (paper
Table 3 "PQ dim."), the medoid/entry point.

Search: iterative best-first traversal with beamwidth W (Alg 1 + DiskANN's
multi-vector extraction).  ``search_plan`` is the reference's numpy
candidate bookkeeping line for line; only the query's ADC table and the
ADC lookups move to the index's device, where each lookup is one launch of
the ``adc_lookup`` kernel on the codes of the round's new neighbours
(gathered on the host, so a write path that grows ``meta.codes`` is seen
at once).
"""
from __future__ import annotations

import dataclasses
from typing import Generator

import numpy as np
import torch

from repro_torch.core import pq as pqmod
from repro_torch.core.distances import np_sq_l2
from repro_torch.core.types import (FetchBatch, FetchRequest, GraphIndexParams,
                                    QueryMetrics, SearchParams, SearchResult)
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import full_f32_matmul
from repro_torch.storage.object_store import ObjectStore, round_to_sectors


@dataclasses.dataclass
class GraphIndexMeta:
    """Compute-node-resident metadata (PQ codes + codebooks + entry point)."""

    pq: pqmod.ProductQuantizer
    codes: np.ndarray             # (N, m) uint8
    medoid: int
    n_data: int
    dim: int
    dtype: np.dtype
    node_nbytes: int              # per-node billable block size
    params: GraphIndexParams

    @property
    def index_bytes(self) -> int:
        return self.n_data * self.node_nbytes


def _robust_prune(
    p_vec: np.ndarray,            # (D,)
    cand_ids: np.ndarray,         # (C,) unique candidate ids (no self)
    cand_vecs: np.ndarray,        # (C, D)
    R: int,
    alpha: float,
    max_pool: int = 192,
) -> np.ndarray:
    """DiskANN RobustPrune: greedy α-dominated candidate elimination.

    The candidate pool is capped at ``max_pool`` points to bound the C×C
    distance matrix — the nearest ones plus a 16-candidate far tail, so
    long-range (navigability) edges always remain prunable-in rather than
    silently dropped.
    """
    d_p = np_sq_l2(p_vec, cand_vecs)              # (C,)
    if len(cand_ids) > max_pool:
        order = np.argsort(d_p, kind="stable")
        keep = np.concatenate([order[: max_pool - 16], order[-16:]])
        cand_ids, cand_vecs, d_p = cand_ids[keep], cand_vecs[keep], d_p[keep]
    order = np.argsort(d_p, kind="stable")
    d_p = d_p[order]
    cand_ids = cand_ids[order]
    cand_vecs = cand_vecs[order]
    d_cc = np_sq_l2(cand_vecs, cand_vecs)         # (C, C), one matmul
    alive = np.ones(len(cand_ids), dtype=bool)
    chosen: list[int] = []
    a2 = alpha * alpha                            # α on metric -> α² on sq
    for oi in range(len(cand_ids)):               # increasing d_p order
        if not alive[oi]:
            continue
        chosen.append(oi)
        if len(chosen) >= R:
            break
        # prune c' if α·d(p*, c') <= d(p, c')
        alive &= ~(a2 * d_cc[oi] <= d_p)
        alive[oi] = False
    return cand_ids[np.asarray(chosen, dtype=np.int64)]


def _merge_candidates(
    cand_ids: torch.Tensor, cand_d: torch.Tensor, expanded: torch.Tensor,
    new_ids: torch.Tensor, new_d: torch.Tensor, L: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vectorised candidate-list merge with id-dedup, batched over rows.

    All inputs are (B, *) tensors of one device; new entries carry d=inf
    where padded (<0 ids).  Dedup keeps the earliest (already-expanded /
    smallest-distance) copy — both copies of an id always carry the same
    distance, and stable sorts keep the pre-existing candidate first, so
    expansion flags survive.  The reference's three stable numpy sorts are
    ``torch.sort(stable=True)``; its ``put_along_axis`` is ``scatter``.
    """
    ids_all = torch.cat([cand_ids, new_ids], dim=1)
    d_all = torch.cat([cand_d, new_d], dim=1)
    e_all = torch.cat([expanded, torch.zeros_like(new_ids, dtype=torch.bool)],
                      dim=1)
    # 1) stable sort by distance
    o1 = torch.sort(d_all, dim=1, stable=True).indices
    ids_all = ids_all.gather(1, o1)
    d_all = d_all.gather(1, o1)
    e_all = e_all.gather(1, o1)
    # 2) stable sort by id -> equal ids adjacent, distance-ordered within
    ids_s, o2 = torch.sort(ids_all, dim=1, stable=True)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[:, 1:] = (ids_s[:, 1:] == ids_s[:, :-1]) & (ids_s[:, 1:] >= 0)
    # scatter dup mask back to distance order and kill duplicates
    dup_back = torch.zeros_like(dup).scatter_(1, o2, dup)
    d_all = torch.where(dup_back | (ids_all < 0),
                        torch.full_like(d_all, float("inf")), d_all)
    # 3) final stable distance sort, truncate to L
    o3 = torch.sort(d_all, dim=1, stable=True).indices[:, :L]
    out_ids = ids_all.gather(1, o3)
    out_d = d_all.gather(1, o3)
    out_e = e_all.gather(1, o3)
    out_ids = torch.where(torch.isinf(out_d), torch.full_like(out_ids, -1),
                          out_ids)
    out_e &= out_ids >= 0
    return out_ids, out_d, out_e


def _batch_sq_l2(q: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """q (B, D), vecs (B, M, D) -> (B, M) float32 squared L2, clamped at 0."""
    q = q.float()
    v = vecs.float()
    qn = (q * q).sum(-1)[:, None]
    vn = (v * v).sum(-1)
    with full_f32_matmul():
        ip = torch.bmm(v, q[:, :, None])[:, :, 0]
    return torch.clamp_min(qn + vn - 2.0 * ip, 0.0)


def _greedy_search_build(
    data: torch.Tensor,           # (N, D) f32 resident for build
    adj: torch.Tensor,            # (N, R) int32, -1 padded, on data's device
    q_vecs: torch.Tensor,         # (B, D) batch of query points
    entry: int,
    L: int,
    max_rounds: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Batched greedy search on the under-construction graph, in torch on
    ``data``'s device, vectorised over the batch as the reference is.

    Returns numpy (visited_ids (B, T) int64 padded with -1, visited_dists
    (B, T) f32) — the candidate pools RobustPrune consumes.  Distances are
    exact (build runs in memory, as DiskANN's builder does).
    """
    dev = data.device
    B = len(q_vecs)
    max_rounds = max_rounds or (L + 8)
    inf = float("inf")
    q = q_vecs.float()
    cand_ids = torch.full((B, L), -1, dtype=torch.int64, device=dev)
    cand_d = torch.full((B, L), inf, dtype=torch.float32, device=dev)
    expanded = torch.zeros((B, L), dtype=torch.bool, device=dev)
    d0 = _batch_sq_l2(q, data[entry][None, None, :].expand(B, 1, -1))[:, 0]
    cand_ids[:, 0] = entry
    cand_d[:, 0] = d0
    ar = torch.arange(B, device=dev)
    vis_ids = torch.full((B, max_rounds), -1, dtype=torch.int64, device=dev)
    vis_d = torch.full((B, max_rounds), inf, dtype=torch.float32, device=dev)

    for t in range(max_rounds):
        masked = torch.where(expanded | (cand_ids < 0),
                             torch.full_like(cand_d, inf), cand_d)
        fi = torch.argmin(masked, dim=1)          # first index on ties
        act = masked[ar, fi] < inf
        if not bool(act.any()):
            break
        nodes = torch.where(act, cand_ids[ar, fi], torch.zeros_like(fi))
        expanded[ar, fi] |= act
        vis_ids[:, t] = torch.where(act, nodes, vis_ids[:, t])
        vis_d[:, t] = torch.where(act, cand_d[ar, fi], vis_d[:, t])
        nbrs = adj[nodes].long()                  # (B, R)
        nbrs = torch.where(act[:, None], nbrs, torch.full_like(nbrs, -1))
        dn = _batch_sq_l2(q, data[nbrs.clamp_min(0)])
        dn = torch.where(nbrs < 0, torch.full_like(dn, inf), dn)
        cand_ids, cand_d, expanded = _merge_candidates(
            cand_ids, cand_d, expanded, nbrs, dn, L)
    return vis_ids.cpu().numpy(), vis_d.cpu().numpy()


class GraphIndex:
    def __init__(self, meta: GraphIndexMeta, store: ObjectStore, *,
                 device: str | torch.device | None = None):
        self.meta = meta
        self.store = store
        self.device = resolve_device(device)

    @property
    def codes_dev(self) -> torch.Tensor:
        """A device copy of every PQ code, made on each access."""
        return torch.from_numpy(
            np.ascontiguousarray(self.meta.codes)).to(self.device)

    # ------------------------------------------------------------- build --
    @staticmethod
    def build(data: np.ndarray, params: GraphIndexParams,
              store: ObjectStore | None = None,
              batch: int = 256, *,
              device: str | torch.device | None = None) -> "GraphIndex":
        dev = resolve_device(device)
        store = store if store is not None else ObjectStore()
        data = np.ascontiguousarray(data)
        n, dim = data.shape
        rng = np.random.default_rng(params.seed)
        R = params.R
        data_f = data.astype(np.float32)
        data_t = torch.from_numpy(data_f).to(dev)

        # medoid = closest point to the dataset mean
        mean = data_f.mean(axis=0)
        medoid = int(np.argmin(np_sq_l2(mean, data_f)))

        # init: random regular graph of degree min(R, 16)
        deg0 = min(R, 16)
        adj = np.full((n, R), -1, dtype=np.int32)
        for i in range(n):
            nb = rng.choice(n - 1, size=min(deg0, n - 1), replace=False)
            nb[nb >= i] += 1
            adj[i, :len(nb)] = nb

        order = rng.permutation(n)
        adj_host = torch.from_numpy(adj)          # shares adj's memory
        adj_t = torch.empty((n, R), dtype=torch.int32, device=dev)
        for pass_i in range(params.build_passes):
            alpha = 1.0 if pass_i == 0 else params.alpha
            for s in range(0, n, batch):
                pts = order[s:s + batch]
                adj_t.copy_(adj_host)
                vis_ids, _ = _greedy_search_build(
                    data_t, adj_t, data_t[torch.from_numpy(pts).to(dev)],
                    medoid, params.L_build)
                rev: dict[int, list[int]] = {}
                for bi, p in enumerate(pts):
                    cand = vis_ids[bi]
                    cand = cand[(cand >= 0) & (cand != p)]
                    # also keep current neighbours in the pool (Vamana)
                    cur = adj[p]
                    cur = cur[(cur >= 0) & (cur != p)]
                    cand = np.unique(np.concatenate([cand, cur]))
                    if cand.size == 0:
                        continue
                    sel = _robust_prune(
                        data_f[p], cand, data_f[cand], R, alpha)
                    adj[p, :] = -1
                    adj[p, :len(sel)] = sel
                    for t in sel:
                        rev.setdefault(int(t), []).append(int(p))
                # reverse edges with overflow pruning
                for t, srcs in rev.items():
                    cur = adj[t]
                    cur = cur[cur >= 0]
                    merged = np.unique(np.concatenate(
                        [cur, np.asarray(srcs, dtype=np.int32)]))
                    merged = merged[merged != t]
                    if len(merged) <= R:
                        adj[t, :] = -1
                        adj[t, :len(merged)] = merged
                    else:
                        sel = _robust_prune(
                            data_f[t], merged.astype(np.int64),
                            data_f[merged], R, alpha)
                        adj[t, :] = -1
                        adj[t, :len(sel)] = sel
        del data_t, adj_t

        # ---- PQ metadata (in-memory) ----
        m = params.pq_dims
        pq = pqmod.train_pq(data_f, m, seed=params.seed, device=dev)
        codes = pq.encode(data_f)

        # ---- persist node blocks ----
        itemsize = data.dtype.itemsize
        raw = dim * itemsize + R * 4 + 8
        node_nbytes = round_to_sectors(raw, params.sector_bytes)
        for i in range(n):
            store.put(("node", i), (data[i], adj[i].copy()), node_nbytes)

        meta = GraphIndexMeta(
            pq=pq, codes=codes, medoid=medoid, n_data=n, dim=dim,
            dtype=data.dtype, node_nbytes=node_nbytes, params=params)
        return GraphIndex(meta, store, device=dev)

    # ------------------------------------------------------------ search --
    def _adc(self, ids: np.ndarray, table_dev: torch.Tensor) -> np.ndarray:
        """ADC distances (len(ids),) f32 of nodes ``ids``: the host gathers
        their codes from ``meta.codes`` (which the write path grows and
        rewrites in place), one copy takes them to the index's device, and
        one lookup runs there."""
        codes = torch.from_numpy(self.meta.codes[np.asarray(ids, np.int64)])
        return self.meta.pq.adc_lookup_dev(codes.to(self.device),
                                           table_dev).cpu().numpy()

    def search_plan(
        self, q: np.ndarray, params: SearchParams,
        metrics: QueryMetrics | None = None,
    ) -> Generator[FetchBatch, dict, SearchResult]:
        meta = self.meta
        mtr = metrics if metrics is not None else QueryMetrics()
        q = np.asarray(q, dtype=np.float32)
        table = torch.from_numpy(meta.pq.adc_table(q)).to(self.device)
        L = params.search_len
        W = params.beamwidth

        visited = np.zeros(meta.n_data, dtype=bool)
        in_cand = np.zeros(meta.n_data, dtype=bool)
        cand_ids = np.full(L, -1, dtype=np.int64)
        cand_d = np.full(L, np.inf, dtype=np.float32)
        expanded = np.zeros(L, dtype=bool)
        d0 = self._adc(np.array([meta.medoid]), table)[0]
        mtr.pq_dist_comps += 1
        cand_ids[0] = meta.medoid
        cand_d[0] = d0
        in_cand[meta.medoid] = True
        exact: dict[int, float] = {}

        for _ in range(params.max_rounds):
            masked = np.where(expanded | (cand_ids < 0), np.inf, cand_d)
            order = np.argsort(masked, kind="stable")
            frontier = order[: W]
            frontier = frontier[masked[frontier] < np.inf]
            if frontier.size == 0:
                break
            nodes = cand_ids[frontier]
            expanded[frontier] = True
            visited[nodes] = True
            reqs = [FetchRequest(("node", int(i)), meta.node_nbytes)
                    for i in nodes]
            payloads = yield FetchBatch(reqs)
            mtr.roundtrips += 1
            mtr.requests += len(reqs)
            mtr.expansions += len(reqs)
            mtr.bytes_read += len(reqs) * meta.node_nbytes

            new_nbrs: list[np.ndarray] = []
            for nd, rq in zip(nodes, reqs):
                vec, nbrs = payloads[rq.key]
                de = float(np_sq_l2(q, np.asarray(
                    vec, dtype=np.float32)[None])[0])
                mtr.dist_comps += 1
                exact[int(nd)] = de
                nbrs = nbrs[nbrs >= 0]
                new_nbrs.append(nbrs)
            if new_nbrs:
                nn = np.unique(np.concatenate(new_nbrs))
                # snapshot isolation: nodes added after this plan started
                # (id >= the entry-time n_data) are invisible to it
                nn = nn[nn < len(visited)]
                nn = nn[~visited[nn] & ~in_cand[nn]]
            else:
                nn = np.zeros(0, dtype=np.int64)
            if nn.size:
                dn = self._adc(nn, table)
                mtr.pq_dist_comps += len(nn)
                ids_all = np.concatenate([cand_ids, nn])
                d_all = np.concatenate([cand_d, dn])
                e_all = np.concatenate([expanded,
                                        np.zeros(len(nn), dtype=bool)])
                oo = np.argsort(d_all, kind="stable")[:L]
                evicted = np.setdiff1d(ids_all[np.argsort(d_all)[L:]],
                                       ids_all[oo], assume_unique=False)
                in_cand[nn] = True
                ev = evicted[evicted >= 0]
                in_cand[ev] = False
                cand_ids = ids_all[oo]
                cand_d = d_all[oo]
                expanded = e_all[oo]
        # rerank by exact distances of expanded nodes (DiskANN full-precision
        # rerank from fetched blocks)
        if exact:
            ids = np.fromiter(exact.keys(), dtype=np.int64)
            ds = np.fromiter(exact.values(), dtype=np.float32)
            oo = np.argsort(ds)[: params.k]
            out_ids, out_d = ids[oo], ds[oo]
        else:
            out_ids = np.zeros(0, np.int64)
            out_d = np.zeros(0, np.float32)
        k = params.k
        if len(out_ids) < k:
            out_ids = np.pad(out_ids, (0, k - len(out_ids)),
                             constant_values=-1)
            out_d = np.pad(out_d, (0, k - len(out_d)),
                           constant_values=np.inf)
        return SearchResult(out_ids, out_d, mtr)

    def search(self, q: np.ndarray, params: SearchParams) -> SearchResult:
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
    def device_arrays(self) -> dict[str, np.ndarray]:
        """Resident layout for a device beam-search path: full vectors +
        padded adjacency."""
        n = self.meta.n_data
        dim = self.meta.dim
        R = self.meta.params.R
        vecs = np.zeros((n, dim), dtype=np.float32)
        adj = np.full((n, R), -1, dtype=np.int32)
        for i in range(n):
            v, nb = self.store.get(("node", i))
            vecs[i] = v.astype(np.float32)
            adj[i] = nb
        return dict(vectors=vecs, adjacency=adj,
                    medoid=np.int32(self.meta.medoid))
