"""K-means machinery: Lloyd iterations, soft-balanced assignment, and the
hierarchical balanced clustering that SPANN uses to partition the dataset
(the hierarchy doubles as the BKT centroid tree held in compute-node memory,
paper §2.3.1).

Build runs host-side (numpy): index construction is an offline job in the
paper too (built on local disk, then uploaded).  The *query-time* centroid
search has two implementations:

* ``BKTree.search`` — best-first tree descent, the paper's in-memory BKT
  (O(n log nprobe) scaling, §2.3.1).  Pointer-chasing: host metadata path.
* flat top-nprobe over all centroids — the device serving path's form
  (the l2_distance kernel): BKT pointer-chasing does not transfer to the
  device; a flat distance matrix + top-k does.

The port's own copy of the reference's numpy host part (``kmeans_np``,
``_enforce_capacity``, ``BKTree``, ``hierarchical_partition``): the same
seed gives the same tree in both packages.  Batched Lloyd for PQ codebooks
(``kmeans_batched``) runs in torch on the tensors' device.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from repro_torch.core.distances import np_sq_l2
from repro_torch.core.threefry import pq_init_idx
from repro_torch.kernels.ref import full_f32_matmul


# ---------------------------------------------------------------------------
# numpy Lloyd with balanced assignment (host-side build path)
# ---------------------------------------------------------------------------

def _enforce_capacity(d: np.ndarray, assign: np.ndarray, k: int,
                      cap: int) -> np.ndarray:
    """Greedy capacity repair: overfull clusters evict their farthest
    members to the members' next-preferred cluster with space."""
    assign = assign.copy()
    counts = np.bincount(assign, minlength=k)
    if (counts <= cap).all():
        return assign
    pref = np.argsort(d, axis=1)                 # (N, k) preference order
    for j in np.flatnonzero(counts > cap):
        members = np.flatnonzero(assign == j)
        order = np.argsort(d[members, j])        # keep the closest
        for p in members[order[cap:]]:
            for alt in pref[p]:
                if counts[alt] < cap:
                    assign[p] = alt
                    counts[alt] += 1
                    counts[j] -= 1
                    break
    return assign

def kmeans_np(
    x: np.ndarray,
    k: int,
    iters: int = 8,
    balance_penalty: float = 0.0,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Lloyd's k-means.  Returns (centroids (k, D) f32, assign (N,) int32).

    balance_penalty > 0 enforces a hard per-cluster capacity of
    ``ceil(n/k * (1 + 1/balance_penalty))``: overflow members (farthest
    first) are greedily reassigned to their next-preferred cluster with
    space — the balanced clustering SPANN's partitioning relies on.
    Empty clusters are reseeded to the points farthest from their centroid.
    """
    rng = rng or np.random.default_rng(0)
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    k = min(k, n)
    centroids = x[rng.choice(n, size=k, replace=False)].copy()
    assign = np.zeros(n, dtype=np.int32)
    cap = n + 1
    if balance_penalty > 0.0:
        cap = int(np.ceil(n / k * (1.0 + 1.0 / balance_penalty)))
    for it in range(iters):
        d = np_sq_l2(x, centroids)  # (N, k)
        assign = np.argmin(d, axis=1).astype(np.int32)
        if balance_penalty > 0.0:
            assign = _enforce_capacity(d, assign, k, cap)
        counts = np.bincount(assign, minlength=k)
        # reseed empties to points with largest distance to their centroid
        empties = np.flatnonzero(counts == 0)
        if empties.size:
            worst = np.argsort(-d[np.arange(n), assign])[: empties.size]
            assign[worst] = empties
            counts = np.bincount(assign, minlength=k)
        sums = np.zeros((k, x.shape[1]), dtype=np.float64)
        np.add.at(sums, assign, x)
        centroids = (sums / np.maximum(counts, 1)[:, None]).astype(np.float32)
    return centroids, assign


# ---------------------------------------------------------------------------
# batched Lloyd in torch (PQ codebooks: m independent same-shape subproblems)
# ---------------------------------------------------------------------------

def kmeans_batched(
    x: torch.Tensor, k: int, iters: int = 10, *,
    init_idx=None, seed: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched Lloyd.  x: (M, N, D) -> (centroids (M, k, D) f32, assign (M, N)).

    All M subproblems run in lockstep on ``x``'s device — this is the PQ
    codebook trainer (M = number of subquantizers, k = 256).  Each step is
    the reference's (``repro.core.kmeans.kmeans_batched``): one batched
    product in full f32 (TF32 off), ``argmin`` (first index on ties, as
    ``jnp.argmin``), per-cluster sums and counts as a one-hot product, and
    an empty cluster keeps its centroid.  ``assign`` is the last step's
    assignment (made against the centroids before that step's update).

    ``init_idx`` (M, k) gives the init rows explicitly; otherwise they are
    the reference's ``jax.random`` draw from ``PRNGKey(seed)``, recomputed
    in numpy by :func:`repro_torch.core.threefry.pq_init_idx`, so a seed
    picks the same rows as the reference on any device.
    """
    m, n, d = x.shape
    k = min(k, n)
    if init_idx is None:
        init_idx = pq_init_idx(seed, m, n, k)
    if not isinstance(init_idx, torch.Tensor):
        init_idx = torch.from_numpy(np.array(init_idx, dtype=np.int64))
    init_idx = init_idx.long().to(x.device)
    if tuple(init_idx.shape) != (m, k):
        raise ValueError(f"init_idx has shape {tuple(init_idx.shape)}, "
                         f"expected {(m, k)}")
    x = x.float()
    cc = torch.gather(x, 1, init_idx[:, :, None].expand(m, k, d))
    xn = (x * x).sum(-1)[:, :, None]                      # (M, N, 1)
    a = torch.zeros((m, n), dtype=torch.long, device=x.device)
    for _ in range(iters):
        cn = (cc * cc).sum(-1)[:, None, :]                # (M, 1, k)
        with full_f32_matmul():
            ip = torch.bmm(x, cc.transpose(1, 2))         # (M, N, k)
        a = torch.argmin(xn + cn - 2.0 * ip, dim=2)
        onehot = torch.zeros((m, n, k), dtype=x.dtype, device=x.device)
        onehot.scatter_(2, a[:, :, None], 1.0)
        with full_f32_matmul():
            sums = torch.bmm(onehot.transpose(1, 2), x)   # (M, k, D)
        counts = onehot.sum(1)[:, :, None]                # (M, k, 1)
        cc = torch.where(counts > 0, sums / counts.clamp_min(1.0), cc)
    return cc, a


# ---------------------------------------------------------------------------
# Hierarchical balanced partition (SPANN's dataset split + BKT tree)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Node:
    center: np.ndarray          # (D,) f32
    children: list[int]         # child node indices ([] for leaf)
    leaf_id: int                # posting-list id if leaf else -1


@dataclasses.dataclass
class BKTree:
    """Balanced k-means tree over the dataset partition.

    Leaves correspond 1:1 to posting lists; ``centroids[i]`` is the center
    of leaf i.  Lives in compute-node memory (the paper: TurboPuffer caches
    exactly this metadata).
    """

    nodes: list[_Node]
    root: int
    centroids: np.ndarray       # (n_leaves, D) f32

    def search(self, q: np.ndarray, nprobe: int, overquery: int = 4
               ) -> tuple[np.ndarray, int]:
        """Best-first descent; returns (top-nprobe leaf ids, dist comps).

        Emits ~``nprobe * overquery`` candidate leaves then takes the exact
        top-nprobe among them — mirrors SPTAG's BKT search behaviour and
        gives the O(n log nprobe) cost the paper cites.
        """
        q = np.asarray(q, dtype=np.float32)
        want = min(nprobe * overquery, len(self.centroids))
        heap: list[tuple[float, int]] = []
        root = self.nodes[self.root]
        ndist = 0
        if not root.children:          # degenerate single-leaf tree
            return np.array([root.leaf_id]), 1
        d0 = np_sq_l2(q, np.stack([self.nodes[c].center
                                   for c in root.children]))
        ndist += len(root.children)
        for c, dd in zip(root.children, d0):
            heapq.heappush(heap, (float(dd), c))
        out: list[tuple[float, int]] = []
        while heap and len(out) < want:
            d, ni = heapq.heappop(heap)
            node = self.nodes[ni]
            if not node.children:
                out.append((d, node.leaf_id))
                continue
            dc = np_sq_l2(q, np.stack([self.nodes[c].center
                                       for c in node.children]))
            ndist += len(node.children)
            for c, dd in zip(node.children, dc):
                heapq.heappush(heap, (float(dd), c))
        out.sort()
        ids = np.array([i for _, i in out[:nprobe]], dtype=np.int64)
        return ids, ndist

    def flat_search(self, q: np.ndarray, nprobe: int) -> np.ndarray:
        """Exact flat top-nprobe over all leaf centroids (device-path ref)."""
        d = np_sq_l2(q, self.centroids)
        return np.argsort(d)[:nprobe].astype(np.int64)


def hierarchical_partition(
    x: np.ndarray,
    n_leaves: int,
    branch: int = 8,
    iters: int = 8,
    balance_penalty: float = 1.0,
    seed: int = 0,
) -> tuple[BKTree, np.ndarray]:
    """Recursively split ``x`` with balanced k-means until ~n_leaves leaves.

    Returns (tree, leaf_assign (N,) int32).  Leaf centers become the posting
    -list centroids.  This is SPANN's multi-level balanced clustering (much
    cheaper than flat k-means with k = 16% * N, and identical in spirit).
    """
    rng = np.random.default_rng(seed)
    x = np.asarray(x, dtype=np.float32)
    n = x.shape[0]
    target_leaf = max(1, int(round(n / max(1, n_leaves))))
    nodes: list[_Node] = []
    leaf_assign = np.zeros(n, dtype=np.int32)
    leaf_centers: list[np.ndarray] = []

    def build(idx: np.ndarray) -> int:
        center = x[idx].mean(axis=0).astype(np.float32)
        if len(idx) <= target_leaf or len(idx) <= branch:
            leaf_id = len(leaf_centers)
            leaf_centers.append(center)
            leaf_assign[idx] = leaf_id
            nodes.append(_Node(center=center, children=[], leaf_id=leaf_id))
            return len(nodes) - 1
        k = min(branch, max(2, len(idx) // target_leaf))
        _, a = kmeans_np(x[idx], k, iters=iters,
                         balance_penalty=balance_penalty, rng=rng)
        children = []
        for j in range(a.max() + 1):
            sub = idx[a == j]
            if sub.size == 0:
                continue
            children.append(build(sub))
        me = _Node(center=center, children=children, leaf_id=-1)
        nodes.append(me)
        return len(nodes) - 1

    root = build(np.arange(n))
    tree = BKTree(nodes=nodes, root=root,
                  centroids=np.stack(leaf_centers).astype(np.float32))
    return tree, leaf_assign
