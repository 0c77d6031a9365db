"""Core datatypes for the cloud-native vector search engine.

These mirror the paper's vocabulary: indexes are built from a dataset and
parameterised (Table 3), searched with per-query parameters (nprobe /
search_len / beamwidth), and every query produces the instrumentation
metrics of §5.1 (①–⑦).

The port's own copy of ``repro.core.types``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClusterIndexParams:
    """SPANN-style cluster index build parameters (paper §2.3.1, §3).

    centroid_frac: fraction of dataset points promoted to centroids
      (paper's ``centroid%``; 0.16 means 16%).
    num_replica:   closure replication bound (paper's ``replica#``) —
      boundary vectors are duplicated into up to this many posting lists.
    closure_eps:   a point is replicated into list j iff
      d(p, c_j) <= (1 + closure_eps) * d(p, c_1)  (SPANN's closure rule).
    kmeans_iters / branch: hierarchical balanced k-means controls for the
      BKT build.
    """

    centroid_frac: float = 0.16
    num_replica: int = 8
    closure_eps: float = 0.15
    kmeans_iters: int = 8
    branch: int = 8
    balance_penalty: float = 0.0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class GraphIndexParams:
    """DiskANN-style graph index build parameters (paper §2.3.2, §3).

    R:          max out-degree (graph density knob of Fig 17).
    L_build:    candidate-set size used during construction.
    alpha:      robust-prune slack (>1 keeps long-range edges).
    pq_dims:    number of PQ subquantizers held in memory (Table 3 "PQ dim.";
                paper default QD = max(dim/8, 48)).
    sector_bytes: storage block size per node (4KB in the paper).
    """

    R: int = 64
    L_build: int = 128
    alpha: float = 1.2
    pq_dims: int = 48
    build_passes: int = 2
    sector_bytes: int = 4096
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Per-query search parameters (paper §5.1 Query Serving)."""

    k: int = 10
    # cluster index
    nprobe: int = 8
    # graph index
    search_len: int = 10          # candidate-set bound (DiskANN's L)
    beamwidth: int = 16           # W: blocks fetched per expansion round
    max_rounds: int = 512         # safety bound on traversal iterations


@dataclasses.dataclass
class QueryMetrics:
    """Instrumentation for a single query (paper §5.1 ①–⑦ analogues).

    bytes_read:   total data fetched from (cache + storage).
    bytes_storage: bytes actually served by remote storage (cache misses).
    requests:     number of GET requests issued to storage (IOPS pressure).
    roundtrips:   dependent fetch phases (1 for cluster; rt for graph).
    expansions:   neighbour expansions performed (graph) ④.
    lists_visited: posting lists visited (cluster) ⑤.
    dist_comps:   full-precision distance computations.
    pq_dist_comps: ADC (PQ) distance computations.
    cache_hits / cache_lookups: segment-cache statistics ⑦.
    """

    bytes_read: int = 0
    bytes_storage: int = 0
    requests: int = 0
    roundtrips: int = 0
    expansions: int = 0
    lists_visited: int = 0
    dist_comps: int = 0
    pq_dist_comps: int = 0
    cache_hits: int = 0
    cache_lookups: int = 0

    @property
    def hit_rate(self) -> float:
        return self.cache_hits / max(1, self.cache_lookups)


@dataclasses.dataclass
class SearchResult:
    ids: np.ndarray            # (k,) int64 result ids
    dists: np.ndarray          # (k,) float32 distances (squared L2)
    metrics: QueryMetrics


@dataclasses.dataclass
class FetchRequest:
    """One GET against the object store."""

    key: Any                   # object key (e.g. ("list", 17) / ("node", 93))
    nbytes: int


@dataclasses.dataclass
class FetchBatch:
    """A dependency-free batch of GETs issued in one roundtrip.

    Cluster search issues a single batch with all nprobe posting lists
    (no intra-query dependencies, paper §2.3.1).  Graph search issues one
    batch of <=W node blocks per expansion round (paper footnote 8: the W
    requests still count individually against the IOPS limit).
    """

    requests: list[FetchRequest]

    @property
    def nbytes(self) -> int:
        return sum(r.nbytes for r in self.requests)


def recall_at_k(found_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """recall@k with k = len(true_ids) (paper uses k=10)."""
    return float(len(np.intersect1d(found_ids, true_ids))) / float(len(true_ids))
