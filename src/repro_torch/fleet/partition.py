"""Index partitioning across shard servers (fleet data placement).

Two placement schemes, one per index family:

* **Cluster (SPANN-class)** — posting lists are the unit of placement.
  Balanced assignment is greedy LPT on *billable bytes* (lists sorted by
  size, each list's R replicas go to the R least-loaded distinct shards),
  so a skewed list-size distribution still yields near-even per-shard
  storage.  Replication factor R means every probed list can be served by
  any of R shards — the routing freedom power-of-two-choices and hedging
  exploit.
* **Graph (DiskANN-class)** — node blocks are hash-partitioned
  (splitmix64 finalizer keyed by the partition seed), replicas on the next
  R-1 shards ring-wise.  Beam-search rounds touch pseudo-random node sets,
  so hashing spreads every round's W fetches across the fleet.

Both expose the same interface the router consumes:
``owners(key) -> tuple[shard ids]`` for a fetch key, plus byte/count
balance introspection.

The port's own copy of ``repro.fleet.partition``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """splitmix64 finalizer: a cheap, well-mixed 64-bit hash."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _check(n_items: int, n_shards: int, replication: int) -> None:
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if not 1 <= replication <= n_shards:
        raise ValueError(
            f"replication must be in [1, n_shards={n_shards}], "
            f"got {replication}")
    if n_items < 1:
        raise ValueError(f"nothing to partition (n_items={n_items})")


@dataclasses.dataclass
class ClusterPartition:
    """Posting-list -> shard placement with replication factor R."""

    kind = "cluster"
    n_shards: int
    replication: int
    owners_arr: np.ndarray        # (n_lists, R) int32 distinct shard ids
    shard_bytes: np.ndarray       # (n_shards,) int64 stored bytes per shard

    @staticmethod
    def build(list_nbytes: np.ndarray, n_shards: int,
              replication: int) -> "ClusterPartition":
        """Balanced greedy LPT over list byte sizes (deterministic)."""
        list_nbytes = np.asarray(list_nbytes, dtype=np.int64)
        n_lists = len(list_nbytes)
        _check(n_lists, n_shards, replication)
        owners = np.zeros((n_lists, replication), dtype=np.int32)
        load = [(0, s) for s in range(n_shards)]      # (bytes, shard) heap
        heapq.heapify(load)
        order = np.argsort(-list_nbytes, kind="stable")
        for li in order:
            nb = int(list_nbytes[li])
            picked = [heapq.heappop(load) for _ in range(replication)]
            for r, (b, s) in enumerate(picked):
                owners[li, r] = s
                heapq.heappush(load, (b + nb, s))
        shard_bytes = np.zeros(n_shards, dtype=np.int64)
        for li in range(n_lists):
            for s in owners[li]:
                shard_bytes[s] += list_nbytes[li]
        return ClusterPartition(n_shards=n_shards, replication=replication,
                                owners_arr=owners, shard_bytes=shard_bytes)

    def owners(self, key) -> tuple[int, ...]:
        _, li = key
        return tuple(int(s) for s in self.owners_arr[li])

    def inherit(self, new_li: int, parent_li: int) -> None:
        """A re-cluster split ``parent_li``: the new list keeps the
        parent's replica owners (the data stays where it already lives —
        a split moves no bytes between shards)."""
        if new_li < len(self.owners_arr):
            return                       # already registered
        if new_li != len(self.owners_arr):
            raise ValueError(
                f"non-contiguous list id {new_li} "
                f"(have {len(self.owners_arr)})")
        self.owners_arr = np.vstack(
            [self.owners_arr, self.owners_arr[parent_li][None]])

    @property
    def bytes_imbalance(self) -> float:
        """max/mean stored bytes across shards (1.0 = perfectly even)."""
        mean = self.shard_bytes.mean()
        return float(self.shard_bytes.max() / max(mean, 1e-12))


@dataclasses.dataclass
class GraphPartition:
    """Node-block -> shard placement: seeded hash, ring replication."""

    kind = "graph"
    n_shards: int
    replication: int
    base: np.ndarray              # (n_nodes,) int32 primary shard per node
    seed: int = 0

    @staticmethod
    def build(n_nodes: int, n_shards: int, replication: int,
              seed: int = 0) -> "GraphPartition":
        _check(n_nodes, n_shards, replication)
        base = np.fromiter(
            (_splitmix64(i ^ (seed * 0x9E3779B97F4A7C15 & _MASK64))
             % n_shards for i in range(n_nodes)),
            dtype=np.int32, count=n_nodes)
        return GraphPartition(n_shards=n_shards, replication=replication,
                              base=base, seed=seed)

    def owners(self, key) -> tuple[int, ...]:
        _, node = key
        if node < len(self.base):
            b = int(self.base[node])
        else:                         # a node stitched in by live ingest
            b = _splitmix64(
                node ^ (self.seed * 0x9E3779B97F4A7C15 & _MASK64)
            ) % self.n_shards
        return tuple((b + r) % self.n_shards for r in range(self.replication))

    @property
    def bytes_imbalance(self) -> float:
        """max/mean node count across shards (blocks are equal-sized)."""
        counts = np.bincount(self.base, minlength=self.n_shards)
        return float(counts.max() / max(counts.mean(), 1e-12))


def partition_for_index(index, n_shards: int, replication: int,
                        seed: int = 0):
    """Pick the placement scheme matching the index family."""
    meta = index.meta
    if hasattr(meta, "list_nbytes"):        # ClusterIndexMeta
        return ClusterPartition.build(meta.list_nbytes, n_shards,
                                      replication)
    if hasattr(meta, "node_nbytes"):        # GraphIndexMeta
        return GraphPartition.build(meta.n_data, n_shards, replication,
                                    seed=seed)
    raise TypeError(f"cannot partition index with meta {type(meta)!r}")
