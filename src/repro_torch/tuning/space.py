"""Declarative tuning space: workloads, environments, candidate configs.

The joint space the auto-tuner searches is the paper's §5.2/§7 parameter
landscape made explicit:

    {index class} × {build params} × {search params} × {cache policy}

Grids carry *paper-derived priors* — they are centred on the settings the
paper's sweeps (Figs 7, 14–19) found load-bearing, not on exhaustive
ranges:

* cluster (SPANN-class): ``centroid_frac`` around 16% with the
  fine-grained 32% variant that wins under I/O congestion (Fig 14);
  ``num_replica`` 4/8 (Fig 16/24); ``nprobe`` the power-of-two sweep of
  the §5.1 protocol.
* graph (DiskANN-class): out-degree ``R`` 32–128 (Fig 17: cloud favours
  dense graphs), beamwidth 4–32 (Fig 19: the IOPS-vs-latency trade),
  ``search_len`` the §5.1 power-of-two sweep.
* cache policy: none / scan-resistant SLRU / pinned hot-set (§5.1, §7 A3).

The port's own copy of ``repro.tuning.space``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses

from repro_torch.cache.slru import CACHE_POLICIES
from repro_torch.storage.spec import PRESETS, StorageSpec

# power-of-two sweeps from the paper's §5.1 protocol
NPROBE_GRID = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)
SEARCHLEN_GRID = (20, 40, 80, 160, 320, 640)

CENTROID_FRAC_GRID = (0.08, 0.16, 0.32)
REPLICA_GRID = (4, 8)
R_GRID = (32, 64, 128)
BEAMWIDTH_GRID = (4, 8, 16, 32)

# cache policies come from the cache layer itself (one source of truth)
assert CACHE_POLICIES == ("none", "slru", "pinned")

# short CLI aliases for the paper's Table 1 environments
STORAGE_ALIASES = {
    "tos": "volcano-tos",
    "tos-external": "volcano-tos-external",
    "ssd": "local-ssd",
    "s3": "s3-external",
    "internal": "tos-internal-50gbps",
}


def resolve_storage(name: str) -> StorageSpec:
    key = STORAGE_ALIASES.get(name, name)
    if key not in PRESETS:
        known = sorted(set(STORAGE_ALIASES) | set(PRESETS))
        raise KeyError(f"unknown storage {name!r}; one of {known}")
    return PRESETS[key]


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """What the user wants served (the tuner's input, paper Table 2 axes)."""

    n: int = 1_000_000
    dim: int = 960
    dtype: str = "float32"            # "float32" | "int8"
    target_recall: float = 0.9        # recall@k floor
    concurrency: int = 1
    query_dist: str = "sequential"    # "sequential" | "zipf"
    zipf_a: float = 1.2
    k: int = 10
    write_rate_qps: float = 0.0       # live updates/s (ingest tuning axis)

    @property
    def dtype_bytes(self) -> int:
        return 4 if self.dtype == "float32" else 1

    @property
    def vector_bytes(self) -> int:
        return self.dim * self.dtype_bytes


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Where it runs: a storage preset plus the compute-node cache budget."""

    storage: StorageSpec
    cache_bytes: int = 0

    def describe(self) -> str:
        return (f"{self.storage.describe()}, "
                f"cache {self.cache_bytes / 2**30:.2f} GiB")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the joint config space.

    ``kind`` selects which fields are meaningful: cluster uses
    (centroid_frac, num_replica, nprobe); graph uses (R, beamwidth,
    search_len).  ``cache_policy`` applies to both.
    """

    kind: str                          # "cluster" | "graph"
    cache_policy: str = "none"
    # cluster build + search
    centroid_frac: float = 0.16
    num_replica: int = 8
    nprobe: int = 64
    # graph build + search
    R: int = 64
    beamwidth: int = 16
    search_len: int = 80

    def build_sig(self) -> tuple:
        """Hashable identity of the *build* (what forces a re-index)."""
        if self.kind == "cluster":
            return ("cluster", self.centroid_frac, self.num_replica)
        return ("graph", self.R)

    def label(self) -> str:
        if self.kind == "cluster":
            return (f"cluster[cf={self.centroid_frac:g},rep={self.num_replica},"
                    f"nprobe={self.nprobe},cache={self.cache_policy}]")
        return (f"graph[R={self.R},W={self.beamwidth},L={self.search_len},"
                f"cache={self.cache_policy}]")

    def to_dict(self) -> dict:
        d = dict(kind=self.kind, cache_policy=self.cache_policy)
        if self.kind == "cluster":
            d.update(centroid_frac=self.centroid_frac,
                     num_replica=self.num_replica, nprobe=self.nprobe)
        else:
            d.update(R=self.R, beamwidth=self.beamwidth,
                     search_len=self.search_len)
        return d


def cache_policies(env: EnvSpec) -> tuple[str, ...]:
    """Policies worth considering: without a cache budget only "none"."""
    return ("none",) if env.cache_bytes <= 0 else CACHE_POLICIES


def enumerate_space(workload: WorkloadSpec, env: EnvSpec,
                    kinds: tuple[str, ...] = ("cluster", "graph"),
                    ) -> list[Candidate]:
    """The full joint grid for (workload, env) before any screening."""
    cands: list[Candidate] = []
    policies = cache_policies(env)
    if "cluster" in kinds:
        for cf in CENTROID_FRAC_GRID:
            for rep in REPLICA_GRID:
                for nprobe in NPROBE_GRID:
                    if nprobe > cf * workload.n:    # more probes than lists
                        continue
                    for pol in policies:
                        cands.append(Candidate(
                            kind="cluster", cache_policy=pol,
                            centroid_frac=cf, num_replica=rep,
                            nprobe=nprobe))
    if "graph" in kinds:
        for R in R_GRID:
            for W in BEAMWIDTH_GRID:
                for L in SEARCHLEN_GRID:
                    if L < workload.k:
                        continue
                    for pol in policies:
                        cands.append(Candidate(
                            kind="graph", cache_policy=pol,
                            R=R, beamwidth=W, search_len=L))
    return cands
