"""Synthetic dataset analogues of the paper's Table 2.

The container has no copies of GIST1M/DEEP10M/MSSPACE10M/BIGANN1B, so we
generate clustered Gaussian-mixture analogues matching each dataset's
*dimensionality and datatype* (the two axes the paper's §5.2 shows drive
index behaviour) at reduced cardinality.  Cluster structure makes recall
non-trivial (pure iid Gaussians make ANN degenerate in high dim).

| analogue      | dim | dtype   | stands in for |
|---------------|-----|---------|---------------|
| gist-analog   | 960 | float32 | GIST1M        |
| deep-analog   |  96 | float32 | DEEP10M       |
| msspace-analog| 100 | int8    | MSSPACE10M    |
| bigann-analog | 128 | int8    | BIGANN1B      |

The port's own copy of ``repro.data.synth``: the same spec gives
bit-identical data in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    dim: int
    dtype: str           # "float32" | "int8"
    n: int
    n_queries: int
    n_clusters: int = 64
    cluster_std: float = 0.35
    intrinsic_dim: int = 32
    seed: int = 0


GIST_ANALOG = DatasetSpec("gist-analog", 960, "float32", 20_000, 200,
                          intrinsic_dim=32)
DEEP_ANALOG = DatasetSpec("deep-analog", 96, "float32", 50_000, 500,
                          intrinsic_dim=24)
MSSPACE_ANALOG = DatasetSpec("msspace-analog", 100, "int8", 50_000, 500,
                             intrinsic_dim=24)
BIGANN_ANALOG = DatasetSpec("bigann-analog", 128, "int8", 100_000, 500,
                            intrinsic_dim=32)

ANALOGS = {d.name: d for d in
           [GIST_ANALOG, DEEP_ANALOG, MSSPACE_ANALOG, BIGANN_ANALOG]}


def make_dataset(spec: DatasetSpec) -> tuple[np.ndarray, np.ndarray]:
    """Returns (data (N, D), queries (Q, D)) with the spec's dtype.

    Data lives on a low-rank manifold (x = U z, intrinsic_dim << dim) with
    per-cluster scale variation.  Isotropic full-rank Gaussians at 960-D
    exhibit total distance concentration (every pairwise distance equal),
    which (a) no real embedding set shows and (b) degenerates graph-index
    pruning — the ambient dim still controls vector BYTES, which is the
    axis the paper's dimensionality studies measure.

    Queries are perturbed dataset points (they live on the data manifold —
    the regime where ANN search is meaningful).
    """
    rng = np.random.default_rng(spec.seed)
    r = min(spec.intrinsic_dim, spec.dim)
    basis = rng.normal(0.0, 1.0, size=(r, spec.dim)) / np.sqrt(r)
    centers_z = rng.normal(0.0, 1.0, size=(spec.n_clusters, r))
    scales = rng.uniform(0.3, 1.2, size=spec.n_clusters) * spec.cluster_std
    assign = rng.integers(0, spec.n_clusters, size=spec.n)
    z = centers_z[assign] + rng.normal(
        0.0, 1.0, size=(spec.n, r)) * scales[assign][:, None]
    data = z @ basis + rng.normal(0.0, 0.02, size=(spec.n, spec.dim))
    qi = rng.choice(spec.n, size=spec.n_queries, replace=False)
    qz = z[qi] + rng.normal(0.0, 1.0, size=(spec.n_queries, r)) \
        * (scales[assign[qi]] * 0.5)[:, None]
    queries = qz @ basis + rng.normal(
        0.0, 0.02, size=(spec.n_queries, spec.dim))
    if spec.dtype == "int8":
        scale = 127.0 / (np.abs(data).max() + 1e-9)
        data = np.clip(np.round(data * scale), -127, 127).astype(np.int8)
        queries = np.clip(np.round(queries * scale), -127, 127).astype(np.int8)
    else:
        data = data.astype(np.float32)
        queries = queries.astype(np.float32)
    return data, queries


def scaled(spec: DatasetSpec, n: int, n_queries: int | None = None,
           **overrides) -> DatasetSpec:
    """A smaller/larger copy of a dataset spec (for tests/benchmarks)."""
    return dataclasses.replace(
        spec, n=n, n_queries=n_queries or min(spec.n_queries, max(16, n // 100)),
        **overrides)
