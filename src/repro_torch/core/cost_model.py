"""The paper's analytic cost models (Eq. 1, Eq. 2) made executable.

Cluster:  C = c_centroid(n, nprobe) + c_fetch(l) + l * c_dist        (Eq. 1)
Graph:    C = rt × (TTFB + c_fetch(K) + K * c_dist)                  (Eq. 2)

``environment``-aware: c_fetch terms are priced with a StorageSpec
(bandwidth under concurrency sharing + IOPS throttling + TTFB), c_dist with
a compute-rate constant.  Used by tests (crossover/monotonicity) and by
``examples/cloud_tuning.py`` to pick the index class per workload — the
actionable deliverable of RQ1/RQ2.

The port's own copy of ``repro.core.cost_model``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.storage.spec import StorageSpec


@dataclasses.dataclass(frozen=True)
class ComputeSpec:
    """Host compute model for the serving node.

    dist_flops_per_s is calibrated to the paper's Fig 2 CPU/I-O splits:
    scattered posting-list scans on x86 are memory-bound at ~4 GFLOP/s
    effective (GIST1M nprobe=8 on SSD: 51% distance comps vs 31% I/O
    implies ~3.7 GFLOP/s), not the peak SIMD rate.
    """

    dist_flops_per_s: float = 4e9       # sustained distance-comp throughput
    bkt_node_visit_s: float = 2e-7      # per BKT node visit (pointer chase)
    adc_lookup_s: float = 2e-9          # per (code, subquantizer) lookup


DEFAULT_COMPUTE = ComputeSpec()


def plan_compute_seconds(d_dist: int, d_pq: int, dim: int, pq_m: int,
                         spec: ComputeSpec = DEFAULT_COMPUTE) -> float:
    """Price the compute a search plan performed between two yields.

    ``d_dist`` full-precision and ``d_pq`` ADC distance computations since
    the last checkpoint, priced with the node's :class:`ComputeSpec`.  Both
    the serving engine and the fleet router charge plan compute through this
    one function, so a query costs the same wherever its scan runs.
    """
    return (d_dist * 2.0 * dim / spec.dist_flops_per_s
            + d_pq * max(pq_m, 1) * spec.adc_lookup_s)


@dataclasses.dataclass(frozen=True)
class ClusterWorkloadPoint:
    """Index/workload statistics needed by Eq. (1)."""

    n_lists: int
    avg_list_bytes: float
    avg_list_len: float
    dim: int
    nprobe: int


@dataclasses.dataclass(frozen=True)
class GraphWorkloadPoint:
    """Index/workload statistics needed by Eq. (2)."""

    roundtrips: int          # rt — grows with search_len/recall (Fig 8b)
    requests_per_round: float  # ≈ beamwidth W
    node_nbytes: int
    R: int                   # out-degree: neighbours scored per expansion
    pq_m: int
    dim: int


def _fetch_time_s(env: StorageSpec, nbytes: float, n_requests: float,
                  concurrency: int = 1, hit_rate: float = 0.0,
                  hit_latency_s: float = 100e-6) -> float:
    """One dependency-free fetch phase under `concurrency` active queries.

    Bandwidth is a shared pipe (processor sharing): effective per-query
    bandwidth = bw / concurrency.  The IOPS limit throttles request
    admission at ``get_qps_limit / concurrency`` per query.  TTFB is paid
    once per phase (requests within a phase are issued together).

    ``hit_rate`` models a compute-node segment cache: a fraction of the
    phase's requests are served locally at ``hit_latency_s``, shrinking the
    bytes/requests hitting storage.  The phase still waits on its slowest
    request, so TTFB is charged with the probability that at least one of
    the phase's requests misses (1 - hit_rate^n).
    """
    hr = min(max(hit_rate, 0.0), 1.0)
    bw = env.bandwidth_Bps / max(1, concurrency)
    iops = env.get_qps_limit / max(1, concurrency)
    t_bw = nbytes * (1.0 - hr) / bw
    t_iops = n_requests * (1.0 - hr) / iops
    p_any_miss = 1.0 - hr ** max(n_requests, 1.0)
    return (hr * hit_latency_s + env.ttfb_p50_s * p_any_miss
            + max(t_bw, t_iops))


def cluster_query_cost(
    env: StorageSpec, w: ClusterWorkloadPoint,
    compute: ComputeSpec = DEFAULT_COMPUTE,
    concurrency: int = 1,
    dtype_bytes: int = 4,
    hit_rate: float = 0.0,
    hit_latency_s: float = 100e-6,
) -> dict[str, float]:
    """Eq. (1) with environment pricing.  Returns per-term seconds.

    ``hit_rate`` discounts the single fetch phase's storage traffic by the
    expected cache hit fraction (Eq. 1 extended for §7's cached serving):
    the reported ``bytes``/``requests`` are the *storage-billed* residuals,
    which is what the QPS ceilings in :func:`predicted_qps` care about.
    """
    hr = min(max(hit_rate, 0.0), 1.0)
    # c_centroid: BKT descent is O(branch * log(n) * nprobe-ish); we price
    # the empirical ~n log(nprobe) form the paper cites.
    visits = w.nprobe + math.log2(max(2, w.n_lists)) * 8.0
    c_centroid = visits * compute.bkt_node_visit_s + (
        visits * w.dim / compute.dist_flops_per_s * 2.0)
    l_vectors = w.nprobe * w.avg_list_len
    nbytes = w.nprobe * w.avg_list_bytes
    c_fetch = _fetch_time_s(env, nbytes, w.nprobe, concurrency,
                            hit_rate=hr, hit_latency_s=hit_latency_s)
    c_dist = l_vectors * (2.0 * w.dim) / compute.dist_flops_per_s
    total = c_centroid + c_fetch + c_dist
    return dict(total=total, c_centroid=c_centroid, c_fetch=c_fetch,
                c_dist=c_dist, bytes=nbytes * (1.0 - hr),
                requests=float(w.nprobe) * (1.0 - hr))


def graph_query_cost(
    env: StorageSpec, w: GraphWorkloadPoint,
    compute: ComputeSpec = DEFAULT_COMPUTE,
    concurrency: int = 1,
    hit_rate: float = 0.0,
    hit_latency_s: float = 100e-6,
) -> dict[str, float]:
    """Eq. (2) with environment pricing.  Returns per-term seconds.

    ``hit_rate`` is modelled at *round* granularity: graph cache hits
    concentrate in the early traversal rounds (entry-point neighbourhood,
    paper Fig 23 / suggestion A3), so a hit fraction ``hr`` removes that
    fraction of the ``rt × TTFB`` latency floor entirely — cached rounds
    cost only ``hit_latency_s`` — and discounts storage bytes/requests.
    """
    hr = min(max(hit_rate, 0.0), 1.0)
    per_round_bytes = w.requests_per_round * w.node_nbytes
    c_fetch = _fetch_time_s(env, per_round_bytes, w.requests_per_round,
                            concurrency) - env.ttfb_p50_s
    # neighbours scored by ADC each round + W exact rerank distances
    c_dist = (w.requests_per_round * w.R * w.pq_m * compute.adc_lookup_s
              + w.requests_per_round * 2.0 * w.dim
              / compute.dist_flops_per_s)
    rt_miss = w.roundtrips * (1.0 - hr)
    rt_hit = w.roundtrips * hr
    per_round = env.ttfb_p50_s + c_fetch + c_dist
    total = rt_miss * per_round + rt_hit * (hit_latency_s + c_dist)
    return dict(total=total, ttfb_total=rt_miss * env.ttfb_p50_s,
                c_fetch=rt_miss * c_fetch,
                c_dist=w.roundtrips * c_dist,
                bytes=rt_miss * per_round_bytes,
                requests=rt_miss * w.requests_per_round)


def predicted_qps(env: StorageSpec, per_query_s: float, bytes_per_query: float,
                  requests_per_query: float, concurrency: int) -> float:
    """Workload QPS under the environment's three ceilings:

    latency pipelineing (concurrency/latency), shared bandwidth
    (bw / bytes-per-query), and the GET rate limit (IOPS / requests).
    """
    qps_lat = concurrency / max(per_query_s, 1e-12)
    qps_bw = env.bandwidth_Bps / max(bytes_per_query, 1e-12)
    qps_iops = env.get_qps_limit / max(requests_per_query, 1e-12)
    return min(qps_lat, qps_bw, qps_iops)
