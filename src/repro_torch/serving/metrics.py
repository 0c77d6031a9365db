"""Workload-level measurement (paper §5.1 ①–⑦).

The port's own copy of ``repro.serving.metrics``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.types import QueryMetrics


@dataclasses.dataclass
class BatchTrace:
    """One fetch phase of one query (for Fig 22a / Fig 23-style plots)."""

    round_idx: int
    submit_t: float
    done_t: float
    n_requests: int        # remote storage requests (misses)
    n_hits: int            # cache hits in this batch
    nbytes_storage: int
    nbytes_total: int
    n_nvme: int = 0        # requests served from the local NVMe tier
    nbytes_nvme: int = 0   # bytes served from the local NVMe tier

    @property
    def io_latency(self) -> float:
        return self.done_t - self.submit_t


@dataclasses.dataclass
class QueryRecord:
    qid: int
    start_t: float                 # service start (window admission)
    end_t: float
    ids: np.ndarray
    dists: np.ndarray
    metrics: QueryMetrics
    batches: list[BatchTrace]
    arrive_t: float | None = None  # open-loop arrival (None => start_t)

    @property
    def latency(self) -> float:
        return self.end_t - self.start_t

    @property
    def sojourn(self) -> float:
        """Arrival-to-completion time (includes backlog wait)."""
        t0 = self.start_t if self.arrive_t is None else self.arrive_t
        return self.end_t - t0


@dataclasses.dataclass
class WorkloadReport:
    """Aggregates for one (index, params, environment, workload) run."""

    records: list[QueryRecord]
    wall_time_s: float
    storage_bytes: int
    storage_requests: int
    concurrency: int
    scenario: str = "closed"       # arrival process kind
    n_arrivals: int = 0
    offered_qps: float = 0.0       # arrival rate (== qps when closed-loop)
    ingest: dict | None = None     # repro.ingest accounting (rw runs)

    # ------------------------------------------------ paper metrics ①–⑦ --
    @property
    def qps(self) -> float:                                   # ①
        return len(self.records) / max(self.wall_time_s, 1e-12)

    def latency_percentile(self, p: float) -> float:          # ②
        return float(np.percentile([r.latency for r in self.records], p))

    def sojourn_percentile(self, p: float) -> float:
        """Arrival-to-completion percentile — includes backlog wait
        (closed loop backlogs everything at t=0, so there it measures
        drain position, not service time; use latency_percentile there)."""
        return float(np.percentile([r.sojourn for r in self.records], p))

    @property
    def mean_latency(self) -> float:
        return float(np.mean([r.latency for r in self.records]))

    @property
    def bandwidth_Bps(self) -> float:                         # ③
        return self.storage_bytes / max(self.wall_time_s, 1e-12)

    @property
    def mean_expansions(self) -> float:                       # ④
        return float(np.mean([r.metrics.expansions for r in self.records]))

    @property
    def mean_lists_visited(self) -> float:                    # ⑤
        return float(np.mean([r.metrics.lists_visited
                              for r in self.records]))

    @property
    def mean_io_latency(self) -> float:                       # ⑥
        waits = [b.io_latency for r in self.records for b in r.batches
                 if b.n_requests > 0]
        return float(np.mean(waits)) if waits else 0.0

    @property
    def hit_rate(self) -> float:                              # ⑦
        hits = sum(r.metrics.cache_hits for r in self.records)
        lookups = sum(r.metrics.cache_lookups for r in self.records)
        return hits / lookups if lookups else 0.0

    # ------------------------------------------------------ derived -----
    @property
    def mean_roundtrips(self) -> float:
        return float(np.mean([r.metrics.roundtrips for r in self.records]))

    @property
    def mean_requests(self) -> float:
        return float(np.mean([r.metrics.requests for r in self.records]))

    @property
    def mean_bytes_read(self) -> float:
        return float(np.mean([r.metrics.bytes_read for r in self.records]))

    @property
    def mean_bytes_storage(self) -> float:
        return float(np.mean([r.metrics.bytes_storage
                              for r in self.records]))

    def recall_against(self, gt_ids: np.ndarray) -> float:
        from repro_torch.core.types import recall_at_k
        recs = [recall_at_k(r.ids[r.ids >= 0], gt_ids[r.qid])
                for r in self.records]
        return float(np.mean(recs))

    def summary(self) -> dict:
        out = dict(
            qps=self.qps,
            mean_latency_s=self.mean_latency,
            p50_latency_s=self.latency_percentile(50),
            p99_latency_s=self.latency_percentile(99),
            bandwidth_MBps=self.bandwidth_Bps / 1e6,
            mean_io_latency_s=self.mean_io_latency,
            mean_roundtrips=self.mean_roundtrips,
            mean_requests=self.mean_requests,
            mean_bytes_read_MB=self.mean_bytes_read / 1e6,
            hit_rate=self.hit_rate,
            storage_requests=self.storage_requests,
        )
        if self.ingest is not None:
            out["ingest"] = self.ingest
        return out
