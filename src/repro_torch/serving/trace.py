"""Search-trace record & replay.

A query's fetch trace (which segments, in which dependency phases, with
which compute between them) is a property of the *index + parameters*, not
of the environment: the algorithms never adapt mid-query to cache state or
congestion.  So the benchmark harness records each search once and replays
the trace through the timing engine for every (storage × concurrency ×
cache) configuration — identical results, orders-of-magnitude faster
sweeps (the paper's figures are exactly such grids).

The port's own copy of ``repro.serving.trace``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.types import (FetchBatch, QueryMetrics, SearchParams,
                              SearchResult)
from repro_torch.serving.engine import EngineConfig, QueryEngine
from repro_torch.serving.metrics import WorkloadReport


@dataclasses.dataclass
class QueryTrace:
    qid: int
    batches: list[FetchBatch]
    checkpoints: list[tuple]       # metrics snapshot at each yield
    final: tuple                   # metrics snapshot at return
    result_ids: np.ndarray
    result_dists: np.ndarray


_FIELDS = ("bytes_read", "requests", "roundtrips", "expansions",
           "lists_visited", "dist_comps", "pq_dist_comps")


def _snap(m: QueryMetrics) -> tuple:
    return tuple(getattr(m, f) for f in _FIELDS)


def _restore(m: QueryMetrics, snap: tuple) -> None:
    for f, v in zip(_FIELDS, snap):
        setattr(m, f, v)


def record_traces(index, queries: np.ndarray, params: SearchParams,
                  query_ids=None) -> list[QueryTrace]:
    """Run every search once against the raw store, capturing its trace."""
    qids = list(query_ids) if query_ids is not None else range(len(queries))
    out = []
    for qi, qid in zip(range(len(queries)), qids):
        m = QueryMetrics()
        gen = index.search_plan(queries[qi], params, m)
        batches, checkpoints = [], []
        try:
            batch = next(gen)
            while True:
                batches.append(batch)
                checkpoints.append(_snap(m))
                payloads = {r.key: index.store.get(r.key)
                            for r in batch.requests}
                batch = gen.send(payloads)
        except StopIteration as stop:
            res: SearchResult = stop.value
        out.append(QueryTrace(
            qid=qid, batches=batches, checkpoints=checkpoints,
            final=_snap(m), result_ids=res.ids, result_dists=res.dists))
    return out


def _replay_plan(trace: QueryTrace, metrics: QueryMetrics):
    for batch, snap in zip(trace.batches, trace.checkpoints):
        _restore(metrics, snap)
        yield batch
    _restore(metrics, trace.final)
    return SearchResult(trace.result_ids, trace.result_dists, metrics)


class _TraceAdapter:
    """Duck-typed index whose search_plan replays recorded traces."""

    def __init__(self, index, traces: list[QueryTrace]):
        self.meta = index.meta
        self.store = index.store
        self._traces = traces
        self._cursor = 0

    def reset(self):
        self._cursor = 0

    def search_plan(self, q, params, metrics=None):
        metrics = metrics if metrics is not None else QueryMetrics()
        tr = self._traces[self._cursor]
        self._cursor += 1
        return _replay_plan(tr, metrics)


def replay_workload(index, traces: list[QueryTrace],
                    config: EngineConfig) -> WorkloadReport:
    """Replay recorded traces under an environment configuration."""
    adapter = _TraceAdapter(index, traces)
    engine = QueryEngine(adapter, config)
    dummy_queries = np.zeros((len(traces), 1), dtype=np.float32)
    return engine.run(dummy_queries, SearchParams(),
                      query_ids=[t.qid for t in traces])
