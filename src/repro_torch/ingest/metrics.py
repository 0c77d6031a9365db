"""Ingest-side measurement: freshness, write amplification, compaction
pressure.

Two freshness clocks per update (both in virtual seconds):

* **visibility lag** — arrival → applied to a delta tier (searchable).
  Grows when the apply window backs up behind a write burst.
* **seal lag** — arrival → folded into the sealed objects by a flush.
  Grows with the delta capacity (bigger memtables flush later) and with
  compaction queueing (a storm of flush jobs serialises behind
  ``compaction_parallelism``).

Write amplification is measured, not modelled: compaction bytes written
divided by payload bytes ingested (rewriting a whole posting list to add
one vector is the cloud-native update tax both follow-up papers call
out).  Compaction busy intervals are recorded so serving reports can
slice query latency into during/outside-compaction populations.

The port's own copy of ``repro.ingest.metrics``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _lag_stats(lags: list[float]) -> dict:
    if not lags:
        return dict(n=0, mean_s=0.0, p99_s=0.0, max_s=0.0)
    a = np.asarray(lags)
    return dict(n=len(a), mean_s=round(float(a.mean()), 9),
                p99_s=round(float(np.percentile(a, 99)), 9),
                max_s=round(float(a.max()), 9))


def merge_intervals(intervals: list[tuple[float, float]]
                    ) -> list[tuple[float, float]]:
    """Coalesce overlapping (t0, t1) busy windows."""
    out: list[list[float]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def latency_during(records, intervals: list[tuple[float, float]],
                   invert: bool = False) -> list[float]:
    """Latencies of queries whose service overlapped (or, with
    ``invert``, avoided) any compaction busy window."""
    merged = merge_intervals(intervals)

    def overlaps(r) -> bool:
        return any(r.start_t < t1 and r.end_t > t0 for t0, t1 in merged)

    return [r.latency for r in records if overlaps(r) != invert]


@dataclasses.dataclass
class IngestReport:
    """Aggregated over every :class:`IngestAgent` of a run (a fleet run
    appends all sites into one report)."""

    ops_delivered: int = 0
    inserts_applied: int = 0
    deletes_applied: int = 0
    bytes_ingested: int = 0               # applied insert payload bytes
    visibility_lags: list = dataclasses.field(default_factory=list)
    seal_lags: list = dataclasses.field(default_factory=list)
    # compaction I/O (charged through StorageSim)
    compaction_read_bytes: int = 0
    compaction_read_requests: int = 0
    compaction_write_bytes: int = 0
    compaction_write_requests: int = 0
    flushes: int = 0
    lists_rewritten: int = 0
    blocks_rewritten: int = 0
    reclusters: int = 0
    repairs: int = 0                      # robust-prune reruns (graph)
    overflow_applies: int = 0             # applies past the hard delta cap
    intervals: list = dataclasses.field(default_factory=list)
    peak_delta_bytes: int = 0
    final_delta_bytes: int = 0
    unsealed: int = 0                     # updates still delta-only at end
    #: optional live hook ``fn(kind, lag_s)`` called on every apply —
    #: the fleet monitor subscribes its freshness-lag SLO here.  Not
    #: data: excluded from comparison and repr, never serialized.
    on_apply: object = dataclasses.field(default=None, repr=False,
                                         compare=False)

    # ------------------------------------------------------------ derived --
    @property
    def updates_applied(self) -> int:
        return self.inserts_applied + self.deletes_applied

    @property
    def write_amplification(self) -> float:
        """Compaction bytes written per payload byte ingested."""
        if self.bytes_ingested == 0:
            return 0.0
        return self.compaction_write_bytes / self.bytes_ingested

    @property
    def compaction_busy_s(self) -> float:
        return sum(t1 - t0 for t0, t1 in merge_intervals(self.intervals))

    def record_apply(self, kind: str, lag: float, nbytes: int) -> None:
        if kind == "insert":
            self.inserts_applied += 1
            self.bytes_ingested += nbytes
        else:
            self.deletes_applied += 1
        self.visibility_lags.append(lag)
        if self.on_apply is not None:
            self.on_apply(kind, lag)

    def record_seal(self, lags: list[float]) -> None:
        self.seal_lags.extend(lags)

    # --------------------------------------------------------------- JSON --
    def to_dict(self, records=None) -> dict:
        out = dict(
            ops_delivered=self.ops_delivered,
            inserts_applied=self.inserts_applied,
            deletes_applied=self.deletes_applied,
            bytes_ingested=self.bytes_ingested,
            visibility_lag=_lag_stats(self.visibility_lags),
            seal_lag=_lag_stats(self.seal_lags),
            unsealed=self.unsealed,
            flushes=self.flushes,
            lists_rewritten=self.lists_rewritten,
            blocks_rewritten=self.blocks_rewritten,
            reclusters=self.reclusters,
            repairs=self.repairs,
            overflow_applies=self.overflow_applies,
            compaction_read_bytes=self.compaction_read_bytes,
            compaction_read_requests=self.compaction_read_requests,
            compaction_write_bytes=self.compaction_write_bytes,
            compaction_write_requests=self.compaction_write_requests,
            write_amplification=round(self.write_amplification, 4),
            compaction_busy_s=round(self.compaction_busy_s, 9),
            peak_delta_bytes=self.peak_delta_bytes,
            final_delta_bytes=self.final_delta_bytes,
        )
        if records is not None:
            during = latency_during(records, self.intervals)
            outside = latency_during(records, self.intervals, invert=True)
            out["queries_during_compaction"] = len(during)
            out["query_p50_during_compaction_s"] = round(
                float(np.percentile(during, 50)), 9) if during else 0.0
            out["query_p99_during_compaction_s"] = round(
                float(np.percentile(during, 99)), 9) if during else 0.0
            out["query_p50_outside_compaction_s"] = round(
                float(np.percentile(outside, 50)), 9) if outside else 0.0
            out["query_p99_outside_compaction_s"] = round(
                float(np.percentile(outside, 99)), 9) if outside else 0.0
        return out
