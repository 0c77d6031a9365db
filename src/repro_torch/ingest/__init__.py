"""``repro_torch.ingest`` — streaming updates, delta indexes and background
compaction under live traffic.

The paper serves build-once indexes; this subsystem makes both index
families mutable end to end:

* :mod:`repro_torch.ingest.memtable` — the in-memory delta tier (flat
  brute-force segment + tombstones, sized in bytes);
* :mod:`repro_torch.ingest.mutable` — :class:`MutableClusterIndex` /
  :class:`MutableGraphIndex`: merged (delta ∪ sealed) search through
  ``dedup_topk`` with tombstone filtering, plus the pure mutation
  kernels compaction drives;
* :mod:`repro_torch.ingest.compaction` — :class:`IngestAgent`: applies the
  update stream through the shared admission window and runs flushes,
  posting-list re-clustering and graph stitch/repair as kernel events
  whose I/O goes through the query-serving :class:`StorageSim`;
* :mod:`repro_torch.ingest.stream` — timestamped insert/delete streams and
  churn ground truth;
* :mod:`repro_torch.ingest.metrics` — freshness lags, write amplification,
  compaction busy intervals.

Entry points: ``run_workload(..., updates=, ingest=)`` for one engine,
``run_fleet(..., updates=, ingest=)`` / ``python -m repro_torch.fleet
--scenario rw`` for a sharded fleet.

The port's own copy of ``repro.ingest``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from repro_torch.ingest.compaction import IngestAgent, IngestConfig
from repro_torch.ingest.memtable import DeltaEntry, Memtable
from repro_torch.ingest.metrics import (IngestReport, latency_during,
                                        merge_intervals)
from repro_torch.ingest.mutable import (MutableClusterIndex, MutableGraphIndex,
                                        make_mutable)
from repro_torch.ingest.stream import (UpdateOp, UpdateStream, churn_ground_truth,
                                       churned_corpus, synth_updates)

__all__ = [
    "IngestAgent", "IngestConfig", "IngestReport",
    "Memtable", "DeltaEntry",
    "MutableClusterIndex", "MutableGraphIndex", "make_mutable",
    "UpdateOp", "UpdateStream", "synth_updates", "churned_corpus",
    "churn_ground_truth", "latency_during", "merge_intervals",
]
