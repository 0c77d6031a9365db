"""``repro_torch.fleet`` — sharded, replicated fleet serving.

The paper analyses one compute node against one storage bucket (§2.1) and
defers distributed serving to future work; this subsystem is that future
work: N shard servers (each an independent engine + cache + storage
simulator) advanced on one shared deterministic virtual clock, with

* ``partition``: posting-list (balanced, replicated) and node-block
  (hashed, replicated) placement;
* ``server``: bounded admission queues with shed accounting
  (backpressure);
* ``router``: scatter-gather fan-out, power-of-two-choices replica
  selection, hedged requests, global top-k merge;
* ``metrics``: :class:`FleetReport` — tail latency (p50/p99/p99.9), load
  imbalance, hedge and shed rates.

CLI: ``python -m repro_torch.fleet --shards 4 --replicas 2`` emits a
deterministic JSON report.

The port's own copy of ``repro.fleet``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from repro_torch.fleet.metrics import FleetQueryRecord, FleetReport, FleetSeries
from repro_torch.fleet.partition import (ClusterPartition, GraphPartition,
                                   partition_for_index)
from repro_torch.fleet.router import (FleetConfig, FleetRouter, merge_topk,
                                run_fleet)
from repro_torch.fleet.server import ShardGroup, ShardServer, ShardStats

__all__ = [
    "FleetConfig", "FleetRouter", "run_fleet", "merge_topk",
    "FleetReport", "FleetQueryRecord", "FleetSeries",
    "ShardGroup", "ShardServer", "ShardStats",
    "ClusterPartition", "GraphPartition", "partition_for_index",
]
