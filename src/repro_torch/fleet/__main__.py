"""CLI entry: ``python -m repro_torch.fleet`` → JSON fleet report on stdout.

Builds a synthetic workload analogue (``data/synth.py``), builds the
index, partitions it across the fleet and serves the query set under the
selected scenario; the report is bit-identical for a given ``--seed``.

The index build (closure replication through ``l2_topk``; for the graph,
its greedy search and PQ training), the exact ground truth (``l2_topk``)
and every round's PQ distances of a routed graph query (``adc_lookup``)
run on the card; ``--device cpu`` runs their plain PyTorch versions
instead, and without it a host with no card raises.  Routing, storage,
caches and virtual time are host simulation, as in the reference.

Examples:

    python -m repro_torch.fleet --shards 4 --replicas 2
    python -m repro_torch.fleet --shards 8 --replicas 2 --hedge --index graph
    # open-loop Poisson at 300 QPS for 2 virtual seconds, 50ms SLO
    python -m repro_torch.fleet --scenario poisson --rate 300 --duration 2
    # kill shard 1 mid-run, recover it, watch p99 (recall is unchanged)
    python -m repro_torch.fleet --scenario poisson --replicas 2 \\
        --fail 1:0.5:1.5
    # let the autoscaler defend the SLO through a 4x burst
    python -m repro_torch.fleet --scenario burst --rate 150 --duration 2 \\
        --autoscale --slo-ms 80
    # read-write mix: live inserts/deletes + background compaction
    python -m repro_torch.fleet --scenario rw --write-rate 400 \\
        --n-updates 200 --delta-kb 64
    # multi-tenant: N workloads sharing the fleet's caches + bandwidth
    python -m repro_torch.fleet --tenants tenants.json --cache-mb 4 \\
        --cache-policy weighted
    # on a host without a card: the plain PyTorch versions
    python -m repro_torch.fleet --device cpu

The port's own copy of ``repro.fleet.__main__``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.cli import (add_common_args, add_exec_args, add_monitor_args,
                             add_obs_args, add_scenario_args,
                             autoscale_from_args, emit_json, emit_obs,
                             exec_fields_from_args, faults_from_args,
                             ingest_from_args, monitor_from_args,
                             pricebook_from_args, scenario_from_args,
                             tracer_from_args)
from repro_torch.core.cluster_index import ClusterIndex
from repro_torch.core.flat import exact_topk
from repro_torch.core.graph_index import GraphIndex
from repro_torch.core.types import (ClusterIndexParams, GraphIndexParams,
                                    SearchParams)
from repro_torch.data.synth import DatasetSpec, make_dataset
from repro_torch.device import resolve_device
from repro_torch.fleet.router import FleetConfig, run_fleet
from repro_torch.tuning.space import STORAGE_ALIASES, resolve_storage


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.fleet",
        description="Serve a synthetic workload across a sharded, "
                    "replicated fleet and report tail latency, balance, "
                    "hedge and shed rates — under closed-loop or "
                    "open-loop (poisson/burst/trace) arrivals, with "
                    "optional fault injection and SLO autoscaling.")
    p.add_argument("--shards", type=int, default=4)
    p.add_argument("--replicas", type=int, default=2,
                   help="replication factor R (replica shards per segment)")
    p.add_argument("--index", choices=["cluster", "graph"],
                   default="cluster")
    p.add_argument("--n", type=int, default=2000,
                   help="synthetic dataset cardinality")
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--queries", type=int, default=64)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--nprobe", type=int, default=16)
    p.add_argument("--search-len", type=int, default=40)
    p.add_argument("--beamwidth", type=int, default=8)
    p.add_argument("--storage", default="tos",
                   help="storage preset: %s or a full preset name"
                        % "/".join(sorted(STORAGE_ALIASES)))
    p.add_argument("--concurrency", type=int, default=8,
                   help="in-service fleet queries (admission window)")
    p.add_argument("--shard-concurrency", type=int, default=4)
    p.add_argument("--queue-depth", type=int, default=16)
    p.add_argument("--cache-mb", type=float, default=0.0,
                   help="per-shard SLRU cache budget in MiB")
    p.add_argument("--nvme-gb", type=float, default=0.0,
                   help="per-instance local NVMe tier capacity in GiB "
                        "(0 = flat DRAM-over-remote hierarchy)")
    p.add_argument("--tier-policy", default="second-hit",
                   choices=["second-hit", "admit-always"],
                   help="NVMe promotion policy (needs --nvme-gb > 0)")
    p.add_argument("--nvme-writeback", action="store_true",
                   help="land compaction output on local NVMe first, "
                        "flush to the object store asynchronously "
                        "(needs --nvme-gb > 0)")
    p.add_argument("--hedge", action="store_true",
                   help="enable hedged requests (needs --replicas >= 2)")
    p.add_argument("--hedge-percentile", type=float, default=95.0)
    p.add_argument("--no-recall", action="store_true",
                   help="skip the exact ground-truth pass")
    p.add_argument("--device", default=None,
                   help="where the index build and the exact ground truth "
                        "run, and where a graph index keeps its PQ codes "
                        "(default: cuda; raises without a card; 'cpu' runs "
                        "the plain PyTorch versions)")
    t = p.add_argument_group("tenancy")
    t.add_argument("--tenants", default=None, metavar="SPEC.JSON",
                   help="serve N tenant workloads (JSON list of tenant "
                        "specs; see docs/tenancy.md) over this one fleet")
    t.add_argument("--cache-policy", default="shared",
                   choices=["shared", "static", "weighted"],
                   help="how the per-instance cache budget is split "
                        "across tenants (--tenants runs only)")
    t.add_argument("--no-solo", action="store_true",
                   help="skip the per-tenant solo baseline runs (no "
                        "interference ratios in the report)")
    add_exec_args(p)
    add_scenario_args(p)
    add_obs_args(p)
    add_monitor_args(p)
    add_common_args(p)
    return p


def fleet_config_from_args(args, storage) -> FleetConfig:
    """The one CLI-to-FleetConfig mapping (single- and multi-tenant).
    Config-level validation errors (e.g. tier knobs without --nvme-gb)
    surface as parser errors, not tracebacks."""
    try:
        return _fleet_config(args, storage)
    except ValueError as e:
        build_parser().error(str(e))


def _fleet_config(args, storage) -> FleetConfig:
    return FleetConfig(
        n_shards=args.shards, replication=args.replicas, storage=storage,
        concurrency=args.concurrency,
        shard_concurrency=args.shard_concurrency,
        queue_depth=args.queue_depth,
        cache_bytes=int(args.cache_mb * 2**20),
        cache_policy="slru" if args.cache_mb > 0 else "none",
        nvme_bytes=int(args.nvme_gb * 2**30),
        tier_policy=args.tier_policy,
        nvme_writeback=args.nvme_writeback,
        hedge=args.hedge, hedge_percentile=args.hedge_percentile,
        seed=args.seed,
        **exec_fields_from_args(args, build_parser()))


def validated_faults(args):
    """Parse --fail and range-check shard ids against --shards."""
    try:
        faults = faults_from_args(args)
    except ValueError as e:
        build_parser().error(str(e))
    if faults is not None:
        bad = [f.shard for f in faults.faults if f.shard >= args.shards]
        if bad:
            build_parser().error(f"--fail shard(s) {bad} out of range for "
                                 f"--shards {args.shards}")
    return faults


#: single-tenant workload flags that tenant specs own entirely — their
#: appearing alongside --tenants is a user error, not a silent no-op
#: (defaults come from the parser itself, so they can never drift)
_TENANT_OWNED_FLAGS = (
    "scenario", "rate", "duration", "arrivals", "slo_ms",
    "burst_factor", "burst_start", "burst_len", "trace_zipf_a",
    "write_rate", "n_updates", "delete_frac",
    "delta_kb", "flush_frac", "compaction_par",
    "index", "n", "dim", "queries", "k", "nprobe", "search_len",
    "beamwidth",
)


def run_tenancy(args, storage) -> int:
    """The --tenants path: N workloads over one shared fleet."""
    from repro_torch.core.flat import exact_topk
    from repro_torch.tenancy import (Tenant, load_tenant_specs,
                                     materialize_tenant, measure_interference,
                                     run_tenant_fleet)
    parser = build_parser()
    dead = [name for name in _TENANT_OWNED_FLAGS
            if getattr(args, name) != parser.get_default(name)]
    if dead:
        parser.error(
            f"--tenants runs take every workload axis from the tenant "
            f"spec file; --{'/--'.join(d.replace('_', '-') for d in dead)} "
            f"would be ignored — set it per tenant in the JSON instead")
    if args.cache_policy != "shared" and args.cache_mb <= 0:
        parser.error(
            f"--cache-policy {args.cache_policy} needs a cache budget "
            f"(--cache-mb > 0); with no cache there is nothing to "
            f"partition")
    try:
        specs = load_tenant_specs(args.tenants)
    except (OSError, ValueError) as e:
        build_parser().error(f"--tenants: {e}")
    faults = validated_faults(args)
    if args.autoscale:
        build_parser().error(
            "--autoscale composes with --tenants only through a fleet-"
            "wide SLO, which multi-tenant runs don't have (each tenant "
            "carries its own); drop one of the two flags")
    cfg = fleet_config_from_args(args, storage)
    device = resolve_device(args.device)

    def make_tenants() -> list[Tenant]:
        return [materialize_tenant(s, base_seed=cfg.seed, tid=i,
                                   device=device)
                for i, s in enumerate(specs)]

    # ground truth only needs each tenant's data/queries/update stream,
    # which the serving runs leave intact — keep the first materialised
    # list instead of paying the index builds a further time for recall
    first: list[Tenant] = []

    def tenants_once() -> list[Tenant]:
        made = make_tenants()
        if not first:
            first.extend(made)
        return made

    tracer = tracer_from_args(args)
    monitor = monitor_from_args(args, parser)
    pricebook = pricebook_from_args(args, parser)
    if monitor is not None and monitor.recall_target is not None:
        # live recall needs ground truth up front; tenant name -> gt
        import dataclasses as _dc
        gt_map = {}
        for t in tenants_once():
            if t.updates is None:
                gt_map[t.spec.name] = exact_topk(t.data, t.queries,
                                                 t.spec.k, device=device)[0]
        monitor = _dc.replace(monitor, gt_ids=gt_map)
    t0 = time.perf_counter()
    if args.no_solo or faults is not None:
        # interference baselines are only meaningful on a healthy fleet
        rep = run_tenant_fleet(tenants_once(), cfg, args.cache_policy,
                               faults=faults,
                               series_dt=args.series_dt, tracer=tracer,
                               monitor=monitor, pricebook=pricebook,
                               explain=bool(args.explain),
                               mrc=bool(args.mrc))
    else:
        rep = measure_interference(tenants_once, cfg, args.cache_policy,
                                   series_dt=args.series_dt,
                                   tracer=tracer, monitor=monitor,
                                   pricebook=pricebook,
                                   explain=bool(args.explain),
                                   mrc=bool(args.mrc))
    wall_s = time.perf_counter() - t0
    if rep.showback is not None:
        from repro_torch.obs import format_showback
        print(format_showback(rep.showback), file=sys.stderr)
    from repro_torch.obs import run_manifest
    out = dict(config=cfg.to_dict(), cache_policy=args.cache_policy,
               tenant_specs=[s.to_dict() for s in specs],
               report=rep.summary(),
               meta=run_manifest(seed=args.seed, config=cfg.to_dict(),
                                 wall_s=wall_s))
    emit_obs(out, args, tracer)
    if faults is not None:
        out["fault_schedule"] = faults.to_dicts()
    if not args.no_recall:
        recalls = {}
        for sl, t in zip(rep.tenants, first):
            if t.updates is not None:
                from repro_torch.ingest.stream import churn_ground_truth
                gt = churn_ground_truth(t.data, queries=t.queries,
                                        k=t.spec.k, stream=t.updates,
                                        device=device)
            else:
                gt, _ = exact_topk(t.data, t.queries, t.spec.k,
                                   device=device)
            recalls[sl.name] = round(sl.recall_against(gt), 4)
        out["recall"] = recalls
    emit_json(out, args)
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        storage = resolve_storage(args.storage)
    except KeyError as e:
        build_parser().error(str(e.args[0]))
    if args.tenants is not None:
        return run_tenancy(args, storage)
    try:
        scenario = scenario_from_args(args)
        autoscale = autoscale_from_args(args)
    except ValueError as e:
        build_parser().error(str(e))
    faults = validated_faults(args)
    if autoscale is not None and scenario.kind == "closed":
        build_parser().error(
            "--autoscale needs an open-loop --scenario (poisson/burst/"
            "trace): closed-loop sojourns measure drain position, which "
            "would pin the SLO controller at permanent scale-up")

    spec = DatasetSpec("fleet-analog", args.dim, "float32", args.n,
                       args.queries, n_clusters=max(8, min(64, args.n // 16)),
                       intrinsic_dim=min(32, args.dim), seed=args.seed)
    data, queries = make_dataset(spec)
    device = resolve_device(args.device)
    if args.index == "cluster":
        index = ClusterIndex.build(data, ClusterIndexParams(
            kmeans_iters=4, seed=args.seed), device=device)
        params = SearchParams(k=args.k, nprobe=args.nprobe)
    else:
        from repro_torch.core.pq import default_pq_dims
        index = GraphIndex.build(data, GraphIndexParams(
            R=24, L_build=48, build_passes=1,
            pq_dims=default_pq_dims(args.dim), seed=args.seed),
            device=device)
        params = SearchParams(k=args.k, search_len=args.search_len,
                              beamwidth=args.beamwidth)

    cfg = fleet_config_from_args(args, storage)
    arrivals = scenario.make_arrivals(len(queries), cfg.concurrency,
                                      seed=args.seed)
    updates = None
    ingest_cfg = None
    if scenario.kind == "rw":
        protected = frozenset([index.meta.medoid]) \
            if args.index == "graph" else None
        updates = scenario.make_updates(data, seed=args.seed,
                                        protected=protected)
        ingest_cfg = ingest_from_args(args)
    # closed-loop sojourns measure drain position, not service time —
    # goodput-vs-SLO is only meaningful for open-loop arrivals (rw runs
    # its queries closed-loop too)
    slo_s = scenario.slo_s if scenario.kind not in ("closed", "rw") \
        else None
    tracer = tracer_from_args(args)
    parser = build_parser()
    monitor = monitor_from_args(args, parser)
    pricebook = pricebook_from_args(args, parser)
    gt_pre = None
    if monitor is not None:
        import dataclasses as _dc
        if scenario.kind == "rw":
            # freshness-lag SLO: alert when updates take longer than
            # the latency SLO to become visible
            monitor = _dc.replace(monitor,
                                  freshness_slo_s=args.slo_ms * 1e-3)
        if monitor.recall_target is not None:
            if updates is not None:
                parser.error("--recall-slo needs a pure-query scenario: "
                             "under churn the ground truth moves with "
                             "every applied update")
            gt_pre, _ = exact_topk(data, queries, args.k, device=device)
            monitor = _dc.replace(monitor, gt_ids=gt_pre)
    t0 = time.perf_counter()
    report = run_fleet(index, queries, params, cfg,
                       arrivals=arrivals, faults=faults,
                       autoscale=autoscale, slo_s=slo_s,
                       series_dt=args.series_dt,
                       updates=updates, ingest=ingest_cfg,
                       tracer=tracer, monitor=monitor,
                       pricebook=pricebook,
                       explain=bool(args.explain), mrc=bool(args.mrc))
    wall_s = time.perf_counter() - t0

    from repro_torch.obs import run_manifest
    out = dict(config=cfg.to_dict(), index=args.index,
               scenario=scenario.to_dict(), report=report.summary(),
               meta=run_manifest(seed=args.seed, config=cfg.to_dict(),
                                 wall_s=wall_s))
    emit_obs(out, args, tracer)
    if faults is not None:
        out["fault_schedule"] = faults.to_dicts()
    if autoscale is not None:
        out["autoscale_config"] = autoscale.to_dict()
    if scenario.kind == "rw":
        out["ingest_config"] = ingest_cfg.to_dict()
        if updates is not None:
            out["update_stream"] = updates.to_dict()
    if not args.no_recall:
        if updates is not None:
            from repro_torch.ingest.stream import churn_ground_truth
            gt = churn_ground_truth(data, queries=queries, k=args.k,
                                    stream=updates, device=device)
        elif gt_pre is not None:
            gt = gt_pre
        else:
            gt, _ = exact_topk(data, queries, args.k, device=device)
        out["recall"] = round(report.recall_against(gt), 4)
    emit_json(out, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
