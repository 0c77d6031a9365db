"""CLI entry: ``python -m repro_torch.tuning`` → JSON recommendation on stdout.

Two modes:

* **index tuning** (default): pick index class, build/search params and
  cache policy for a workload + storage environment.

      python -m repro_torch.tuning --recall 0.95 --concurrency 64 --dim 960 \\
          --storage tos --cache-gb 4

* **fleet sizing** (``--fleet``): pick shards × replication.  With the
  default closed-loop scenario the target is a speedup over one shard;
  with an open-loop scenario (``--scenario poisson/burst/trace``) the
  fleet is sized for an **offered load + SLO** — the cheapest fleet whose
  goodput under ``--slo-ms`` meets ``--goodput``.

      python -m repro_torch.tuning --fleet --scenario poisson --rate 400 \\
          --duration 1 --slo-ms 50

* **batch-window tuning** (``--tune-window``): sweep the kernel
  execution backend's per-shard batch-coalescing window on a fixed
  fleet point and map the occupancy vs p99 frontier.  Both fleet modes
  also accept ``--backend kernel`` to price the sweep from a measured
  CalibrationTable instead of the analytic ComputeSpec constants.

      python -m repro_torch.tuning --tune-window --scenario poisson --rate 400

* **cache-split tuning** (``--tune-split``): split a shared cache
  budget across tenants.  The analytic screen prices candidates from
  Che-approximation curves, or — with ``--mrc-curves`` — from measured
  miss-ratio curves written by a live ``--mrc``-profiled fleet run
  (docs/observability.md).

      python -m repro_torch.tuning --tune-split --tenants tenants.json \\
          --cache-gb 0.004 --mrc-curves mrc.json

* **tier-split tuning** (``--tune-tier``): split a fixed $/hour budget
  across fleet width, DRAM cache and the local NVMe tier
  (docs/storage.md).  The screen prices per-tier hit rates from the
  workload's access profile (or ``--mrc-curves``) and a price book;
  the top candidates are re-priced on real tiered fleet runs.

      python -m repro_torch.tuning --tune-tier --budget-usd-hour 2.0 \\
          --pricebook default

The port's own copy of ``repro.tuning.__main__``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code apart from its ``--device`` lines.  Every rung's and sweep's index
build (the cluster closure through ``l2_topk``; the graph's greedy search
and PQ training), its exact ground truth (``l2_topk``) and a graph
candidate's PQ distances (``adc_lookup``) run on the card; ``--device
cpu`` runs their plain PyTorch versions instead, and without it a host
with no card raises.  The probe, routing, caches and virtual time are host
simulation, as in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from repro_torch.cli import (add_common_args, add_exec_args, add_monitor_args,
                             add_obs_args, add_scenario_args, emit_json,
                             emit_obs, exec_fields_from_args, monitor_from_args,
                             pricebook_from_args, scenario_from_args,
                             tracer_from_args)
from repro_torch.device import resolve_device
from repro_torch.tuning.evaluate import EvalBudget
from repro_torch.tuning.fleet import (tune_batch_window, tune_fleet,
                                      tune_fleet_for_load)
from repro_torch.tuning.recommend import autotune
from repro_torch.tuning.space import (STORAGE_ALIASES, EnvSpec, WorkloadSpec,
                                      resolve_storage)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.tuning",
        description="Auto-tune index class, build/search params and cache "
                    "policy for a workload + storage environment; with "
                    "--fleet, size a serving fleet (optionally for an "
                    "open-loop offered load + SLO).")
    p.add_argument("--n", type=int, default=1_000_000,
                   help="dataset cardinality (default 1M)")
    p.add_argument("--dim", type=int, default=960)
    p.add_argument("--dtype", choices=["float32", "int8"], default="float32")
    p.add_argument("--recall", type=float, default=0.9,
                   help="target recall@k")
    p.add_argument("--concurrency", type=int, default=1)
    p.add_argument("--dist", choices=["sequential", "zipf"],
                   default="sequential", help="query distribution")
    p.add_argument("--zipf-a", type=float, default=1.2,
                   help="zipf exponent for --dist zipf")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--storage", default="tos",
                   help="storage preset: %s or a full preset name"
                        % "/".join(sorted(STORAGE_ALIASES)))
    p.add_argument("--cache-gb", type=float, default=0.0,
                   help="compute-node cache budget in GiB")
    p.add_argument("--budget", choices=["screen", "quick", "full"],
                   default="quick",
                   help="screen = analytic only; quick = small simulation "
                        "rungs; full = default rungs")
    p.add_argument("--kinds", default="cluster,graph",
                   help="comma-separated index kinds to consider")
    # fleet sizing mode
    p.add_argument("--fleet", action="store_true",
                   help="size a fleet (shards x replication) instead of "
                        "tuning index knobs")
    p.add_argument("--target-speedup", type=float, default=2.0,
                   help="closed-loop fleet target: speedup over 1 shard")
    p.add_argument("--goodput", type=float, default=0.99,
                   help="open-loop fleet target: min fraction of arrivals "
                        "served within the SLO")
    p.add_argument("--hedge", action="store_true",
                   help="consider hedged fleets (R >= 2 points)")
    p.add_argument("--tune-window", action="store_true",
                   help="sweep the kernel backend's batch-coalescing "
                        "window on a fixed fleet point and map the "
                        "occupancy vs p99 frontier (docs/execution.md)")
    g = p.add_argument_group("cache-split tuning (--tune-split)")
    g.add_argument("--tune-split", action="store_true",
                   help="split the --cache-gb budget across --tenants: "
                        "analytic screen + refinement on real static-"
                        "policy fleet runs (docs/tenancy.md)")
    g.add_argument("--tenants", default=None, metavar="SPEC.JSON",
                   help="tenant spec file (same schema as python -m "
                        "repro.fleet --tenants)")
    g.add_argument("--mrc-curves", default=None, metavar="MRC.JSON",
                   help="price the split screen from measured miss-"
                        "ratio curves (an artifact written by a fleet "
                        "run's --mrc PATH) instead of the analytic "
                        "Che-approximation profiles")
    g.add_argument("--split-steps", type=int, default=8,
                   help="screen granularity: simplex steps per tenant")
    g.add_argument("--refine-top", type=int, default=3,
                   help="screen candidates to refine on real runs")
    g.add_argument("--shards", type=int, default=2,
                   help="fleet point for the refinement runs")
    g.add_argument("--replicas", type=int, default=1,
                   help="fleet point for the refinement runs")
    t = p.add_argument_group("tier-split tuning (--tune-tier)")
    t.add_argument("--tune-tier", action="store_true",
                   help="split a fixed $/hour budget across fleet width, "
                        "DRAM cache and the local NVMe tier: analytic "
                        "screen + refinement on real tiered fleet runs "
                        "(docs/storage.md)")
    t.add_argument("--budget-usd-hour", type=float, default=0.0,
                   metavar="USD",
                   help="the hourly budget to split (required; priced "
                        "with --pricebook, default price book otherwise)")
    t.add_argument("--tier-steps", type=int, default=6,
                   help="screen granularity: DRAM-share steps per width")
    t.add_argument("--tier-widths", default="1,2,4", metavar="W,W,...",
                   help="fleet widths the screen considers")
    p.add_argument("--device", default=None,
                   help="where the index builds and the exact ground truths "
                        "run, and where a graph index keeps its PQ codes "
                        "(default: cuda; raises without a card; 'cpu' runs "
                        "the plain PyTorch versions)")
    add_exec_args(p)
    add_scenario_args(p, faults=False)
    add_obs_args(p)
    add_monitor_args(p)
    add_common_args(p)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    w = WorkloadSpec(n=args.n, dim=args.dim, dtype=args.dtype,
                     target_recall=args.recall,
                     concurrency=args.concurrency, query_dist=args.dist,
                     zipf_a=args.zipf_a, k=args.k,
                     write_rate_qps=args.write_rate)
    try:
        storage = resolve_storage(args.storage)
    except KeyError as e:
        build_parser().error(str(e.args[0]))
    env = EnvSpec(storage=storage,
                  cache_bytes=int(args.cache_gb * 2**30))

    tracer = tracer_from_args(args)
    parser = build_parser()
    monitor = monitor_from_args(args, parser)
    pricebook = pricebook_from_args(args, parser)
    if monitor is not None and not args.fleet:
        parser.error("--monitor applies to the fleet-sizing validation "
                     "rerun; add --fleet (index tuning has no serving "
                     "run to monitor)")
    if pricebook is not None and not (args.fleet or args.tune_tier):
        parser.error("--pricebook applies to the fleet-sizing validation "
                     "rerun or the --tune-tier budget screen; add --fleet "
                     "or --tune-tier")
    if monitor is not None and monitor.recall_target is not None:
        parser.error("--recall-slo is a serving-run knob (python -m "
                     "repro.fleet); the sizing rerun has no precomputed "
                     "ground truth to judge live recall against")
    if args.tune_split:
        if args.fleet or args.tune_window or args.tune_tier:
            parser.error("--tune-split is its own mode; drop --fleet/"
                         "--tune-window/--tune-tier")
        if not args.tenants:
            parser.error("--tune-split needs --tenants SPEC.JSON")
        if args.cache_gb <= 0:
            parser.error("--tune-split splits the --cache-gb budget; "
                         "give a budget > 0")
    elif args.tenants:
        parser.error("--tenants belongs to --tune-split")
    elif args.mrc_curves and not args.tune_tier:
        parser.error("--mrc-curves belongs to --tune-split/--tune-tier")
    if args.tune_tier:
        if args.fleet or args.tune_window:
            parser.error("--tune-tier is its own mode; drop --fleet/"
                         "--tune-window")
        if args.budget_usd_hour <= 0:
            parser.error("--tune-tier splits an hourly dollar budget; "
                         "give --budget-usd-hour > 0")
        if args.cache_gb:
            parser.error("--cache-gb conflicts with --tune-tier (the "
                         "DRAM budget is a tuned output, priced from "
                         "--budget-usd-hour)")
    elif args.budget_usd_hour:
        parser.error("--budget-usd-hour belongs to --tune-tier")
    exec_kw = None
    if args.tune_window:
        if args.batch_window_us:
            parser.error("--batch-window-us conflicts with --tune-window "
                         "(the window is the swept axis)")
        if args.fleet:
            parser.error("--tune-window sweeps one fixed fleet point; "
                         "drop --fleet (size the fleet first, then tune "
                         "its window)")
    else:
        fields = exec_fields_from_args(args, parser)
        if args.backend == "kernel":
            if not args.fleet and not args.tune_split:
                parser.error("--backend kernel applies to fleet sweeps; "
                             "add --fleet (or --tune-window; the index "
                             "tuner has no serving fleet to price)")
            exec_kw = fields
    device = resolve_device(args.device)
    from repro_torch.obs import run_manifest

    if args.tune_split:
        import json as _json

        from repro_torch.fleet import FleetConfig
        from repro_torch.tenancy import load_tenant_specs
        from repro_torch.tuning.tenancy import tune_cache_split
        specs = load_tenant_specs(args.tenants)
        mrc = None
        if args.mrc_curves:
            with open(args.mrc_curves) as f:
                mrc = _json.load(f)
        cfg = FleetConfig(
            n_shards=args.shards, replication=args.replicas,
            storage=storage, concurrency=args.concurrency,
            cache_bytes=env.cache_bytes, cache_policy="slru",
            seed=args.seed, **fields)
        t0 = time.perf_counter()
        rec = tune_cache_split(specs, cfg, steps=args.split_steps,
                               refine_top=args.refine_top, mrc=mrc,
                               device=device)
        out = rec.to_dict()
        out["meta"] = run_manifest(
            seed=args.seed,
            config=dict(mode="cache-split", tenants=args.tenants,
                        mrc_curves=args.mrc_curves,
                        cache_bytes=env.cache_bytes),
            wall_s=time.perf_counter() - t0)
        emit_json(out, args)
        return 0

    if args.tune_tier:
        import json as _json

        from repro_torch.tuning.tier import tune_tier_split
        mrc = None
        if args.mrc_curves:
            with open(args.mrc_curves) as f:
                mrc = _json.load(f)
        try:
            widths = tuple(int(x) for x in args.tier_widths.split(",")
                           if x.strip())
            if not widths:
                raise ValueError
        except ValueError:
            parser.error("--tier-widths wants comma-separated ints, got "
                         f"{args.tier_widths!r}")
        t0 = time.perf_counter()
        try:
            rec = tune_tier_split(
                w, env, args.budget_usd_hour, book=pricebook,
                widths=widths, steps=args.tier_steps,
                refine_top=args.refine_top, mrc=mrc, seed=args.seed,
                device=device)
        except ValueError as e:
            parser.error(str(e))
        out = rec.to_dict()
        out["meta"] = run_manifest(
            seed=args.seed,
            config=dict(mode="tier-split",
                        budget_usd_per_hour=args.budget_usd_hour,
                        pricebook=rec.pricebook,
                        mrc_curves=args.mrc_curves),
            wall_s=time.perf_counter() - t0)
        emit_json(out, args)
        return 0

    if args.tune_window:
        try:
            scenario = scenario_from_args(args)
        except ValueError as e:
            build_parser().error(str(e))
        t0 = time.perf_counter()
        rec = tune_batch_window(
            w, env,
            scenario=scenario if scenario.kind != "closed" else None,
            calibration=args.calibration, goodput_target=args.goodput,
            seed=args.seed, device=device)
        out = rec.to_dict()
        if tracer is not None:
            # traced validation rerun at the recommended window (the
            # sweep itself stays untraced; see trace_fleet_point)
            from repro_torch.tuning.fleet import trace_fleet_point
            trace_fleet_point(
                w, env, rec.point, scenario=scenario, tracer=tracer,
                exec_kw=dict(backend="kernel",
                             batch_window_s=rec.window_us * 1e-6,
                             calibration=args.calibration),
                seed=args.seed, device=device)
        out["meta"] = run_manifest(
            seed=args.seed,
            config=dict(mode="batch-window", **dataclasses.asdict(w)),
            wall_s=time.perf_counter() - t0)
        emit_obs(out, args, tracer)
        emit_json(out, args)
        return 0

    if args.fleet:
        try:
            scenario = scenario_from_args(args)
        except ValueError as e:
            build_parser().error(str(e))
        t0 = time.perf_counter()
        if scenario.kind == "closed":
            rec = tune_fleet(w, env, target_speedup=args.target_speedup,
                             hedge=args.hedge, exec_kw=exec_kw,
                             seed=args.seed, device=device)
        else:
            rec = tune_fleet_for_load(w, env, scenario,
                                      goodput_target=args.goodput,
                                      hedge=args.hedge, exec_kw=exec_kw,
                                      seed=args.seed, device=device)
        out = rec.to_dict()
        if tracer is not None or monitor is not None \
                or pricebook is not None:
            # validation rerun of the winning point (the sweep itself
            # stays untraced/unmetered; see trace_fleet_point) — the
            # recommendation carries its alert log and dollar estimate
            from repro_torch.tuning.fleet import trace_fleet_point
            vrep = trace_fleet_point(w, env, rec.point, scenario=scenario,
                                     tracer=tracer, monitor=monitor,
                                     pricebook=pricebook, exec_kw=exec_kw,
                                     seed=args.seed, device=device)
            if vrep.alerts is not None:
                out["alerts"] = vrep.alerts
            if vrep.cost is not None:
                out["cost"] = vrep.cost
        out["meta"] = run_manifest(
            seed=args.seed,
            config=dict(mode="fleet", **dataclasses.asdict(w)),
            wall_s=time.perf_counter() - t0)
        emit_obs(out, args, tracer)
        emit_json(out, args)
        return 0

    if args.budget == "screen":
        budget: EvalBudget | str = "screen"
    elif args.budget == "quick":
        rungs = ((400, 20), (800, 32)) if args.dim >= 512 \
            else ((1200, 32), (2400, 48))
        budget = EvalBudget(rungs=rungs, max_rung0=10, seed=args.seed)
    else:
        budget = None                      # default_budget inside autotune
    t0 = time.perf_counter()
    rec = autotune(w, env, budget=budget, kinds=tuple(
        k.strip() for k in args.kinds.split(",") if k.strip()),
        device=device)
    if tracer is not None:
        # traced validation rerun of the recommended config (the halving
        # sweep stays untraced; see trace_candidate)
        from repro_torch.tuning.evaluate import trace_candidate
        trace_candidate(w, env, rec.config, tracer=tracer, seed=args.seed,
                        device=device)
    out = rec.to_dict()
    if args.write_rate > 0:
        # the workload churns: also pick the compaction knobs for the
        # recommended index config (analytic screen; --budget != screen
        # refines the top points on the real engine)
        from repro_torch.tuning.ingest import tune_ingest
        refine = 0 if args.budget == "screen" else 3
        out["ingest"] = tune_ingest(w, env, rec.config, refine=refine,
                                    seed=args.seed, device=device).to_dict()
    out["meta"] = run_manifest(
        seed=args.seed,
        config=dict(mode="index", budget=args.budget,
                    **dataclasses.asdict(w)),
        wall_s=time.perf_counter() - t0)
    emit_obs(out, args, tracer)
    emit_json(out, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
