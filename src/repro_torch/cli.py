"""Shared CLI plumbing for ``python -m repro_torch.fleet`` / ``python -m
repro_torch.tuning``.

Both CLIs previously duplicated seed/JSON/output handling; with scenario
serving they also share the whole scenario axis (``--scenario
{closed,poisson,burst,trace}`` plus rate/duration/SLO knobs, fault
schedules and autoscaling).  One definition here keeps flags, defaults
and JSON emission identical across entry points.

The port's own copy of ``repro.cli``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.sim.arrivals import ARRIVAL_KINDS, Scenario
from repro_torch.sim.autoscale import AutoscaleConfig
from repro_torch.sim.faults import FaultSchedule


def add_common_args(p: argparse.ArgumentParser, *, seed: int = 0) -> None:
    """--seed / --compact / --out: determinism and emission knobs."""
    p.add_argument("--seed", type=int, default=seed)
    p.add_argument("--compact", action="store_true",
                   help="single-line JSON output")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="also write the JSON report to PATH")


def add_exec_args(p: argparse.ArgumentParser) -> None:
    """--backend / --batch-window-us / --calibration: the execution-
    backend axis (repro_torch.exec; see docs/execution.md)."""
    g = p.add_argument_group("execution backend")
    g.add_argument("--backend", choices=["analytic", "kernel"],
                   default="analytic",
                   help="compute pricing: hand-set ComputeSpec constants "
                        "(analytic) or batch-coalesced, measured "
                        "CalibrationTable pricing (kernel)")
    g.add_argument("--batch-window-us", type=float, default=0.0,
                   metavar="US",
                   help="kernel backend: per-shard batch-coalescing "
                        "window in microseconds (0 = per-job dispatch)")
    g.add_argument("--calibration", default=None, metavar="TABLE.JSON",
                   help="kernel backend: CalibrationTable JSON to price "
                        "from (default: the committed measured table)")


def exec_fields_from_args(args, parser: argparse.ArgumentParser = None
                          ) -> dict:
    """FleetConfig kwargs for the execution-backend axis (validated)."""
    if args.backend == "analytic" and (args.batch_window_us
                                       or args.calibration):
        msg = ("--batch-window-us/--calibration are kernel-backend "
               "knobs; add --backend kernel")
        if parser is not None:
            parser.error(msg)
        raise ValueError(msg)
    return dict(backend=args.backend,
                batch_window_s=args.batch_window_us * 1e-6,
                calibration=args.calibration)


def add_obs_args(p: argparse.ArgumentParser) -> None:
    """--trace / --attrib: the observability axis (repro_torch.obs)."""
    g = p.add_argument_group("observability")
    g.add_argument("--trace", default=None, metavar="PATH",
                   help="record a span trace and write Chrome-trace/"
                        "Perfetto JSON to PATH (open at ui.perfetto.dev)")
    g.add_argument("--attrib", action="store_true",
                   help="print a critical-path attribution breakdown "
                        "(and include it in the JSON report)")
    g.add_argument("--explain", nargs="?", const="-", default=None,
                   metavar="PATH",
                   help="explain the latency tail: exemplar reservoirs, "
                        "windowed attribution and alert forensics "
                        "(repro.obs.explain); the report gains an "
                        "'explain' block, a summary renders to stderr, "
                        "and with PATH the full report is also written "
                        "there as JSON (implies tracing)")
    g.add_argument("--mrc", nargs="?", const="-", default=None,
                   metavar="PATH",
                   help="profile online miss-ratio curves per tenant "
                        "(SHARDS sampled ghost, repro.obs.mrc); the "
                        "report gains an 'mrc' block, and with PATH the "
                        "curves artifact is also written there — feed it "
                        "to 'python -m repro.tuning --tune-split --mrc'")


def tracer_from_args(args):
    """A live Tracer when --trace/--attrib/--explain asked for one,
    else None."""
    from repro_torch.obs import Tracer
    if (getattr(args, "trace", None) or getattr(args, "attrib", False)
            or getattr(args, "explain", None)):
        return Tracer()
    return None


def _write_artifact(path: str, payload: dict) -> None:
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    print(f"# wrote {path}", file=sys.stderr)


def emit_obs(out: dict, args, tracer) -> None:
    """Fold the observability outputs into the report payload.

    Renderings go to stderr so stdout stays machine-parseable; the
    Chrome trace goes to the ``--trace`` path, and the ``--explain`` /
    ``--mrc`` blocks (already inside ``out`` via the report summary)
    are additionally written as standalone artifacts when those flags
    carry a PATH.
    """
    def block(key):
        # the report summary nests the block at report.<key> (single
        # fleet run) or report.fleet.<key> (multi-tenant run)
        rep = out.get("report", out)
        return rep.get(key, rep.get("fleet", {}).get(key))

    if getattr(args, "explain", None) and block("explain") is not None:
        from repro_torch.obs.explain import render_explain
        print(render_explain(block("explain")), file=sys.stderr)
        if args.explain != "-":
            _write_artifact(args.explain, block("explain"))
    if getattr(args, "mrc", None) and args.mrc != "-" \
            and block("mrc") is not None:
        _write_artifact(args.mrc, block("mrc"))
    if tracer is None:
        return
    from repro_torch.obs import attribute, write_chrome_trace
    if args.attrib:
        rep = attribute(tracer)
        out["attrib"] = rep.to_dict()
        print(rep.render(), file=sys.stderr)
    if args.trace:
        write_chrome_trace(args.trace, tracer)
        print(f"# wrote {args.trace}", file=sys.stderr)


def add_monitor_args(p: argparse.ArgumentParser) -> None:
    """--monitor / --alert-actions / --pricebook: live SLO monitoring
    and dollar metering (repro_torch.obs.monitor / repro_torch.obs.cost)."""
    g = p.add_argument_group("monitoring / costing")
    g.add_argument("--monitor", action="store_true",
                   help="attach live SLO monitors with burn-rate "
                        "alerting (alert log lands in the JSON report; "
                        "observation only unless --alert-actions)")
    g.add_argument("--monitor-interval", type=float, default=0.05,
                   help="rule-evaluation tick in virtual seconds")
    g.add_argument("--alert-actions", action="store_true",
                   help="let alerts actuate: scale-out on a page-"
                        "severity latency burn, tenant deprioritization "
                        "on a sustained ticket burn (requires --monitor;"
                        " the run is no longer bit-exact vs unmonitored)")
    g.add_argument("--recall-slo", type=float, default=None,
                   metavar="FLOOR",
                   help="with --monitor: also watch live recall@k "
                        "against this floor (computes ground truth "
                        "before the run; pure-query scenarios only)")
    g.add_argument("--pricebook", default=None, metavar="NAME|PATH",
                   help="price the run in dollars: a preset name "
                        "(default, egress-heavy, dense-cache) or a JSON "
                        "file of PriceBook fields (docs/cost.md)")


def monitor_from_args(args, parser: argparse.ArgumentParser = None):
    """A MonitorConfig when --monitor asked for one, else None."""
    from repro_torch.obs import MonitorConfig
    if not args.monitor:
        if args.alert_actions or args.recall_slo is not None:
            flag = ("--alert-actions" if args.alert_actions
                    else "--recall-slo")
            msg = f"{flag} requires --monitor"
            if parser is not None:
                parser.error(msg)
            raise SystemExit(f"error: {msg}")
        return None
    return MonitorConfig(interval_s=args.monitor_interval,
                         actions=args.alert_actions,
                         recall_target=args.recall_slo)


def pricebook_from_args(args, parser: argparse.ArgumentParser = None):
    """A PriceBook when --pricebook named one, else None."""
    if args.pricebook is None:
        return None
    from repro_torch.obs import resolve_pricebook
    try:
        return resolve_pricebook(args.pricebook)
    except (KeyError, ValueError) as e:
        msg = str(e).strip('"')
        if parser is not None:
            parser.error(msg)
        raise SystemExit(f"error: {msg}")


def add_scenario_args(p: argparse.ArgumentParser, *,
                      faults: bool = True) -> None:
    """The arrival-scenario axis shared by fleet and tuning.

    ``faults=False`` (the tuner) registers only the arrival/SLO knobs:
    fault injection and autoscaling act on a single concrete run, which
    is ``python -m repro_torch.fleet``'s job, not the sizing sweep's.
    """
    g = p.add_argument_group("scenario")
    g.add_argument("--scenario", choices=list(ARRIVAL_KINDS),
                   default="closed",
                   help="arrival process: closed (paper harness), poisson "
                        "(open loop), burst (poisson with a spike), trace "
                        "(zipf-repeated replay)")
    g.add_argument("--rate", type=float, default=200.0,
                   help="offered load in QPS (open-loop scenarios)")
    g.add_argument("--duration", type=float, default=None,
                   help="arrival horizon in virtual seconds")
    g.add_argument("--arrivals", type=int, default=None,
                   help="cap on total arrivals (cycles the query set)")
    g.add_argument("--slo-ms", type=float, default=50.0,
                   help="p99 SLO in milliseconds (goodput / autoscaling)")
    g.add_argument("--burst-factor", type=float, default=4.0)
    g.add_argument("--burst-start", type=float, default=0.25,
                   help="burst window start (virtual seconds)")
    g.add_argument("--burst-len", type=float, default=0.25)
    g.add_argument("--trace-zipf-a", type=float, default=1.2,
                   help="trace popularity skew (zipf exponent)")
    w = p.add_argument_group("read-write mix (--scenario rw)")
    w.add_argument("--write-rate", type=float, default=0.0,
                   help="update arrivals per virtual second (0 = pure "
                        "query run, bit-identical to --scenario closed)")
    w.add_argument("--n-updates", type=int, default=None,
                   help="cap on total updates (default: write rate x 1s)")
    w.add_argument("--delete-frac", type=float, default=0.2,
                   help="delete share of the update stream")
    w.add_argument("--delta-kb", type=float, default=256.0,
                   help="delta-tier (memtable) capacity per site, KiB")
    w.add_argument("--flush-frac", type=float, default=0.5,
                   help="flush trigger as a fraction of the delta cap")
    w.add_argument("--compaction-par", type=int, default=1,
                   help="concurrent background compaction jobs per site")
    if not faults:
        return
    g.add_argument("--fail", action="append", default=[],
                   metavar="SHARD:T_FAIL[:T_RECOVER]",
                   help="kill shard SHARD at T_FAIL (revive at T_RECOVER); "
                        "repeatable")
    g.add_argument("--autoscale", action="store_true",
                   help="enable the SLO-driven instance autoscaler")
    g.add_argument("--autoscale-max", type=int, default=4,
                   help="max serving instances per shard")
    g.add_argument("--series-dt", type=float, default=None,
                   help="time-series slice width (default 0.05s when a "
                        "non-closed scenario, fault or autoscaler is on)")


def scenario_from_args(args) -> Scenario:
    return Scenario(
        kind=args.scenario, rate_qps=args.rate, duration_s=args.duration,
        n_arrivals=args.arrivals, burst_factor=args.burst_factor,
        burst_start_s=args.burst_start, burst_len_s=args.burst_len,
        zipf_a=args.trace_zipf_a, slo_s=args.slo_ms * 1e-3,
        write_rate_qps=getattr(args, "write_rate", 0.0),
        n_updates=getattr(args, "n_updates", None),
        delete_frac=getattr(args, "delete_frac", 0.2))


def ingest_from_args(args):
    """The compaction knobs (only consulted on rw runs)."""
    from repro_torch.ingest.compaction import IngestConfig
    return IngestConfig(
        delta_cap_bytes=int(args.delta_kb * 1024),
        flush_frac=args.flush_frac,
        compaction_parallelism=args.compaction_par)


def faults_from_args(args) -> FaultSchedule | None:
    return FaultSchedule.parse(args.fail) if args.fail else None


def autoscale_from_args(args) -> AutoscaleConfig | None:
    if not args.autoscale:
        return None
    return AutoscaleConfig(slo_p99_s=args.slo_ms * 1e-3,
                           max_instances=args.autoscale_max)


def emit_json(payload: dict, args) -> None:
    """Print (and optionally persist) the deterministic JSON report."""
    text = json.dumps(payload, indent=None if args.compact else 2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
            f.write("\n")
        print(f"# wrote {args.out}", file=sys.stderr)
