"""Fleet sizing as a tuning axis: shard count × replication as evaluable
points (the ROADMAP's "tuner-driven replica/centroid re-partitioning").

The single-node tuner answers *which index and knobs*; this module
answers *how many shards and how many replicas* once one node isn't
enough.  Each :class:`FleetPoint` is priced by running the real fleet —
partition, scatter-gather router, shard engines — on a subsampled
workload analogue (the same scaling discipline as
``tuning.evaluate``), and the sweep shares one index build across all
points because only the *placement* changes.

Selection is cost-first: the smallest fleet (shards × replication =
machines × stored copies) whose measured speedup over one shard meets
``target_speedup`` and whose recall meets the workload target.  Replica
count matters beyond fault tolerance: R >= 2 unlocks
power-of-two-choices balancing and hedging, at the price of extra
storage and diluted per-shard cache.

The port's own copy of ``repro.tuning.fleet``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code apart from its ``device`` lines. The sweep's eval index and its exact
ground truth are built where ``device`` says (default: the card).
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.core.cluster_index import ClusterIndex
from repro_torch.core.flat import exact_topk
from repro_torch.core.types import ClusterIndexParams, SearchParams
from repro_torch.data.synth import DatasetSpec, make_dataset
from repro_torch.fleet.partition import ClusterPartition
from repro_torch.fleet.router import FleetConfig, FleetRouter
from repro_torch.sim.arrivals import Scenario
from repro_torch.tuning.space import EnvSpec, WorkloadSpec

SHARD_GRID = (1, 2, 4, 8)
FLEET_REPLICA_GRID = (1, 2)
#: batch-window sweep grid (µs) for the kernel execution backend
WINDOW_GRID_US = (0.0, 50.0, 100.0, 200.0, 500.0, 1000.0)


@dataclasses.dataclass(frozen=True)
class FleetPoint:
    """One evaluable fleet configuration (the tuner's new axes)."""

    n_shards: int
    replication: int = 1
    hedge: bool = False

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if not 1 <= self.replication <= self.n_shards:
            raise ValueError(
                f"replication must be in [1, {self.n_shards}], got "
                f"{self.replication}")

    @property
    def machines(self) -> int:
        return self.n_shards

    @property
    def stored_copies(self) -> int:
        return self.replication

    def label(self) -> str:
        h = ",hedge" if self.hedge else ""
        return f"fleet[S={self.n_shards},R={self.replication}{h}]"

    def to_dict(self) -> dict:
        return dict(n_shards=self.n_shards, replication=self.replication,
                    hedge=self.hedge)


@dataclasses.dataclass
class FleetOutcome:
    """Measured behaviour of one fleet point at eval scale."""

    point: FleetPoint
    qps: float
    speedup: float                 # vs the 1-shard baseline of this sweep
    p99_s: float
    recall: float
    load_imbalance: float
    hedge_rate: float
    shed_rate: float
    eval_n: int

    @property
    def cost_units(self) -> int:
        """Machines × stored copies — what the fleet bills for."""
        return self.point.n_shards * self.point.replication

    def to_dict(self) -> dict:
        return dict(config=self.point.to_dict(),
                    qps_eval=round(self.qps, 2),
                    speedup=round(self.speedup, 3),
                    p99_s=round(self.p99_s, 6),
                    recall=round(self.recall, 4),
                    load_imbalance=round(self.load_imbalance, 4),
                    hedge_rate=round(self.hedge_rate, 4),
                    shed_rate=round(self.shed_rate, 4),
                    cost_units=self.cost_units, eval_n=self.eval_n)


@dataclasses.dataclass
class FleetRecommendation:
    """Sweep result: the cheapest fleet that meets the targets."""

    workload: WorkloadSpec
    env_storage: str
    point: FleetPoint
    speedup: float
    feasible: bool                 # meets target_speedup AND recall target
    target_speedup: float
    outcomes: list[FleetOutcome]

    def to_dict(self) -> dict:
        return dict(
            workload=dataclasses.asdict(self.workload),
            environment=dict(storage=self.env_storage),
            recommendation=self.point.to_dict(),
            speedup=round(self.speedup, 3),
            meets_target=self.feasible,
            target_speedup=self.target_speedup,
            sweep=[o.to_dict() for o in self.outcomes])

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)


def _eval_index(w: WorkloadSpec, eval_n: int, nq: int, seed: int,
                device=None):
    n = min(eval_n, w.n)
    spec = DatasetSpec("fleet-analog", w.dim, w.dtype, n, nq,
                       n_clusters=max(8, min(64, n // 16)),
                       intrinsic_dim=min(32, w.dim), seed=seed)
    data, queries = make_dataset(spec)
    gt, _ = exact_topk(data, queries, w.k, device=device)
    index = ClusterIndex.build(data, ClusterIndexParams(
        kmeans_iters=4, seed=seed), device=device)
    return index, queries, gt


def _fleet_cfg(w: WorkloadSpec, env: EnvSpec, point: FleetPoint,
               seed: int, exec_kw: dict | None = None) -> FleetConfig:
    """The sweep's concrete fleet config for one point — shared between
    closed-loop pricing, open-loop pricing and traced validation so all
    three measure the *same* fleet.  ``exec_kw`` selects the execution
    backend (``backend``/``batch_window_s``/``calibration`` FleetConfig
    fields; default analytic)."""
    # fixed total fleet cache: replication dilutes the per-shard share
    per_shard_cache = env.cache_bytes // point.n_shards
    return FleetConfig(
        n_shards=point.n_shards, replication=point.replication,
        storage=env.storage, concurrency=max(w.concurrency, 32),
        shard_concurrency=8, queue_depth=64,
        cache_bytes=per_shard_cache,
        cache_policy="slru" if per_shard_cache > 0 else "none",
        hedge=point.hedge, seed=seed, **(exec_kw or {}))


def evaluate_fleet_point(w: WorkloadSpec, env: EnvSpec, point: FleetPoint,
                         index, queries, gt, *, nprobe: int = 64,
                         baseline_qps: float | None = None,
                         exec_kw: dict | None = None,
                         seed: int = 0) -> FleetOutcome:
    """Run one fleet point on the shared eval index and measure it.

    The fleet question only exists under load: the driver holds enough
    closed-loop queries outstanding to saturate a single shard, so the
    sweep measures added *capacity*, not an idle latency floor.
    """
    params = SearchParams(k=w.k, nprobe=min(nprobe, index.meta.n_lists))
    cfg = _fleet_cfg(w, env, point, seed, exec_kw)
    partition = ClusterPartition.build(index.meta.list_nbytes,
                                       point.n_shards, point.replication)
    rep = FleetRouter(index, cfg, partition=partition).run(queries, params)
    qps = rep.qps
    return FleetOutcome(
        point=point, qps=qps,
        speedup=qps / baseline_qps if baseline_qps else 1.0,
        p99_s=rep.latency_percentile(99), recall=rep.recall_against(gt),
        load_imbalance=rep.load_imbalance, hedge_rate=rep.hedge_rate,
        shed_rate=rep.shed_rate, eval_n=index.meta.n_data)


def tune_fleet(w: WorkloadSpec, env: EnvSpec, target_speedup: float = 2.0,
               shard_grid: tuple[int, ...] = SHARD_GRID,
               replica_grid: tuple[int, ...] = FLEET_REPLICA_GRID,
               hedge: bool = False, eval_n: int = 1200, nq: int = 48,
               nprobe: int = 32, exec_kw: dict | None = None,
               seed: int = 0, device=None) -> FleetRecommendation:
    """Sweep shards × replication; pick the cheapest point meeting the
    speedup and recall targets (ties: higher QPS)."""
    index, queries, gt = _eval_index(w, eval_n, nq, seed, device=device)
    base = evaluate_fleet_point(
        w, env, FleetPoint(1, 1), index, queries, gt, nprobe=nprobe,
        exec_kw=exec_kw, seed=seed)
    outcomes = [dataclasses.replace(base, speedup=1.0)]
    for s in shard_grid:
        for r in replica_grid:
            if r > s or (s == 1 and r == 1):
                continue
            point = FleetPoint(s, r, hedge=hedge and r > 1)
            outcomes.append(evaluate_fleet_point(
                w, env, point, index, queries, gt, nprobe=nprobe,
                baseline_qps=base.qps, exec_kw=exec_kw, seed=seed))
    feas = [o for o in outcomes
            if o.speedup >= target_speedup
            and o.recall >= w.target_recall - 0.005]
    if feas:
        pick = min(feas, key=lambda o: (o.cost_units, -o.qps))
        feasible = True
    else:
        pick = max(outcomes, key=lambda o: (o.speedup, -o.cost_units))
        feasible = False
    return FleetRecommendation(
        workload=w, env_storage=env.storage.name, point=pick.point,
        speedup=pick.speedup, feasible=feasible,
        target_speedup=target_speedup, outcomes=outcomes)


# ------------------------------------------------- scenario-driven sizing --

@dataclasses.dataclass
class LoadOutcome:
    """One fleet point measured under an open-loop scenario."""

    point: FleetPoint
    offered_qps: float
    achieved_qps: float
    goodput_frac: float            # arrivals served within the SLO
    p99_sojourn_s: float           # arrival-to-completion p99
    recall: float
    shed_rate: float
    eval_n: int

    @property
    def cost_units(self) -> int:
        return self.point.n_shards * self.point.replication

    def to_dict(self) -> dict:
        return dict(config=self.point.to_dict(),
                    offered_qps=round(self.offered_qps, 2),
                    achieved_qps=round(self.achieved_qps, 2),
                    goodput_frac=round(self.goodput_frac, 4),
                    p99_sojourn_s=round(self.p99_sojourn_s, 6),
                    recall=round(self.recall, 4),
                    shed_rate=round(self.shed_rate, 4),
                    cost_units=self.cost_units, eval_n=self.eval_n)


@dataclasses.dataclass
class LoadRecommendation:
    """The cheapest fleet that serves an offered load within its SLO."""

    workload: WorkloadSpec
    env_storage: str
    scenario: Scenario
    point: FleetPoint
    feasible: bool
    goodput_target: float
    outcomes: list[LoadOutcome]

    def to_dict(self) -> dict:
        return dict(
            workload=dataclasses.asdict(self.workload),
            environment=dict(storage=self.env_storage),
            scenario=self.scenario.to_dict(),
            recommendation=self.point.to_dict(),
            meets_slo=self.feasible,
            goodput_target=self.goodput_target,
            sweep=[o.to_dict() for o in self.outcomes])

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)


def evaluate_fleet_load(w: WorkloadSpec, env: EnvSpec, point: FleetPoint,
                        scenario: Scenario, index, queries, gt, *,
                        nprobe: int = 32, exec_kw: dict | None = None,
                        seed: int = 0) -> LoadOutcome:
    """Run one fleet point under an open-loop scenario and measure
    whether it keeps up: achieved vs offered QPS, goodput under the SLO
    and p99 sojourn (arrival -> completion, backlog wait included)."""
    params = SearchParams(k=w.k, nprobe=min(nprobe, index.meta.n_lists))
    cfg = _fleet_cfg(w, env, point, seed, exec_kw)
    partition = ClusterPartition.build(index.meta.list_nbytes,
                                       point.n_shards, point.replication)
    arrivals = scenario.make_arrivals(len(queries), cfg.concurrency,
                                      seed=seed)
    rep = FleetRouter(index, cfg, partition=partition).run(
        queries, params, arrivals=arrivals, slo_s=scenario.slo_s)
    return LoadOutcome(
        point=point, offered_qps=rep.offered_qps, achieved_qps=rep.qps,
        goodput_frac=rep.goodput_frac,
        p99_sojourn_s=rep.sojourn_percentile(99),
        recall=rep.recall_against(gt), shed_rate=rep.shed_rate,
        eval_n=index.meta.n_data)


def tune_fleet_for_load(w: WorkloadSpec, env: EnvSpec, scenario: Scenario,
                        goodput_target: float = 0.99,
                        shard_grid: tuple[int, ...] = SHARD_GRID,
                        replica_grid: tuple[int, ...] = FLEET_REPLICA_GRID,
                        hedge: bool = False, eval_n: int = 1200,
                        nq: int = 48, nprobe: int = 32,
                        exec_kw: dict | None = None,
                        seed: int = 0, device=None) -> LoadRecommendation:
    """Size the fleet for an **offered load + SLO** instead of a speedup
    target: sweep shards × replication under the open-loop scenario and
    pick the cheapest point whose goodput (fraction of arrivals served
    within ``scenario.slo_s``) meets ``goodput_target`` at the workload's
    recall target.  Ties: lower p99 sojourn."""
    if scenario.kind == "closed":
        raise ValueError(
            "tune_fleet_for_load needs an open-loop scenario (poisson/"
            "burst/trace); use tune_fleet for closed-loop speedup targets")
    index, queries, gt = _eval_index(w, eval_n, nq, seed, device=device)
    outcomes = []
    for s in shard_grid:
        for r in replica_grid:
            if r > s:
                continue
            point = FleetPoint(s, r, hedge=hedge and r > 1)
            outcomes.append(evaluate_fleet_load(
                w, env, point, scenario, index, queries, gt,
                nprobe=nprobe, exec_kw=exec_kw, seed=seed))
    feas = [o for o in outcomes
            if o.goodput_frac >= goodput_target
            and o.recall >= w.target_recall - 0.005]
    if feas:
        pick = min(feas, key=lambda o: (o.cost_units, o.p99_sojourn_s))
        feasible = True
    else:
        pick = max(outcomes, key=lambda o: (o.goodput_frac, -o.cost_units))
        feasible = False
    return LoadRecommendation(
        workload=w, env_storage=env.storage.name, scenario=scenario,
        point=pick.point, feasible=feasible,
        goodput_target=goodput_target, outcomes=outcomes)


def trace_fleet_point(w: WorkloadSpec, env: EnvSpec, point: FleetPoint,
                      *, scenario: Scenario | None = None, tracer=None,
                      monitor=None, pricebook=None,
                      eval_n: int = 1200, nq: int = 48, nprobe: int = 32,
                      exec_kw: dict | None = None, seed: int = 0,
                      device=None):
    """Re-run one (typically: the recommended) fleet point with a tracer
    attached, on the same eval index and config recipe the sweep used.

    The sweep itself stays untraced — tracing all grid points would slow
    the search for spans nobody reads; the validation rerun shows *why*
    the winning point behaves as it does.  ``monitor``/``pricebook``
    (repro_torch.obs) attach live SLO monitors and dollar metering to the same
    rerun, so a sizing recommendation can carry an alert log and a cost
    estimate.  Returns the FleetReport; the spans land in ``tracer``.
    """
    index, queries, _ = _eval_index(w, eval_n, nq, seed, device=device)
    params = SearchParams(k=w.k, nprobe=min(nprobe, index.meta.n_lists))
    cfg = _fleet_cfg(w, env, point, seed, exec_kw)
    partition = ClusterPartition.build(index.meta.list_nbytes,
                                       point.n_shards, point.replication)
    arrivals = None
    slo_s = None
    if scenario is not None and scenario.kind != "closed":
        arrivals = scenario.make_arrivals(len(queries), cfg.concurrency,
                                          seed=seed)
        slo_s = scenario.slo_s
    return FleetRouter(index, cfg, partition=partition).run(
        queries, params, arrivals=arrivals, slo_s=slo_s, tracer=tracer,
        monitor=monitor, pricebook=pricebook)


# ---------------------------------------------------- batch-window tuning --

@dataclasses.dataclass
class WindowOutcome:
    """One batch-coalescing window measured on the kernel backend."""

    window_us: float
    achieved_qps: float
    p99_s: float                   # completion p99: latency (closed-loop)
    #                                or sojourn (open-loop)
    goodput_frac: float            # 1.0 on closed-loop runs (no SLO clock)
    recall: float
    mean_occupancy: float          # query-tile fill across MXU batches
    mean_batch_jobs: float         # jobs coalesced per batch
    batches: int
    eval_n: int

    def to_dict(self) -> dict:
        return dict(window_us=round(self.window_us, 3),
                    achieved_qps=round(self.achieved_qps, 2),
                    p99_s=round(self.p99_s, 6),
                    goodput_frac=round(self.goodput_frac, 4),
                    recall=round(self.recall, 4),
                    mean_occupancy=round(self.mean_occupancy, 4),
                    mean_batch_jobs=round(self.mean_batch_jobs, 3),
                    batches=self.batches, eval_n=self.eval_n)


@dataclasses.dataclass
class WindowRecommendation:
    """Sweep result: the highest-occupancy window still inside budget."""

    workload: WorkloadSpec
    env_storage: str
    point: FleetPoint
    scenario: Scenario | None
    window_us: float
    feasible: bool
    goodput_target: float
    p99_slack: float
    outcomes: list[WindowOutcome]

    def to_dict(self) -> dict:
        d = dict(
            workload=dataclasses.asdict(self.workload),
            environment=dict(storage=self.env_storage),
            fleet=self.point.to_dict(),
            recommendation=dict(backend="kernel",
                                batch_window_us=round(self.window_us, 3)),
            meets_target=self.feasible,
            goodput_target=self.goodput_target,
            p99_slack=self.p99_slack,
            sweep=[o.to_dict() for o in self.outcomes])
        if self.scenario is not None:
            d["scenario"] = self.scenario.to_dict()
        return d

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)


def _backend_stats(router) -> tuple[int, int, float]:
    """(batches, jobs_batched, occupancy_sum) summed across the fleet's
    shard-engine backends — read post-run, no tracer required."""
    batches = jobs = 0
    occ = 0.0
    for g in router.groups:
        for srv in g.all_servers():
            be = srv.engine.backend
            if be is None:
                continue
            batches += be.batches
            jobs += be.jobs_batched
            occ += be.occupancy_sum
    return batches, jobs, occ


def evaluate_batch_window(w: WorkloadSpec, env: EnvSpec, point: FleetPoint,
                          window_us: float, index, queries, gt, *,
                          scenario: Scenario | None = None,
                          calibration: str | None = None,
                          nprobe: int = 32, seed: int = 0) -> WindowOutcome:
    """Run one coalescing window on the kernel backend and measure the
    latency/occupancy trade it buys.  Occupancy and batch sizes come from
    the shard backends' own counters, so the sweep stays untraced."""
    params = SearchParams(k=w.k, nprobe=min(nprobe, index.meta.n_lists))
    cfg = _fleet_cfg(w, env, point, seed, dict(
        backend="kernel", batch_window_s=window_us * 1e-6,
        calibration=calibration))
    partition = ClusterPartition.build(index.meta.list_nbytes,
                                       point.n_shards, point.replication)
    router = FleetRouter(index, cfg, partition=partition)
    arrivals = None
    slo_s = None
    if scenario is not None and scenario.kind != "closed":
        arrivals = scenario.make_arrivals(len(queries), cfg.concurrency,
                                          seed=seed)
        slo_s = scenario.slo_s
    rep = router.run(queries, params, arrivals=arrivals, slo_s=slo_s)
    batches, jobs, occ = _backend_stats(router)
    open_loop = arrivals is not None
    return WindowOutcome(
        window_us=window_us, achieved_qps=rep.qps,
        p99_s=(rep.sojourn_percentile(99) if open_loop
               else rep.latency_percentile(99)),
        goodput_frac=rep.goodput_frac if open_loop else 1.0,
        recall=rep.recall_against(gt),
        mean_occupancy=occ / batches if batches else 0.0,
        mean_batch_jobs=jobs / batches if batches else 0.0,
        batches=batches, eval_n=index.meta.n_data)


def tune_batch_window(w: WorkloadSpec, env: EnvSpec,
                      point: FleetPoint | None = None, *,
                      scenario: Scenario | None = None,
                      window_grid_us: tuple[float, ...] = WINDOW_GRID_US,
                      calibration: str | None = None,
                      goodput_target: float = 0.99,
                      p99_slack: float = 0.2, eval_n: int = 1200,
                      nq: int = 48, nprobe: int = 32,
                      seed: int = 0, device=None) -> WindowRecommendation:
    """Sweep the kernel backend's coalescing window on one fleet point.

    Wider windows fold more concurrent scans into each MXU dispatch —
    higher query-tile occupancy, better-amortized unit cost — at the
    price of queueing delay.  The sweep maps that frontier; the pick is
    the highest-occupancy window that (a) meets the goodput and recall
    targets and (b) keeps p99 within ``1 + p99_slack`` of the sweep's
    p99 floor, ties broken toward lower p99.  When nothing qualifies the
    min-p99 window wins and ``feasible`` is False.
    """
    if point is None:
        point = FleetPoint(2, 1)
    index, queries, gt = _eval_index(w, eval_n, nq, seed, device=device)
    outcomes = [evaluate_batch_window(
        w, env, point, us, index, queries, gt, scenario=scenario,
        calibration=calibration, nprobe=nprobe, seed=seed)
        for us in window_grid_us]
    p99_floor = min(o.p99_s for o in outcomes)
    feas = [o for o in outcomes
            if o.goodput_frac >= goodput_target
            and o.recall >= w.target_recall - 0.005
            and o.p99_s <= p99_floor * (1.0 + p99_slack)]
    if feas:
        pick = max(feas, key=lambda o: (o.mean_occupancy, -o.p99_s))
        feasible = True
    else:
        pick = min(outcomes, key=lambda o: o.p99_s)
        feasible = False
    return WindowRecommendation(
        workload=w, env_storage=env.storage.name, point=point,
        scenario=scenario, window_us=pick.window_us, feasible=feasible,
        goodput_target=goodput_target, p99_slack=p99_slack,
        outcomes=outcomes)
