"""The port's serving fleet (``repro_torch.fleet``) on the CPU against the
JAX package's.

* the port reproduces ``tests/data/golden_fleet_prerefactor.json`` on its
  own cluster-index build;
* one sweep of fleet configurations runs both packages' ``run_fleet`` on
  the same cluster index and compares whole reports and per-query ids;
* the graph fleet on a converted reference graph index;
* a drift guard: every module copied from ``repro`` has the reference's
  code, up to docstrings and the package name in imports, except where a
  module is named below with its reason;
* the committed calibration table was measured on the card, and prices as
  the reference's class does.

Every comparison is exact unless a tolerance is given beside it.
"""
import ast
import difflib
import hashlib
import importlib
import json
import os
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.cluster_index import ClusterIndex as JClusterIndex  # noqa: E402
from repro.core.graph_index import GraphIndex as JGraphIndex  # noqa: E402
from repro.core.types import ClusterIndexParams as JClusterParams  # noqa: E402
from repro.core.types import GraphIndexParams as JGraphParams  # noqa: E402
from repro.exec import table as jtable  # noqa: E402
from repro_torch.convert import graph_index_from_reference  # noqa: E402
from repro_torch.core.cluster_index import ClusterIndex  # noqa: E402
from repro_torch.core.types import ClusterIndexParams  # noqa: E402
from repro_torch.data.synth import DEEP_ANALOG, make_dataset, scaled  # noqa: E402
from repro_torch.exec import table as ptable  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GOLDEN_PATH = ROOT / "tests" / "data" / "golden_fleet_prerefactor.json"
TABLE = ptable.DEFAULT_TABLE_PATH
ADC_RTOL, ADC_ATOL = 1e-5, 1e-4      # the reference's (tests/test_kernels.py)


def _pkg(name: str) -> SimpleNamespace:
    def m(mod):
        return importlib.import_module(f"{name}.{mod}")
    return SimpleNamespace(fleet=m("fleet"), arrivals=m("sim.arrivals"),
                           faults=m("sim.faults"), autoscale=m("sim.autoscale"),
                           obs=m("obs"), spec=m("storage.spec"),
                           types=m("core.types"), ingest=m("ingest"),
                           ci=m("core.cluster_index"),
                           gi=m("core.graph_index"),
                           dev={} if name == "repro" else {"device": "cpu"})


REF, PORT = _pkg("repro"), _pkg("repro_torch")


@pytest.fixture(scope="module")
def deep():
    data, queries = make_dataset(scaled(DEEP_ANALOG, 1200, 32))
    ref = JClusterIndex.build(data, JClusterParams(kmeans_iters=4, seed=0))
    port = ClusterIndex.build(data, ClusterIndexParams(kmeans_iters=4, seed=0),
                              device="cpu")
    return data, queries, ref, port


def _ids_sha256(report) -> str:
    h = hashlib.sha256()
    for r in sorted(report.records, key=lambda r: r.qid):
        h.update(np.asarray(r.qid).tobytes())
        h.update(np.asarray(r.ids, dtype=np.int64).tobytes())
    return h.hexdigest()


# ------------------------------------------------------------- golden --

@pytest.mark.parametrize("name", ["one_shard", "four_shard"])
def test_port_fleet_reproduces_the_golden_reports(deep, name):
    """The configurations of ``tests/test_scenarios.py``'s golden test, on
    the port's own index: virtual time at rel 1e-9, ids bit for bit."""
    _, queries, _, port = deep
    golden = json.loads(GOLDEN_PATH.read_text())
    F = PORT.fleet
    p = PORT.types.SearchParams(k=golden["params"]["k"],
                                nprobe=golden["params"]["nprobe"])
    cfg = dict(
        one_shard=F.FleetConfig(n_shards=1, replication=1, concurrency=8,
                                shard_concurrency=8, queue_depth=64, seed=0),
        four_shard=F.FleetConfig(n_shards=4, replication=2, concurrency=16,
                                 shard_concurrency=4, queue_depth=16,
                                 hedge=True, hedge_percentile=75.0, seed=5))[name]
    rep = F.run_fleet(port, queries, p, cfg)
    g = golden[name]
    assert rep.wall_time_s == pytest.approx(g["wall_time_s"], rel=1e-9, abs=1e-12)
    assert rep.qps == pytest.approx(g["qps"], rel=1e-9)
    assert _ids_sha256(rep) == g["ids_sha256"]


# ---------------------------------------------- configuration sweep --

HEDGED = dict(n_shards=4, replication=2, concurrency=16, shard_concurrency=4,
              queue_depth=16, hedge=True, hedge_percentile=75.0, seed=5)
KERNEL = dict(backend="kernel", calibration=TABLE)

#: name -> (FleetConfig fields, what else run_fleet gets: P -> kwargs)
CASES = {
    "1x1_closed": (dict(n_shards=1, replication=1, concurrency=8,
                        shard_concurrency=8, queue_depth=64, seed=0),
                   lambda P, nq: {}),
    "4x2_hedged": (HEDGED, lambda P, nq: {}),
    "slru_cache": (dict(n_shards=2, replication=2, concurrency=8,
                        cache_bytes=64 * 1024, cache_policy="slru", seed=1),
                   lambda P, nq: {}),
    "nvme_tier": (dict(n_shards=2, replication=1, concurrency=8,
                       cache_bytes=32 * 1024, cache_policy="slru",
                       nvme_bytes=4 << 20, seed=2),
                  lambda P, nq: {}),
    "poisson": (dict(n_shards=4, replication=2, concurrency=16,
                     shard_concurrency=4, queue_depth=16, seed=7),
                lambda P, nq: dict(arrivals=P.arrivals.Poisson(
                    rate_qps=400.0, n_total=2 * nq), slo_s=0.05)),
    "burst": (dict(n_shards=2, replication=2, concurrency=16, seed=8),
              lambda P, nq: dict(
                  arrivals=P.arrivals.Scenario(
                      kind="burst", rate_qps=150.0, duration_s=0.5,
                      slo_s=0.08).make_arrivals(nq, 16, seed=8),
                  slo_s=0.08)),
    "zipf_trace": (dict(n_shards=2, replication=1, concurrency=16,
                        cache_bytes=1 << 30, cache_policy="slru", seed=3),
                   lambda P, nq: dict(arrivals=P.arrivals.zipf_trace(
                       nq, rate_qps=300.0, n_total=150, seed=3))),
    "fail_recover": (dict(n_shards=4, replication=2, concurrency=16,
                          shard_concurrency=4, queue_depth=16, seed=7),
                     lambda P, nq: dict(
                         arrivals=P.arrivals.Poisson(rate_qps=400.0,
                                                     n_total=2 * nq),
                         slo_s=0.05,
                         faults=P.faults.FaultSchedule((P.faults.ShardFault(
                             shard=1, t_fail=0.01, t_recover=0.05),)))),
    "autoscale": (dict(n_shards=2, replication=1, concurrency=32,
                       shard_concurrency=4, queue_depth=32, seed=6),
                  lambda P, nq: dict(
                      arrivals=P.arrivals.Poisson(rate_qps=2000.0,
                                                  n_total=5 * nq),
                      slo_s=0.02,
                      autoscale=P.autoscale.AutoscaleConfig(
                          slo_p99_s=0.02, check_interval_s=0.01,
                          cooldown_s=0.02, max_instances=4))),
    "kernel_window0": (dict(HEDGED, batch_window_s=0.0, **KERNEL),
                       lambda P, nq: {}),
    "kernel_window200us": (dict(HEDGED, batch_window_s=200e-6, **KERNEL),
                           lambda P, nq: {}),
    "traced": (dict(HEDGED, batch_window_s=200e-6, **KERNEL),
               lambda P, nq: dict(tracer=P.obs.Tracer())),
    "monitor_pricebook": (HEDGED, lambda P, nq: dict(
        monitor=P.obs.MonitorConfig(),
        pricebook=P.obs.PRICEBOOKS["default"])),
    "explain": (dict(HEDGED, cache_bytes=64 * 1024, cache_policy="slru"),
                lambda P, nq: dict(tracer=P.obs.Tracer(), explain=True)),
    "mrc": (dict(HEDGED, cache_bytes=64 * 1024, cache_policy="slru"),
            lambda P, nq: dict(mrc=True)),
}

#: What follows the port's QUERY_TILE (32, the card's narrow ``l2_topk``
#: tile; the reference's is 8) in a traced kernel-backend run: the two
#: per-shard gauges, the occupancy histogram's counters and the batch
#: span's ``occupancy`` argument (ROADMAP, Queue 3).  The pricing does not
#: depend on the tile.
_OCCUPANCY = re.compile(r"^exec\.(shard\d+\.(batch_occupancy|pad_waste)"
                        r"|batch_occupancy\.\w+)$")


def _without_occupancy(doc):
    """The chrome-trace document with the tile-dependent values taken out."""
    events = []
    for ev in doc["traceEvents"]:
        ev = dict(ev)
        if _OCCUPANCY.match(ev.get("name", "")):
            continue
        if ev.get("name") == "batch_compute" and "args" in ev:
            ev["args"] = {k: v for k, v in ev["args"].items()
                          if k != "occupancy"}
        events.append(ev)
    return dict(doc, traceEvents=events)


def _run_case(P, index, queries, name):
    fields, extra = CASES[name]
    kw = extra(P, len(queries))
    p = P.types.SearchParams(k=10, nprobe=16)
    rep = P.fleet.run_fleet(index, queries, p, P.fleet.FleetConfig(**fields),
                            **kw)
    return rep, kw.get("tracer")


@pytest.mark.parametrize("name", list(CASES))
def test_fleet_configuration_gives_the_reference_report(deep, name):
    _, queries, ref_index, port_index = deep
    want, want_tr = _run_case(REF, ref_index, queries, name)
    got, got_tr = _run_case(PORT, port_index, queries, name)
    assert got.to_json() == want.to_json()
    assert [r.qid for r in got.records] == [r.qid for r in want.records]
    for a, b in zip(got.records, want.records):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)
    if name == "autoscale":
        assert any(e["action"] == "up" for e in want.scale_events)
    if name == "fail_recover":
        assert [e["event"] for e in want.fault_log] == ["fail", "recover"]
    if got_tr is not None:
        assert (_without_occupancy(PORT.obs.chrome_trace(got_tr))
                == _without_occupancy(REF.obs.chrome_trace(want_tr)))
        assert (PORT.obs.attribute(got_tr).to_dict()
                == REF.obs.attribute(want_tr).to_dict())


def test_traced_kernel_run_differs_only_in_the_tile_occupancy(deep):
    """The traced case above leaves out the occupancy values; here they
    are, and they follow each package's tile: 32 in the port, 8 in the
    reference."""
    from repro.exec.batched import QUERY_TILE as J_TILE
    from repro_torch.exec.batched import QUERY_TILE as P_TILE
    assert (P_TILE, J_TILE) == (32, 8)
    _, queries, ref_index, port_index = deep
    _, want_tr = _run_case(REF, ref_index, queries, "traced")
    _, got_tr = _run_case(PORT, port_index, queries, "traced")

    def batches(tr, attr):
        return [s.attrs[attr] for s in tr.spans if s.name == "batch_compute"]

    jobs = batches(got_tr, "jobs")
    assert jobs == batches(want_tr, "jobs")
    assert jobs, "the traced run coalesced no batch"
    for b, po, jo in zip(jobs, batches(got_tr, "occupancy"),
                         batches(want_tr, "occupancy")):
        assert po == round(b / (-(-b // P_TILE) * P_TILE), 4)
        assert jo == round(b / (-(-b // J_TILE) * J_TILE), 4)


# ------------------------------------------------------- graph fleet --

@pytest.fixture(scope="module")
def graph(deep):
    data, queries, _, _ = deep
    ref = JGraphIndex.build(data, JGraphParams(
        R=24, L_build=48, build_passes=1, pq_dims=24, seed=0))
    return queries, ref, graph_index_from_reference(ref, device="cpu")


@pytest.mark.parametrize("fields", [
    dict(n_shards=3, replication=2, concurrency=4, seed=0),
    dict(HEDGED, batch_window_s=200e-6, **KERNEL),
], ids=["3x2", "4x2_hedged_kernel"])
def test_graph_fleet_on_a_converted_index_gives_the_reference_report(graph, fields):
    """Ids equal; distances within the ADC tolerance (rtol 1e-5, atol
    1e-4); the summary equal (virtual time depends on counts and bytes)."""
    queries, ref, port = graph
    reps = []
    for P, index in ((REF, ref), (PORT, port)):
        p = P.types.SearchParams(k=10, search_len=40, beamwidth=8)
        reps.append(P.fleet.run_fleet(index, queries, p,
                                      P.fleet.FleetConfig(**fields)))
    want, got = reps
    assert got.summary() == want.summary()
    assert [r.qid for r in got.records] == [r.qid for r in want.records]
    for a, b in zip(got.records, want.records):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_allclose(a.dists, b.dists, rtol=ADC_RTOL,
                                   atol=ADC_ATOL)


# -------------------------------------------------------- drift guard --

#: Modules copied from ``repro`` (same relative paths).
COPIED = [
    "obs/trace.py", "obs/metrics.py", "obs/critical_path.py",
    "obs/explain.py", "obs/export.py", "obs/manifest.py", "obs/mrc.py",
    "obs/monitor.py", "obs/cost.py", "obs/__init__.py",
    "sim/kernel.py", "sim/__init__.py", "sim/arrivals.py",
    "sim/admission.py", "sim/faults.py", "sim/autoscale.py",
    "storage/spec.py", "storage/simulator.py", "storage/tier.py",
    "cache/slru.py", "core/cost_model.py",
    "serving/metrics.py", "serving/engine.py", "serving/workload.py",
    "serving/trace.py",
    "exec/backend.py", "exec/__init__.py", "exec/table.py",
    "fleet/partition.py", "fleet/server.py", "fleet/metrics.py",
    "fleet/router.py", "fleet/__init__.py", "fleet/__main__.py",
    "tuning/space.py", "cli.py", "storage/object_store.py",
    "ingest/memtable.py", "ingest/stream.py", "ingest/metrics.py",
    "ingest/mutable.py", "ingest/compaction.py", "ingest/__init__.py",
    "tenancy/spec.py", "tenancy/policy.py", "tenancy/metrics.py",
    "tenancy/fleet.py", "tenancy/__init__.py",
    "tuning/screen.py", "tuning/pareto.py", "tuning/evaluate.py",
    "tuning/recommend.py", "tuning/fleet.py", "tuning/tier.py",
    "tuning/tenancy.py", "tuning/ingest.py", "tuning/__init__.py",
    "tuning/__main__.py",
    "configs/__init__.py", "configs/base.py", "configs/archs.py",
    "configs/shapes.py", "configs/dbrx_132b.py", "configs/gemma_2b.py",
    "configs/internlm2_20b.py", "configs/llama32_vision_11b.py",
    "configs/mamba2_1p3b.py", "configs/moonshot_16b_a3b.py",
    "configs/musicgen_medium.py", "configs/qwen3_32b.py",
    "configs/recurrentgemma_2b.py", "configs/starcoder2_7b.py",
    "data/pipeline.py", "launch/report.py",
]

#: module -> (top-level definitions of the reference that the port leaves
#: out; why the port differs; the whole of the difference: the lines of
#: ``ast.unparse`` of both stripped modules that a line diff shows, "-" the
#: reference's and "+" the port's, in order)
ALLOWED = {
    "launch/report.py": (
        set(),
        "the table's default mesh is the port's production mesh, 32x8",
        [
            "-    ap.add_argument('--mesh', default='16x16')",
            "+    ap.add_argument('--mesh', default='32x8')",
        ]),
    "fleet/__main__.py": (
        set(),
        "--device picks where the index builds (the tenants' too) and the "
        "exact and churned ground truths run",
        [
            '+from repro_torch.device import resolve_device',
            "-    p = argparse.ArgumentParser(prog='python -m repro.fleet', "
            "description='Serve a synthetic workload across a sharded, "
            'replicated fleet and report tail latency, balance, hedge and '
            'shed rates — under closed-loop or open-loop '
            '(poisson/burst/trace) arrivals, with optional fault injection '
            "and SLO autoscaling.')",
            "+    p = argparse.ArgumentParser(prog='python -m "
            "repro_torch.fleet', description='Serve a synthetic workload "
            'across a sharded, replicated fleet and report tail latency, '
            'balance, hedge and shed rates — under closed-loop or open-loop '
            '(poisson/burst/trace) arrivals, with optional fault injection '
            "and SLO autoscaling.')",
            '+    p.add_argument(\'--device\', default=None, help="where the '
            'index build and the exact ground truth run, and where a graph '
            'index keeps its PQ codes (default: cuda; raises without a card; '
            '\'cpu\' runs the plain PyTorch versions)")',
            '+    device = resolve_device(args.device)',
            '-        return [materialize_tenant(s, base_seed=cfg.seed, '
            'tid=i) for i, s in enumerate(specs)]',
            '+        return [materialize_tenant(s, base_seed=cfg.seed, '
            'tid=i, device=device) for i, s in enumerate(specs)]',
            '-                gt_map[t.spec.name] = exact_topk(t.data, '
            't.queries, t.spec.k)[0]',
            '+                gt_map[t.spec.name] = exact_topk(t.data, '
            't.queries, t.spec.k, device=device)[0]',
            '-                gt = churn_ground_truth(t.data, '
            'queries=t.queries, k=t.spec.k, stream=t.updates)',
            '+                gt = churn_ground_truth(t.data, '
            'queries=t.queries, k=t.spec.k, stream=t.updates, device=device)',
            '-                gt, _ = exact_topk(t.data, t.queries, t.spec.k)',
            '+                gt, _ = exact_topk(t.data, t.queries, '
            't.spec.k, device=device)',
            '+    device = resolve_device(args.device)',
            '-        index = ClusterIndex.build(data, '
            'ClusterIndexParams(kmeans_iters=4, seed=args.seed))',
            '+        index = ClusterIndex.build(data, '
            'ClusterIndexParams(kmeans_iters=4, seed=args.seed), '
            'device=device)',
            '-        index = GraphIndex.build(data, GraphIndexParams(R=24, '
            'L_build=48, build_passes=1, pq_dims=default_pq_dims(args.dim), '
            'seed=args.seed))',
            '+        index = GraphIndex.build(data, GraphIndexParams(R=24, '
            'L_build=48, build_passes=1, pq_dims=default_pq_dims(args.dim), '
            'seed=args.seed), device=device)',
            '-            gt_pre, _ = exact_topk(data, queries, args.k)',
            '+            gt_pre, _ = exact_topk(data, queries, args.k, '
            'device=device)',
            '-            gt = churn_ground_truth(data, queries=queries, '
            'k=args.k, stream=updates)',
            '+            gt = churn_ground_truth(data, queries=queries, '
            'k=args.k, stream=updates, device=device)',
            '-            gt, _ = exact_topk(data, queries, args.k)',
            '+            gt, _ = exact_topk(data, queries, args.k, '
            'device=device)',
        ]),
    "ingest/stream.py": (
        set(),
        "churn_ground_truth takes the device of its exact top-k (default: "
        "the card)",
        [
            '-def churn_ground_truth(data: np.ndarray, stream: UpdateStream, '
            'queries: np.ndarray, k: int) -> np.ndarray:',
            '+def churn_ground_truth(data: np.ndarray, stream: UpdateStream, '
            'queries: np.ndarray, k: int, device=None) -> np.ndarray:',
            '-    idx, _ = exact_topk(corpus, queries, k)',
            '+    idx, _ = exact_topk(corpus, queries, k, device=device)',
        ]),
    "tenancy/fleet.py": (
        set(),
        "materialize_tenant takes the device of the tenant's index build "
        "(default: the card)",
        [
            '-def materialize_tenant(spec: TenantSpec, base_seed: int=0, '
            'tid: int=0) -> Tenant:',
            '+def materialize_tenant(spec: TenantSpec, base_seed: int=0, '
            'tid: int=0, device=None) -> Tenant:',
            '-        index = ClusterIndex.build(data, '
            'ClusterIndexParams(kmeans_iters=4, seed=seed))',
            '+        index = ClusterIndex.build(data, '
            'ClusterIndexParams(kmeans_iters=4, seed=seed), device=device)',
            '-        index = GraphIndex.build(data, GraphIndexParams(R=24, '
            'L_build=48, build_passes=1, pq_dims=default_pq_dims(spec.dim), '
            'seed=seed))',
            '+        index = GraphIndex.build(data, GraphIndexParams(R=24, '
            'L_build=48, build_passes=1, pq_dims=default_pq_dims(spec.dim), '
            'seed=seed), device=device)',
        ]),
    "tuning/evaluate.py": (
        set(),
        "each rung's exact ground truth and index builds run where "
        'device says (default: the card)',
        [
            '-    def __init__(self, w: WorkloadSpec, n: int, nq: int, '
            'seed: int):',
            '+    def __init__(self, w: WorkloadSpec, n: int, nq: int, '
            'seed: int, device=None):',
            '-        self.gt, _ = exact_topk(self.data, self.queries, w.k)',
            '+        self.gt, _ = exact_topk(self.data, self.queries, w.k, '
            'device=device)',
            '+        self.device = device',
            '-            idx = ClusterIndex.build(self.data, '
            'ClusterIndexParams(centroid_frac=c.centroid_frac, '
            'num_replica=c.num_replica, kmeans_iters=4, seed=self.seed))',
            '+            idx = ClusterIndex.build(self.data, '
            'ClusterIndexParams(centroid_frac=c.centroid_frac, '
            'num_replica=c.num_replica, kmeans_iters=4, seed=self.seed), '
            'device=self.device)',
            '-            idx = GraphIndex.build(self.data, '
            'GraphIndexParams(R=R_eval, L_build=max(24, 2 * R_eval), '
            'build_passes=1, pq_dims=default_pq_dims(self.data.shape[1]), '
            'seed=self.seed))',
            '+            idx = GraphIndex.build(self.data, '
            'GraphIndexParams(R=R_eval, L_build=max(24, 2 * R_eval), '
            'build_passes=1, pq_dims=default_pq_dims(self.data.shape[1]), '
            'seed=self.seed), device=self.device)',
            '-def trace_candidate(w: WorkloadSpec, env: EnvSpec, cand: '
            'Candidate, *, eval_n: int=800, nq: int=32, seed: int=0, '
            'tracer=None):',
            '-    rung = _Rung(w, eval_n, nq, seed)',
            '+def trace_candidate(w: WorkloadSpec, env: EnvSpec, cand: '
            'Candidate, *, eval_n: int=800, nq: int=32, seed: int=0, '
            'tracer=None, device=None):',
            '+    rung = _Rung(w, eval_n, nq, seed, device=device)',
            '-def successive_halving(w: WorkloadSpec, env: EnvSpec, '
            'screened: list[scr.Prediction], budget: EvalBudget | '
            'None=None) -> list[EvalOutcome]:',
            '+def successive_halving(w: WorkloadSpec, env: EnvSpec, '
            'screened: list[scr.Prediction], budget: EvalBudget | '
            'None=None, device=None) -> list[EvalOutcome]:',
            '-        rung = _Rung(w, n_sub, nq, seed=budget.seed + ri)',
            '+        rung = _Rung(w, n_sub, nq, seed=budget.seed + ri, '
            'device=device)',
        ]),
    "tuning/recommend.py": (
        set(),
        "autotune passes the device of its rungs' builds to "
        'successive_halving',
        [
            '-def autotune(workload: WorkloadSpec, env: EnvSpec, budget: '
            'ev.EvalBudget | str | None=None, kinds: tuple[str, '
            "...]=('cluster', 'graph'), seed: int=0) -> Recommendation:",
            '+def autotune(workload: WorkloadSpec, env: EnvSpec, budget: '
            'ev.EvalBudget | str | None=None, kinds: tuple[str, '
            "...]=('cluster', 'graph'), seed: int=0, device=None) -> "
            'Recommendation:',
            '-        outcomes = ev.successive_halving(workload, env, '
            'screened, eb)',
            '+        outcomes = ev.successive_halving(workload, env, '
            'screened, eb, device=device)',
        ]),
    "tuning/fleet.py": (
        set(),
        "the sweep's eval index and exact ground truth are built where "
        'device says (default: the card)',
        [
            '-def _eval_index(w: WorkloadSpec, eval_n: int, nq: int, seed: '
            'int):',
            '+def _eval_index(w: WorkloadSpec, eval_n: int, nq: int, seed: '
            'int, device=None):',
            '-    gt, _ = exact_topk(data, queries, w.k)',
            '-    index = ClusterIndex.build(data, '
            'ClusterIndexParams(kmeans_iters=4, seed=seed))',
            '+    gt, _ = exact_topk(data, queries, w.k, device=device)',
            '+    index = ClusterIndex.build(data, '
            'ClusterIndexParams(kmeans_iters=4, seed=seed), device=device)',
            '-def tune_fleet(w: WorkloadSpec, env: EnvSpec, target_speedup: '
            'float=2.0, shard_grid: tuple[int, ...]=SHARD_GRID, '
            'replica_grid: tuple[int, ...]=FLEET_REPLICA_GRID, hedge: '
            'bool=False, eval_n: int=1200, nq: int=48, nprobe: int=32, '
            'exec_kw: dict | None=None, seed: int=0) -> '
            'FleetRecommendation:',
            '-    index, queries, gt = _eval_index(w, eval_n, nq, seed)',
            '+def tune_fleet(w: WorkloadSpec, env: EnvSpec, target_speedup: '
            'float=2.0, shard_grid: tuple[int, ...]=SHARD_GRID, '
            'replica_grid: tuple[int, ...]=FLEET_REPLICA_GRID, hedge: '
            'bool=False, eval_n: int=1200, nq: int=48, nprobe: int=32, '
            'exec_kw: dict | None=None, seed: int=0, device=None) -> '
            'FleetRecommendation:',
            '+    index, queries, gt = _eval_index(w, eval_n, nq, seed, '
            'device=device)',
            '-def tune_fleet_for_load(w: WorkloadSpec, env: EnvSpec, '
            'scenario: Scenario, goodput_target: float=0.99, shard_grid: '
            'tuple[int, ...]=SHARD_GRID, replica_grid: tuple[int, '
            '...]=FLEET_REPLICA_GRID, hedge: bool=False, eval_n: int=1200, '
            'nq: int=48, nprobe: int=32, exec_kw: dict | None=None, seed: '
            'int=0) -> LoadRecommendation:',
            '+def tune_fleet_for_load(w: WorkloadSpec, env: EnvSpec, '
            'scenario: Scenario, goodput_target: float=0.99, shard_grid: '
            'tuple[int, ...]=SHARD_GRID, replica_grid: tuple[int, '
            '...]=FLEET_REPLICA_GRID, hedge: bool=False, eval_n: int=1200, '
            'nq: int=48, nprobe: int=32, exec_kw: dict | None=None, seed: '
            'int=0, device=None) -> LoadRecommendation:',
            '-    index, queries, gt = _eval_index(w, eval_n, nq, seed)',
            '+    index, queries, gt = _eval_index(w, eval_n, nq, seed, '
            'device=device)',
            '-def trace_fleet_point(w: WorkloadSpec, env: EnvSpec, point: '
            'FleetPoint, *, scenario: Scenario | None=None, tracer=None, '
            'monitor=None, pricebook=None, eval_n: int=1200, nq: int=48, '
            'nprobe: int=32, exec_kw: dict | None=None, seed: int=0):',
            '-    index, queries, _ = _eval_index(w, eval_n, nq, seed)',
            '+def trace_fleet_point(w: WorkloadSpec, env: EnvSpec, point: '
            'FleetPoint, *, scenario: Scenario | None=None, tracer=None, '
            'monitor=None, pricebook=None, eval_n: int=1200, nq: int=48, '
            'nprobe: int=32, exec_kw: dict | None=None, seed: int=0, '
            'device=None):',
            '+    index, queries, _ = _eval_index(w, eval_n, nq, seed, '
            'device=device)',
            '-def tune_batch_window(w: WorkloadSpec, env: EnvSpec, point: '
            'FleetPoint | None=None, *, scenario: Scenario | None=None, '
            'window_grid_us: tuple[float, ...]=WINDOW_GRID_US, calibration: '
            'str | None=None, goodput_target: float=0.99, p99_slack: '
            'float=0.2, eval_n: int=1200, nq: int=48, nprobe: int=32, seed: '
            'int=0) -> WindowRecommendation:',
            '+def tune_batch_window(w: WorkloadSpec, env: EnvSpec, point: '
            'FleetPoint | None=None, *, scenario: Scenario | None=None, '
            'window_grid_us: tuple[float, ...]=WINDOW_GRID_US, calibration: '
            'str | None=None, goodput_target: float=0.99, p99_slack: '
            'float=0.2, eval_n: int=1200, nq: int=48, nprobe: int=32, seed: '
            'int=0, device=None) -> WindowRecommendation:',
            '-    index, queries, gt = _eval_index(w, eval_n, nq, seed)',
            '+    index, queries, gt = _eval_index(w, eval_n, nq, seed, '
            'device=device)',
        ]),
    "tuning/tier.py": (
        set(),
        'tune_tier_split builds its eval index where device says '
        '(default: the card)',
        [
            '-def tune_tier_split(w: WorkloadSpec, env: EnvSpec, '
            'budget_usd_per_hour: float, *, book: PriceBook | None=None, '
            'widths: tuple[int, ...]=TIER_WIDTH_GRID, steps: int=6, '
            'refine_top: int=3, mrc: dict | None=None, eval_n: int=1200, '
            'nq: int=48, nprobe: int=32, seed: int=0) -> '
            'TierSplitRecommendation:',
            '+def tune_tier_split(w: WorkloadSpec, env: EnvSpec, '
            'budget_usd_per_hour: float, *, book: PriceBook | None=None, '
            'widths: tuple[int, ...]=TIER_WIDTH_GRID, steps: int=6, '
            'refine_top: int=3, mrc: dict | None=None, eval_n: int=1200, '
            'nq: int=48, nprobe: int=32, seed: int=0, device=None) -> '
            'TierSplitRecommendation:',
            '-    index, queries, gt = _eval_index(w, eval_n, nq, seed)',
            '+    index, queries, gt = _eval_index(w, eval_n, nq, seed, '
            'device=device)',
        ]),
    "tuning/tenancy.py": (
        set(),
        'tune_cache_split materialises its tenants where device says '
        '(default: the card)',
        [
            '-def tune_cache_split(specs: list[TenantSpec], cfg: '
            'FleetConfig, *, steps: int=8, refine_top: int=3, mrc: dict | '
            'None=None) -> CacheSplitRecommendation:',
            '+def tune_cache_split(specs: list[TenantSpec], cfg: '
            'FleetConfig, *, steps: int=8, refine_top: int=3, mrc: dict | '
            'None=None, device=None) -> CacheSplitRecommendation:',
            '-    tenants = [materialize_tenant(s, base_seed=cfg.seed, '
            'tid=i) for i, s in enumerate(specs)]',
            '+    tenants = [materialize_tenant(s, base_seed=cfg.seed, '
            'tid=i, device=device) for i, s in enumerate(specs)]',
            '-        fresh = [t if t.updates is None else '
            'materialize_tenant(specs[i], base_seed=cfg.seed, tid=i) for i, '
            't in enumerate(tenants)]',
            '+        fresh = [t if t.updates is None else '
            'materialize_tenant(specs[i], base_seed=cfg.seed, tid=i, '
            'device=device) for i, t in enumerate(tenants)]',
        ]),
    "tuning/ingest.py": (
        set(),
        'a measured ingest point builds its index where device says '
        '(default: the card)',
        [
            '-def evaluate_ingest_point(w: WorkloadSpec, env: EnvSpec, '
            'pred: IngestPrediction, *, eval_n: int=1200, nq: int=32, seed: '
            'int=0) -> IngestOutcome:',
            '+def evaluate_ingest_point(w: WorkloadSpec, env: EnvSpec, '
            'pred: IngestPrediction, *, eval_n: int=1200, nq: int=32, seed: '
            'int=0, device=None) -> IngestOutcome:',
            '-    index = make_mutable(ClusterIndex.build(data, '
            'ClusterIndexParams(kmeans_iters=4, seed=seed)))',
            '+    index = make_mutable(ClusterIndex.build(data, '
            'ClusterIndexParams(kmeans_iters=4, seed=seed), device=device))',
            '-def tune_ingest(w: WorkloadSpec, env: EnvSpec, cand: '
            'Candidate | None=None, *, refine: int=0, eval_n: int=1200, nq: '
            'int=32, seed: int=0) -> IngestRecommendation:',
            '+def tune_ingest(w: WorkloadSpec, env: EnvSpec, cand: '
            'Candidate | None=None, *, refine: int=0, eval_n: int=1200, nq: '
            'int=32, seed: int=0, device=None) -> IngestRecommendation:',
            '-            outcomes.append(evaluate_ingest_point(w, env, p, '
            'eval_n=eval_n, nq=nq, seed=seed))',
            '+            outcomes.append(evaluate_ingest_point(w, env, p, '
            'eval_n=eval_n, nq=nq, seed=seed, device=device))',
        ]),
    "tuning/__main__.py": (
        set(),
        '--device picks where every index build and exact ground truth '
        'of the tuner runs',
        [
            '+from repro_torch.device import resolve_device',
            "-    p = argparse.ArgumentParser(prog='python -m "
            "repro.tuning', description='Auto-tune index class, "
            'build/search params and cache policy for a workload + storage '
            'environment; with --fleet, size a serving fleet (optionally '
            "for an open-loop offered load + SLO).')",
            "+    p = argparse.ArgumentParser(prog='python -m "
            "repro_torch.tuning', description='Auto-tune index class, "
            'build/search params and cache policy for a workload + storage '
            'environment; with --fleet, size a serving fleet (optionally '
            "for an open-loop offered load + SLO).')",
            '+    p.add_argument(\'--device\', default=None, help="where the '
            'index builds and the exact ground truths run, and where a '
            'graph index keeps its PQ codes (default: cuda; raises without '
            'a card; \'cpu\' runs the plain PyTorch versions)")',
            '+    device = resolve_device(args.device)',
            '-        rec = tune_cache_split(specs, cfg, '
            'steps=args.split_steps, refine_top=args.refine_top, mrc=mrc)',
            '+        rec = tune_cache_split(specs, cfg, '
            'steps=args.split_steps, refine_top=args.refine_top, mrc=mrc, '
            'device=device)',
            '-            rec = tune_tier_split(w, env, '
            'args.budget_usd_hour, book=pricebook, widths=widths, '
            'steps=args.tier_steps, refine_top=args.refine_top, mrc=mrc, '
            'seed=args.seed)',
            '+            rec = tune_tier_split(w, env, '
            'args.budget_usd_hour, book=pricebook, widths=widths, '
            'steps=args.tier_steps, refine_top=args.refine_top, mrc=mrc, '
            'seed=args.seed, device=device)',
            '-        rec = tune_batch_window(w, env, scenario=scenario if '
            "scenario.kind != 'closed' else None, "
            'calibration=args.calibration, goodput_target=args.goodput, '
            'seed=args.seed)',
            '+        rec = tune_batch_window(w, env, scenario=scenario if '
            "scenario.kind != 'closed' else None, "
            'calibration=args.calibration, goodput_target=args.goodput, '
            'seed=args.seed, device=device)',
            '-            trace_fleet_point(w, env, rec.point, '
            'scenario=scenario, tracer=tracer, '
            "exec_kw=dict(backend='kernel', batch_window_s=rec.window_us * "
            '1e-06, calibration=args.calibration), seed=args.seed)',
            '+            trace_fleet_point(w, env, rec.point, '
            'scenario=scenario, tracer=tracer, '
            "exec_kw=dict(backend='kernel', batch_window_s=rec.window_us * "
            '1e-06, calibration=args.calibration), seed=args.seed, '
            'device=device)',
            '-            rec = tune_fleet(w, env, '
            'target_speedup=args.target_speedup, hedge=args.hedge, '
            'exec_kw=exec_kw, seed=args.seed)',
            '+            rec = tune_fleet(w, env, '
            'target_speedup=args.target_speedup, hedge=args.hedge, '
            'exec_kw=exec_kw, seed=args.seed, device=device)',
            '-            rec = tune_fleet_for_load(w, env, scenario, '
            'goodput_target=args.goodput, hedge=args.hedge, '
            'exec_kw=exec_kw, seed=args.seed)',
            '+            rec = tune_fleet_for_load(w, env, scenario, '
            'goodput_target=args.goodput, hedge=args.hedge, '
            'exec_kw=exec_kw, seed=args.seed, device=device)',
            '-            vrep = trace_fleet_point(w, env, rec.point, '
            'scenario=scenario, tracer=tracer, monitor=monitor, '
            'pricebook=pricebook, exec_kw=exec_kw, seed=args.seed)',
            '+            vrep = trace_fleet_point(w, env, rec.point, '
            'scenario=scenario, tracer=tracer, monitor=monitor, '
            'pricebook=pricebook, exec_kw=exec_kw, seed=args.seed, '
            'device=device)',
            '-    rec = autotune(w, env, budget=budget, '
            "kinds=tuple((k.strip() for k in args.kinds.split(',') if "
            'k.strip())))',
            '+    rec = autotune(w, env, budget=budget, '
            "kinds=tuple((k.strip() for k in args.kinds.split(',') if "
            'k.strip())), device=device)',
            '-        trace_candidate(w, env, rec.config, tracer=tracer, '
            'seed=args.seed)',
            '+        trace_candidate(w, env, rec.config, tracer=tracer, '
            'seed=args.seed, device=device)',
            "-        out['ingest'] = tune_ingest(w, env, rec.config, "
            'refine=refine, seed=args.seed).to_dict()',
            "+        out['ingest'] = tune_ingest(w, env, rec.config, "
            'refine=refine, seed=args.seed, device=device).to_dict()',
        ]),
    "exec/__init__.py": (
        set(),
        "the port's exec package also exports measure_table and "
        "CALIBRATE_COMMAND",
        [
            '-from repro_torch.exec.table import DEFAULT_TABLE_PATH, '
            'CalibEntry, CalibrationTable, load_table',
            "-__all__ = ['KernelBackend', 'CalibEntry', 'CalibrationTable', "
            "'DEFAULT_TABLE_PATH', 'load_table', 'QUERY_TILE', 'CAND_TILE', "
            "'pad_amount', 'batched_topk', 'scan_topk_oracle', 'coalesce_scan']",
            '+from repro_torch.exec.calibrate import measure_table',
            '+from repro_torch.exec.table import CALIBRATE_COMMAND, '
            'DEFAULT_TABLE_PATH, CalibEntry, CalibrationTable, load_table',
            "+__all__ = ['KernelBackend', 'QUERY_TILE', 'CAND_TILE', "
            "'pad_amount', 'batched_topk', 'scan_topk_oracle', 'coalesce_scan',"
            " 'measure_table', 'CalibEntry', 'CalibrationTable', "
            "'CALIBRATE_COMMAND', 'DEFAULT_TABLE_PATH', 'load_table']",
        ]),
    "exec/table.py": (
        set(),
        "the port names the command that measures a table on the card; "
        "load_table itself is the reference's, over the port's own "
        "committed table",
        [
            "-__all__ = ['CalibEntry', 'CalibrationTable', "
            "'DEFAULT_TABLE_PATH', 'load_table']",
            "+__all__ = ['CalibEntry', 'CalibrationTable', 'CALIBRATE_COMMAND',"
            " 'DEFAULT_TABLE_PATH', 'load_table']",
            "+CALIBRATE_COMMAND = 'python -m repro_torch.exec.calibrate --out "
            "calibration.json'",
        ]),
}


def _strip(tree: ast.AST) -> ast.AST:
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module == "repro" or node.module.startswith("repro.")):
            node.module = "repro_torch" + node.module[len("repro"):]
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "repro" or a.name.startswith("repro."):
                    a.name = "repro_torch" + a.name[len("repro"):]
    return tree


def _defines(node: ast.stmt) -> str | None:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return node.name
    if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
        return node.targets[0].id
    return None


def _difference(ref: ast.Module, port: ast.Module) -> list[str]:
    """The lines a line diff of the two unparsed modules shows."""
    lines = difflib.unified_diff(ast.unparse(ref).splitlines(),
                                 ast.unparse(port).splitlines(),
                                 lineterm="", n=0)
    return [ln for ln in lines
            if ln[:1] in "+-" and not ln.startswith(("---", "+++"))]


def _stripped(pkg: str, rel: str) -> ast.Module:
    return _strip(ast.parse((ROOT / "src" / pkg / rel).read_text()))


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_has_the_reference_code(rel):
    ref, port = _stripped("repro", rel), _stripped("repro_torch", rel)
    if rel not in ALLOWED:
        assert ast.dump(port) == ast.dump(ref)
        return
    left_out, why, difference = ALLOWED[rel]
    assert why
    assert left_out <= {_defines(n) for n in ref.body}
    ref.body = [n for n in ref.body if _defines(n) not in left_out]
    assert _difference(ref, port) == difference


def test_drift_guard_sees_a_changed_expression():
    src = "from repro.x import y\n\ndef f(a):\n    '''doc'''\n    return a + 1\n"
    same = "from repro_torch.x import y\n\ndef f(a):\n    '''other'''\n    return a + 1\n"
    drift = "from repro_torch.x import y\n\ndef f(a):\n    return 1 + a\n"
    dump = [ast.dump(_strip(ast.parse(s))) for s in (src, same, drift)]
    assert dump[0] == dump[1] != dump[2]



@pytest.mark.parametrize("old,new", [
    ('round(report.recall_against(gt), 4)', 'round(report.recall_against(gt), 3)'),
    ('"--hedge-percentile", type=float, default=95.0',
     '"--hedge-percentile", type=float, default=90.0'),
], ids=["main", "build_parser"])
def test_drift_guard_sees_a_change_beside_the_allowed_ones(old, new):
    """In ``fleet/__main__.py`` only the pinned lines may differ: one more
    change in ``main`` or ``build_parser`` shows."""
    rel = "fleet/__main__.py"
    text = (ROOT / "src" / "repro_torch" / rel).read_text()
    assert text.count(old) == 1
    left_out, _, difference = ALLOWED[rel]
    ref = _stripped("repro", rel)
    ref.body = [n for n in ref.body if _defines(n) not in left_out]
    drifted = _strip(ast.parse(text.replace(old, new)))
    assert _difference(ref, drifted) != difference

# ------------------------------------------------- committed table --

def test_committed_table_was_measured_on_the_card():
    t = ptable.load_table()
    assert os.path.samefile(ptable.DEFAULT_TABLE_PATH,
                            ROOT / "src" / "repro_torch" / "exec"
                            / "calibration_default.json")
    assert t.to_dict() == ptable.CalibrationTable.load(TABLE).to_dict()
    meta = t.meta
    assert meta["backend"] == "cuda" and "interpret" not in meta
    assert re.fullmatch(r"NVIDIA .+, \d+(\.\d+)? W", meta["card"]), meta["card"]
    assert meta["generated_by"] == "python -m repro_torch.exec.calibrate"
    assert meta["quick"] is False
    n_dist = sum(e.op == "dist" for e in t.entries)
    assert len(meta["rooflines"]) == n_dist > 0
    assert all(r["roofline_frac"] < 1.0 for r in meta["rooflines"])
    assert all(e.unit_s > 0 for e in t.entries)


@pytest.mark.parametrize("work", [(4096, 2048, 64, 8, None, None),
                                  (500, 0, 32, 0, 50000, None),
                                  (0, 777, 96, 48, None, 1e6),
                                  (1, 1, 128, 16, 1, 1)])
def test_reference_table_prices_the_same_in_the_port(work):
    """The reference's committed table, loaded by path into the port's
    class, prices as the reference's class does."""
    path = jtable.DEFAULT_TABLE_PATH
    port, ref = ptable.load_table(path), jtable.load_table(path)
    d_dist, d_pq, dim, pq_m, db, ab = work
    assert (port.plan_seconds(d_dist, d_pq, dim, pq_m, dist_batch=db, adc_batch=ab)
            == ref.plan_seconds(d_dist, d_pq, dim, pq_m, dist_batch=db,
                                adc_batch=ab))


@pytest.mark.parametrize("kind", ["cluster", "graph"])
def test_fleet_updates_need_the_write_path(kind):
    """``run_fleet(updates=...)`` runs the port's write path: on the
    port's own build of the same data, the reference's update stream gives
    the reference's report, ingest accounting included, and the same ids
    (graph distances within the ADC tolerance)."""
    data, queries = make_dataset(scaled(DEEP_ANALOG, 600, 16))
    reps = []
    for P in (REF, PORT):
        if kind == "cluster":
            index = P.ci.ClusterIndex.build(
                data, P.types.ClusterIndexParams(kmeans_iters=2, seed=0),
                **P.dev)
            params = P.types.SearchParams(k=5, nprobe=4)
            protected = None
        else:
            index = P.gi.GraphIndex.build(
                data, P.types.GraphIndexParams(R=16, L_build=24,
                                               build_passes=1, pq_dims=16,
                                               seed=0), **P.dev)
            params = P.types.SearchParams(k=5, search_len=16, beamwidth=4)
            protected = frozenset([index.meta.medoid])
        updates = P.ingest.synth_updates(data, rate_qps=400.0, n_updates=60,
                                    delete_frac=0.3, seed=0,
                                    protected=protected)
        reps.append(P.fleet.run_fleet(
            index, queries, params,
            P.fleet.FleetConfig(n_shards=2, replication=2, concurrency=4,
                                seed=1),
            updates=updates,
            ingest=P.ingest.IngestConfig(delta_cap_bytes=4096)))
    want, got = reps
    assert got.ingest is not None and got.ingest["ops_delivered"] >= 60
    assert got.ingest["flushes"] > 0
    assert got.summary() == want.summary()
    for a, b in zip(got.records, want.records):
        assert (a.qid, a.start_t, a.end_t) == (b.qid, b.start_t, b.end_t)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_allclose(a.dists, b.dists, rtol=ADC_RTOL,
                                   atol=ADC_ATOL)
