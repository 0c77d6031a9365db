"""The port's serving stack and fleet CLI on the CPU against the JAX
package's.

* ``python -m repro_torch.fleet --device cpu`` prints the reference CLI's
  JSON for the same flags, once the ``meta`` block (wall-clock provenance)
  is removed: the cluster fleet under every scenario, the write path
  (``--scenario rw``, the command of ``docs/ingest.md``), multi-tenancy
  (``--tenants`` with the ``tenants.json`` of ``docs/tenancy.md``) and the
  graph fleet on the port's own graph build;
* ``run_workload`` (the single ``QueryEngine``), ``serving.trace``
  record/replay and the event kernel's order and named RNG streams give
  the reference's results.

Every comparison is exact, except graph distances: the ADC sums in
another order, within the reference's rtol 1e-5 / atol 1e-4.
"""
import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.cluster_index import ClusterIndex as JClusterIndex  # noqa: E402
from repro.core.graph_index import GraphIndex as JGraphIndex  # noqa: E402
from repro.core.types import ClusterIndexParams as JClusterParams  # noqa: E402
from repro.core.types import GraphIndexParams as JGraphParams  # noqa: E402
from repro.fleet import __main__ as jcli  # noqa: E402
from repro_torch.convert import graph_index_from_reference  # noqa: E402
from repro_torch.core.cluster_index import ClusterIndex  # noqa: E402
from repro_torch.core.types import ClusterIndexParams  # noqa: E402
from repro_torch.data.synth import DEEP_ANALOG, make_dataset, scaled  # noqa: E402
from repro_torch.exec.table import DEFAULT_TABLE_PATH  # noqa: E402
from repro_torch.fleet import __main__ as pcli  # noqa: E402

PKGS = ("repro", "repro_torch")


def _m(pkg, mod):
    return importlib.import_module(f"{pkg}.{mod}")


# --------------------------------------------------------------- CLI --

def _cli_json(main, argv, capsys) -> dict:
    assert main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert out.pop("meta")["seed"] == 0
    return out


#: the ``tenants.json`` of ``docs/tenancy.md``
TENANTS = [
    {"name": "search-hot", "n": 600, "dim": 32, "nprobe": 8,
     "scenario": "trace", "rate_qps": 250, "slo_ms": 60, "weight": 2.0},
    {"name": "analytics", "n": 1200, "dim": 32, "nprobe": 64,
     "scenario": "burst", "burst_factor": 10, "slo_ms": 150, "weight": 1.0},
]


@pytest.mark.parametrize("flags", [
    [],
    ["--scenario", "poisson", "--rate", "300", "--duration", "0.5",
     "--slo-ms", "50"],
    ["--backend", "kernel", "--batch-window-us", "200",
     "--calibration", DEFAULT_TABLE_PATH],
    ["--cache-mb", "1", "--nvme-gb", "0.001"],
    ["--shards", "2", "--replicas", "2", "--scenario", "poisson", "--rate",
     "300", "--duration", "0.5", "--fail", "1:0.1:0.3"],
    ["--scenario", "burst", "--rate", "150", "--duration", "0.5",
     "--slo-ms", "50", "--autoscale"],
    ["--explain", "--mrc", "--monitor", "--recall-slo", "0.5",
     "--pricebook", "default", "--cache-mb", "1"],
    ["--scenario", "rw", "--write-rate", "400", "--n-updates", "200",
     "--delta-kb", "64", "--flush-frac", "0.5", "--compaction-par", "1"],
    ["--tenants", "TENANTS", "--cache-mb", "4", "--cache-policy", "weighted"],
    ["--tenants", "TENANTS", "--no-solo", "--cache-mb", "4",
     "--cache-policy", "static"],
    ["--index", "graph"],
    ["--index", "graph", "--hedge", "--replicas", "2"],
], ids=["default", "poisson", "kernel", "cache_nvme", "fail", "autoscale",
        "obs", "rw", "tenants", "tenants_no_solo", "graph", "graph_hedged"])
def test_fleet_cli_prints_the_reference_report(flags, capsys, tmp_path):
    if "TENANTS" in flags:
        spec = tmp_path / "tenants.json"
        spec.write_text(json.dumps(TENANTS))
        flags = [str(spec) if f == "TENANTS" else f for f in flags]
    want = _cli_json(jcli.main, flags + ["--compact"], capsys)
    got = _cli_json(pcli.main, flags + ["--compact", "--device", "cpu"], capsys)
    assert got == want
    assert "recall" in got
    if flags == ["--index", "graph", "--hedge", "--replicas", "2"]:
        assert got["report"]["qps"] == 60.3254     # the reference's figure

# ------------------------------------------------- engine and replay --

@pytest.fixture(scope="module")
def indexes():
    data, queries = make_dataset(scaled(DEEP_ANALOG, 800, 12))
    ci = {"repro": JClusterIndex.build(data, JClusterParams(kmeans_iters=4,
                                                            seed=0)),
          "repro_torch": ClusterIndex.build(
              data, ClusterIndexParams(kmeans_iters=4, seed=0), device="cpu")}
    jg = JGraphIndex.build(data, JGraphParams(R=16, L_build=32,
                                              build_passes=1, pq_dims=24,
                                              seed=0))
    gi = {"repro": jg,
          "repro_torch": graph_index_from_reference(jg, device="cpu")}
    return queries, {"cluster": ci, "graph": gi}


def _params(pkg, which):
    SP = _m(pkg, "core.types").SearchParams
    return (SP(k=10, nprobe=16) if which == "cluster"
            else SP(k=10, search_len=40, beamwidth=8))


def _assert_same_records(got, want, graph):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.qid == b.qid
        np.testing.assert_array_equal(a.ids, b.ids)
        if graph:     # ADC sums in another order: the reference's tolerance
            np.testing.assert_allclose(a.dists, b.dists, rtol=1e-5, atol=1e-4)
        else:
            np.testing.assert_array_equal(a.dists, b.dists)


@pytest.mark.parametrize("which", ["cluster", "graph"])
@pytest.mark.parametrize("arrivals", ["closed", "poisson"])
def test_run_workload_gives_the_reference_report(indexes, which, arrivals):
    queries, idx = indexes
    reps = {}
    for pkg in PKGS:
        eng = _m(pkg, "serving.engine")
        tos = _m(pkg, "storage.spec").TOS
        kw = {}
        if arrivals == "poisson":
            kw["arrivals"] = _m(pkg, "sim.arrivals").Poisson(
                rate_qps=300.0, n_total=2 * len(queries))
        reps[pkg] = eng.run_workload(
            idx[which][pkg], queries, _params(pkg, which), tos,
            concurrency=8, cache_bytes=1 << 20, seed=3, **kw)
    want, got = reps["repro"], reps["repro_torch"]
    assert got.summary() == want.summary()
    _assert_same_records(got.records, want.records, which == "graph")


@pytest.mark.parametrize("which", ["cluster", "graph"])
def test_trace_record_and_replay_give_the_reference_results(indexes, which):
    queries, idx = indexes
    traces, reps = {}, {}
    for pkg in PKGS:
        tr = _m(pkg, "serving.trace")
        eng = _m(pkg, "serving.engine")
        index, params = idx[which][pkg], _params(pkg, which)
        traces[pkg] = tr.record_traces(index, queries, params)
        cfg = eng.EngineConfig(storage=_m(pkg, "storage.spec").TOS,
                               concurrency=4, cache_bytes=1 << 20, seed=1)
        reps[pkg] = tr.replay_workload(index, traces[pkg], cfg)
    for a, b in zip(traces["repro_torch"], traces["repro"]):
        assert a.qid == b.qid
        assert a.checkpoints == b.checkpoints and a.final == b.final
        assert ([[(r.key, r.nbytes) for r in fb.requests] for fb in a.batches]
                == [[(r.key, r.nbytes) for r in fb.requests] for fb in b.batches])
        np.testing.assert_array_equal(a.result_ids, b.result_ids)
    want, got = reps["repro"], reps["repro_torch"]
    assert got.summary() == want.summary()
    _assert_same_records(got.records, want.records, which == "graph")


# ------------------------------------------------------- event kernel --

def _tie_heavy(pkg):
    k = _m(pkg, "sim").Kernel(seed=7)
    rng = k.rng("gen")
    fired = []
    times = rng.choice([0.0, 0.1, 0.2, 0.3], size=200)
    for i, t in enumerate(times):
        if i % 2:
            k.at(float(t), lambda i=i, t=t: (
                fired.append(("a", i)),
                k.at(float(t), fired.append, ("b", i))))
        else:
            k.at(float(t), fired.append, ("c", i))
    tick = []
    ticker = k.every(0.05, tick.append)
    k.at(0.31, ticker.cancel)
    k.run()
    streams = {name: k.rng(name).random(4).tolist()
               for name in ("arrivals", "storage", "hedge")}
    return fired, tick, streams, k.now


def test_event_kernel_order_and_rng_streams_are_the_reference_s():
    assert _tie_heavy("repro_torch") == _tie_heavy("repro")


def test_arrival_processes_give_the_reference_schedules():
    def schedule(pkg):
        A = _m(pkg, "sim.arrivals")
        out = []
        for proc in (A.ClosedLoop(4, n_total=20),
                     A.Poisson(200.0, n_total=20),
                     A.Scenario(kind="burst", rate_qps=150.0,
                                duration_s=0.5).make_arrivals(20, 4, seed=2),
                     A.zipf_trace(20, rate_qps=300.0, n_total=30, seed=3)):
            k = _m(pkg, "sim").Kernel(seed=0)
            log = []
            proc.start(k, lambda i, wi: log.append((k.now, i, wi)), 20)
            k.run()
            out.append(log)
        return out
    assert schedule("repro_torch") == schedule("repro")
