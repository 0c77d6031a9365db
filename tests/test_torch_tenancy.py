"""The port's multi-tenancy (``repro_torch.tenancy``) on the CPU against the
JAX package's (``repro.tenancy``).

Mirrors ``tests/test_tenancy.py`` test for test (all but the two tuner
tests, which ``tests/test_torch_tuning.py`` mirrors).  Each test runs the reference's
scenario through both packages, holds the port to the reference's own
assertions, and compares what the two give: whole multi-tenant reports
(``to_json()``), per-tenant records' ids and virtual times exactly.  The
port builds each tenant's index itself with ``device="cpu"``: its
``materialize_tenant`` takes a device (default: the card), so where the
reference passes bare ``TenantSpec`` s the port's side passes tenants
materialised on the CPU.
"""
import hashlib
import importlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.synth import DEEP_ANALOG, make_dataset, scaled  # noqa: E402

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "data",
                           "golden_fleet_prerefactor.json")

#: the documented weighted-policy interference bound (docs/tenancy.md)
WEIGHTED_INTERFERENCE_BOUND = 1.5


def _pkg(name: str) -> SimpleNamespace:
    def m(mod):
        return importlib.import_module(f"{name}.{mod}")
    return SimpleNamespace(name=name, t=m("tenancy"), types=m("core.types"),
                           ci=m("core.cluster_index"), fleet=m("fleet"),
                           dev={} if name == "repro" else {"device": "cpu"})


REF, PORT = _pkg("repro"), _pkg("repro_torch")
BOTH = (REF, PORT)


def _mat(P, specs, seed):
    """What ``run_tenant_fleet`` does with bare specs, on the CPU in the
    port."""
    return [P.t.materialize_tenant(s, base_seed=seed, tid=i, **P.dev)
            for i, s in enumerate(specs)]


def _specs(P, *dicts):
    return [P.t.TenantSpec(**d) for d in dicts]


def _same_tenant_records(got, want):
    for a, b in zip(got.tenants, want.tenants):
        assert a.name == b.name
        assert [(r.qid, r.start_t, r.end_t) for r in a.records] == \
            [(r.qid, r.start_t, r.end_t) for r in b.records]
        for ra, rb in zip(a.records, b.records):
            np.testing.assert_array_equal(ra.ids, rb.ids)


def _same(got, want):
    assert got.to_json() == want.to_json()
    _same_tenant_records(got, want)


# ------------------------------------------------------------- policies --

def test_policy_factory_and_validation():
    w = {0: 1.0, 1: 1.0}
    for P in BOTH:
        t = P.t
        assert t.make_tenant_cache("shared", 0, w) is None
        for pol, cls in (("shared", t.SharedTenantCache),
                         ("static", t.StaticTenantCache),
                         ("weighted", t.WeightedTenantCache)):
            assert isinstance(t.make_tenant_cache(pol, 1 << 20, w), cls)
        with pytest.raises(ValueError):
            t.make_tenant_cache("lru", 1 << 20, w)
        with pytest.raises(ValueError):
            t.StaticTenantCache(1 << 20, {0: 0.0})
    assert PORT.t.TENANT_CACHE_POLICIES == REF.t.TENANT_CACHE_POLICIES


def test_static_partitions_quota_and_isolation():
    outs = []
    for P in BOTH:
        c = P.t.StaticTenantCache(1000, {0: 3.0, 1: 1.0})
        assert c.parts[0].capacity + c.parts[1].capacity == 1000
        assert c.parts[0].capacity == 750
        c.put((1, "k"), 200)
        for i in range(20):
            c.put((0, "x", i), 100)
        assert c.get((1, "k"))
        assert c.tenant_used_bytes(0) <= c.tenant_quota_bytes(0)
        assert c.tenant_used_bytes(1) == 200
        outs.append([c.tenant_used_bytes(0), c.tenant_quota_bytes(0),
                     c.tenant_quota_bytes(1)])
    assert outs[1] == outs[0]


def test_shared_policy_is_one_slru():
    outs = []
    for P in BOTH:
        c = P.t.SharedTenantCache(300, {0: 1.0, 1: 1.0})
        c.put((0, "a"), 200)
        c.put((1, "b"), 200)
        outs.append([bool(c.get((0, "a"))), bool(c.get((1, "b"))),
                     c.tenant_used_bytes(0), c.tenant_used_bytes(1)])
    assert outs[1] == outs[0] == [False, True, 0, 200]


def test_weighted_reallocation_moves_quota_toward_ghost_pressure():
    outs = []
    for P in BOTH:
        c = P.t.WeightedTenantCache(1000, {0: 1.0, 1: 1.0},
                                    realloc_every=64, step_frac=0.1)
        q0 = c.parts[0].capacity
        for _ in range(10):
            for i in range(10):
                key = (0, "k", i)
                if not c.get(key):
                    c.put(key, 100)
        assert c.reallocations > 0
        assert c.parts[0].capacity > q0
        assert c.parts[0].capacity + c.parts[1].capacity == 1000
        assert c.parts[1].capacity >= c.floors[1]
        outs.append([c.reallocations, c.parts[0].capacity,
                     c.parts[1].capacity, dict(c.floors)])
    assert outs[1] == outs[0]


def test_weighted_quota_sum_invariant_under_churn():
    outs = []
    for P in BOTH:
        rng = np.random.default_rng(0)
        c = P.t.WeightedTenantCache(4096, {0: 1.0, 1: 2.0, 2: 1.0},
                                    realloc_every=32)
        total0 = sum(p.capacity for p in c.parts.values())
        trace = []
        for _ in range(2000):
            tid = int(rng.integers(0, 3))
            key = (tid, int(rng.integers(0, 40)))
            op = rng.integers(0, 4)
            if op == 0:
                c.put(key, int(rng.integers(1, 400)))
            elif op == 1:
                c.get(key)
            elif op == 2:
                c.remove(key)
            else:
                c.invalidate(key)
            assert sum(p.capacity for p in c.parts.values()) == total0
            for p in c.parts.values():
                assert p.used_bytes <= p.capacity
            trace.append(tuple((p.capacity, p.used_bytes)
                               for p in c.parts.values()))
        outs.append((trace, c.reallocations))
    assert outs[1] == outs[0]


def test_fair_share_windows():
    for P in BOTH:
        f = P.t.fair_share_windows
        assert f(8, [1.0, 1.0]) == [4, 4]
        assert f(8, [3.0, 1.0]) == [6, 2]
        assert f(2, [0.1, 9.9]) == [1, 1]
        assert sum(f(8, [1.0, 1.0, 1.0])) == 8
        assert sum(f(7, [1.0, 2.0, 4.0])) == 7
        assert f(2, [1.0, 1.0, 1.0]) == [1, 1, 1]
        with pytest.raises(ValueError):
            f(8, [0.0])
    for w in ([1.0, 2.0, 4.0], [0.3, 0.3, 0.4], [5.0, 1.0]):
        for n in (2, 7, 9, 64):
            assert PORT.t.fair_share_windows(n, w) == \
                REF.t.fair_share_windows(n, w)


# ----------------------------------------------------------- spec/json ---

def test_tenant_spec_validation_and_json(tmp_path):
    for P in BOTH:
        TS = P.t.TenantSpec
        with pytest.raises(ValueError):
            TS(name="x", index="flat")
        with pytest.raises(ValueError):
            TS(name="x", weight=0.0)
        with pytest.raises(ValueError):
            TS(name="x", scenario="storm")
        specs = [TS(name="a", n=300), TS(name="b", n=300)]
        path = tmp_path / f"{P.name}.json"
        path.write_text(json.dumps([s.to_dict() for s in specs]))
        loaded = P.t.load_tenant_specs(str(path))
        assert [s.name for s in loaded] == ["a", "b"]
        path.write_text(json.dumps([specs[0].to_dict(), specs[0].to_dict()]))
        with pytest.raises(ValueError):
            P.t.load_tenant_specs(str(path))
        path.write_text(json.dumps([dict(name="a", botnet=1)]))
        with pytest.raises(ValueError):
            P.t.load_tenant_specs(str(path))
    assert PORT.t.TenantSpec(name="a", n=300).to_dict() == \
        REF.t.TenantSpec(name="a", n=300).to_dict()


# -------------------------------------------------------- golden parity --

@pytest.mark.parametrize("name", ["one_shard", "four_shard"])
def test_single_tenant_shared_reproduces_golden(name):
    """One tenant under the shared policy reproduces the golden fleet
    reports bit-exactly in both packages (the reference's test runs both
    configurations in one body; here each is a case)."""
    golden = json.load(open(GOLDEN_PATH))
    g = golden[name]
    data, queries = make_dataset(scaled(DEEP_ANALOG, 1200, 32))
    reps = []
    for P in BOTH:
        F = P.fleet
        p = P.types.SearchParams(k=golden["params"]["k"],
                                 nprobe=golden["params"]["nprobe"])
        cfg = dict(
            one_shard=F.FleetConfig(n_shards=1, replication=1, concurrency=8,
                                    shard_concurrency=8, queue_depth=64,
                                    seed=0),
            four_shard=F.FleetConfig(n_shards=4, replication=2,
                                     concurrency=16, shard_concurrency=4,
                                     queue_depth=16, hedge=True,
                                     hedge_percentile=75.0, seed=5))[name]
        index = P.ci.ClusterIndex.build(data, P.types.ClusterIndexParams(
            kmeans_iters=4, seed=0), **P.dev)
        tenant = P.t.Tenant(spec=P.t.TenantSpec(name="solo"), index=index,
                            queries=queries, params=p)
        rep = P.t.run_tenant_fleet([tenant], cfg, "shared")
        assert rep.fleet.wall_time_s == pytest.approx(
            g["wall_time_s"], rel=1e-9, abs=1e-12)
        assert rep.fleet.qps == pytest.approx(g["qps"], rel=1e-9)
        h = hashlib.sha256()
        for r in sorted(rep.tenants[0].records, key=lambda r: r.qid):
            h.update(np.asarray(r.qid).tobytes())
            h.update(np.asarray(r.ids, dtype=np.int64).tobytes())
        assert h.hexdigest() == g["ids_sha256"]
        reps.append(rep)
    _same(reps[1], reps[0])


# ------------------------------------------------------------ behaviour --

STEADY = dict(name="steady", n=600, dim=32, n_queries=32, nprobe=8,
              scenario="trace", rate_qps=250.0, n_arrivals=128, zipf_a=1.4,
              slo_ms=60, weight=1.0)
BURSTY = dict(name="bursty", n=1200, dim=32, n_queries=24, nprobe=64,
              scenario="burst", rate_qps=250.0, n_arrivals=128,
              burst_factor=10.0, burst_start_s=0.1, burst_len_s=0.3,
              slo_ms=150, weight=1.0)


def _contended_cfg(P):
    return P.fleet.FleetConfig(n_shards=2, replication=2, concurrency=6,
                               cache_bytes=64 * 1024, cache_policy="slru",
                               seed=3)


@pytest.fixture(scope="module")
def interference():
    """For each package: one solo baseline + one shared-fleet run per
    policy."""
    out = {}
    for P in BOTH:
        cfg = _contended_cfg(P)
        solo = P.t.run_tenant_fleet(_mat(P, _specs(P, STEADY), cfg.seed),
                                    cfg, "shared")
        solo_p99 = solo.tenants[0].sojourn_percentile(99)
        reports = {}
        for pol in P.t.TENANT_CACHE_POLICIES:
            rep = P.t.run_tenant_fleet(
                _mat(P, _specs(P, STEADY, BURSTY), cfg.seed), cfg, pol)
            rep.tenant("steady").solo_p99_s = solo_p99
            reports[pol] = rep
        out[P.name] = reports
    return out["repro_torch"], out["repro"]


def test_weighted_bounds_bursty_interference(interference):
    got, want = interference
    weighted = got["weighted"].tenant("steady")
    shared = got["shared"].tenant("steady")
    assert weighted.interference_ratio <= WEIGHTED_INTERFERENCE_BOUND
    assert weighted.interference_ratio < shared.interference_ratio
    assert got["weighted"].reallocations > 0
    for pol in got:
        _same(got[pol], want[pol])
        assert got[pol].tenant("steady").interference_ratio == \
            want[pol].tenant("steady").interference_ratio


def test_shared_policy_shows_cache_pollution(interference):
    got, want = interference
    assert got["static"].tenant("steady").hit_rate > \
        got["shared"].tenant("steady").hit_rate
    for pol in ("static", "shared"):
        assert got[pol].tenant("steady").hit_rate == \
            want[pol].tenant("steady").hit_rate


def test_weighted_dominates_static_on_aggregate_goodput(interference):
    got, want = interference
    assert got["weighted"].aggregate_goodput_qps > \
        got["static"].aggregate_goodput_qps
    for pol in ("weighted", "static"):
        assert got[pol].aggregate_goodput_qps == \
            want[pol].aggregate_goodput_qps


A = dict(name="a", n=500, dim=32, n_queries=24, nprobe=8, weight=1.0)
B = dict(name="b", n=400, dim=32, n_queries=16, nprobe=8, weight=1.0)
B_PRIME = dict(name="b", n=800, dim=48, n_queries=32, nprobe=48, weight=1.0)


def test_static_hit_rates_independent_across_tenants():
    outs = []
    for P in BOTH:
        cfg = P.fleet.FleetConfig(n_shards=2, replication=1, concurrency=2,
                                  cache_bytes=96 * 1024, cache_policy="slru",
                                  seed=1)

        def run(b, pol):
            return P.t.run_tenant_fleet(
                _mat(P, _specs(P, A, b), cfg.seed), cfg, pol)

        r1, r2 = run(B, "static"), run(B_PRIME, "static")
        assert r1.tenant("a").hit_rate == r2.tenant("a").hit_rate
        assert r1.tenant("a").bytes_read == r2.tenant("a").bytes_read
        s1, s2 = run(B, "shared"), run(B_PRIME, "shared")
        assert s1.tenant("a").hit_rate != s2.tenant("a").hit_rate
        outs.append((r1, r2, s1, s2))
    for got, want in zip(outs[1], outs[0]):
        _same(got, want)


def test_multi_tenant_run_deterministic_and_results_exact():
    specs = (dict(name="c", n=500, dim=32, n_queries=16, nprobe=12),
             dict(name="g", n=400, dim=32, n_queries=12, index="graph",
                  search_len=24, beamwidth=4))
    outs = []
    for P in BOTH:
        cfg = P.fleet.FleetConfig(n_shards=2, replication=2, concurrency=8,
                                  cache_bytes=1 << 20, cache_policy="slru",
                                  seed=0)
        a = P.t.run_tenant_fleet(_mat(P, _specs(P, *specs), cfg.seed), cfg,
                                 "weighted")
        if P is PORT:
            b = P.t.run_tenant_fleet(_mat(P, _specs(P, *specs), cfg.seed),
                                     cfg, "weighted")
            assert a.to_json() == b.to_json()
        tenants = _mat(P, _specs(P, *specs), cfg.seed)
        rep = P.t.run_tenant_fleet(tenants, cfg, "weighted")
        for sl, t in zip(rep.tenants, tenants):
            for r in sl.records:
                direct = t.index.search(t.queries[r.qid], t.params)
                np.testing.assert_array_equal(r.ids, direct.ids)
        outs.append(a)
    _same(outs[1], outs[0])


def test_per_tenant_windows_are_fair_shares():
    outs = []
    for P in BOTH:
        cfg = P.fleet.FleetConfig(n_shards=1, replication=1, concurrency=9,
                                  seed=0)
        specs = _specs(P, dict(name="big", n=300, dim=16, n_queries=8,
                               nprobe=4, weight=2.0),
                       dict(name="small", n=300, dim=16, n_queries=8,
                            nprobe=4, weight=1.0))
        rep = P.t.run_tenant_fleet(_mat(P, specs, cfg.seed), cfg, "shared")
        assert rep.tenant("big").window == 6
        assert rep.tenant("small").window == 3
        outs.append(rep)
    _same(outs[1], outs[0])


def test_multi_tenant_router_validation():
    for P in BOTH:
        cfg = P.fleet.FleetConfig(n_shards=1, replication=1)
        with pytest.raises(ValueError):
            P.t.MultiTenantRouter([], cfg)
        t = P.t.materialize_tenant(P.t.TenantSpec(name="a", n=300, dim=16,
                                                  n_queries=8), 0, 0, **P.dev)
        with pytest.raises(ValueError):
            P.t.MultiTenantRouter([t], cfg, cache_policy="arc")


def test_rw_tenant_applies_updates_in_shared_fleet():
    specs = (dict(name="rw", n=500, dim=32, n_queries=16, nprobe=12,
                  scenario="rw", write_rate_qps=600.0, n_updates=80,
                  delete_frac=0.3, n_arrivals=48, delta_kb=4.0),
             dict(name="ro", n=400, dim=32, n_queries=12, nprobe=8))
    outs = []
    for P in BOTH:
        cfg = P.fleet.FleetConfig(n_shards=2, replication=1, concurrency=4,
                                  seed=2)
        tenants = _mat(P, _specs(P, *specs), cfg.seed)
        stream = tenants[0].updates
        assert stream is not None and len(stream) == 80
        rep = P.t.run_tenant_fleet(tenants, cfg, "shared")
        rw = rep.tenant("rw")
        assert rw.ingest is not None and rw.ingest["ops_delivered"] >= 80
        assert rw.ingest["flushes"] > 0
        assert rep.tenant("ro").ingest is None
        t_end = max(op.t for op in stream.ops)
        dead = {op.id for op in stream.ops if op.kind == "delete"}
        reborn = {op.id for op in stream.ops if op.kind == "insert"}
        for r in rw.records:
            if r.start_t > t_end:
                assert not set(int(i) for i in r.ids) & (dead - reborn)
        outs.append((rep, [(op.t, op.kind, op.id) for op in stream.ops]))
    _same(outs[1][0], outs[0][0])
    assert outs[1][1] == outs[0][1]
