"""The port's write path (``repro_torch.ingest``) on the CPU against the JAX
package's (``repro.ingest``).

Mirrors ``tests/test_ingest.py`` test for test (all but the two tuner
tests, which ``tests/test_torch_tuning.py`` mirrors).  Each test makes its inputs once with
numpy, runs the reference's scenario through both packages, holds the port
to the reference's own assertions, and compares what the two give: whole
reports (``summary()``), per-query ids and virtual times exactly, graph
distances within the reference's ADC tolerance (rtol 1e-5, atol 1e-4).
Both packages build their own indexes from the same seed (the port with
``device="cpu"``); the port's graph build now takes the reference's PQ
init draw, so the graph cases compare port-built indexes too.

The reference's hypothesis test of tombstones is mirrored as a seeded
sweep, so it runs without hypothesis.
"""
import dataclasses
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
ADC_RTOL, ADC_ATOL = 1e-5, 1e-4      # the reference's (tests/test_kernels.py)


def _pkg(name: str) -> SimpleNamespace:
    def m(mod):
        return importlib.import_module(f"{name}.{mod}")
    return SimpleNamespace(
        name=name, ingest=m("ingest"), types=m("core.types"),
        ci=m("core.cluster_index"), gi=m("core.graph_index"),
        fleet=m("fleet"), partition=m("fleet.partition"),
        engine=m("serving.engine"), admission=m("sim.admission"),
        arrivals=m("sim.arrivals"), kernel=m("sim.kernel"),
        sim=m("storage.simulator"), spec=m("storage.spec"),
        cost=m("core.cost_model"), slru=m("cache.slru"),
        store=m("storage.object_store"),
        dev={} if name == "repro" else {"device": "cpu"})


REF, PORT = _pkg("repro"), _pkg("repro_torch")
BOTH = (REF, PORT)


def _quiet(P):
    return dataclasses.replace(P.spec.TOS, ttfb_sigma=1e-9)


@pytest.fixture(scope="module")
def setup():
    return make_dataset(scaled(DEEP_ANALOG, 1200, 32))


def _cluster(P, data, iters=4):
    return P.ci.ClusterIndex.build(data, P.types.ClusterIndexParams(
        kmeans_iters=iters, seed=0), **P.dev)


def _graph(P, data, R=24, L=48, m=24):
    return P.gi.GraphIndex.build(data, P.types.GraphIndexParams(
        R=R, L_build=L, build_passes=1, pq_dims=m, seed=0), **P.dev)


def _drain(P, mutable, seed=7):
    """Force-flush every site's delta through a private kernel."""
    kernel = P.kernel.Kernel(seed=seed)
    sim = P.sim.StorageSim(P.spec.TOS, kernel, seed=seed)
    for sid in sorted(mutable.sites):
        agent = P.ingest.IngestAgent(
            mutable, site_id=sid, kernel=kernel, cfg=P.ingest.IngestConfig(),
            compute=P.cost.ComputeSpec(), sim_provider=lambda: sim,
            report=P.ingest.IngestReport())
        agent.flush_now()
    kernel.run()


def _gt(P, data, stream, queries, k=10):
    return P.ingest.churn_ground_truth(data, stream, queries, k, **P.dev)


def _same_stream(a, b):
    assert len(a) == len(b)
    for x, y in zip(a.ops, b.ops):
        assert (x.t, x.seq, x.kind, x.id) == (y.t, y.seq, y.kind, y.id)
        if x.vec is None:
            assert y.vec is None
        else:
            np.testing.assert_array_equal(x.vec, y.vec)


def _same_results(got, want, graph=False):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.ids, b.ids)
        if graph:
            np.testing.assert_allclose(a.dists, b.dists, rtol=ADC_RTOL,
                                       atol=ADC_ATOL)
        else:
            np.testing.assert_array_equal(a.dists, b.dists)


def _same_report(got, want, graph=False):
    assert got.summary() == want.summary()
    assert [(r.qid, r.start_t, r.end_t) for r in got.records] == \
        [(r.qid, r.start_t, r.end_t) for r in want.records]
    _same_results(got.records, want.records, graph)


def _recall(P, results, gt, ids=None):
    rk = P.types.recall_at_k
    return float(np.mean([
        rk((r.ids[r.ids >= 0] if ids is None else ids[r.ids[r.ids >= 0]]),
           gt[i]) for i, r in enumerate(results)]))


# ------------------------------------------------------------- memtable --

def _memtable_trace(P):
    m = P.ingest.Memtable(vec_nbytes=32)
    out = [m.used_bytes]
    m.insert(1, np.ones(8, np.float32), (0, 2), 0.0, 0.0)
    out.append(m.used_bytes)
    out.append(m.delete(5, 0.1))
    out.append(m.used_bytes)
    out.append(m.delete(1, 0.2))
    out += [len(m), 1 in m.tombstones]
    m.insert(5, np.ones(8, np.float32), (0,), 0.3, 0.3)
    out.append(5 in m.tombstones)
    return out


def test_memtable_bytes_and_tombstones():
    want, got = (_memtable_trace(P) for P in BOTH)
    assert got == want == [0, 40, False, 48, True, 0, False, False]


def test_memtable_search_and_list_restriction():
    outs = []
    for P in BOTH:
        m = P.ingest.Memtable(vec_nbytes=8)
        m.insert(10, np.array([0.0, 0.0]), (0,), 0.0, 0.0)
        m.insert(11, np.array([1.0, 1.0]), (1,), 0.0, 0.0)
        ids, d, n = m.search(np.zeros(2), k=5)
        ids1, _, _ = m.search(np.zeros(2), k=5, lists=(1,))
        outs.append((list(ids), d.tolist(), n, list(ids1)))
    assert outs[1] == outs[0]
    assert outs[1][0] == [10, 11] and outs[1][2] == 2 and outs[1][3] == [11]


# ------------------------------------------------------------ admission --

def test_admission_window_order_and_drain():
    outs = []
    for P in BOTH:
        k = P.kernel.Kernel()
        started = []
        adm = P.admission.AdmissionWindow(
            k, 2, lambda item, t: started.append((item, t)))
        seen = [adm.offer("a"), adm.offer("b"), adm.offer("c"), adm.depth]
        adm.release(1.5)
        seen.append(list(started))
        adm.release(2.0)
        adm.release(2.5)
        seen += [adm.idle, adm.drained]
        adm.mark_exhausted()
        seen += [adm.drained, adm.arrivals_total]
        outs.append(seen)
    assert outs[1] == outs[0] == [
        True, True, False, 1, [("a", 0.0), ("b", 0.0), ("c", 1.5)],
        True, False, True, 3]


# -------------------------------------------------------------- caches ---

def test_slru_remove_fixes_byte_accounting():
    outs = []
    for P in BOTH:
        c = P.slru.SLRUCache(1000)
        c.put("a", 100)
        c.put("b", 200)
        seen = [c.get("a"), c.remove("a"), "a" in c, c.used_bytes,
                c.protected_bytes, c.remove("b"), c.used_bytes,
                c.remove("zzz")]
        c.put("d", 50)
        seen += [c.invalidate("d"), c.invalidate("d")]
        outs.append(seen)
    assert outs[1] == outs[0]
    assert outs[1][1:] == [100, False, 200, 0, 200, 0, 0, True, False]
    assert outs[1][0]


def test_pinned_remove_unpins():
    outs = []
    for P in BOTH:
        c = P.slru.PinnedCache({"x", "y"})
        outs.append([bool(c.get("x")), c.invalidate("x"), bool(c.get("x"))])
    assert outs[1] == outs[0] == [True, True, False]


# ------------------------------------------------- merged-search churn ---

def test_merged_search_never_returns_deleted(setup):
    data, queries = setup
    res = []
    for P in BOTH:
        mci = P.ingest.make_mutable(_cluster(P, data))
        p = P.types.SearchParams(k=10, nprobe=16)
        base = mci.search(queries[0], p)
        victims = [int(i) for i in base.ids[:4]]
        for v in victims:
            mci.site(0).delete(v, 0.0)
            mci.note_delete(v)
        r = mci.search(queries[0], p)
        assert not set(int(i) for i in r.ids) & set(victims)
        assert len(r.ids) == 10
        res.append([base, r])
    _same_results(res[1], res[0])


def test_delta_insert_is_immediately_searchable(setup):
    data, queries = setup
    res = []
    for P in BOTH:
        mci = P.ingest.make_mutable(_cluster(P, data))
        p = P.types.SearchParams(k=10, nprobe=16)
        q = queries[1]
        new_id = len(data) + 17
        lists, n = mci.assign_lists(q)
        mci.site(0).insert(new_id, q.copy(), lists, 0.0, 0.0)
        mci.note_insert(new_id)
        r = mci.search(q, p)
        assert int(r.ids[0]) == new_id
        res.append((lists, n, r))
    assert res[1][:2] == res[0][:2]
    _same_results([res[1][2]], [res[0][2]])


@pytest.mark.parametrize("seed", range(5))
def test_property_tombstones_never_surface(setup, seed):
    """The reference's hypothesis test as a seeded sweep: any victim set
    (1-24 ids of 1,200), any query."""
    data, queries = setup
    rng = np.random.default_rng(seed)
    victims = rng.integers(0, 1200, int(rng.integers(1, 25))).tolist()
    qi = int(rng.integers(0, 32))
    res = []
    for P in BOTH:
        mci = P.ingest.make_mutable(_cluster(P, data))
        for v in victims:
            mci.site(0).delete(v, 0.0)
            mci.note_delete(v)
        r = mci.search(queries[qi], P.types.SearchParams(k=10, nprobe=16))
        assert not set(int(i) for i in r.ids) & set(victims)
        res.append(r)
    _same_results([res[1]], [res[0]])


# -------------------------------------------- compaction == rebuild ------

def test_full_compaction_matches_rebuilt_cluster(setup):
    data, queries = setup
    outs = []
    for P in BOTH:
        mci = P.ingest.make_mutable(_cluster(P, data))
        p = P.types.SearchParams(k=10, nprobe=32)
        stream = P.ingest.synth_updates(data, rate_qps=500.0, n_updates=150,
                                        delete_frac=0.3, seed=3)
        rep = P.engine.run_workload(
            mci, queries, p, _quiet(P), concurrency=8, seed=0,
            updates=stream,
            ingest=P.ingest.IngestConfig(delta_cap_bytes=32 * 1024))
        _drain(P, mci)
        assert mci.delta_bytes == 0
        gt = _gt(P, data, stream, queries)
        merged = [mci.search(q, p) for q in queries]
        rec_m = _recall(P, merged, gt)
        corpus, ids = P.ingest.churned_corpus(data, stream)
        rebuilt = _cluster(P, corpus)
        rec_r = _recall(P, [rebuilt.search(q, p) for q in queries], gt, ids)
        assert rec_m >= rec_r - 0.05
        dead = {op.id for op in stream.ops if op.kind == "delete"}
        reborn = {op.id for op in stream.ops if op.kind == "insert"}
        for r in merged:
            assert not set(int(i) for i in r.ids) & (dead - reborn)
        outs.append((stream, rep, gt, merged, rec_m, rec_r))
    (s0, r0, g0, m0, *rec0), (s1, r1, g1, m1, *rec1) = outs
    _same_stream(s1, s0)
    _same_report(r1, r0)
    np.testing.assert_array_equal(g1, g0)
    _same_results(m1, m0)
    assert rec1 == rec0


def test_full_compaction_matches_rebuilt_graph():
    data, queries = make_dataset(scaled(DEEP_ANALOG, 900, 24))
    outs = []
    for P in BOTH:
        gi = _graph(P, data)
        p = P.types.SearchParams(k=10, search_len=40, beamwidth=8)
        stream = P.ingest.synth_updates(
            data, rate_qps=500.0, n_updates=80, delete_frac=0.25, seed=2,
            protected=frozenset([gi.meta.medoid]))
        mgi = P.ingest.make_mutable(gi)
        rep = P.engine.run_workload(
            mgi, queries, p, _quiet(P), concurrency=8, seed=0,
            updates=stream,
            ingest=P.ingest.IngestConfig(delta_cap_bytes=16 * 1024))
        _drain(P, mgi)
        assert mgi.delta_bytes == 0
        gt = _gt(P, data, stream, queries)
        merged = [mgi.search(q, p) for q in queries]
        rec_m = _recall(P, merged, gt)
        corpus, ids = P.ingest.churned_corpus(data, stream)
        rebuilt = _graph(P, corpus)
        rec_r = _recall(P, [rebuilt.search(q, p) for q in queries], gt, ids)
        assert rec_m >= rec_r - 0.05
        dead = {op.id for op in stream.ops if op.kind == "delete"}
        for r in merged:
            assert not set(int(i) for i in r.ids) & dead
        outs.append((stream, rep, gt, merged, rec_m, rec_r,
                     {i: mgi.adjacency(i).tolist() for i in sorted(mgi._adj)}))
    (s0, r0, g0, m0, *rest0), (s1, r1, g1, m1, *rest1) = outs
    _same_stream(s1, s0)
    _same_report(r1, r0, graph=True)
    np.testing.assert_array_equal(g1, g0)
    _same_results(m1, m0, graph=True)
    assert rest1 == rest0        # recalls and the stitched adjacency


# ----------------------------------------------------------- overflow ----

def test_overflowed_list_reclusters(setup):
    data, queries = setup
    q = queries[0]
    rng = np.random.default_rng(0)
    vecs = [(q + rng.normal(0, 0.01, size=q.shape)).astype(data.dtype)
            for _ in range(200)]
    outs = []
    for P in BOTH:
        mci = P.ingest.make_mutable(_cluster(P, data))
        n_lists0 = mci.meta.n_lists
        p = P.types.SearchParams(k=10, nprobe=16)
        ops = []
        t = 0.0
        for i in range(200):
            t += 1e-3
            ops.append(dataclasses.replace(
                P.ingest.synth_updates(data, 1.0, 1, delete_frac=0.0,
                                       seed=i).ops[0],
                t=t, seq=i, id=len(data) + i, vec=vecs[i]))
        stream = P.ingest.UpdateStream(ops)
        rep = P.engine.run_workload(
            mci, queries, p, _quiet(P), concurrency=4, seed=0,
            updates=stream,
            ingest=P.ingest.IngestConfig(delta_cap_bytes=16 * 1024,
                                         overflow_factor=1.5))
        _drain(P, mci)
        assert mci.meta.n_lists > n_lists0
        res = mci.search(q, p)
        assert int(res.ids[0]) >= len(data)
        outs.append((rep, res, mci.meta.n_lists,
                     mci.meta.list_lengths.tolist(),
                     mci.meta.tree.centroids.copy()))
    (r0, q0, n0, l0, c0), (r1, q1, n1, l1, c1) = outs
    _same_report(r1, r0)
    _same_results([q1], [q0])
    assert (n1, l1) == (n0, l0)
    np.testing.assert_array_equal(c1, c0)


# ------------------------------------------------------- partitions ------

def test_cluster_partition_inherit_and_graph_growth(setup):
    data, _ = setup
    outs = []
    for P in BOTH:
        ci = _cluster(P, data)
        part = P.partition.ClusterPartition.build(ci.meta.list_nbytes, 4, 2)
        n0 = len(part.owners_arr)
        parent_owners = part.owners(("list", 3))
        part.inherit(n0, 3)
        assert part.owners(("list", n0)) == parent_owners
        with pytest.raises(ValueError):
            part.inherit(n0 + 5, 0)
        gp = P.partition.GraphPartition.build(100, 4, 2, seed=1)
        grown = gp.owners(("node", 10_000))
        assert len(set(grown)) == 2 and all(0 <= s < 4 for s in grown)
        assert gp.owners(("node", 10_000)) == grown
        outs.append((n0, parent_owners, part.owners_arr.tolist(), grown))
    assert outs[1] == outs[0]


# ------------------------------------------------------ rw scenario ------

@pytest.mark.parametrize("name", ["one_shard", "four_shard"])
def test_rw_zero_writes_reproduces_golden(setup, name):
    """The rw path at write rate 0 reproduces the closed-loop golden
    reports bit-exactly in both packages (the reference's test runs both
    configurations in one body; here each is a case)."""
    data, queries = setup
    golden = json.load(open(GOLDEN_PATH))
    g = golden[name]
    reps = []
    for P in BOTH:
        F = P.fleet
        p = P.types.SearchParams(k=golden["params"]["k"],
                                 nprobe=golden["params"]["nprobe"])
        scen = P.arrivals.Scenario(kind="rw", write_rate_qps=0.0)
        cfg = dict(
            one_shard=F.FleetConfig(n_shards=1, replication=1, concurrency=8,
                                    shard_concurrency=8, queue_depth=64,
                                    seed=0),
            four_shard=F.FleetConfig(n_shards=4, replication=2,
                                     concurrency=16, shard_concurrency=4,
                                     queue_depth=16, hedge=True,
                                     hedge_percentile=75.0, seed=5))[name]
        mci = P.ingest.make_mutable(_cluster(P, data))
        arr = scen.make_arrivals(len(queries), cfg.concurrency, seed=cfg.seed)
        updates = scen.make_updates(data, seed=cfg.seed)
        assert updates is None
        rep = F.run_fleet(mci, queries, p, cfg, arrivals=arr, updates=updates)
        assert rep.wall_time_s == pytest.approx(g["wall_time_s"], rel=1e-9,
                                                abs=1e-12)
        assert rep.qps == pytest.approx(g["qps"], rel=1e-9)
        h = hashlib.sha256()
        for r in sorted(rep.records, key=lambda r: r.qid):
            h.update(np.asarray(r.qid).tobytes())
            h.update(np.asarray(r.ids, dtype=np.int64).tobytes())
        assert h.hexdigest() == g["ids_sha256"]
        assert rep.ingest is None
        reps.append(rep)
    assert reps[1].to_json() == reps[0].to_json()


def test_rw_fleet_deterministic_and_fresh(setup):
    data, queries = setup
    outs = []
    for P in BOTH:
        p = P.types.SearchParams(k=10, nprobe=16)
        cfg = P.fleet.FleetConfig(n_shards=3, replication=2, concurrency=8,
                                  seed=1)

        def once():
            stream = P.ingest.synth_updates(data, 600.0, 120,
                                            delete_frac=0.3, seed=3)
            rep = P.fleet.run_fleet(
                P.ingest.make_mutable(_cluster(P, data)), queries, p, cfg,
                updates=stream,
                ingest=P.ingest.IngestConfig(delta_cap_bytes=24 * 1024))
            return rep, stream

        a, stream = once()
        if P is PORT:
            b, _ = once()
            assert a.to_json() == b.to_json()
        ing = a.ingest
        assert ing["flushes"] > 0
        assert ing["write_amplification"] > 1.0
        assert ing["visibility_lag"]["mean_s"] > 0
        assert ing["seal_lag"]["n"] > 0
        assert ing["compaction_read_bytes"] > 0
        t_end = max(op.t for op in stream.ops)
        dead = {op.id for op in stream.ops if op.kind == "delete"}
        reborn = {op.id for op in stream.ops if op.kind == "insert"}
        for r in a.records:
            if r.start_t > t_end:
                assert not set(int(i) for i in r.ids) & (dead - reborn)
        outs.append(a)
    assert outs[1].to_json() == outs[0].to_json()
    _same_report(outs[1], outs[0])


def test_compaction_contends_with_queries(setup):
    data, queries = setup
    outs = []
    for P in BOTH:
        p = P.types.SearchParams(k=10, nprobe=32)
        cfg = P.fleet.FleetConfig(n_shards=2, replication=1, concurrency=8,
                                  seed=2)
        stream = P.ingest.synth_updates(data, rate_qps=3000.0, n_updates=600,
                                        delete_frac=0.2, seed=5)
        arr = P.arrivals.Scenario(kind="rw", n_arrivals=4 * len(queries))
        quiet = P.fleet.run_fleet(
            P.ingest.make_mutable(_cluster(P, data)), queries, p, cfg,
            arrivals=arr.make_arrivals(len(queries), cfg.concurrency))
        churn = P.fleet.run_fleet(
            P.ingest.make_mutable(_cluster(P, data)), queries, p, cfg,
            arrivals=arr.make_arrivals(len(queries), cfg.concurrency),
            updates=stream,
            ingest=P.ingest.IngestConfig(delta_cap_bytes=16 * 1024,
                                         recluster=False))
        ing = churn.ingest
        assert ing["queries_during_compaction"] > 0
        assert churn.wall_time_s > quiet.wall_time_s
        assert ing["query_p99_during_compaction_s"] > 0
        outs.append((quiet, churn))
    for got, want in zip(outs[1], outs[0]):
        _same_report(got, want)


def test_freshness_lag_grows_with_delta_capacity(setup):
    data, queries = setup
    outs = []
    for P in BOTH:
        p = P.types.SearchParams(k=10, nprobe=16)

        def seal_lag(cap):
            stream = P.ingest.synth_updates(data, 800.0, 200,
                                            delete_frac=0.2, seed=6)
            rep = P.engine.run_workload(
                P.ingest.make_mutable(_cluster(P, data)), queries, p,
                _quiet(P), concurrency=8, seed=0, updates=stream,
                ingest=P.ingest.IngestConfig(delta_cap_bytes=cap))
            return rep.ingest["seal_lag"]

        small, big = seal_lag(8 * 1024), seal_lag(128 * 1024)
        assert small["n"] > 0
        assert big["n"] == 0 or big["mean_s"] > small["mean_s"]
        outs.append((small, big))
    assert outs[1] == outs[0]


def test_rw_cache_invalidation_serves_fresh_content(setup):
    data, queries = setup
    outs = []
    for P in BOTH:
        p = P.types.SearchParams(k=10, nprobe=16)
        cfg = P.fleet.FleetConfig(n_shards=2, replication=1, concurrency=8,
                                  seed=3, cache_bytes=1 << 30,
                                  cache_policy="slru")
        stream = P.ingest.synth_updates(data, 600.0, 120, delete_frac=0.3,
                                        seed=7)
        arr = P.arrivals.Scenario(kind="rw", n_arrivals=3 * len(queries))
        rep = P.fleet.run_fleet(
            P.ingest.make_mutable(_cluster(P, data)), queries, p, cfg,
            arrivals=arr.make_arrivals(len(queries), cfg.concurrency),
            updates=stream,
            ingest=P.ingest.IngestConfig(delta_cap_bytes=16 * 1024))
        assert rep.hit_rate > 0.2
        t_end = max(op.t for op in stream.ops)
        dead = {op.id for op in stream.ops if op.kind == "delete"}
        reborn = {op.id for op in stream.ops if op.kind == "insert"}
        for r in rep.records:
            if r.start_t > t_end:
                assert not set(int(i) for i in r.ids) & (dead - reborn)
        outs.append(rep)
    _same_report(outs[1], outs[0])


def test_scenario_rw_validation_and_stream_synth(setup):
    data, _ = setup
    streams = []
    for P in BOTH:
        Scenario = P.arrivals.Scenario
        with pytest.raises(ValueError):
            Scenario(kind="rw", write_rate_qps=-1.0)
        with pytest.raises(ValueError):
            Scenario(kind="rw", delete_frac=1.0)
        s = Scenario(kind="rw", write_rate_qps=100.0, n_updates=50,
                     delete_frac=0.3)
        stream = s.make_updates(data, seed=0)
        assert len(stream) == 50
        assert stream.n_inserts + stream.n_deletes == 50
        assert stream.n_deletes > 0
        _same_stream(s.make_updates(data, seed=0), stream)
        live = set(range(len(data)))
        for op in stream.ops:
            if op.kind == "insert":
                live.add(op.id)
            else:
                assert op.id in live
                live.discard(op.id)
        streams.append(stream)
    _same_stream(streams[1], streams[0])
    assert streams[1].to_dict() == streams[0].to_dict()


# ---------------------------------------------------- space reclamation --

def test_retired_graph_blocks_are_reclaimed():
    data, queries = make_dataset(scaled(DEEP_ANALOG, 900, 24))
    outs = []
    for P in BOTH:
        gi = _graph(P, data)
        node_nb = gi.meta.node_nbytes
        assert gi.store.total_bytes == gi.meta.n_data * node_nb
        p = P.types.SearchParams(k=10, search_len=40, beamwidth=8)
        stream = P.ingest.synth_updates(
            data, rate_qps=500.0, n_updates=80, delete_frac=0.25, seed=2,
            protected=frozenset([gi.meta.medoid]))
        mgi = P.ingest.make_mutable(gi)
        rep = P.engine.run_workload(
            mgi, queries, p, _quiet(P), concurrency=8, seed=0,
            updates=stream,
            ingest=P.ingest.IngestConfig(delta_cap_bytes=16 * 1024))
        _drain(P, mgi)
        assert mgi.delta_bytes == 0
        assert len(mgi.dead) > 0
        assert mgi.store.total_bytes == mgi.live_count * node_nb
        assert len(mgi.store) == mgi.live_count
        for d in mgi.dead:
            assert ("node", d) not in mgi.store
        lingering = mgi.store.lingering_count
        mgi.store.purge_lingering()
        assert mgi.store.lingering_count == 0
        for d in mgi.dead:
            with pytest.raises(KeyError):
                mgi.store.get(("node", d))
        res = mgi.search(queries[0], p)
        assert len(res.ids) == 10
        assert not set(int(i) for i in res.ids) & mgi.dead
        outs.append((rep, res, sorted(mgi.dead), mgi.live_count,
                     mgi.store.total_bytes, lingering, mgi.meta.medoid,
                     mgi.meta.codes.copy()))
    (r0, q0, *s0, c0), (r1, q1, *s1, c1) = outs
    _same_report(r1, r0, graph=True)
    _same_results([q1], [q0], graph=True)
    assert s1 == s0
    np.testing.assert_array_equal(c1, c0)   # the codes the installs grew


def test_unlink_keeps_inflight_reads_alive():
    outs = []
    for P in BOTH:
        store = P.store.ObjectStore()
        store.put("a", ("payload",), 100)
        seen = [store.total_bytes, store.unlink("a"), store.total_bytes,
                "a" in store, store.get("a"), store.unlink("a")]
        store.put("a", ("fresh",), 50)
        seen += [store.get("a"), store.total_bytes]
        store.unlink("a")
        seen.append(store.purge_lingering())
        with pytest.raises(KeyError):
            store.get("a")
        outs.append(seen)
    assert outs[1] == outs[0] == [100, 100, 0, False, ("payload",), 0,
                                  ("fresh",), 50, 1]


# --------------------------------------------- invariant sweep (churn) ---

def _mini_index(P, kind, data):
    if kind == "cluster":
        return P.ingest.make_mutable(_cluster(P, data, iters=3))
    return P.ingest.make_mutable(_graph(P, data, R=16, L=24, m=16))


def _mini_params(P, kind):
    if kind == "cluster":
        return P.types.SearchParams(k=5, nprobe=8)
    return P.types.SearchParams(k=5, search_len=16, beamwidth=4)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["cluster", "graph"])
@pytest.mark.parametrize("scenario", ["closed", "poisson", "rw"])
def test_determinism_matrix_replay_is_byte_identical(seed, kind, scenario):
    """Every (seed x index kind x scenario) cell replays to a
    byte-identical report in the port, and to the reference's."""
    data, queries = make_dataset(scaled(DEEP_ANALOG, 360, 10, seed=seed))

    def once(P) -> str:
        index = _mini_index(P, kind, data)
        p = _mini_params(P, kind)
        scen = P.arrivals.Scenario(
            kind=scenario, rate_qps=300.0, n_arrivals=2 * len(queries),
            write_rate_qps=400.0 if scenario == "rw" else 0.0,
            n_updates=40, delete_frac=0.25)
        arrivals = scen.make_arrivals(len(queries), 4, seed=seed)
        updates = scen.make_updates(
            data, seed=seed,
            protected=(frozenset([index.meta.medoid])
                       if kind == "graph" else None))
        rep = P.engine.run_workload(
            index, queries, p, _quiet(P), concurrency=4, seed=seed,
            arrivals=arrivals, updates=updates,
            ingest=P.ingest.IngestConfig(delta_cap_bytes=8 * 1024))
        h = hashlib.sha256()
        for r in sorted(rep.records, key=lambda r: (r.qid, r.start_t)):
            h.update(np.asarray([r.qid], dtype=np.int64).tobytes())
            h.update(np.asarray([r.start_t, r.end_t],
                                dtype=np.float64).tobytes())
            h.update(np.asarray(r.ids, dtype=np.int64).tobytes())
            h.update(np.asarray(r.dists, dtype=np.float64).tobytes())
        return json.dumps(rep.summary(), sort_keys=True) + h.hexdigest()

    got = once(PORT)
    assert got == once(PORT)
    assert got == once(REF)


@pytest.mark.parametrize("kind", ["cluster", "graph"])
@pytest.mark.parametrize("delta_kb,flush_frac,par", [
    (2, 0.25, 1),          # tiny delta, eager flushes
    (16, 0.5, 2),          # mid delta, parallel compaction
    (256, 1.0, 1),         # huge delta, lazy flush (mostly unsealed)
])
def test_property_no_tombstone_resurrection_any_schedule(kind, delta_kb,
                                                         flush_frac, par):
    data, queries = make_dataset(scaled(DEEP_ANALOG, 360, 10))
    outs = []
    for P in BOTH:
        index = _mini_index(P, kind, data)
        p = _mini_params(P, kind)
        protected = frozenset([index.meta.medoid]) if kind == "graph" \
            else None
        stream = P.ingest.synth_updates(data, rate_qps=600.0, n_updates=60,
                                        delete_frac=0.4, seed=9,
                                        protected=protected)
        cfg = P.ingest.IngestConfig(delta_cap_bytes=int(delta_kb) * 1024,
                                    flush_frac=flush_frac,
                                    compaction_parallelism=par)
        rep = P.engine.run_workload(index, queries, p, _quiet(P),
                                    concurrency=4, seed=0, updates=stream,
                                    ingest=cfg)
        t_end = max(op.t for op in stream.ops)
        events = sorted(((op.t, op.kind, op.id) for op in stream.ops))
        for r in rep.records:
            if r.end_t <= t_end:
                continue
            dead = set()
            for t, kind_, id_ in events:
                if t > r.start_t:
                    break
                (dead.add if kind_ == "delete" else dead.discard)(id_)
            assert not set(int(i) for i in r.ids) & dead
        _drain(P, index)
        final_dead = set()
        for _, kind_, id_ in events:
            (final_dead.add if kind_ == "delete" else final_dead.discard)(id_)
        after = [index.search(q, p) for q in queries]
        for res in after:
            assert not set(int(i) for i in res.ids) & final_dead
        outs.append((rep, after))
    _same_report(outs[1][0], outs[0][0], graph=kind == "graph")
    _same_results(outs[1][1], outs[0][1], graph=kind == "graph")
