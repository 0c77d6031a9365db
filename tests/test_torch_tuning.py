"""The port's auto-tuner (``repro_torch.tuning``) on the CPU against the JAX
package's (``repro.tuning``).

Mirrors the reference's 28 tuner tests test for test: the twelve of
``tests/test_tuning.py`` and the tuner tests of ``test_tier.py``,
``test_ingest.py``, ``test_tenancy.py``, ``test_fleet.py``,
``test_scenarios.py``, ``test_exec.py`` and ``test_explain.py``.  Each
runs the reference's scenario through both packages on the same inputs,
holds the port to the reference's own assertions, and compares what the
two give (``to_dict()`` of every recommendation, exactly).  The port's
entry points take ``device="cpu"``; without it they build on the card.

The one field that differs by design is a kernel-backend batch's
occupancy: it is the share of the ``l2_topk`` query tile a batch fills,
and the port's tile is 32 queries where the reference's is 8
(``repro_torch/exec/batched.py``).  The batch-window test holds it to the
reference run with its tile set to 32.
"""
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")


def _pkg(name: str) -> SimpleNamespace:
    def m(mod):
        return importlib.import_module(f"{name}.{mod}")
    return SimpleNamespace(
        name=name, tuning=m("tuning"), cost=m("core.cost_model"),
        storage=m("storage.spec"), book=m("obs.cost"), mrc=m("obs.mrc"),
        tier=m("tuning.tier"), tenancy=m("tuning.tenancy"),
        space=m("tuning.space"), t=m("tenancy"), fleet=m("fleet"),
        arrivals=m("sim.arrivals"), cli=m("tuning.__main__"),
        table=m("exec.table"), backend=m("exec.backend"),
        dev={} if name == "repro" else {"device": "cpu"})


REF, PORT = _pkg("repro"), _pkg("repro_torch")
BOTH = (REF, PORT)


def _same(outs):
    """The port's output equals the reference's."""
    want, got = outs
    assert got == want


# ------------------------------------------------------------ cost model --

def test_cluster_cost_hit_rate_discounts_monotonically():
    outs = []
    for P in BOTH:
        w = P.cost.ClusterWorkloadPoint(n_lists=100_000, avg_list_bytes=40_000,
                                        avg_list_len=12, dim=960, nprobe=64)
        prev = None
        costs = []
        for hr in [0.0, 0.25, 0.5, 0.75, 1.0]:
            c = P.cost.cluster_query_cost(P.storage.TOS, w, concurrency=8,
                                          hit_rate=hr)
            if prev is not None:
                assert c["total"] <= prev["total"]
                assert c["bytes"] <= prev["bytes"]
                assert c["requests"] <= prev["requests"]
            prev = c
            costs.append(c)
        assert prev["bytes"] == 0.0 and prev["requests"] == 0.0
        outs.append(costs)
    _same(outs)


def test_graph_cost_hit_rate_removes_ttfb_floor():
    outs = []
    for P in BOTH:
        TOS = P.storage.TOS
        w = P.cost.GraphWorkloadPoint(roundtrips=20, requests_per_round=16,
                                      node_nbytes=4096, R=64, pq_m=112,
                                      dim=960)
        cold = P.cost.graph_query_cost(TOS, w, hit_rate=0.0)
        warm = P.cost.graph_query_cost(TOS, w, hit_rate=0.5)
        hot = P.cost.graph_query_cost(TOS, w, hit_rate=1.0)
        assert warm["total"] < cold["total"]
        assert warm["ttfb_total"] == pytest.approx(cold["ttfb_total"] * 0.5)
        assert hot["bytes"] == 0.0
        assert hot["total"] < 20 * TOS.ttfb_p50_s
        outs.append([cold, warm, hot])
    _same(outs)


def test_hit_rate_zero_matches_legacy_behaviour():
    outs = []
    for P in BOTH:
        w = P.cost.ClusterWorkloadPoint(n_lists=10_000, avg_list_bytes=64_000,
                                        avg_list_len=40, dim=960, nprobe=32)
        legacy = P.cost.cluster_query_cost(P.storage.TOS, w)
        assert legacy == P.cost.cluster_query_cost(P.storage.TOS, w,
                                                   hit_rate=0.0)
        outs.append(legacy)
    _same(outs)


# ----------------------------------------------------------------- space --

def test_enumerate_space_policies_follow_cache_budget():
    outs = []
    for P in BOTH:
        T = P.tuning
        w = T.WorkloadSpec(n=1_000_000, dim=960)
        no_cache = T.enumerate_space(w, T.EnvSpec(storage=P.storage.TOS,
                                                  cache_bytes=0))
        cached = T.enumerate_space(w, T.EnvSpec(storage=P.storage.TOS,
                                                cache_bytes=2**30))
        assert {c.cache_policy for c in no_cache} == {"none"}
        assert {c.cache_policy for c in cached} == {"none", "slru", "pinned"}
        assert len(cached) == 3 * len(no_cache)
        outs.append([c.to_dict() for c in no_cache + cached])
    _same(outs)


# ---------------------------------------------------------------- screen --

def test_screen_prunes_at_least_90_percent():
    outs = []
    for P in BOTH:
        T = P.tuning
        w = T.WorkloadSpec(n=1_000_000, dim=960, target_recall=0.9,
                           concurrency=16)
        env = T.EnvSpec(storage=P.storage.TOS, cache_bytes=4 * 2**30)
        res = T.screen(w, env, T.enumerate_space(w, env))
        assert res.prune_fraction >= 0.90
        assert len(res.kept) >= 4
        outs.append((res.n_total, res.prune_fraction,
                     [p.to_dict() for p in res.kept]))
    _same(outs)


def test_screen_monotone_in_recall_target():
    outs = []
    for P in BOTH:
        T = P.tuning
        env = T.EnvSpec(storage=P.storage.TOS)
        prev = float("inf")
        bests = []
        for target in [0.7, 0.9, 0.95, 0.99, 0.995]:
            w = T.WorkloadSpec(n=1_000_000, dim=960, target_recall=target,
                               concurrency=16)
            preds = [T.predict(w, env, c) for c in T.enumerate_space(w, env)]
            best = T.best_predicted_qps(preds)
            assert best <= prev + 1e-9
            prev = best
            bests.append(best)
        outs.append(bests)
    _same(outs)


def test_screen_recall_priors_monotone_in_knobs():
    outs = []
    for P in BOTH:
        T = P.tuning
        env = T.EnvSpec(storage=P.storage.TOS)
        w = T.WorkloadSpec(n=1_000_000, dim=960)
        recalls = []
        for kind, knob, grid in (("cluster", "nprobe", [8, 32, 128, 512, 2048]),
                                 ("graph", "search_len", [20, 80, 320, 640])):
            r_prev = 0.0
            for v in grid:
                r = T.predict(w, env, T.Candidate(kind=kind, **{knob: v})
                              ).pred_recall
                assert r >= r_prev
                r_prev = r
                recalls.append(r)
        outs.append(recalls)
    _same(outs)


# ---------------------------------------------------------------- pareto --

def test_pareto_frontier_correctness_on_synthetic_set():
    pts = [(0.70, 100.0), (0.90, 80.0), (0.90, 60.0), (0.85, 70.0),
           (0.99, 20.0), (0.60, 90.0), (0.99, 20.0)]
    outs = []
    for P in BOTH:
        front = P.tuning.pareto_frontier(pts, recall_of=lambda p: p[0],
                                         qps_of=lambda p: p[1])
        assert front == [(0.70, 100.0), (0.90, 80.0), (0.99, 20.0)]
        recalls = [p[0] for p in front]
        qpss = [p[1] for p in front]
        assert recalls == sorted(recalls)
        assert qpss == sorted(qpss, reverse=True)
        outs.append(front)
    _same(outs)


def test_pareto_single_point_and_empty():
    for P in BOTH:
        f = P.tuning.pareto_frontier([(0.5, 1.0)], lambda p: p[0],
                                     lambda p: p[1])
        assert f == [(0.5, 1.0)]
        assert P.tuning.pareto_frontier([], lambda p: p[0],
                                        lambda p: p[1]) == []


# -------------------------------------------------------------- autotune --

def test_autotune_screen_budget_emits_json():
    outs = []
    for P in BOTH:
        T = P.tuning
        w = T.WorkloadSpec(n=1_000_000, dim=960, target_recall=0.9,
                           concurrency=16)
        rec = T.autotune(w, T.EnvSpec(storage=P.storage.TOS),
                         budget="screen", **P.dev)
        blob = json.loads(rec.to_json())
        assert blob["recommendation"]["kind"] in ("cluster", "graph")
        assert blob["screen"]["prune_fraction"] >= 0.90
        assert blob["pareto_frontier"]
        assert rec.prune_fraction >= 0.90
        outs.append(blob)
    _same(outs)


def test_autotune_e2e_graph_for_high_concurrency_high_dim():
    """Paper rule (RQ2), at dim 960: the graph index's rung build (greedy
    search, PQ at m = 120) and the rung's exact ground truth run in the
    port."""
    outs = []
    for P in BOTH:
        T = P.tuning
        w = T.WorkloadSpec(n=1_000_000, dim=960, target_recall=0.995,
                           concurrency=64)
        budget = T.EvalBudget(rungs=((300, 12),), max_rung0=6)
        rec = T.autotune(w, T.EnvSpec(storage=T.resolve_storage("tos")),
                         budget=budget, **P.dev)
        assert rec.config.kind == "graph"
        assert rec.simulated > 0
        outs.append(rec.to_dict())
    _same(outs)


def test_autotune_e2e_cluster_for_low_recall_ssd():
    outs = []
    for P in BOTH:
        T = P.tuning
        w = T.WorkloadSpec(n=10_000_000, dim=96, target_recall=0.7,
                           concurrency=1)
        budget = T.EvalBudget(rungs=((800, 20),), max_rung0=6)
        rec = T.autotune(w, T.EnvSpec(storage=T.resolve_storage("ssd")),
                         budget=budget, **P.dev)
        assert rec.config.kind == "cluster"
        assert rec.simulated > 0
        assert rec.feasible
        outs.append(rec.to_dict())
    _same(outs)


# ------------------------------------------------------------------ tier --

def test_enumerate_tier_splits_spends_the_budget():
    outs = []
    for P in BOTH:
        book = P.book.PriceBook()
        budget = 1.2
        splits = P.tuning.enumerate_tier_splits(budget, book, widths=(1, 2),
                                                steps=4)
        assert all(s.usd_per_hour(book) == pytest.approx(budget)
                   for s in splits)
        for w in (1, 2):
            mine = [s for s in splits if s.n_shards == w]
            assert len(mine) == 5
            assert any(s.nvme_gib == 0 for s in mine)
            assert any(s.dram_gib == 0 for s in mine)
        only_one = P.tuning.enumerate_tier_splits(0.8, book, widths=(1, 2),
                                                  steps=2)
        assert {s.n_shards for s in only_one} == {1}
        with pytest.raises(ValueError, match="cannot pay"):
            P.tuning.enumerate_tier_splits(0.4, book, widths=(1,), steps=2)
        outs.append([s.to_dict() for s in splits + only_one])
    _same(outs)


def test_screen_tier_splits_orders_by_fetch_latency():
    profile = {("list", i): [1 << 20, 1] for i in range(64 << 10)}  # 64 GiB
    outs = []
    for P in BOTH:
        book = P.book.PriceBook()
        splits = P.tuning.enumerate_tier_splits(1.2, book, widths=(1,),
                                                steps=4)
        preds = P.tuning.screen_tier_splits(profile, splits, book,
                                            remote_spec=P.storage.TOS)
        assert [p.expected_fetch_s for p in preds] == \
            sorted(p.expected_fetch_s for p in preds)
        for p in preds:
            assert 0.0 <= p.hit_dram <= p.hit_nvme <= 1.0
            assert p.usd_per_hour == pytest.approx(1.2)
        by_nvme = max(preds, key=lambda p: p.split.nvme_gib)
        by_dram = max(preds, key=lambda p: p.split.dram_gib)
        assert by_nvme.expected_fetch_s < by_dram.expected_fetch_s
        outs.append([p.to_dict() for p in preds])
    _same(outs)


def test_tune_tier_split_end_to_end():
    outs = []
    for P in BOTH:
        T = P.tuning
        w = T.WorkloadSpec(n=8_000_000, dim=960, target_recall=0.5)
        env = T.EnvSpec(storage=P.storage.TOS)
        rec = T.tune_tier_split(w, env, 0.56, widths=(1,), steps=4,
                                refine_top=2, eval_n=1200, nq=32, seed=0,
                                **P.dev)
        assert rec.feasible
        assert len(rec.refined) == 2
        assert rec.split.usd_per_hour(P.book.PriceBook()) == \
            pytest.approx(0.56)
        picked = next(o for o in rec.refined if o.split == rec.split)
        if rec.split.nvme_gib > 0:
            assert picked.hit_nvme_frac > 0
        d = rec.to_dict()
        assert json.loads(rec.to_json()) == json.loads(json.dumps(d))
        assert d["recommendation"] == rec.split.to_dict()
        assert [p["expected_fetch_s"] for p in d["screened"]] == \
            sorted(p["expected_fetch_s"] for p in d["screened"])
        outs.append(d)
    _same(outs)


def test_resolve_mrc_curve_shapes():
    for P in BOTH:
        resolve = P.tier.resolve_mrc_curve
        bare = {"sizes": [1, 2], "miss_ratio": [0.9, 0.1]}
        assert resolve(bare) is bare
        row = {"name": "t0", "sizes": [1], "miss_ratio": [0.5]}
        assert resolve({"tenants": [row]}) == row
        with pytest.raises(ValueError, match="one fleet-wide"):
            resolve({"tenants": [row, dict(row, name="t1")]})
        with pytest.raises(ValueError, match="one fleet-wide"):
            resolve({})


# ---------------------------------------------------------------- ingest --

def test_ingest_screen_write_amplification_shrinks_with_delta():
    outs = []
    for P in BOTH:
        T = P.tuning
        w = T.WorkloadSpec(n=1_000_000, dim=96, write_rate_qps=200.0)
        env = T.EnvSpec(storage=T.resolve_storage("tos"))
        c = P.space.Candidate(kind="cluster")
        wa_small = T.analytic_write_amplification(w, c,
                                                  T.IngestPoint(64 * 1024))
        wa_big = T.analytic_write_amplification(
            w, c, T.IngestPoint(4 * 1024 * 1024))
        assert wa_big < wa_small
        preds = T.screen_ingest(w, env, c)
        assert any(p.feasible for p in preds)
        assert preds[0].pred_qps >= preds[-1].pred_qps or \
            not preds[-1].feasible
        with pytest.raises(ValueError):
            T.tune_ingest(T.WorkloadSpec(write_rate_qps=0.0), env, **P.dev)
        outs.append((wa_small, wa_big, [p.to_dict() for p in preds]))
    _same(outs)


def test_tune_ingest_screen_recommends_fresh_feasible_point():
    outs = []
    for P in BOTH:
        T = P.tuning
        w = T.WorkloadSpec(n=500_000, dim=96, concurrency=8,
                           write_rate_qps=100.0)
        env = T.EnvSpec(storage=T.resolve_storage("tos"))
        rec = T.tune_ingest(w, env, **P.dev)
        assert rec.point.delta_cap_bytes > 0
        feas = [p for p in rec.screened if p.feasible]
        best = max(p.pred_qps for p in feas)
        mine = [p for p in feas if p.point == rec.point][0]
        assert mine.pred_qps >= 0.95 * best
        outs.append(rec.to_dict())
    _same(outs)


# --------------------------------------------------------------- tenancy --

def test_tune_cache_split_screen_and_refine():
    outs = []
    for P in BOTH:
        T = P.tuning
        with pytest.raises(ValueError):
            P.tenancy.CacheSplit((0.5, 0.6))
        splits = T.enumerate_splits(2, steps=4)
        assert len(splits) == 3
        cfg = P.fleet.FleetConfig(n_shards=2, replication=1, concurrency=8,
                                  cache_bytes=96 * 1024,
                                  cache_policy="slru", seed=0)
        specs = [P.t.TenantSpec(name="hot", n=500, dim=32, n_queries=32,
                                nprobe=8),
                 P.t.TenantSpec(name="cold", n=900, dim=32, n_queries=16,
                                nprobe=32)]
        tenants = [P.t.materialize_tenant(s, base_seed=0, tid=i, **P.dev)
                   for i, s in enumerate(specs)]
        preds = T.screen_cache_splits(tenants, cfg.cache_bytes, steps=4)
        assert preds[0].miss_bytes_per_s <= preds[-1].miss_bytes_per_s
        rec = T.tune_cache_split(specs, cfg, steps=4, refine_top=2, **P.dev)
        assert abs(sum(rec.split.fractions) - 1.0) < 1e-9
        assert len(rec.outcomes) == 2
        best = max(o.aggregate_goodput_qps for o in rec.outcomes)
        assert rec.outcomes[0].aggregate_goodput_qps <= best + 1e-9
        with pytest.raises(ValueError):
            T.tune_cache_split(specs[:1], cfg, **P.dev)
        outs.append(([p.to_dict() for p in preds], rec.to_dict()))
    _same(outs)


def test_che_approximation_monotone_and_exact_limits():
    prof = {("k", i): [100, (i % 5) + 1] for i in range(50)}
    sizes = [0, 500, 1500, 3000, 5000]
    outs = []
    for P in BOTH:
        hits = [P.tuning.che_hit_rate(prof, c) for c in sizes]
        assert hits[0] == 0.0
        assert hits[-1] == 1.0
        assert all(hits[i] <= hits[i + 1] + 1e-12
                   for i in range(len(hits) - 1))
        outs.append(hits)
    _same(outs)


# ----------------------------------------------------------------- fleet --

def test_tune_fleet_picks_larger_fleet_for_higher_target():
    outs = []
    for P in BOTH:
        T = P.tuning
        w = T.WorkloadSpec(n=1_000_000, dim=96, target_recall=0.9,
                           concurrency=16)
        env = T.EnvSpec(storage=T.resolve_storage("tos"))
        kw = dict(shard_grid=(1, 2, 4), replica_grid=(1, 2), eval_n=800,
                  nq=32, **P.dev)
        modest = T.tune_fleet(w, env, target_speedup=1.05, **kw)
        ambitious = T.tune_fleet(w, env, target_speedup=1.8, **kw)
        assert modest.feasible
        m = modest.point.n_shards * modest.point.replication
        a = ambitious.point.n_shards * ambitious.point.replication
        assert a >= m
        if ambitious.feasible:
            assert ambitious.speedup >= 1.8
        outs.append((modest.to_dict(), ambitious.to_dict()))
    _same(outs)


def test_fleet_point_validation():
    for P in BOTH:
        with pytest.raises(ValueError):
            P.tuning.FleetPoint(0)
        with pytest.raises(ValueError):
            P.tuning.FleetPoint(2, replication=4)


def test_tune_fleet_for_load_picks_bigger_fleet_for_harder_slo():
    outs = []
    for P in BOTH:
        T = P.tuning
        Scenario = P.arrivals.Scenario
        w = T.WorkloadSpec(n=1_000_000, dim=96, target_recall=0.9,
                           concurrency=16)
        env = T.EnvSpec(storage=T.resolve_storage("tos"))

        def mk(rate):
            return Scenario(kind="poisson", rate_qps=rate, duration_s=0.5,
                            slo_s=0.06)
        kw = dict(shard_grid=(1, 2, 4), replica_grid=(1, 2), eval_n=800,
                  nq=32, **P.dev)
        easy = T.tune_fleet_for_load(w, env, mk(150.0), **kw)
        hard = T.tune_fleet_for_load(w, env, mk(900.0), **kw)
        assert easy.feasible
        e = easy.point.n_shards * easy.point.replication
        h = hard.point.n_shards * hard.point.replication
        assert h >= e
        with pytest.raises(ValueError, match="open-loop"):
            T.tune_fleet_for_load(w, env, Scenario(kind="closed"), **P.dev)
        outs.append((easy.to_dict(), hard.to_dict()))
    _same(outs)


# ------------------------------------------------------------------ exec --

def _batch_window(P, **kw):
    T = P.tuning
    w = T.WorkloadSpec(n=2000, dim=32, dtype="float32", target_recall=0.9,
                       concurrency=8, k=10)
    env = T.EnvSpec(storage=T.resolve_storage("tos"), cache_bytes=0)
    return T.tune_batch_window(w, env, window_grid_us=(0.0, 500.0),
                               eval_n=400, nq=16, seed=0, **kw, **P.dev)


def test_tune_batch_window_smoke(monkeypatch):
    """The reference's assertions on each package with its own committed
    table; then, on the port's table and with the reference's tile set to
    the port's 32, the two recommendations are equal to the last digit."""
    for P in BOTH:
        rec = _batch_window(P)
        assert isinstance(rec, P.tuning.WindowRecommendation)
        assert rec.window_us in (0.0, 500.0)
        assert len(rec.outcomes) == 2
        o0, o1 = rec.outcomes
        assert o0.mean_batch_jobs == 1.0 and o0.batches > 0
        assert o1.mean_batch_jobs >= o0.mean_batch_jobs
        assert {o.recall for o in rec.outcomes} == {o0.recall}
        d = rec.to_dict()
        assert d["recommendation"]["backend"] == "kernel"
        assert len(d["sweep"]) == 2
    table = PORT.table.DEFAULT_TABLE_PATH
    monkeypatch.setattr(REF.backend, "QUERY_TILE", PORT.backend.QUERY_TILE)
    _same([_batch_window(P, calibration=table).to_dict() for P in BOTH])


# --------------------------------------------------------------- explain --

def _zipf_stream(n_keys=200, n_accesses=20000, a=1.1, seed=0):
    rng = np.random.default_rng(seed)
    sizes = (rng.integers(1, 9, n_keys) * 64).astype(int)
    w = 1.0 / np.arange(1, n_keys + 1) ** a
    w /= w.sum()
    stream = rng.choice(n_keys, size=n_accesses, p=w)
    return sizes, stream


def _mrc_artifact(names, sizes, curves):
    return dict(sample_rate=1.0, ref_bytes=sizes[len(sizes) // 2],
                sizes=list(sizes),
                tenants=[dict(tid=i, name=n, accesses=1000,
                              sampled=1000, cold=10,
                              mean_obj_bytes=256.0,
                              sizes=list(sizes), miss_ratio=list(c),
                              demand_bytes_per_s=d)
                         for i, (n, c, d) in enumerate(
                             zip(names, curves, (4e6, 1e6)))])


def test_shards_mrc_tracks_che_within_documented_tolerance():
    sizes, stream = _zipf_stream()
    profile = {("k", int(i)): [int(sizes[i]), int((stream == i).sum())]
               for i in np.unique(stream)}
    total = int(sizes.sum())
    grid = [total // 32, total // 16, total // 8, total // 4,
            total // 2, total]
    outs = []
    for P in BOTH:
        che = P.tenancy.che_hit_rate
        got = []
        for rate, (tol_mean, tol_max) in ((1.0, (0.05, 0.10)),
                                          (0.25, (0.08, 0.15))):
            est = P.mrc.TenantMRC(rate)
            for i in stream:
                est.access(("k", int(i)), int(sizes[i]))
            errs = [abs(est.miss_ratio(c) - (1.0 - che(profile, c)))
                    for c in grid]
            assert np.mean(errs) <= tol_mean, (rate, errs)
            assert np.max(errs) <= tol_max, (rate, errs)
            curve = est.curve(grid)
            assert all(a >= b - 1e-9 for a, b in zip(curve, curve[1:]))
            got.append((errs, curve))
        outs.append(got)
    _same(outs)


def test_screen_cache_splits_accepts_mrc_curves():
    sizes = [16 * 1024, 64 * 1024, 256 * 1024]
    curves = [[0.9, 0.6, 0.1], [0.3, 0.28, 0.27]]
    outs = []
    for P in BOTH:
        specs = [P.t.TenantSpec(name="hot", n=500, dim=32, n_queries=8,
                                nprobe=8),
                 P.t.TenantSpec(name="cold", n=500, dim=32, n_queries=8,
                                nprobe=8)]
        tenants = [P.t.materialize_tenant(s, base_seed=0, tid=i, **P.dev)
                   for i, s in enumerate(specs)]
        art = _mrc_artifact(["hot", "cold"], sizes, curves)
        preds = P.tenancy.screen_cache_splits(tenants, 256 * 1024, steps=4,
                                              mrc=art)
        assert preds[0].miss_bytes_per_s <= preds[-1].miss_bytes_per_s
        assert preds[0].split.fractions[0] > preds[0].split.fractions[1]
        bad = _mrc_artifact(["hot", "WRONG"], sizes, curves)
        with pytest.raises(ValueError, match="cold"):
            P.tenancy.screen_cache_splits(tenants, 256 * 1024, steps=4,
                                          mrc=bad)
        outs.append([p.to_dict() for p in preds])
    _same(outs)


def test_live_mrc_feeds_tune_cache_split():
    """End-to-end: profile a multi-tenant run online, hand the mrc block
    straight to the tuner."""
    outs = []
    for P in BOTH:
        cfg = P.fleet.FleetConfig(n_shards=2, replication=1, concurrency=8,
                                  cache_bytes=96 * 1024,
                                  cache_policy="slru", seed=0)
        specs = [P.t.TenantSpec(name="hot", n=500, dim=32, n_queries=24,
                                nprobe=8),
                 P.t.TenantSpec(name="cold", n=900, dim=32, n_queries=16,
                                nprobe=32)]
        tenants = [P.t.materialize_tenant(s, base_seed=0, tid=i, **P.dev)
                   for i, s in enumerate(specs)]
        rep = P.t.run_tenant_fleet(tenants, cfg, "shared", mrc=True)
        mrc = rep.fleet.mrc
        assert {t["name"] for t in mrc["tenants"]} == {"hot", "cold"}
        rec = P.tenancy.tune_cache_split(specs, cfg, steps=4, refine_top=1,
                                         mrc=mrc, **P.dev)
        assert abs(sum(rec.split.fractions) - 1.0) < 1e-9
        assert rec.outcomes
        outs.append((mrc, rec.to_dict()))
    _same(outs)


def test_tuning_cli_tune_split_with_mrc_curves(tmp_path, capsys):
    tenants = tmp_path / "tenants.json"
    tenants.write_text(json.dumps(dict(tenants=[
        dict(name="hot", n=500, dim=32, n_queries=8, nprobe=8),
        dict(name="cold", n=500, dim=32, n_queries=8, nprobe=8)])))
    sizes = [16 * 1024, 64 * 1024, 256 * 1024]
    art = tmp_path / "mrc.json"
    art.write_text(json.dumps(_mrc_artifact(
        ["hot", "cold"], sizes, [[0.9, 0.6, 0.1], [0.3, 0.28, 0.27]])))
    argv = ["--tune-split", "--tenants", str(tenants),
            "--cache-gb", str(256 * 1024 / 2 ** 30),
            "--concurrency", "8", "--split-steps", "4",
            "--refine-top", "1", "--mrc-curves", str(art), "--compact"]
    outs = []
    for P in BOTH:
        extra = ["--device", "cpu"] if P is PORT else []
        assert P.cli.main(argv + extra) == 0
        out = json.loads(capsys.readouterr().out)
        assert abs(sum(out["recommendation"]) - 1.0) < 1e-9
        assert out["screened"] and out["refined"]
        assert "meta" in out
        out.pop("meta")
        outs.append(out)
    _same(outs)
