"""The port's graph index (``repro_torch.core.graph_index``) on the CPU
against the JAX package's.

* the build's pieces on the same inputs: ``_merge_candidates`` and
  ``_greedy_search_build`` (torch) and ``_robust_prune`` (numpy), with
  integer-valued vectors so every distance is exact;
* ``build`` on integer-valued data gives the reference's adjacency, medoid
  and node blocks; on deep-analog data the port's own build gives the
  reference's PQ codebooks (f32 rtol 1e-5: the port takes the reference's
  ``jax.random`` k-means init draw), codes, adjacency and search ids;
* ``search`` on a converted reference index gives the reference's ids and
  metrics for every query (deep-analog, n = 2000, as test_graph_index.py);
* ``tests/test_graph_index.py``'s properties on the port's own build.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graph_index as jgi  # noqa: E402
from repro.core.flat import exact_topk as j_exact_topk  # noqa: E402
from repro.core.types import GraphIndexParams as JParams  # noqa: E402
from repro.core.types import SearchParams as JSearch  # noqa: E402
from repro.data.synth import DEEP_ANALOG, make_dataset, scaled  # noqa: E402
from repro_torch.convert import graph_index_from_reference  # noqa: E402
from repro_torch.core import graph_index as gi  # noqa: E402
from repro_torch.core.types import (GraphIndexParams, SearchParams,  # noqa: E402
                                    recall_at_k)

T = torch.from_numpy


@pytest.fixture(scope="module")
def deep():
    data, queries = make_dataset(scaled(DEEP_ANALOG, 2000, 20))
    gt, _ = j_exact_topk(data, queries, 10)
    ref = jgi.GraphIndex.build(
        data, JParams(R=32, L_build=64, pq_dims=48, seed=0), batch=256)
    port = gi.GraphIndex.build(
        data, GraphIndexParams(R=32, L_build=64, pq_dims=48, seed=0),
        batch=256, device="cpu")
    return data, queries, gt, ref, port


# ------------------------------------------------------- build pieces --

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_candidates_matches_reference(seed):
    rng = np.random.default_rng(seed)
    B, L, R = 6, 8, 10
    cand_ids = rng.integers(-1, 30, size=(B, L)).astype(np.int64)
    # distances on a coarse grid (exact ties), inf on padded ids
    cand_d = (rng.integers(0, 6, size=(B, L)) / 4).astype(np.float32)
    cand_d[cand_ids < 0] = np.inf
    expanded = (rng.random((B, L)) < 0.4) & (cand_ids >= 0)
    new_ids = rng.integers(-1, 30, size=(B, R)).astype(np.int64)
    new_d = (rng.integers(0, 6, size=(B, R)) / 4).astype(np.float32)
    new_d[new_ids < 0] = np.inf
    want = jgi._merge_candidates(cand_ids, cand_d, expanded, new_ids, new_d, L)
    got = gi._merge_candidates(T(cand_ids), T(cand_d), T(expanded),
                               T(new_ids), T(new_d), L)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_merge_keeps_expanded_flag():
    ids, d, e = gi._merge_candidates(
        T(np.array([[7, -1]])), T(np.array([[1.0, np.inf]], np.float32)),
        T(np.array([[True, False]])), T(np.array([[7, 3]])),
        T(np.array([[1.0, 2.0]], np.float32)), 2)
    assert ids[0, 0] == 7 and e[0, 0]
    assert ids[0, 1] == 3 and not e[0, 1]


def test_robust_prune_matches_reference():
    rng = np.random.default_rng(0)
    p = rng.normal(size=16).astype(np.float32)
    cand = rng.normal(size=(220, 16)).astype(np.float32)   # > max_pool
    ids = np.arange(100, 320, dtype=np.int64)
    for alpha in (1.0, 1.2):
        sel = gi._robust_prune(p, ids, cand, R=8, alpha=alpha)
        np.testing.assert_array_equal(
            sel, jgi._robust_prune(p, ids, cand, R=8, alpha=alpha))
        assert len(sel) <= 8 and len(np.unique(sel)) == len(sel)
    d = ((cand - p) ** 2).sum(1)
    assert gi._robust_prune(p, ids, cand, R=8, alpha=1.2)[0] == ids[np.argmin(d)]


@pytest.mark.parametrize("L", [8, 24])
def test_greedy_search_build_matches_reference(L):
    rng = np.random.default_rng(L)
    n, D, R = 400, 12, 10
    data = rng.integers(-6, 7, size=(n, D)).astype(np.float32)
    adj = np.full((n, R), -1, dtype=np.int32)
    for i in range(n):
        deg = rng.integers(1, R + 1)
        adj[i, :deg] = rng.choice(n, size=deg, replace=False)
    pts = rng.choice(n, size=37, replace=False)
    want_ids, want_d = jgi._greedy_search_build(data, adj, data[pts], 5, L)
    got_ids, got_d = gi._greedy_search_build(T(data), T(adj), T(data[pts]),
                                             5, L)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_d, want_d)


@pytest.mark.parametrize("passes", [1, 2])
def test_build_on_integer_data_gives_reference_graph(passes):
    data = np.random.default_rng(passes).integers(-8, 8, (500, 16)).astype(
        np.float32)
    kw = dict(R=12, L_build=24, build_passes=passes, pq_dims=8, seed=3)
    ref = jgi.GraphIndex.build(data, JParams(**kw), batch=128)
    port = gi.GraphIndex.build(data, GraphIndexParams(**kw), batch=128,
                               device="cpu")
    assert port.meta.medoid == ref.meta.medoid
    assert port.meta.node_nbytes == ref.meta.node_nbytes
    ra, pa = ref.device_arrays(), port.device_arrays()
    np.testing.assert_array_equal(pa["adjacency"], ra["adjacency"])
    np.testing.assert_array_equal(pa["vectors"], ra["vectors"])
    for i in range(len(data)):
        assert port.store.nbytes(("node", i)) == ref.store.nbytes(("node", i))
    assert port.codes_dev.dtype == torch.uint8
    assert tuple(port.codes_dev.shape) == (len(data), 8)
    np.testing.assert_array_equal(port.codes_dev.numpy(), port.meta.codes)


# ------------------------------------------------- search on one index --

@pytest.mark.parametrize("search_len,beamwidth", [(10, 8), (40, 8), (40, 1)])
def test_search_on_converted_index_gives_reference_ids(deep, search_len,
                                                       beamwidth):
    _, queries, _, ref, _ = deep
    port = graph_index_from_reference(ref, device="cpu")
    for q in queries:
        want = ref.search(q, JSearch(k=10, search_len=search_len,
                                     beamwidth=beamwidth))
        got = port.search(q, SearchParams(k=10, search_len=search_len,
                                          beamwidth=beamwidth))
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_allclose(got.dists, want.dists, rtol=1e-6)
        for f in ("roundtrips", "requests", "bytes_read", "dist_comps",
                  "pq_dist_comps"):
            assert getattr(got.metrics, f) == getattr(want.metrics, f), f


@pytest.mark.parametrize("search_len", [10, 40])
def test_port_built_index_gives_the_reference_graph_and_search_ids(
        deep, search_len):
    _, queries, _, ref, port = deep
    np.testing.assert_allclose(port.meta.pq.codebooks, ref.meta.pq.codebooks,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(port.meta.codes, ref.meta.codes)
    ra, pa = ref.device_arrays(), port.device_arrays()
    for key in ("vectors", "adjacency", "medoid"):
        np.testing.assert_array_equal(pa[key], ra[key])
    for q in queries:
        want = ref.search(q, JSearch(k=10, search_len=search_len, beamwidth=8))
        got = port.search(q, SearchParams(k=10, search_len=search_len,
                                          beamwidth=8))
        np.testing.assert_array_equal(got.ids, want.ids)
        assert got.metrics.roundtrips == want.metrics.roundtrips
        assert got.metrics.pq_dist_comps == want.metrics.pq_dist_comps


def test_converted_index_carries_every_node(deep):
    _, _, _, ref, _ = deep
    port = graph_index_from_reference(ref, device="cpu")
    ra, pa = ref.device_arrays(), port.device_arrays()
    for key in ("vectors", "adjacency", "medoid"):
        np.testing.assert_array_equal(pa[key], ra[key])
    np.testing.assert_array_equal(port.meta.codes, ref.meta.codes)
    assert port.meta.params == GraphIndexParams(R=32, L_build=64, pq_dims=48,
                                                seed=0)


def test_search_runs_one_lookup_per_round_with_new_neighbours(deep):
    _, queries, _, _, port = deep
    calls = []
    orig = port.meta.pq.adc_lookup_dev
    port.meta.pq.adc_lookup_dev = lambda c, t: (calls.append(len(c)),
                                                orig(c, t))[1]
    try:
        r = port.search(queries[0], SearchParams(k=10, search_len=40,
                                                 beamwidth=8))
    finally:
        del port.meta.pq.adc_lookup_dev
    assert calls[0] == 1                          # the medoid
    assert all(c > 0 for c in calls)
    assert len(calls) <= 1 + r.metrics.roundtrips
    assert sum(calls) == r.metrics.pq_dist_comps


# ---------------------------------- test_graph_index.py's properties --

def _run(idx, queries, gt, **kw):
    recs, rts, reqs = [], [], []
    for i, q in enumerate(queries):
        r = idx.search(q, SearchParams(k=10, **kw))
        recs.append(recall_at_k(r.ids, gt[i]))
        rts.append(r.metrics.roundtrips)
        reqs.append(r.metrics.requests)
    return float(np.mean(recs)), float(np.mean(rts)), float(np.mean(reqs))


def test_recall_increases_with_search_len(deep):
    _, queries, gt, _, port = deep
    r10, rt10, _ = _run(port, queries, gt, search_len=10, beamwidth=8)
    r80, rt80, _ = _run(port, queries, gt, search_len=80, beamwidth=8)
    assert r80 >= r10
    assert r80 >= 0.9
    assert rt80 > rt10


def test_beamwidth_reduces_roundtrips(deep):
    _, queries, gt, _, port = deep
    r1, rt1, _ = _run(port, queries, gt, search_len=80, beamwidth=1)
    r16, rt16, _ = _run(port, queries, gt, search_len=80, beamwidth=16)
    assert rt16 < rt1
    assert abs(r16 - r1) < 0.08


def test_graph_degree_bounded(deep):
    _, _, _, _, port = deep
    adj = port.device_arrays()["adjacency"]
    assert adj.shape[1] == port.meta.params.R
    assert (adj >= 0).sum(1).max() <= port.meta.params.R
    assert not (adj == np.arange(len(adj))[:, None]).any()


def test_exact_rerank_distances(deep):
    data, queries, _, _, port = deep
    r = port.search(queries[0], SearchParams(k=10, search_len=40, beamwidth=8))
    valid = r.ids >= 0
    want = ((data[r.ids[valid]].astype(np.float32)
             - queries[0].astype(np.float32)[None]) ** 2).sum(1)
    np.testing.assert_allclose(r.dists[valid], want, rtol=1e-4)


def test_node_block_is_sector_aligned(deep):
    _, _, _, _, port = deep
    assert port.meta.node_nbytes % port.meta.params.sector_bytes == 0
    assert port.meta.node_nbytes == 4096      # 96-d f32 + 32 neighbours


def test_denser_graph_bigger_blocks():
    # 960-d f32 (3840 B) + 64 neighbours spills into a 2nd sector
    data = np.random.default_rng(0).integers(-8, 8, (200, 960)).astype(
        np.float32)
    kw = dict(L_build=16, build_passes=1, pq_dims=8, seed=0)
    big = gi.GraphIndex.build(data, GraphIndexParams(R=64, **kw), device="cpu")
    small = gi.GraphIndex.build(data, GraphIndexParams(R=8, **kw), device="cpu")
    assert big.meta.node_nbytes == 8192 and small.meta.node_nbytes == 4096
