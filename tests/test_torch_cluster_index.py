"""The port's cluster index on the CPU against the JAX package's.

DEEP_ANALOG at n=2000 (seed 0), as ``tests/test_cluster_index.py`` builds
it: the port's build must give the JAX build's tree and posting lists; a
JAX-built index carried across by ``convert`` must give the JAX
``device_search_batch`` ids exactly; ground truth and host search must
give the same ids; and the int8 MSSPACE case must hold too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import cluster_index as jci  # noqa: E402
from repro.core.flat import exact_topk as jexact_topk  # noqa: E402
from repro.core.types import ClusterIndexParams as JParams  # noqa: E402
from repro.core.types import SearchParams as JSearch  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402
from repro_torch.convert import cluster_index_from_reference  # noqa: E402
from repro_torch.core.cluster_index import (ClusterIndex,  # noqa: E402
                                            closure_pairs,
                                            device_search_batch)
from repro_torch.core.flat import exact_topk  # noqa: E402
from repro_torch.core.types import (ClusterIndexParams,  # noqa: E402
                                    SearchParams, recall_at_k)
from repro_torch.data import synth  # noqa: E402

PARAMS = dict(centroid_frac=0.16, num_replica=8, seed=0)


@pytest.fixture(scope="module")
def built():
    data, queries = jsynth.make_dataset(jsynth.scaled(jsynth.DEEP_ANALOG,
                                                      2000, 20))
    jidx = jci.ClusterIndex.build(data, JParams(**PARAMS))
    pidx = ClusterIndex.build(data, ClusterIndexParams(**PARAMS),
                              device="cpu")
    return data, queries, jidx, pidx


def _assert_same_index(jidx, pidx):
    jt, pt = jidx.meta.tree, pidx.meta.tree
    np.testing.assert_array_equal(pt.centroids, jt.centroids)
    assert pt.root == jt.root and len(pt.nodes) == len(jt.nodes)
    for a, b in zip(pt.nodes, jt.nodes):
        assert a.children == b.children and a.leaf_id == b.leaf_id
        np.testing.assert_array_equal(a.center, b.center)
    np.testing.assert_array_equal(pidx.meta.list_lengths, jidx.meta.list_lengths)
    np.testing.assert_array_equal(pidx.meta.list_nbytes, jidx.meta.list_nbytes)
    for li in range(jidx.meta.n_lists):
        pids, pvecs = pidx.store.get(("list", li))
        jids, jvecs = jidx.store.get(("list", li))
        np.testing.assert_array_equal(pids, jids)
        np.testing.assert_array_equal(pvecs, jvecs)
        assert pidx.store.nbytes(("list", li)) == jidx.store.nbytes(("list", li))


def test_synth_data_bit_identical():
    for spec in (jsynth.scaled(jsynth.DEEP_ANALOG, 500, 5),
                 jsynth.scaled(jsynth.MSSPACE_ANALOG, 500, 5)):
        pspec = synth.DatasetSpec(**{f: getattr(spec, f)
                                     for f in spec.__dataclass_fields__})
        for a, b in zip(synth.make_dataset(pspec), jsynth.make_dataset(spec)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_build_matches_jax_build(built):
    _, _, jidx, pidx = built
    _assert_same_index(jidx, pidx)


def test_convert_then_device_search_matches_jax_ids(built):
    _, queries, jidx, _ = built
    cidx = cluster_index_from_reference(jidx)
    _assert_same_index(jidx, cidx)
    assert cidx.meta.params == ClusterIndexParams(**PARAMS)
    arrs = cidx.device_arrays()
    for key, val in jidx.device_arrays().items():
        np.testing.assert_array_equal(arrs[key], val)
    jids, jd = jci.device_search_batch(
        jnp.asarray(arrs["centroids"]), jnp.asarray(arrs["list_vecs"]),
        jnp.asarray(arrs["list_ids"]), jnp.asarray(queries, jnp.float32),
        nprobe=32, k=10)
    ids, d = device_search_batch(
        torch.from_numpy(arrs["centroids"]), torch.from_numpy(arrs["list_vecs"]),
        torch.from_numpy(arrs["list_ids"]), torch.from_numpy(queries),
        nprobe=32, k=10)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-3)


def test_exact_topk_and_host_search_match_jax(built):
    data, queries, jidx, pidx = built
    gt, gd = exact_topk(data, queries, 10, device="cpu")
    jgt, jgd = jexact_topk(data, queries, 10)
    assert gt.dtype == np.int64 and gd.dtype == np.float32
    np.testing.assert_array_equal(gt, jgt)
    np.testing.assert_allclose(gd, jgd, rtol=1e-5, atol=1e-3)
    recs = []
    for i, q in enumerate(queries):
        r = pidx.search(q, SearchParams(k=10, nprobe=16))
        jr = jidx.search(q, JSearch(k=10, nprobe=16))
        np.testing.assert_array_equal(r.ids, jr.ids)
        np.testing.assert_array_equal(r.dists, jr.dists)
        assert r.metrics == r.metrics.__class__(**vars(jr.metrics))
        recs.append(recall_at_k(r.ids, gt[i]))
    assert np.mean(recs) >= 0.7


def test_device_search_returns_unique_ids_and_good_recall(built):
    _, queries, _, pidx = built
    arrs = {k: torch.from_numpy(v) for k, v in pidx.device_arrays().items()}
    gt, _ = exact_topk(built[0], queries, 10, device="cpu")
    recs = {}
    for nprobe in (8, 64):
        ids, d = device_search_batch(arrs["centroids"], arrs["list_vecs"],
                                     arrs["list_ids"],
                                     torch.from_numpy(queries),
                                     nprobe=nprobe, k=10)
        assert ids.dtype == torch.int32 and d.dtype == torch.float32
        for row in ids.numpy():
            assert len(np.unique(row[row >= 0])) == (row >= 0).sum()
        assert (d[:, 1:] >= d[:, :-1]).all()
        recs[nprobe] = np.mean([recall_at_k(ids[i].numpy(), gt[i])
                                for i in range(len(queries))])
    assert recs[8] <= recs[64] + 0.05 and recs[64] >= 0.8


def test_int8_msspace_case_matches_jax():
    spec = jsynth.scaled(jsynth.MSSPACE_ANALOG, 1500, 10)
    data, queries = jsynth.make_dataset(spec)
    assert data.dtype == np.int8
    jidx = jci.ClusterIndex.build(data, JParams(seed=0))
    pidx = ClusterIndex.build(data, ClusterIndexParams(seed=0), device="cpu")
    _assert_same_index(jidx, pidx)
    gt, gd = exact_topk(data, queries, 10, device="cpu")
    jgt, jgd = jexact_topk(data, queries, 10)
    np.testing.assert_array_equal(gt, jgt)
    np.testing.assert_array_equal(gd, jgd)      # int8: exact in f32
    for q in queries:
        r = pidx.search(q, SearchParams(k=10, nprobe=64))
        np.testing.assert_array_equal(
            r.ids, jidx.search(q, JSearch(k=10, nprobe=64)).ids)
    assert pidx.meta.avg_list_bytes < pidx.meta.list_lengths.mean() * (
        spec.dim * 4 + 8)


def test_closure_pairs_rule():
    # point 7 keeps list 3 (nearest) and list 1 (within 1.3225x), not 2;
    # point 8 keeps only its nearest even at distance 0
    dd = np.array([[1.0, 1.3, 1.4], [0.0, 0.5, 0.6]], np.float32)
    idx = np.array([[3, 1, 2], [4, 0, 5]], np.int32)
    lists, points = closure_pairs(dd, idx, (1.0 + 0.15) ** 2, 7)
    assert lists.tolist() == [3, 1, 4] and points.tolist() == [7, 7, 8]
    assert lists.dtype == np.int64 and points.dtype == np.int64
