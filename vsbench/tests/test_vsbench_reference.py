"""The plain reference against the port's build and device search, on the
CPU at a small size: over the port's centroids, the same lists and the
same answers; and the closure check counts what breaks the rule."""
import numpy as np
import pytest
import torch

from repro_torch.core.cluster_index import ClusterIndex, device_search_batch
from repro_torch.core.types import ClusterIndexParams
from vsbench import datagen
from vsbench.reference import search as ref

PARAMS = {"centroid_frac": 0.16, "num_replica": 8, "closure_eps": 0.15,
          "kmeans_iters": 4, "branch": 8, "balance_penalty": 0.0, "seed": 5}
SPEC = datagen.Blobs(4128, 48, 40, 1.0, (-10.0, 10.0), 128, "float32")


@pytest.fixture(scope="module")
def built():
    data, queries = datagen.make(SPEC, 2)
    port = ClusterIndex.build(data, ClusterIndexParams(**PARAMS), device="cpu")
    arrs = port.device_arrays()
    index = ref.build_index(torch.from_numpy(data),
                            torch.from_numpy(arrs["centroids"]), PARAMS)
    return data, queries, port, arrs, index


def test_lists_are_the_ports(built):
    data, _, port, arrs, index = built
    assert np.array_equal(index.lengths.numpy(), port.meta.list_lengths)
    ids, lens = ref.padded_lists(index)
    assert np.array_equal(ids, arrs["list_ids"])
    assert np.array_equal(lens, arrs["list_len"])
    differ, unsure = ref.lists_differ(index, arrs["list_ids"],
                                      arrs["list_len"], len(data))
    assert differ == 0.0 and unsure < 0.05


def test_the_closure_check_counts_what_breaks_the_rule(built):
    data, _, _, arrs, index = built
    n = len(data)
    ids, lens = arrs["list_ids"].copy(), arrs["list_len"].copy()
    long = int(np.argmax(lens))
    ids[long, lens[long] - 1] = -1                 # a replica dropped
    lens[long] -= 1
    differ, _ = ref.lists_differ(index, ids, lens, n)
    assert differ == 1 / n or index.unsure.any()
    bad = arrs["list_ids"].copy()
    bad[long, 0] = n + 3                           # an id outside the data
    assert ref.lists_differ(index, bad, arrs["list_len"], n)[0] >= 1 / n
    twice = arrs["list_ids"].copy()
    twice[long, 1] = twice[long, 0]                # a point twice in a list
    assert ref.lists_differ(index, twice, arrs["list_len"], n)[0] >= 1 / n
    # every replica dropped: each point in its nearest list alone
    only = np.full_like(arrs["list_ids"], -1)
    nearest = torch.cdist(torch.from_numpy(data),
                          torch.from_numpy(arrs["centroids"])).argmin(1)
    cnt = np.zeros(len(only), dtype=np.int32)
    for p, li in enumerate(nearest.tolist()):
        only[li, cnt[li]] = p
        cnt[li] += 1
    assert ref.lists_differ(index, only, cnt, n)[0] > 0.1


@pytest.mark.parametrize("nprobe", [1, 8, 64])
def test_answers_are_the_ports(built, nprobe):
    data, queries, _, arrs, index = built
    a = {key: torch.from_numpy(v) for key, v in arrs.items()}
    q = torch.from_numpy(queries)
    got_ids, got_d = device_search_batch(a["centroids"], a["list_vecs"],
                                         a["list_ids"], q, nprobe=nprobe,
                                         k=10)
    ids, d, probed = ref.search(index, torch.from_numpy(data), q, nprobe, 10)
    assert probed.shape == (len(queries), nprobe)
    assert np.array_equal(np.sort(got_ids.numpy(), 1), np.sort(ids.numpy(), 1))
    fin = np.isfinite(d.numpy())
    assert np.array_equal(fin, np.isfinite(got_d.numpy()))
    # float32 rounding of |q|^2 + |x|^2 - 2 q.x on both sides: a few 1e-7
    # of |q|^2 + |x|^2
    scale = (queries.astype(np.float64) ** 2).sum(1)[:, None] \
        + (data.astype(np.float64) ** 2).sum(1).max()
    gap = np.abs(got_d.numpy()[fin].astype(np.float64) - d.numpy()[fin])
    assert (gap <= 1e-6 * np.broadcast_to(scale, fin.shape)[fin]).all()


def test_exact_topk_is_brute_force(built):
    data, queries, _, _, _ = built
    gt = ref.exact_topk(torch.from_numpy(data), torch.from_numpy(queries), 10)
    d64 = ((queries[:, None, :].astype(np.float64) - data[None]) ** 2).sum(-1)
    want = np.argsort(d64, 1)[:, :10]
    assert (np.sort(gt, 1) == np.sort(want, 1)).all(1).mean() >= 0.99


def test_to_tf32_keeps_ten_mantissa_bits():
    one = 1.0
    x = torch.tensor([one, one + 2 ** -11, one + 3 * 2 ** -11, one + 2 ** -10,
                      -3.0 - 2 ** -9], dtype=torch.float32)
    want = torch.tensor([one, one, one + 2 ** -9, one + 2 ** -10,
                         -3.0 - 2 ** -9], dtype=torch.float32)
    assert torch.equal(ref.to_tf32(x), want)
    r = torch.randn(10_000, generator=torch.Generator().manual_seed(0))
    rel = ((ref.to_tf32(r) - r).abs() / r.abs()).max().item()
    assert 2 ** -13 < rel <= 2 ** -11
