"""The data generator: the sizes and the model a configuration states, the
same draws from the same seed, and another sample from another."""
import json

import numpy as np
import pytest

from conftest import ROOT
from vsbench import datagen

CFG = json.loads((ROOT / "vsbench" / "configs" / "random-s-100.json")
                 .read_text())
SMALL = {**CFG, "n_samples": 4000, "dim": 16, "centers": 40,
         "n_queries": 500}


def test_the_configuration_is_random_s_100():
    spec = datagen.spec_from_config(CFG)
    assert (spec.n_samples, spec.dim, spec.centers, spec.n_queries) == (
        100_000, 100, 1000, 10_000)
    assert spec.cluster_std == 1.0 and spec.center_box == (-10.0, 10.0)
    assert spec.n == 90_000


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_same_seed_same_data(seed):
    spec = datagen.spec_from_config(SMALL)
    a, qa = datagen.make(spec, seed)
    b, qb = datagen.make(spec, seed)
    assert a.shape == (3500, 16) and qa.shape == (500, 16)
    assert a.dtype == qa.dtype == np.float32
    assert np.array_equal(a, b) and np.array_equal(qa, qb)
    c, _ = datagen.make(spec, seed + 1)
    assert c.shape == a.shape and not np.array_equal(a, c)


def test_the_points_are_blobs():
    """Every point lies about one of ``centers`` centres in the box, an
    equal share about each, spread ``cluster_std`` in every dimension."""
    spec = datagen.spec_from_config({**SMALL, "n_samples": 2000, "dim": 64,
                                     "centers": 20, "n_queries": 200})
    data, queries = datagen.make(spec, 3)
    x = np.concatenate([data, queries]).astype(np.float64)
    # at 64-d two points of a blob lie ~11 apart and two blobs ~65: a
    # blob is what lies within 3 times the first of them of any one point
    left = np.arange(len(x))
    sizes, spread = [], []
    while left.size:
        d = np.sqrt(((x[left] - x[left[0]]) ** 2).sum(1))
        mine = left[d < 3.0 * np.sqrt(2 * spec.dim)]
        sizes.append(len(mine))
        spread.append(x[mine].std(0).mean())
        left = np.setdiff1d(left, mine)
    assert len(sizes) == spec.centers and set(sizes) == {100}
    assert 0.9 < np.mean(spread) < 1.05
    assert np.abs(x).max() < 10.0 + 6.0
