"""The comparison on hand-made answers."""
import numpy as np

from vsbench import check

LIMITS = {"malformed": 0, "lists_differ": 0.0, "dist_err": 1e-5,
          "differ": 0.0}


def setup():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(50, 4)).astype(np.float32)
    pool = rng.normal(size=(2, 4)).astype(np.float32)
    d = check.exact_sq(data, pool, np.tile(np.arange(50), (2, 1)))
    order = np.argsort(d, 1)
    return data, pool, d, order


def answer(d, order, k, rows=(0, 1)):
    ids = order[list(rows), :k].astype(np.int32)
    dists = np.take_along_axis(d[list(rows)], order[list(rows), :k], 1)
    return ids, dists.astype(np.float32)


def judge(data, pool, ids, dists, ref_ids, gt=None, lists=0.0):
    gt = ref_ids if gt is None else gt
    return check.judge(np.array([0]), ids[None], dists[None], pool, data,
                       ref_ids, gt, 2, LIMITS, lists)


def test_the_exact_answer_is_correct():
    data, pool, d, order = setup()
    ids, dists = answer(d, order, 5)
    v = judge(data, pool, ids, dists, ids.astype(np.int64))
    assert v.correct and v.recall == 1.0 and v.values["malformed"] == 0
    assert v.values["dist_err"] < 1e-7


def test_padding_where_the_reference_is_short_too():
    data, pool, d, order = setup()
    ids, dists = answer(d, order, 5)
    ids[:, 3:], dists[:, 3:] = -1, np.inf
    v = judge(data, pool, ids, dists, ids.astype(np.int64))
    assert v.correct


def test_a_short_answer_padded_with_inf():
    """The device search pads a short answer with a repeated id at inf:
    no result, and correct where the reference is as short."""
    data, pool, d, order = setup()
    ids, dists = answer(d, order, 5)
    ref = ids.astype(np.int64)
    ref[:, 3:] = -1
    gt = ids.astype(np.int64)
    ids[:, 3:], dists[:, 3:] = ids[:, :1], np.inf
    v = judge(data, pool, ids, dists, ref, gt)
    assert v.correct and v.why_bad == {}
    assert v.recall == 3 / 5


def test_faults_are_counted():
    data, pool, d, order = setup()
    ref, _ = answer(d, order, 5)
    ref = ref.astype(np.int64)
    cases = {}
    ids, dists = answer(d, order, 5)
    ids[0, 4] = ids[0, 3]                                 # a repeated id
    cases["repeat"] = (ids, dists)
    ids, dists = answer(d, order, 5)
    ids[1, 2] = 50                                       # outside the data
    cases["range"] = (ids, dists)
    ids, dists = answer(d, order, 5)
    ids[0, 3:], dists[0, 3:] = -1, np.inf                # short
    cases["short"] = (ids, dists)
    ids, dists = answer(d, order, 5)
    dists[1] = dists[1, ::-1]                            # out of order
    cases["order"] = (ids, dists)
    for name, (ids, dists) in cases.items():
        v = judge(data, pool, ids, dists, ref)
        assert not v.correct and v.values["malformed"] >= 1, name
    # the 5th nearest missed: the 6th given instead, with its own distance
    ids, dists = answer(d, order, 6)
    ids, dists = np.delete(ids, 4, 1), np.delete(dists, 4, 1)
    v = judge(data, pool, ids, dists, ref)
    assert v.values["malformed"] == 0 and v.values["differ"] == 1.0
    assert v.values["dist_err"] < 1e-7 and v.recall == 0.8
    # a distance that is not the returned id's
    ids, dists = answer(d, order, 5)
    dists[0, 0] *= 1.01
    v = judge(data, pool, ids, dists, ref)
    assert v.values["dist_err"] > 1e-5 and not v.correct


def test_lists_that_break_the_closure_rule_are_not_correct():
    data, pool, d, order = setup()
    ids, dists = answer(d, order, 5)
    v = judge(data, pool, ids, dists, ids.astype(np.int64), lists=1e-4)
    assert not v.correct and v.values["lists_differ"] == 1e-4
    assert v.values["differ"] == 0.0 and v.values["malformed"] == 0
