"""The port's recorder of spans and counters (``repro_torch.spans``) and
what the SPANN build and device search record with it, on the CPU."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.core.cluster_index import ClusterIndex, device_search_batch
from repro_torch.core.distances import pairwise_sq_l2, topk_smallest
from repro_torch.core.types import ClusterIndexParams

STAGES = ("probe", "select", "gather", "scan", "merge")


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def hand_index():
    """16 lists of 4-d vectors, at most 6 entries a list.  Lists 0-7 lie
    about the origin and hold the same 5 points (0-4) each, so a query
    there that probes 8 lists sees 40 entries of 5 points; lists 8-15 lie
    about (100, 0, 0, 0) and hold 41 points (5-45), list 15 six of them."""
    g = np.random.default_rng(3)
    L, ml, D = 16, 6, 4
    cents = np.zeros((L, D), np.float32)
    cents[:, 1] = np.arange(L) * 0.01
    cents[8:, 0] = 100.0
    pts = g.normal(0.0, 0.1, (46, D)).astype(np.float32)
    pts[5:, 0] += 100.0
    vecs = np.zeros((L, ml, D), np.float32)
    ids = np.full((L, ml), -1, np.int32)
    for li in range(8):
        ids[li, :5] = np.arange(5)
    for j, li in enumerate(range(8, 16)):
        members = np.arange(5 + 5 * j, 10 + 5 * j)
        if li == 15:
            members = np.arange(40, 46)
        ids[li, :len(members)] = members
    filled = ids >= 0
    vecs[filled] = pts[ids[filled]]
    queries = np.array([[0.05, 0.0, 0.0, 0.0], [100.05, 0.0, 0.0, 0.0]],
                       np.float32)
    return (torch.from_numpy(cents), torch.from_numpy(vecs),
            torch.from_numpy(ids), torch.from_numpy(queries))


def search(index, nprobe=8, k=10):
    cents, vecs, ids, q = index
    return device_search_batch(cents, vecs, ids, q, nprobe=nprobe, k=k)


def test_off_records_nothing_and_costs_a_shared_null_context():
    assert not spans.enabled()
    a, b = spans.span("x"), spans.span("y", batch=3)
    assert a is b
    with a:
        spans.count("n", 5)
        spans.count("d", torch.tensor(2))
    assert spans.next_batch("search.batches") is None
    search(hand_index())
    assert spans.snapshot() == {"spans": [], "counters": {}}


def test_spans_nest_with_parent_and_batch():
    spans.enable()
    with spans.span("outer", batch=spans.next_batch("b")):
        with spans.span("inner"):
            pass
        with spans.span("inner2"):
            with spans.span("leaf"):
                pass
    with spans.span("outer", batch=spans.next_batch("b")):
        pass
    got = spans.snapshot()
    assert [(s["name"], s["parent"], s["batch"]) for s in got["spans"]] == [
        ("outer", None, 0), ("inner", 0, None), ("inner2", 0, None),
        ("leaf", 2, None), ("outer", None, 1)]
    for s in got["spans"]:
        assert s["start_ns"] <= s["end_ns"]
    o, i = got["spans"][0], got["spans"][3]
    assert o["start_ns"] <= i["start_ns"] <= i["end_ns"] <= o["end_ns"]
    assert got["counters"] == {"b": 2}
    spans.reset()
    assert spans.snapshot() == {"spans": [], "counters": {}}
    assert spans.next_batch("b") == 0


def test_counters_add_host_ints_and_device_tensors():
    spans.enable()
    spans.count("host", 3)
    spans.count("host", 4)
    spans.count("dev", torch.tensor(5))
    spans.count("dev", torch.tensor([1, 1, 0]).sum())
    assert spans.snapshot()["counters"] == {"host": 7, "dev": 7}
    spans.disable()
    spans.count("host", 100)
    assert spans.snapshot()["counters"] == {"host": 7, "dev": 7}


def test_a_span_is_a_user_annotation_under_the_profiler(tmp_path):
    spans.enable()
    index = hand_index()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        search(index)
        search(index)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    names = [e["name"] for e in ranges]
    for name in ["repro_torch.search", "repro_torch.search.count"] + [
            f"repro_torch.search.{s}" for s in STAGES]:
        assert names.count(name) == 2, name
    stages = [e for e in ranges if e["name"] == "repro_torch.search.probe"]
    top = [e for e in ranges if e["name"] == "repro_torch.search"]
    for outer, inner in zip(top, stages):
        assert outer["ts"] <= inner["ts"] <= inner["ts"] + inner["dur"] \
            <= outer["ts"] + outer["dur"]
    assert [s["batch"] for s in spans.snapshot()["spans"]
            if s["name"] == "repro_torch.search"] == [0, 1]


def test_the_search_records_its_stages_in_order():
    spans.enable()
    search(hand_index())
    got = spans.snapshot()["spans"]
    assert [s["name"] for s in got] == ["repro_torch.search"] + [
        f"repro_torch.search.{s}" for s in STAGES] + ["repro_torch.search.count"]
    assert got[0]["parent"] is None and got[0]["batch"] == 0
    assert all(s["parent"] == 0 and s["batch"] is None for s in got[1:])
    ends = [s["end_ns"] for s in got[1:]]
    starts = [s["start_ns"] for s in got[1:]]
    assert all(e <= s for e, s in zip(ends, starts[1:]))


@pytest.mark.parametrize("nprobe,k", [(8, 10), (3, 4), (16, 10)])
def test_the_answers_are_the_same_bits_on_and_off(nprobe, k):
    index = hand_index()
    ids_off, d_off = search(index, nprobe, k)
    spans.enable()
    ids_on, d_on = search(index, nprobe, k)
    assert torch.equal(ids_on, ids_off)
    assert d_on.numpy().tobytes() == d_off.numpy().tobytes()


def test_the_search_counts_rows_and_short_answers():
    index = hand_index()
    cents, vecs, ids, q = index
    nprobe, k = 8, 10
    spans.enable()
    out_ids, out_d = search(index, nprobe, k)
    c = spans.snapshot()["counters"]
    _, probe = topk_smallest(pairwise_sq_l2(q, cents), nprobe)
    list_len = (ids >= 0).sum(1)
    B, ml = q.shape[0], ids.shape[1]
    assert c["search.batches"] == 1 and c["search.queries"] == B
    assert c["search.rows_gathered"] == B * nprobe * ml == 96
    assert c["search.rows_filled"] == int(list_len[probe].sum()) == 40 + 41
    # the first query's window holds 40 entries of 5 points: short
    assert torch.isinf(out_d[0]).sum() == 5 and torch.isfinite(out_d[1]).all()
    assert c["search.short_answers"] == 1
    search(index, nprobe, k)
    c = spans.snapshot()["counters"]
    assert (c["search.batches"], c["search.short_answers"],
            c["search.rows_filled"]) == (2, 2, 162)


def test_the_build_records_its_three_parts():
    g = np.random.default_rng(0)
    data = g.normal(size=(400, 8)).astype(np.float32)
    spans.enable()
    index = ClusterIndex.build(data, ClusterIndexParams(seed=0), device="cpu")
    index.device_arrays()
    got = spans.snapshot()["spans"]
    assert [s["name"] for s in got] == [
        "repro_torch.build.bkt", "repro_torch.build.closure",
        "repro_torch.build.device_arrays"]
    assert all(s["parent"] is None and s["end_ns"] > s["start_ns"]
               for s in got)
    assert got[0]["end_ns"] <= got[1]["start_ns"]


def test_the_build_is_the_same_on_and_off():
    g = np.random.default_rng(1)
    data = g.normal(size=(300, 8)).astype(np.float32)
    off = ClusterIndex.build(data, ClusterIndexParams(seed=0),
                             device="cpu").device_arrays()
    spans.enable()
    on = ClusterIndex.build(data, ClusterIndexParams(seed=0),
                            device="cpu").device_arrays()
    for key in off:
        np.testing.assert_array_equal(on[key], off[key])
