"""The index kind as a property of the configuration: the SPANN cell reads
as before, a second kind runs from new files only, the harness refuses a
mix, a limit or a kind it cannot take, and a per-layer metric of the
program's recorder reads its snapshots."""
import dataclasses
import hashlib
import json
import textwrap
import time
from unittest import mock

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY
from repro_torch import spans
from vsbench import check, harness, kinds, loadgen
from vsbench.system import Program
from test_vsbench_faults import DroppedReplicas

# Recorded from the tree before index kinds, by the same runs through its
# harness.run (the reference's answers and work counts read by wrapping its
# harness.reference and Reference.batch_work): each case's checks (floats
# as float.hex), recall@10, and the sha256 of the reference's ids and exact
# top-k (int64, C order), and every batch's (FLOP, bytes).
GOLDEN = {
    (5, "Program"): dict(
        checks={"malformed": 0, "lists_differ": 0.0,
                "dist_err": "0x1.7665f171ef943p-22", "differ": 0.0},
        correct=True, recall="0x1.bf66666666666p-1",
        ids="b83a2299b3e86b295577d2ba3371cafe3f1d7a5d257e0c2c72029c14498969fb",
        gt="5363e490924bf6a9aa323d7ecb3922f79eca14f81cec892ab33d1790bc1f4e1c",
        work={0: (2985344, 484324), 64: (2980416, 489076),
              128: (2992000, 458056), 192: (2994432, 467824)}),
    (2**31 + 7, "Program"): dict(
        checks={"malformed": 0, "lists_differ": 0.0,
                "dist_err": "0x1.ac9dc9a2b13e4p-22", "differ": 0.0},
        correct=True, recall="0x1.bb66666666666p-1",
        ids="5df449cdb703d6f3e1921340631990984334159c85d5c8baff1dc8944de2f73f",
        gt="caca0a261f217b74c0cf4dbaba3ef734d17fc89d2c953aee812f64a9c01c2c7c",
        work={0: (3009536, 497640), 64: (3002112, 469392),
              128: (3001152, 474012), 192: (3003712, 511896)}),
    (9, "DroppedReplicas"): dict(
        checks={"malformed": 0, "lists_differ": "0x1.6ff513cc1e099p-3",
                "dist_err": "0x1.64363da43901ap-22",
                "differ": "0x1.6c00000000000p-1"},
        correct=False, recall="0x1.8366666666666p-1",
        ids="c333fe2c60953e7a2bc25ff30bce7acb2844a0dc9f726327301d1e5b31da60a4",
        gt="90e422daf80d8bb73fdb50283af58c383ff882f8181a5ee1706428bfe745d075",
        work={0: (3004160, 452604), 64: (3018304, 468708),
              128: (3008384, 475572), 192: (3018560, 472536)}),
}
SYSTEMS = {"Program": Program, "DroppedReplicas": DroppedReplicas}


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def as_float(v):
    return float.fromhex(v) if isinstance(v, str) else v


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


@pytest.mark.parametrize("seed, system", list(GOLDEN))
def test_the_spann_cell_reads_as_before(tiny_root, seed, system):
    """One walk of the pool (``seconds`` 0): the verdict, recall, the
    reference's answers and every batch's work are the older tree's."""
    want = GOLDEN[(seed, system)]
    cell = harness.load_cell(tiny_root, TINY)
    assert cell.kind.name == "spann" and "index" not in cell.config
    got = []

    def spy(*a):
        got.append(reference(*a))
        return got[-1]
    reference = cell.kind.reference
    cell = dataclasses.replace(cell, kind=dataclasses.replace(cell.kind,
                                                              reference=spy))
    out = harness.run(tiny_root, cell, seed, 0.0, False, torch.device("cpu"),
                      SYSTEMS[system](), time.perf_counter())
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert list(out["checks"]) == ["malformed", "lists_differ", "dist_err",
                                   "differ"]
    assert {n: c["value"] for n, c in out["checks"].items()} == {
        n: as_float(v) for n, v in want["checks"].items()}
    assert out["correct"] is want["correct"]
    assert (out["attempted"], out["failed"]) == (256, 0)
    assert out["metrics"]["recall_at_10"]["value"] == as_float(want["recall"])
    (rf,) = got
    assert (sha(rf.ids), sha(rf.gt)) == (want["ids"], want["gt"])
    assert rf.work == want["work"]


KIND = {
    "kind.py": '''
        """Exact search by brute force, for the harness's tests."""
        KNOBS = ("block",)
        NUMBERS = ("vectors_differ",)


        def params(cfg):
            return {}
        ''',
    "system.py": '''
        import torch


        class Program:
            def prepare(self, device):
                pass

            def build(self, data, params, device):
                x = torch.from_numpy(data).to(device, copy=True)
                return {"x": x, "shapes": {"n": x.shape[0], "dim": x.shape[1]}}

            def built(self, state):
                return {"vectors": state["x"].cpu().numpy()}

            def search(self, state, queries, k, block):
                x = state["x"]
                out = []
                for s in range(0, queries.shape[0], block):
                    q = queries[s:s + block]
                    d = ((q[:, None, :] - x[None]) ** 2).sum(-1)
                    out.append(torch.topk(d, k, largest=False, sorted=True))
                return (torch.cat([o.indices for o in out]),
                        torch.cat([o.values for o in out]))
        ''',
    "reference.py": '''
        import numpy as np

        from vsbench import work
        from vsbench.kinds import Answers


        def reference(data, pool, built, params, gen, device):
            x = data.astype(np.float64)
            d = ((pool.astype(np.float64)[:, None, :] - x[None]) ** 2).sum(-1)
            ids = np.argsort(d, 1, kind="stable")[:, :gen.k]
            w = work.l2_distance_work(gen.batch, *data.shape)
            differ = (built["vectors"] != data).any(1).mean()
            return Answers(ids=ids, gt=ids,
                           work={gen.rows(b).start: w for b in range(gen.slots)},
                           numbers={"vectors_differ": float(differ)}, notes={})
        ''',
}
EXACT = "tiny-exact.b64"


def add_exact(root, limits=None, traffic=None, index="exact"):
    """The exact kind, a configuration, a traffic mix, limits and a cell,
    as new files under ``root``."""
    kind = root / "vsbench" / "kinds" / "exact"
    kind.mkdir()
    for name, body in KIND.items():
        (kind / name).write_text(textwrap.dedent(body))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "vsbench" / "configs" / "tiny.json").read_text())
    cfg.update(name="tiny-exact", index=index)
    (root / "vsbench" / "configs" / "tiny-exact.json").write_text(json.dumps(cfg))
    (root / "vsbench" / "traffic" / "exact.b64.json").write_text(json.dumps(
        traffic or {"loop": "closed", "clients": 1, "batch": 64, "k": 10,
                    "block": 16}))
    (root / "vsbench" / "checks" / f"{EXACT}.json").write_text(json.dumps(
        limits or {"malformed": 0, "dist_err": 1e-5, "differ": 0.002,
                   "vectors_differ": 0.0}))
    conf = next(c for c in bench["configs"] if c["name"] == "tiny")
    cell = next(w for w in bench["workloads"] if w["name"] == TINY)
    bench["configs"].append({**conf, "name": "tiny-exact",
                             "file": "vsbench/configs/tiny-exact.json"})
    bench["workloads"].append({**cell, "name": EXACT, "config": "tiny-exact",
                               "traffic": "exact.b64"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_second_kind_runs_from_new_files_only(tiny_root):
    from test_vsbench_datadriven import digests
    before = digests(ROOT)
    add_exact(tiny_root)
    after = digests(tiny_root)
    assert all(after[f] == h for f, h in before.items())
    assert digests(ROOT) == before
    cell = harness.load_cell(tiny_root, EXACT)
    assert (cell.kind.name, cell.kind.knobs) == ("exact", ("block",))
    system = cell.kind.program()
    out = harness.run(tiny_root, cell, 3, 0.2, False, torch.device("cpu"),
                      system, time.perf_counter())
    assert out["correct"] and out["failed"] == 0
    assert list(out["checks"]) == ["malformed", "dist_err", "differ",
                                   "vectors_differ"]
    assert out["checks"]["vectors_differ"]["value"] == 0.0
    assert out["metrics"]["recall_at_10"]["value"] == 1.0
    assert set(out["metrics"]) == {"queries_per_s", "recall_at_10", "setup_s"}

    class Moved(type(system)):
        """The index holds one vector off by one unit: the kind's own
        number fails it, though every answer may still be right."""

        def build(self, data, params, device):
            state = super().build(data, params, device)
            state["x"][0] += 1.0
            return state
    out = harness.run(tiny_root, cell, 3, 0.0, False, torch.device("cpu"),
                      Moved(), time.perf_counter())
    assert not out["correct"]
    assert out["checks"]["vectors_differ"]["value"] == 1 / 3000


def test_the_spann_knob_and_limits_are_the_kinds():
    kind = kinds.load(ROOT, "spann")
    assert (kind.knobs, kind.numbers) == (("nprobe",), ("lists_differ",))
    cell = harness.load_cell(ROOT, "random-s-100.b500.np16")
    gen = loadgen.generator(cell.traffic, 10_000, kind.knobs)
    assert (gen.batch, gen.k, gen.knobs, gen.nprobe) == (500, 10,
                                                         {"nprobe": 16}, 16)
    assert harness.index_params(cell.config) == kind.params(cell.config)


@pytest.mark.parametrize("traffic", [
    {"search_len": 64},                     # a knob the kind has not
    {"nprobe": None},                       # the kind's knob left out
])
def test_an_unknown_or_missing_traffic_key_is_refused(traffic):
    mix = {"loop": "closed", "clients": 1, "batch": 500, "k": 10,
           "nprobe": 16, **traffic}
    mix = {key: v for key, v in mix.items() if v is not None}
    with pytest.raises(ValueError, match="keys"):
        loadgen.generator(mix, 10_000, ("nprobe",))


@pytest.mark.parametrize("case", ["missing limit", "stray limit",
                                  "unknown index", "unknown knob"])
def test_what_the_kind_cannot_take_is_refused(tiny_root, case):
    limits = {"malformed": 0, "dist_err": 1e-5, "differ": 0.002,
              "vectors_differ": 0.0}
    traffic = {"loop": "closed", "clients": 1, "batch": 64, "k": 10,
               "block": 16}
    index = "exact"
    if case == "missing limit":
        del limits["vectors_differ"]
    elif case == "stray limit":
        limits["lists_differ"] = 0.0
    elif case == "unknown index":
        index = "nosuch"
    else:
        traffic["nprobe"] = 8
    add_exact(tiny_root, limits, traffic, index)
    with pytest.raises(ValueError):
        cell = harness.load_cell(tiny_root, EXACT)
        harness.run(tiny_root, cell, 3, 0.0, False, torch.device("cpu"),
                    cell.kind.program(), time.perf_counter())


def test_a_number_and_its_limit_are_matched():
    data = np.zeros((4, 2), np.float32)
    ids = np.arange(2)[None, None].repeat(2, 1).astype(np.int32)
    dists = np.zeros((1, 2, 2), np.float32)
    args = (np.array([0]), ids, dists, data[:2], data, ids[0], ids[0], 2)
    limits = {"malformed": 0, "dist_err": 0.0, "differ": 0.0, "own": 0.0}
    assert check.judge(*args, limits, {"own": 0.0}).correct
    for own in ({}, {"own": 0.0, "more": 0.0}, {"other": 0.0}):
        with pytest.raises(ValueError, match="limit"):
            check.judge(*args, limits, own)


READERS = {
    "search_batches": ("program_counter", '''
        def read(rec):
            snap = rec.window_snapshot
            return None if snap is None else snap["counters"]["search.batches"]
        '''),
    "bkt_spans": ("program_span", '''
        def read(rec):
            snap = rec.build_snapshot
            if snap is None:
                return None
            return sum(s["name"] == "repro_torch.build.bkt" for s in snap["spans"])
        '''),
    "search_ranges": ("program_span", '''
        from vsbench import stages


        def read(rec):
            if rec.events is None:
                return None
            return stages.reduce(rec.events)[stages.SEARCH].ranges
        '''),
}


def add_readers(root, names):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name in names:
        source, body = READERS[name]
        bench["per_layer"].append({
            "name": name, "unit": "count", "better": "higher",
            "source": source, "layer": "device search",
            "moves": "queries_per_s", "workloads": [TINY]})
        (root / "vsbench" / "metrics" / f"{name}.py").write_text(
            textwrap.dedent(body))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_program_metric_reads_the_recorder(tiny_root):
    add_readers(tiny_root, READERS)
    cell = harness.load_cell(tiny_root, TINY)
    out = harness.run(tiny_root, cell, 13, 0.2, True, torch.device("cpu"),
                      Program(), time.perf_counter())
    assert out["correct"] and not spans.enabled()
    batches = out["attempted"] // 64
    got = {n: m["value"] for n, m in out["metrics"].items()}
    # the window's batches alone: the warm-up's were reset away
    assert got["search_batches"] == got["search_ranges"] == batches
    assert got["bkt_spans"] == 1
    # untraced, the recorder stays off and nothing reads it
    with mock.patch.object(spans, "enable",
                           side_effect=AssertionError("recorder enabled")):
        out = harness.run(tiny_root, cell, 13, 0.0, False,
                          torch.device("cpu"), Program(), time.perf_counter())
    assert out["correct"] and set(out["metrics"]) == {
        "queries_per_s", "recall_at_10", "setup_s"}


def test_without_a_program_metric_the_recorder_stays_off(tiny_root):
    """A traced run whose metrics read nothing of the recorder keeps its
    snapshots and events empty, as does a system with no recorder."""
    seen = []

    def reader(rec):
        seen.append((rec.build_snapshot, rec.window_snapshot, rec.events))
    cell = harness.load_cell(tiny_root, TINY)
    with mock.patch.object(spans, "enable",
                           side_effect=AssertionError("recorder enabled")), \
            mock.patch.object(harness, "load_reader", lambda *a: reader):
        harness.run(tiny_root, cell, 13, 0.0, True, torch.device("cpu"),
                    Program(), time.perf_counter())
        add_readers(tiny_root, ["search_batches"])
        cell = harness.load_cell(tiny_root, TINY)

        class NoRecorder:
            def __init__(self):
                self.p = Program()

            def __getattr__(self, name):
                if name == "trace":
                    raise AttributeError(name)
                return getattr(self.p, name)
        harness.run(tiny_root, cell, 13, 0.0, True, torch.device("cpu"),
                    NoRecorder(), time.perf_counter())
    assert seen and all(s == (None, None, None) for s in seen)
