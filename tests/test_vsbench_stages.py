"""The benchmark's reading of the port's own spans and counters
(``vsbench/stages.py``), the tool that runs a cell with them on
(``tools/trace_stages.py``), and the harness's runs, which leave the
recorder off; on the CPU at small sizes."""
import importlib.util
import json
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "tools"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from repro_torch import spans  # noqa: E402
from repro_torch.core.cluster_index import device_search_batch  # noqa: E402
from vsbench import devtrace, harness, stages  # noqa: E402
from vsbench.system import Program  # noqa: E402

NAMES = ([f"{s}_device_ms" for s in stages.STAGES]
         + ["search_host_ms", "launches_per_batch", "padded_row_share",
            "short_answer_share", "bkt_s", "closure_s", "device_arrays_s"])


def _vsbench_conftest():
    spec = importlib.util.spec_from_file_location(
        "vsbench_tests_conftest", ROOT / "vsbench" / "tests" / "conftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


@pytest.fixture
def tiny_root(tmp_path):
    conf = _vsbench_conftest()
    return conf.make_root(tmp_path), conf.TINY


def ev(name, a, b, cat="user_annotation", corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def hand_trace():
    """One window, one batch: each stage launches a kernel; one launch in
    the search between its stages, one outside it, one before the window,
    and a device op with no launch."""
    S = "repro_torch.search"
    return [
        {"ph": "M", "name": "process_name"},
        ev(devtrace.WINDOW, 0, 1000),
        ev("vsbench.search", 100, 600),
        ev(S, 110, 590),
        ev(S + ".probe", 120, 200), ev(S + ".select", 200, 300),
        ev(S + ".gather", 300, 350), ev(S + ".scan", 350, 450),
        ev(S + ".merge", 450, 550), ev(S + ".count", 560, 585),
        ev("aten::sort", 205, 290, "cpu_op"),
        *[ev("cudaLaunchKernel", t, t + 5, "cuda_runtime", c) for t, c in
          [(130, 1), (210, 2), (220, 3), (310, 4), (360, 5), (460, 6),
           (570, 7), (586, 8), (650, 9), (-100, 10)]],
        ev("l2_distance_wide_kernel", 140, 160, "kernel", 1),
        ev("radix_sort", 230, 330, "kernel", 2),
        ev("radix_sort", 330, 400, "kernel", 3),
        ev("index_elementwise", 400, 430, "gpu_memcpy", 4),
        ev("gemv2T", 430, 480, "kernel", 5),
        ev("topk", 480, 500, "kernel", 6),
        ev("reduce", 590, 600, "kernel", 7),
        ev("Memcpy DtoD", 600, 610, "gpu_memcpy", 8),
        ev("receive_copy", 660, 700, "gpu_memcpy", 9),
        ev("early", -90, 20, "kernel", 10),          # 0-20 in the window
        ev("no_launch", 800, 805, "gpu_memset"),
        ev(S + ".probe", 120, 200, "gpu_user_annotation", 99),   # a mirror
    ]


def test_ops_go_to_the_stage_that_launched_them():
    got = stages.reduce(hand_trace())
    S = "repro_torch.search"
    us = pytest.approx
    assert got[S + ".probe"].device_s == us(20e-6)
    assert got[S + ".select"].device_s == us(170e-6)        # 100 + 70
    assert got[S + ".select"].launches == 2
    assert got[S + ".gather"].device_s == us(30e-6)
    assert got[S + ".scan"].device_s == us(50e-6)
    assert got[S + ".merge"].device_s == us(20e-6)
    assert got[S + ".count"].device_s == us(10e-6)
    # launched inside the search but between its stages
    assert got[S].device_s == us(10e-6) and got[S].launches == 1
    # launched outside the search, before the window, or by nothing
    assert got[stages.OTHER].device_s == us(40e-6 + 20e-6 + 5e-6)
    assert got[stages.OTHER].launches == 3
    assert got[stages.OTHER].ranges == 0
    # host self time: the search's range less its six stages
    assert got[S].host_s == us((480 - 80 - 100 - 50 - 100 - 100 - 25) * 1e-6)
    assert got[S + ".select"].host_s == us(100e-6)
    assert all(got[S + "." + s].ranges == 1 for s in stages.STAGES)


def test_the_existing_reduction_reads_the_same_trace_as_before():
    tr = devtrace.reduce(hand_trace())
    assert tr.window_s == pytest.approx(1e-3)
    # 0-20, 140-160, 230-500, 590-610, 660-700, 800-805
    assert tr.busy_s == pytest.approx(375e-6)
    assert tr.kernel_time("radix_sort") == (pytest.approx(170e-6), 2)


def test_a_prefix_of_the_harness_holds_what_its_phase_launched():
    got = stages.reduce(hand_trace(), "vsbench.search")
    assert got["vsbench.search"].device_s == pytest.approx(310e-6)
    assert got["vsbench.search"].launches == 8


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        stages.reduce([ev("x", 0, 1)])


def test_every_reading_is_none_without_program_data():
    assert stages.readings(None, None, None) == dict.fromkeys(NAMES)
    empty = {"spans": [], "counters": {}}
    assert stages.readings({}, empty, empty) == dict.fromkeys(NAMES)
    # a device trace alone, with no program range in it
    only = stages.reduce([ev(devtrace.WINDOW, 0, 10),
                          ev("k", 1, 2, "kernel", 1),
                          ev("cudaLaunchKernel", 0, 1, "cuda_runtime", 1)])
    assert set(only) == {stages.OTHER}
    assert stages.readings(only, None, None) == dict.fromkeys(NAMES)


def test_the_readings_of_a_hand_made_run():
    S = "repro_torch.search"

    def sp(name, a, b, parent=None):
        return {"name": name, "parent": parent, "batch": None,
                "start_ns": a, "end_ns": b}

    window = {"spans": [sp(S, 0, 2_000_000), sp(S + ".count", 1_500_000,
                                                 1_900_000, 0),
                        sp(S, 3_000_000, 4_000_000)],
              "counters": {"search.batches": 2, "search.queries": 1000,
                           "search.rows_gathered": 400,
                           "search.rows_filled": 100,
                           "search.short_answers": 3}}
    build = {"spans": [sp("repro_torch.build.bkt", 0, 2_000_000_000),
                       sp("repro_torch.build.closure", 0, 500_000_000),
                       sp("repro_torch.build.device_arrays", 0, 250_000_000)],
             "counters": {}}
    got = stages.readings(stages.reduce(hand_trace()), window, build)
    assert got["probe_device_ms"] == pytest.approx(0.010)
    assert got["select_device_ms"] == pytest.approx(0.085)
    assert got["gather_device_ms"] == pytest.approx(0.015)
    assert got["scan_device_ms"] == pytest.approx(0.025)
    assert got["merge_device_ms"] == pytest.approx(0.010)
    assert got["search_host_ms"] == pytest.approx((3.0 - 0.4) / 2)
    # six launches in the stages and one between them; not count's
    assert got["launches_per_batch"] == pytest.approx(7 / 2)
    assert got["padded_row_share"] == pytest.approx(75.0)
    assert got["short_answer_share"] == pytest.approx(0.3)
    assert (got["bkt_s"], got["closure_s"], got["device_arrays_s"]) == (
        pytest.approx(2.0), pytest.approx(0.5), pytest.approx(0.25))


def test_a_cpu_profile_of_the_search_read_back():
    """The program's ranges in a real export: each stage once a batch,
    host time and no device op on the CPU."""
    g = torch.Generator().manual_seed(0)
    cents = torch.randn(32, 8, generator=g)
    vecs = torch.randn(32, 5, 8, generator=g)
    ids = torch.arange(160, dtype=torch.int32).reshape(32, 5)
    q = torch.randn(16, 8, generator=g)
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(devtrace.WINDOW):
            for _ in range(3):
                with record_function("vsbench.search"):
                    device_search_batch(cents, vecs, ids, q, nprobe=4, k=5)
    got = stages.reduce(devtrace.read(prof))
    for s in stages.STAGES + ("count",):
        st = got[f"{stages.SEARCH}.{s}"]
        assert st.ranges == 3 and st.host_s > 0 and st.device_s == 0
    assert got[stages.SEARCH].ranges == 3


def test_the_tool_on_the_cpu(tiny_root, capsys):
    import trace_stages
    root, cell = tiny_root
    assert trace_stages.main(["--workload", cell, "--seed", str(2**40 + 3),
                              "--seconds", "0.2",
                              "--trace", "0", "--spans", "1",
                              "--device", "cpu", "--root", str(root)]) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["correct"]
    r, c = out["readings"], out["checked"]
    assert r["padded_row_share"] == pytest.approx(
        c["padded_row_share_reference"], abs=1e-9)
    assert 0.8 <= c["build_spans_over_index_build"] <= 1.0
    assert r["short_answer_share"] == 0.0 and r["search_host_ms"] > 0
    assert out["counters"]["search.batches"] == out["batches"]
    assert r["probe_device_ms"] is None        # no device trace on the CPU
    assert not spans.enabled()


@pytest.mark.parametrize("traced", [False, True])
def test_the_harness_leaves_the_recorder_off(tiny_root, traced):
    """A harness run, traced or not, never turns the recorder on, and its
    result holds the metrics it held before."""
    root, cell_name = tiny_root
    cell = harness.load_cell(root, cell_name)
    with mock.patch.object(spans, "enable",
                           side_effect=AssertionError("recorder enabled")):
        out = harness.run(root, cell, 11, 0.2, traced, torch.device("cpu"),
                          Program(), time.perf_counter())
    assert not spans.enabled()
    assert spans.snapshot() == {"spans": [], "counters": {}}
    assert out["correct"]
    # on the CPU: no device trace, no roofline
    want = ({"index_build_s"} if traced
            else {"queries_per_s", "recall_at_10", "setup_s"})
    assert set(out["metrics"]) == want
    assert np.isfinite([m["value"] for m in out["metrics"].values()]).all()
