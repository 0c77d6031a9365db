"""The trace reduction on a hand-made trace."""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from vsbench import devtrace


def ev(name, a, b, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a}


def test_busy_idle_and_what_the_host_did():
    cuda = "kernel"
    events = [{"ph": "M", "name": "process_name"},
        ev("vsbench.window", 0, 1000, "user_annotation"),
        ev("vsbench.send", 0, 100, "user_annotation"),
        ev("vsbench.search", 100, 600, "user_annotation"),
        ev("vsbench.receive", 600, 1000, "user_annotation"),
        ev("aten::sort", 150, 400), ev("cudaLaunchKernel", 380, 390,
                                       "cuda_runtime"),
        ev("cudaMemcpyAsync", 610, 990, "cuda_runtime"),
        ev("l2_distance_wide_kernel", 120, 220, cuda),
        ev("l2_distance_wide_kernel", 200, 300, cuda),      # overlaps
        ev("sort_kernel", 500, 700, cuda),
        ev("Memcpy DtoH", 900, 1100, "gpu_memcpy"),          # past the window
        ev("early_kernel", -50, -10, cuda),                   # before it
        ev("vsbench.search", 100, 600, "gpu_user_annotation"),  # a mirror
    ]
    tr = devtrace.reduce(events)
    assert tr.window_s == pytest.approx(1e-3)
    # busy: 120-300, 500-700, 900-1000 = 480 us
    assert tr.busy_s == pytest.approx(480e-6)
    assert tr.kernel_time("l2_distance") == (pytest.approx(200e-6), 2)
    assert [n for n, _ in tr.device_ops] == [
        "l2_distance_wide_kernel", "sort_kernel", "Memcpy DtoH"]
    # gaps: 0-120 (mid 60, send), 300-500 (mid 400: sort ends at 400, the
    # launch ended at 390, so search:aten::sort), 700-900 (mid 800, copy)
    assert dict(tr.idle_gaps) == {
        "vsbench.send": pytest.approx(120e-6),
        "vsbench.search:aten::sort": pytest.approx(200e-6),
        "vsbench.receive:cudaMemcpyAsync": pytest.approx(200e-6)}


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        devtrace.reduce([ev("x", 0, 1)])


def test_a_profile_read_back():
    """The export the harness reads: the window and the host's ranges."""
    x = torch.randn(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(devtrace.WINDOW):
            for _ in range(3):
                with record_function("vsbench.search"):
                    torch.sort(x @ x)
                time.sleep(0.001)
    tr = devtrace.reduce(devtrace.read(prof))
    assert tr.window_s > 0.003 and tr.busy_s == 0 and tr.device_ops == []
    assert sum(s for _, s in tr.idle_gaps) == pytest.approx(tr.window_s)
