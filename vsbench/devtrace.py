"""Reduce a ``torch.profiler`` trace of the window to what the per-layer
metrics and the result's ``breakdown`` read.

Device time is every operation the trace puts on the card (kernels, copies,
fills; not the harness's own ranges, which the profiler mirrors onto the
device's timeline as ``gpu_user_annotation``), clipped to the window, which
the harness marks with a ``record_function`` range.  Busy time is the union of those intervals; an
idle gap is a stretch of the window between them, named by what the host
was doing at its middle: the harness's phase and the innermost operator it
was in.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile

import numpy as np

WINDOW = "vsbench.window"
PHASES = ("vsbench.send", "vsbench.search", "vsbench.receive")
TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: list             # [[name, seconds], ...] most time first
    idle_gaps: list              # [[host activity, seconds], ...]
    kernels: dict                # device op name -> (total seconds, count)

    def kernel_time(self, part: str) -> tuple[float, int]:
        """Seconds and count of the device ops whose name holds ``part``."""
        hits = [v for name, v in self.kernels.items() if part in name]
        return sum(s for s, _ in hits), sum(c for _, c in hits)


def _union(iv: np.ndarray) -> np.ndarray:
    """Merge (start, end) intervals, sorted by start."""
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.array(out).reshape(-1, 2)


def _innermost(starts, ends, names, t: float, depth: int = 64) -> str | None:
    """Name of the latest-starting event that contains time ``t``."""
    j = bisect.bisect_right(starts, t) - 1
    for i in range(j, max(j - depth, -1), -1):
        if ends[i] >= t:
            return names[i]
    return None


DEVICE = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}


def read(prof) -> list:
    """The trace's events, through the profiler's chrome-trace export (a
    temporary file): building ``prof.events()`` takes minutes at the
    window's ~10^5 operators, the export and its parse seconds."""
    with tempfile.TemporaryDirectory(prefix="vsbench_trace_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def reduce(events: list) -> Trace:
    """``events`` are a chrome trace's events holding one ``vsbench.window``
    range (``ph`` "X": ``cat``, ``name``, ``ts`` and ``dur`` in us)."""
    dev, cpu, phase = [], [], []
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat in DEVICE:
            dev.append((name, a, b))
        elif cat not in HOST:
            continue
        elif name == WINDOW:
            window = (a, b)
        elif name in PHASES:
            phase.append((a, b, name))
        else:
            cpu.append((a, b, name))
    if window is None:
        raise ValueError(f"the trace holds no {WINDOW} range")
    w0, w1 = window
    kernels: dict = {}
    iv = []
    for name, a, b in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        tot, cnt = kernels.get(name, (0.0, 0))
        kernels[name] = (tot + (b - a) * 1e-6, cnt + 1)
        iv.append((a, b))
    busy = _union(np.array(sorted(iv)).reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-6
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    cpu.sort()
    phase.sort()
    c_s, c_e, c_n = ([c[i] for c in cpu] for i in range(3))
    p_s, p_e, p_n = ([p[i] for p in phase] for i in range(3))
    idle: dict = {}
    for a, b in edges:
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        ph = _innermost(p_s, p_e, p_n, mid) or "vsbench.client"
        op = _innermost(c_s, c_e, c_n, mid)
        key = f"{ph}:{op}" if op else ph
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-6
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy_s,
                 device_ops=[[n[:120], s] for n, (s, _) in ops],
                 idle_gaps=[[n[:120], s] for n, s in gaps], kernels=kernels)
