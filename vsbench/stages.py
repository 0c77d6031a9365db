"""The program's own spans and counters, read beside the device trace.

The system under test can record spans and counters of its own
(``repro_torch.spans``): ranges ``repro_torch.search`` around each batch
and ``repro_torch.search.{probe,select,gather,scan,merge}`` around its
stages, which a running profiler holds as ``user_annotation`` ranges, and
counters of the rows the gather reads and fills and of the short answers.
Here a chrome trace's device operations are put down to those ranges, and
the per-layer numbers are read from both.  Nothing here imports the port:
the spans come as ``snapshot()``'s plain dicts.

A device operation belongs to the range that launched it: the chrome
trace ties each kernel, copy and fill to the runtime call that launched it
by its ``correlation`` id, and the operation goes to the innermost range
of the prefix that holds that call on the host, or to ``other``.
"""
from __future__ import annotations

import dataclasses

from vsbench import devtrace

SEARCH = "repro_torch.search"
STAGES = ("probe", "select", "gather", "scan", "merge")
COUNT = SEARCH + ".count"          # the recorder's own device work
OTHER = "other"
LAUNCH = {"cuda_runtime", "cuda_driver"}
BUILD = ("bkt", "closure", "device_arrays")


@dataclasses.dataclass
class Stage:
    device_s: float = 0.0        # device time of the ops launched inside it
    host_s: float = 0.0          # its ranges' time less their inner ranges'
    launches: int = 0            # device ops launched inside it
    ranges: int = 0              # its ranges in the window


def _ranges(events: list, prefix: str, w0: float, w1: float) -> list:
    """``(start, end, name)`` of the host ranges named ``prefix`` or
    ``prefix.*`` that start inside the window, sorted by start."""
    out = []
    for e in events:
        name = e.get("name", "")
        if (e.get("ph") == "X" and e.get("cat") in devtrace.HOST
                and (name == prefix or name.startswith(prefix + "."))):
            a = float(e["ts"])
            if w0 <= a <= w1:
                out.append((a, a + float(e.get("dur", 0.0)), name))
    return sorted(out)


def reduce(events: list, prefix: str = SEARCH) -> dict[str, Stage]:
    """Range name -> :class:`Stage` over the ``vsbench.window`` range of a
    chrome trace's ``events``; device ops launched outside every range of
    ``prefix`` go to ``other``.  Device time is clipped to the window, as
    :func:`devtrace.reduce` clips it."""
    window = next((e for e in events if e.get("ph") == "X"
                   and e.get("name") == devtrace.WINDOW
                   and e.get("cat") in devtrace.HOST), None)
    if window is None:
        raise ValueError(f"the trace holds no {devtrace.WINDOW} range")
    w0 = float(window["ts"])
    w1 = w0 + float(window.get("dur", 0.0))
    ranges = _ranges(events, prefix, w0, w1)
    out: dict[str, Stage] = {}
    # host self time: a range's length less its direct inner ranges'
    open_: list[list] = []       # [end, name, self time]
    for a, b, name in ranges + [(float("inf"), float("inf"), "")]:
        while open_ and open_[-1][0] <= a:
            end, nm, own = open_.pop()
            st = out.setdefault(nm, Stage())
            st.host_s += own * 1e-6
            st.ranges += 1
        if not name:
            break
        if open_:
            open_[-1][2] -= b - a
        open_.append([b, name, b - a])
    launched = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launched[c] = float(e["ts"])
    starts = [r[0] for r in ranges]
    ends = [r[1] for r in ranges]
    names = [r[2] for r in ranges]
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in devtrace.DEVICE:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        t = launched.get((e.get("args") or {}).get("correlation"))
        name = (devtrace._innermost(starts, ends, names, t)
                if t is not None else None) or OTHER
        st = out.setdefault(name, Stage())
        st.device_s += (b - a) * 1e-6
        st.launches += 1
    return out


def _span_s(snap: dict | None, name: str) -> float | None:
    """Seconds of the spans called ``name`` in a snapshot, summed; ``None``
    where it holds none."""
    if not snap:
        return None
    got = [s["end_ns"] - s["start_ns"] for s in snap["spans"]
           if s["name"] == name and s["end_ns"] is not None]
    return sum(got) * 1e-9 if got else None


def search_host_ms(snap: dict | None) -> float | None:
    """Mean host time of a batch's ``repro_torch.search`` span, less the
    time of its ``count`` span (the recorder's own work)."""
    if not snap:
        return None
    spans = snap["spans"]
    own = [s["end_ns"] - s["start_ns"] for s in spans
           if s["name"] == SEARCH and s["end_ns"] is not None]
    if not own:
        return None
    counted = sum(s["end_ns"] - s["start_ns"] for s in spans
                  if s["name"] == COUNT and s["end_ns"] is not None)
    return (sum(own) - counted) * 1e-6 / len(own)


def readings(stages: dict | None, window: dict | None,
             build: dict | None) -> dict:
    """The per-layer numbers, each ``None`` where there is nothing to read:
    ``stages`` is :func:`reduce`'s result over a traced window, ``window``
    the program's snapshot of that window's batches, ``build`` its snapshot
    of the index build."""
    c = window["counters"] if window else {}
    batches = c.get("search.batches")
    dev = {n: s for n, s in (stages or {}).items() if n.startswith(SEARCH)}
    out = {}
    for s in STAGES:
        st = dev.get(f"{SEARCH}.{s}")
        out[f"{s}_device_ms"] = (1e3 * (st.device_s if st else 0.0) / batches
                                 if dev and batches else None)
    out["search_host_ms"] = search_host_ms(window)
    out["launches_per_batch"] = (
        sum(s.launches for n, s in dev.items() if n != COUNT) / batches
        if dev and batches else None)
    g, f = c.get("search.rows_gathered"), c.get("search.rows_filled")
    out["padded_row_share"] = 100.0 * (1.0 - f / g) if g and f is not None \
        else None
    q, short = c.get("search.queries"), c.get("search.short_answers")
    out["short_answer_share"] = 100.0 * short / q if q and short is not None \
        else None
    for part in BUILD:
        out[f"{part}_s"] = _span_s(build, f"repro_torch.build.{part}")
    return out
